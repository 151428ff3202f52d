"""fp32 softmax-attention oracle, with torch.autograd as the gradient oracle.

Counterpart of quantizedattention_tpu/reference/attention.py. Causal means
k <= q (the kernels' convention, not the strict k < q of the original
reference). Every product runs in true fp32: the module turns TF32 off for
its own matmuls (`_no_tf32`), since a card's float32 matmul may otherwise
round its operands to 10-bit mantissas and make the oracle inexact.

GQA: k/v may carry fewer heads than q; q head h reads kv head h // rep, as the
kernels do, so the gradients of k/v come back summed over each group.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V in fp32 on [batch, head, tokens, head_dim]."""
    q, k, v = q.float(), k.float(), v.float()
    rep = q.shape[1] // k.shape[1]
    if rep != 1:
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    with _no_tf32():
        s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if causal:
            q_ids = torch.arange(s.shape[-2], device=s.device)[:, None]
            k_ids = torch.arange(s.shape[-1], device=s.device)[None, :]
            s = torch.where(k_ids <= q_ids, s, -torch.inf)
        return torch.softmax(s, dim=-1) @ v


def reference_attention_vjp(q, k, v, do, causal: bool = False):
    """Oracle gradients (dq, dk, dv) in f32 for cotangent `do`, via autograd."""
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad(), _no_tf32():
        o = reference_attention(*leaves, causal=causal)
        return torch.autograd.grad(o, leaves, do.float())
