"""Corrected-bf16 flash-attention forward: CUDA kernel and plain version.

Counterpart of quantizedattention_tpu/ops/flash_fwd.py. `flash_attention_fwd`
launches the hand-written Hopper kernel (csrc/flash_fwd.cu) for CUDA tensors
and runs `flash_attention_fwd_plain`, the same arithmetic in plain PyTorch,
for CPU tensors. Both return (O f32 [b, h, t, d], lse f32 [b, h, t]) with lse
= m + log2(l) in the exp2 domain.

Numerics shared by both: q is pre-scaled by sm_scale*log2(e) in f32 and
rounded to bf16; k/v are rounded to bf16; S accumulates in f32; masked logits
(causal k <= q, kv padding) are MASK_VALUE; the row max carries +EPS_BIAS
(the "eps" correction); P = exp2(S - m) is rounded to bf16 before both the PV
product and the row sum; rows with l == 0 give 0. The kernel runs the online
softmax over 64-key tiles and the plain version over whole rows, so the two
differ only in where P is rounded and in summation order.

GQA is native: k/v carry h_kv heads with h_kv dividing h, and q head
h = kv_head * rep + g reads kv head `kv_head`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import MASK_VALUE, qk_scales, tile_mask
from quantizedattention_tpu_torch.quantize.bf16_correction import EPS_BIAS
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

_HEAD_DIM = 64  # the kernel's compiled head dim
_BLOCK_ROWS = 64  # rows per kernel block; the GQA group must fit in it


def _check_args(q, k, v, correction):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q [b,h,t,d], k/v [b,h_kv,s,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch/head_dim")
    if h % k.shape[1] != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({k.shape[1]})")
    if k.shape[2] == 0:
        raise ValueError("kv length must be positive")
    if correction != "eps":
        raise NotImplementedError(f"correction={correction!r}: only 'eps' is ported")


def flash_attention_fwd_plain(q, k, v, causal=False, sm_scale=None, correction="eps"):
    """The forward's arithmetic in plain PyTorch, one softmax over whole rows."""
    _check_args(q, k, v, correction)
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    _, qk_scale = qk_scales(d, sm_scale)
    qs = (q.float() * qk_scale).to(torch.bfloat16).float().reshape(b, h_kv, h // h_kv, t, d)
    kf = k.to(torch.bfloat16).float()[:, :, None]
    vf = v.to(torch.bfloat16).float()[:, :, None]
    scores = qs @ kf.transpose(-1, -2)  # [b, h_kv, rep, t, s] f32
    mask = tile_mask(0, 0, t, s, s, causal, device=q.device)
    scores = torch.where(mask, scores, MASK_VALUE)
    m = scores.amax(-1, keepdim=True) + EPS_BIAS
    p = torch.exp2(scores - m).to(torch.bfloat16).float()
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (p @ vf) / l_safe
    lse = m + torch.log2(l_safe)
    return o.reshape(b, h, t, d), lse[..., 0].reshape(b, h, t)


@functools.cache
def _kernel():
    fn = load_kernel("flash_fwd").qa_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, correction="eps"):
    """Flash-attention forward. q [b, h, t, d]; k/v [b, h_kv, s, d].

    CUDA tensors launch the kernel (head_dim 64, rep <= 64) or raise; CPU
    tensors take `flash_attention_fwd_plain`. `flash_attention_fwd.launches`
    counts kernel launches.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale, correction)
    _check_args(q, k, v, correction)
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    rep = h // h_kv
    if d != _HEAD_DIM or rep > _BLOCK_ROWS or b * h_kv > 65535:
        raise ValueError(f"kernel takes head_dim {_HEAD_DIM}, rep <= {_BLOCK_ROWS}, "
                         f"b*h_kv <= 65535; got d={d}, rep={rep}, b*h_kv={b * h_kv}")
    _, qk_scale = qk_scales(d, sm_scale)
    qs = (q.float() * qk_scale).to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    dev = require_cuda(qs, kb, vb)
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    status = _kernel()(
        qs.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h_kv, rep, t, s, int(causal), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
