"""Head-sharded tensor parallelism and batch data parallelism for attention.

Counterpart of quantizedattention_tpu/parallel/sharded.py. Heads are
independent in every attention kernel here, so with the batch split over
`data` and the heads over `model` a rank attends its own (batch, head)
block with the one-device kernel and no collective; the projection that
follows sums over `model`. In the multi-controller port there is nothing to
trace: the caller already holds its local blocks ([b / data, h / model, t,
d] for q, [b / data, h_kv / model, s, d] for k and v; `shard_tensor` with
`spec` cuts them from full tensors), and the function calls the kernel's
autograd Function on them, so gradients shard with it.
"""

from __future__ import annotations

from quantizedattention_tpu_torch.ops.api import (
    attention_jvp,
    flash_attention_bf16,
    sage_attention_int8,
)
_KINDS = {
    "bf16": flash_attention_bf16,
    "int8": sage_attention_int8,
    "jvp": attention_jvp,
}


def make_sharded_attention(mesh, kind: str = "bf16", causal: bool = False,
                           sm_scale: float | None = None):
    """(q, k, v) -> O on this rank's (batch, head) block of `mesh`: `kind` "bf16"
    (B1; backward B2, B3), "int8" (B4, B5; backward B7, B8) or "jvp" (B1
    fp32; backward B2, B3 exact; forward-mode B10). Returns the local O
    block; `spec` is the block layout (batch on data, heads on model)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    fn = _KINDS[kind]

    def sharded(q, k, v):
        return fn(q, k, v, causal=causal, sm_scale=sm_scale)

    sharded.spec = ("data", "model", None, None)
    return sharded
