"""SageAttention3-style int8 flash-attention forward: quantize, then attend.

Counterpart of quantizedattention_tpu/ops/int8_fwd.py: the materialized
training forward (B4 quantizes, B5 attends) and the fused inference forward
(B6, `int8_attention_fwd_fused`), which keeps no int8 residual.

`quantize_qkv` quantizes Q, K (minus the K-smoothing shift) and V with one
launch of B4 (`quantize.int8.quant_int8`) at the JAX package's scale grain
(`tune.config.int8_grain`): one scale per q_grain tokens of each q head, per
kv_grain tokens of each kv head. The residuals keep the JAX layout:
((q_i8 [b*h, q_pad, d], sq [b*h, nq]), (k_i8 [b*h_kv, kv_pad, d], sk),
(v_i8, sv)), q head h = kv_head * rep + g.

`int8_attention_fwd_from_quantized` runs B5 (csrc/int8_fwd.cu) on CUDA
residuals and `int8_attention_fwd_from_quantized_plain` on CPU ones. Shared
numerics (ops/int8_fwd.py:130-171 of the JAX package): the raw logits
Q_i8 K_i8^T are exact integers; c = (sq * sk) * qk_scale per (row, key
grain); masked raw logits (causal k <= q) become 30000 / -c; the row max is
max(raw) * c + EPS_BIAS; P = bf16(exp2(raw * c - m)) feeds the row sum and
the PV product; each kv grain's P V_i8 is scaled by its sv; rows with l == 0
give 0 and lse = m + log2(l) (exp2 domain). The kernel runs the online
softmax per 128-key tile, the plain version over whole rows, so the two
differ only in where P is rounded (as B1 and its plain version do).

Causal masking is on global positions (JAX ops/int8_fwd.py:85-86, the TPU
kernel's q_offset/k_offset): query i sits at q_offset + i and key j at
k_offset + j, visible where k_offset + j <= q_offset + i (and j < s). The
sequence-parallel paths pass a shard's first token (parallel/collective.py,
parallel/ring.py). A row that sees no key (q_offset < k_offset) gives O = 0
and lse = -inf in both versions; the TPU kernel gives such a row inside a
live tile a finite lse and the mean of its V (ROADMAP.md §C, C4). The scale
grain stays the payloads' own: offsets move only the mask. B6 takes none.

`int8_attention_fwd_fused` runs B6 on f32 or bf16 CUDA inputs: one B4 launch
(`quant_int8_uncounted`, on the inputs in their own type) writes the
payloads and scale tables of Q, K (after the shift) and V into scratch, so K
and V are quantized once per call; then B5's kernel attends on that scratch.
O and lse equal B4 then B5 on the same inputs by construction, and its plain
version is exactly that composition. The block size of both is
`ops.int8_tiling`'s.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import (
    check_head_dim,
    check_offsets,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.ops.int8_tiling import block_positions, check_grain
from quantizedattention_tpu_torch.quantize.bf16_correction import EPS_BIAS
from quantizedattention_tpu_torch.quantize.int8 import (
    IN_TYPES,
    QuantJob,
    quant_int8,
    quant_int8_plain,
    quant_int8_uncounted,
)
from quantizedattention_tpu_torch.tune.config import int8_grain
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda


def _qkv_jobs(q, k, v, k_sub, to_f32=True):
    """B4's jobs for q [b, h, t, d], k/v [b, h_kv, s, d]: the caller's
    tensors themselves (f32 unless to_f32 is False), which the kernel reads
    through their strides; no copy."""
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({h_kv})")
    q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, s, h // h_kv)

    def rows(x):
        return x.float() if to_f32 else x

    sub = None if k_sub is None else k_sub.float().reshape(b * h_kv, d).contiguous()
    return [QuantJob(rows(q), q_pad, q_grain), QuantJob(rows(k), kv_pad, kv_grain, sub),
            QuantJob(rows(v), kv_pad, kv_grain)]


def quantize_qkv(q, k, v, k_sub=None):
    """Quantize q [b, h, t, d], k/v [b, h_kv, s, d] at the JAX grain in one
    B4 launch (CUDA) or its plain version (CPU).

    k_sub: optional [b, h_kv, 1, d] shift (the K-smoothing mean) subtracted
    from K, padded rows included. Returns the residuals
    ((q_i8, sq), (k_i8, sk), (v_i8, sv)).
    """
    return tuple(quant_int8(_qkv_jobs(q, k, v, k_sub)))


def quantize_qkv_plain(q, k, v, k_sub=None):
    """`quantize_qkv` through B4's plain version, on any device."""
    return tuple(quant_int8_plain(_qkv_jobs(q, k, v, k_sub)))


def _layout(residuals, dims):
    """Check the residuals against dims; returns (bh_kv, rep, q_grain, kv_grain)."""
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    b, h, t, s, d = dims
    bh_kv = k_i8.shape[0]
    if (b * h) % bh_kv != 0 or q_i8.shape[0] != b * h:
        raise ValueError(f"q rows ({q_i8.shape[0]}) must be b*h = {b * h}, a multiple of the "
                         f"kv rows ({bh_kv})")
    if v_i8.shape != k_i8.shape or q_i8.shape[2] != d or k_i8.shape[2] != d:
        raise ValueError(f"payloads disagree: q {tuple(q_i8.shape)}, k {tuple(k_i8.shape)}, "
                         f"v {tuple(v_i8.shape)}, head_dim {d}")
    if q_i8.shape[1] < t or k_i8.shape[1] < s:
        raise ValueError(f"payloads shorter than dims: {q_i8.shape[1]} < {t} or "
                         f"{k_i8.shape[1]} < {s}")
    if sq.shape[0] != q_i8.shape[0] or sk.shape != sv.shape or sk.shape[0] != bh_kv \
            or q_i8.shape[1] % sq.shape[1] or k_i8.shape[1] % sk.shape[1]:
        raise ValueError(f"scale tables {tuple(sq.shape)}, {tuple(sk.shape)}, "
                         f"{tuple(sv.shape)} do not tile the payloads")
    return bh_kv, b * h // bh_kv, q_i8.shape[1] // sq.shape[1], k_i8.shape[1] // sk.shape[1]


def raw_logits_and_scale(q_i8, sq, k_i8, sk, bh_kv, rep, t, s, q_grain, kv_grain, qk_scale):
    """(raw [bh_kv, rep, t, s] exact integer logits in f32, c = (sq * sk) *
    qk_scale of the same shape), from payloads and scale tables."""
    d = q_i8.shape[2]
    qf = q_i8[:, :t].float().reshape(bh_kv, rep, t, d)
    kf = k_i8[:, :s].float()[:, None]
    raw = qf @ kf.transpose(-1, -2)  # |sums| < 2^24: exact in any order
    dev = q_i8.device
    sq_row = sq.float().reshape(bh_kv, rep, -1)[..., torch.arange(t, device=dev) // q_grain]
    sk_key = sk.float()[:, torch.arange(s, device=dev) // kv_grain]
    c = (sq_row[..., None] * sk_key[:, None, None, :]) * qk_scale
    return raw, c


def int8_attention_fwd_from_quantized_plain(residuals, dims, causal=False, sm_scale=None,
                                            q_offset=0, k_offset=0):
    """B5's arithmetic in plain PyTorch, one softmax over whole rows.
    Returns (o [b, h, t, d] f32, lse [b, h, t]); rows that see no key give
    O = 0 and lse = -inf."""
    q_offset, k_offset = check_offsets(q_offset, k_offset)
    bh_kv, rep, q_grain, kv_grain = _layout(residuals, dims)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    b, h, t, s, d = dims
    _, qk_scale = qk_scales(d, sm_scale)
    raw, c = raw_logits_and_scale(q_i8, sq, k_i8, sk, bh_kv, rep, t, s, q_grain, kv_grain,
                                  qk_scale)
    mask = tile_mask(q_offset, k_offset, t, s, s, causal, k_local_start=0, device=raw.device)
    raw = torch.where(mask, raw, 30000.0 / -c)
    scaled = raw * c
    m = scaled.amax(-1, keepdim=True) + EPS_BIAS
    p = torch.exp2(scaled - m).to(torch.bfloat16).float()
    l = p.sum(-1, keepdim=True)
    vf = v_i8[:, :s].float()[:, None]
    acc = torch.zeros((bh_kv, rep, t, d), dtype=torch.float32, device=raw.device)
    for g0 in range(0, s, kv_grain):  # each kv grain's P V scaled by its sv
        g1 = min(g0 + kv_grain, s)
        pv = p[..., g0:g1] @ vf[:, :, g0:g1]
        acc = acc + pv * sv.float()[:, g0 // kv_grain, None, None, None]
    l_safe = torch.where(l == 0.0, 1.0, l)
    seen = mask.any(-1, keepdim=True)  # [t, 1]: the row sees a key
    o = torch.where(seen, acc / l_safe, 0.0)
    lse = torch.where(seen, m + torch.log2(l_safe), -torch.inf)
    return o.reshape(b, h, t, d), lse[..., 0].reshape(b, h, t)


@functools.cache
def _kernel():
    fn = load_kernel("int8_fwd").qa_int8_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(residuals, dims):
    """Check what the kernel takes; returns (device, bh_kv, rep, q_grain,
    kv_grain, bq)."""
    bh_kv, rep, q_grain, kv_grain = _layout(residuals, dims)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    d = dims[4]
    check_head_dim("B5", d)
    bq = block_positions(bh_kv, rep)
    check_grain(kv_grain, k_i8.shape[1])
    if any(x.dtype != torch.int8 for x in (q_i8, k_i8, v_i8)) or \
            any(x.dtype != torch.float32 for x in (sq, sk, sv)):
        raise ValueError("kernel takes int8 payloads and float32 scales")
    return require_cuda(q_i8, k_i8, v_i8, sq, sk, sv), bh_kv, rep, q_grain, kv_grain, bq


def _attend(residuals, dims, causal, sm_scale, q_offset=0, k_offset=0):
    """One launch of B5's kernel on CUDA residuals, not counted here."""
    dev, bh_kv, rep, q_grain, kv_grain, bq = _launch_args(residuals, dims)
    (q_i8, sq), (k_i8, sk), (v_i8, sv) = residuals
    b, h, t, s, d = dims
    _, qk_scale = qk_scales(d, sm_scale)
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    status = _kernel()(
        q_i8.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        sv.data_ptr(), o.data_ptr(), lse.data_ptr(), bh_kv, rep, t, s, q_i8.shape[1],
        k_i8.shape[1], q_grain, kv_grain, bq, int(causal), q_offset, k_offset, qk_scale, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "int8_fwd")
    return o, lse


def int8_attention_fwd_from_quantized(residuals, dims, causal=False, sm_scale=None, q_offset=0,
                                      k_offset=0):
    """B5: the int8 forward from pre-quantized residuals (the layout of
    `quantize_qkv`); dims = (batch, head, q_tokens, kv_len, head_dim).

    q_offset/k_offset (host ints >= 0): the global positions of the first
    query and key, for causal masking across sequence shards. CUDA residuals
    launch the kernel (head_dim 64 or 128, rep <= 128, kv grain a multiple of
    128) or raise; CPU residuals take the plain version. Returns (o [b, h, t, d]
    f32, lse [b, h, t]). `.launches` counts kernel launches.
    """
    if residuals[0][0].device.type == "cpu":
        return int8_attention_fwd_from_quantized_plain(residuals, dims, causal, sm_scale,
                                                       q_offset, k_offset)
    q_offset, k_offset = check_offsets(q_offset, k_offset)
    out = _attend(residuals, dims, causal, sm_scale, q_offset, k_offset)
    int8_attention_fwd_from_quantized.launches += 1
    return out


int8_attention_fwd_from_quantized.launches = 0


def _qkv_dims(q, k, v):
    """(b, h, t, s, d) of q [b, h, t, d], k/v [b, h_kv, s, d]; raises on others."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"want q [b,h,t,d], k/v [b,h_kv,s,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]


def int8_attention_fwd(q, k, v, causal=False, sm_scale=None, k_sub=None):
    """Int8 attention forward on q [b, h, t, d], k/v [b, h_kv, s, d].

    k_sub: optional [b, h_kv, 1, d] K-smoothing mean, subtracted inside the
    quantization pass. Returns (o f32 [b, h, t, d], lse [b, h, t], residuals)
    with the residuals of `quantize_qkv` for the int8 backward.
    """
    dims = _qkv_dims(q, k, v)
    residuals = quantize_qkv(q, k, v, k_sub=k_sub)
    o, lse = int8_attention_fwd_from_quantized(residuals, dims, causal=causal, sm_scale=sm_scale)
    return o, lse, residuals


# ---------------------------------------------------------------------------
# B6: the fused inference forward
# ---------------------------------------------------------------------------

def int8_attention_fwd_fused_plain(q, k, v, causal=False, sm_scale=None, k_sub=None):
    """B6's arithmetic in plain PyTorch: B4's plain version quantizes at the
    JAX grain, then B5's attends. Returns (o [b, h, t, d] f32, lse [b, h, t])."""
    dims = _qkv_dims(q, k, v)
    residuals = quantize_qkv_plain(q, k, v, k_sub=k_sub)
    return int8_attention_fwd_from_quantized_plain(residuals, dims, causal, sm_scale)


def _fused_launch_args(q, k, v, k_sub):
    """Check what B6 takes, before any launch; returns (dims, B4's jobs on
    the inputs in their own type)."""
    dims = b, h, t, s, d = _qkv_dims(q, k, v)
    h_kv = k.shape[1]
    if h % h_kv != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({h_kv})")
    check_head_dim("B6", d)
    block_positions(b * h_kv, h // h_kv)
    _, kv_grain, _, kv_pad = int8_grain(t, s, h // h_kv)
    check_grain(kv_grain, kv_pad)
    if q.dtype not in IN_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes q, k, v of one type among {list(IN_TYPES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k_sub is not None and tuple(k_sub.shape) != (b, h_kv, 1, d):
        raise ValueError(f"k_sub must be {(b, h_kv, 1, d)}, got {tuple(k_sub.shape)}")
    jobs = _qkv_jobs(q, k, v, k_sub, to_f32=False)
    require_cuda(*(j.x for j in jobs), *(j.sub for j in jobs if j.sub is not None))
    return dims, jobs


def int8_attention_fwd_fused(q, k, v, causal=False, sm_scale=None, k_sub=None):
    """B6: int8 attention forward on inputs in their own floating type.

    q [b, h, t, d], k/v [b, h_kv, s, d] (f32 or bf16 on the kernel path);
    k_sub: optional [b, h_kv, 1, d] K-smoothing shift. Numerics of
    `int8_attention_fwd` on the same inputs (the same grain, payloads and
    scales), with no residuals kept. CUDA tensors launch the kernels (head_dim
    64 or 128, rep <= 128) or raise; CPU tensors take `int8_attention_fwd_fused_plain`.
    Returns (o [b, h, t, d] f32, lse [b, h, t]). `.launches` counts calls on
    the kernel path: B4's launch and B5's together count one.
    """
    if q.device.type == "cpu":
        return int8_attention_fwd_fused_plain(q, k, v, causal, sm_scale, k_sub)
    dims, jobs = _fused_launch_args(q, k, v, k_sub)
    out = _attend(quant_int8_uncounted(jobs), dims, causal, sm_scale)
    int8_attention_fwd_fused.launches += 1
    return out


int8_attention_fwd_fused.launches = 0
