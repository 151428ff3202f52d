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
softmax over 128-key tiles and the plain version over whole rows, so the two
differ only in where P is rounded and in summation order.

`correction` picks the rule (quantize/bf16_correction.py): "eps" as above,
"none" the same without EPS_BIAS, "beta" the reference's tied-max rule. JAX
applies "beta" once per kv subtile of `correction_grain(t, s, rep,
precision)` keys (384 or 1024 at the usual lengths, from key 0): where more
than one logit of the subtile lies within `tol` of max(running max,
subtile max), that max becomes beta * max (or 0 where it is not positive),
and P, l and alpha are taken against it. Both versions do the same per
group of that many keys: the plain version group by group, the kernel with
a pre-pass over each group's key tiles that finds each row's two largest
logits (tied exactly when the second is within tol of the max). At large
tied logits every P of a row may underflow: O = 0 and a finite lse (the JAX
package's own test of the rule, tests/test_bf16_attention.py:101-127).

Causal masking is on global positions (flash_fwd.py:228-229, the TPU
kernel's q_offset/k_offset): query i sits at q_offset + i and key j at
k_offset + j, and a key is visible where k_offset + j <= q_offset + i (and j
< s: the kv-length mask stays local). A sequence shard passes its first
token's position. A row that sees no key (q_offset < k_offset) gives O = 0
and lse = -inf in both versions; the TPU kernel gives such a row inside a
live tile a finite lse and the mean of its V (ROADMAP.md §C). Only the bf16
mode takes offsets: `flash_attention_fwd_fp32` has none.

The kernel takes q as it comes (f32 or bf16, any strides with rows
contiguous) and scales and rounds it itself; bf16 k/v go to its TMA maps as
they are (a [b, s, h_kv, d] storage read as [b, h_kv, s, d] included), and
f32 k/v are cast to bf16 by one launch for both (`kv_to_bf16`). The launch
geometry is ops/flash_tiling.py's.

GQA is native: k/v carry h_kv heads with h_kv dividing h, and q head
h = kv_head * rep + g reads kv head `kv_head`.

On the card both modes take head dim 64 or 128 (BASELINE config 2's two;
the fp32 mode's 128 is the rCM DiT's at DIT128_CFG); ops/common.py:
check_head_dim refuses the rest.

The fp32 mode (flash_fwd.py:255-260, `precision="fp32"`; the primal of
`attention_jvp` and the rCM prepass) is a second kernel of the same file with
its own wrapper, `flash_attention_fwd_fp32`, and its own launch count: q is
pre-scaled in f32, k/v stay f32, nothing is rounded to a narrower type (the
TPU's Precision.HIGHEST dots), and the eps row-max bias still applies. The
kernel takes each product as three TF32 products on the tensor cores
(3xTF32: x = big + small, big rounded to nearest TF32), reads q through its
strides and scales it itself, and takes K and V from one prep launch
(`kv_split_tf32`: K big and small, V^T big and small) that reads them
through their strides. The plain version serves both modes through its
`precision` argument; `kv_split_tf32_plain` is the prep's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops import flash_tiling
from quantizedattention_tpu_torch.ops.common import (
    MASK_VALUE,
    check_head_dim,
    check_offsets,
    qk_scales,
    tile_mask,
)
from quantizedattention_tpu_torch.quantize.bf16_correction import (
    APPROX_MAX_TOL,
    BETA,
    EPS_BIAS,
    amplify_tied_max,
)
from quantizedattention_tpu_torch.tune.config import correction_grain
from quantizedattention_tpu_torch.utils.runtime import check_status

# the correction rules and the kernels' numbering of them (csrc/flash_fwd.cu RULE_*)
RULES = {"eps": 0, "none": 1, "beta": 2}


def _check_args(q, k, v, correction, precision="bf16"):
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
    if correction not in RULES:
        raise ValueError(f"unknown correction {correction!r}: want one of {list(RULES)}")
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"unknown precision {precision!r}")


def flash_attention_fwd_plain(q, k, v, causal=False, sm_scale=None, correction="eps",
                              precision="bf16", q_offset=0, k_offset=0, beta=BETA,
                              tol=APPROX_MAX_TOL):
    """The forward's arithmetic in plain PyTorch; `precision="fp32"` rounds
    nothing. "eps" and "none" take one softmax over whole rows; "beta" runs
    the online softmax over groups of `correction_grain` keys, as the JAX
    kernel does. Rows that see no key give O = 0 and lse = -inf."""
    _check_args(q, k, v, correction, precision)
    q_offset, k_offset = check_offsets(q_offset, k_offset)
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    _, qk_scale = qk_scales(d, sm_scale)
    fp32 = precision == "fp32"

    def rnd(x):
        return x if fp32 else x.to(torch.bfloat16).float()

    qs = rnd(q.float() * qk_scale).reshape(b, h_kv, h // h_kv, t, d)
    kf = rnd(k.float())[:, :, None]
    vf = rnd(v.float())[:, :, None]
    scores = qs @ kf.transpose(-1, -2)  # [b, h_kv, rep, t, s] f32
    mask = tile_mask(q_offset, k_offset, t, s, s, causal, k_local_start=0, device=q.device)
    scores = torch.where(mask, scores, MASK_VALUE)
    if correction == "beta":
        grain = correction_grain(t, s, h // h_kv, precision)
        m = torch.full(scores.shape[:-1] + (1,), -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(scores.shape[:-1] + (d,), device=q.device)
        for lo in range(0, s, grain):
            sg = scores[..., lo:lo + grain]
            next_m = amplify_tied_max(sg, torch.maximum(m, sg.amax(-1, keepdim=True)), beta, tol)
            p = rnd(torch.exp2(sg - next_m))
            alpha = torch.exp2(m - next_m)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[..., lo:lo + grain, :]
            m = next_m
    else:
        m = scores.amax(-1, keepdim=True) + (EPS_BIAS if correction == "eps" else 0.0)
        p = rnd(torch.exp2(scores - m))
        l = p.sum(-1, keepdim=True)
        acc = p @ vf
    l_safe = torch.where(l == 0.0, 1.0, l)
    seen = mask.any(-1, keepdim=True)  # [t, 1]: the row sees a key
    o = torch.where(seen, acc / l_safe, 0.0)
    lse = torch.where(seen, m + torch.log2(l_safe), -torch.inf)
    return o.reshape(b, h, t, d), lse[..., 0].reshape(b, h, t)


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {  # the C entries of csrc/flash_fwd.cu
    "qa_flash_fwd": [_PTR, _I64, _I64, _I64, _I32] + [_PTR, _I64, _I64, _I64] * 2 + [_PTR, _PTR]
                    + [_I32] * 9 + [ctypes.c_float] + [_I32] * 3 + [ctypes.c_float] * 2 + [_PTR],
    "qa_flash_kv_to_bf16": [_PTR, _I64, _I64, _I64] * 2 + [_PTR, _PTR] + [_I32] * 4 + [_PTR],
    "qa_flash_kv_split_tf32": [_PTR, _I64, _I64, _I64] * 2 + [_PTR] * 4 + [_I32] * 4 + [_PTR],
    "qa_flash_fwd_f32": [_PTR, _I64, _I64, _I64] + [_PTR] * 6 + [_I32] * 6
                        + [ctypes.c_float] + [_I32] * 3 + [ctypes.c_float] * 2 + [_PTR],
}


@functools.cache
def _kernel(name="qa_flash_fwd"):
    fn = getattr(load_kernel("flash_fwd"), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _strides(x):
    """x's (batch, head, token) strides in elements, as the kernel takes them:
    a dimension of size 1 gets the stride of a whole [s, d] matrix (any
    16-byte multiple does; TMA wants one)."""
    return [st if n > 1 else x.shape[2] * x.shape[3] for n, st in zip(x.shape[:3], x.stride()[:3])]


def _kernel_ready(x, dtypes):
    """x itself if the kernel reads it in place (a dtype of `dtypes`, on a
    CUDA device, rows contiguous, pointer and strides 16-byte aligned), else a
    contiguous copy (f32 unless x's dtype is in `dtypes`)."""
    if x.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got one on {x.device}")
    if x.dtype not in dtypes:
        x = x.float()
    size = x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(st > 0 and st * size % 16 == 0 for st in _strides(x))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def kv_to_bf16(k, v):
    """f32 k and v [b, h_kv, s, d], d 64 or 128 (rows contiguous, 16-byte
    aligned) -> contiguous bf16 copies, both in one launch: the K/V prep of
    f32 inputs (B1 bf16's and fast B2/B3's)."""
    b, h_kv, s, d = k.shape
    check_head_dim("B1 bf16", d)
    kb = torch.empty((b, h_kv, s, d), dtype=torch.bfloat16, device=k.device)
    vb = torch.empty_like(kb)
    status = _kernel("qa_flash_kv_to_bf16")(
        k.data_ptr(), *_strides(k), v.data_ptr(), *_strides(v), kb.data_ptr(), vb.data_ptr(),
        b, h_kv, s, d, torch.cuda.current_stream(k.device).cuda_stream)
    check_status(status, "flash_fwd kv_to_bf16")
    return kb, vb


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, correction="eps", q_offset=0,
                        k_offset=0, beta=BETA, tol=APPROX_MAX_TOL):
    """Corrected-bf16 flash-attention forward. q [b, h, t, d]; k/v [b, h_kv, s, d].

    CUDA tensors launch the kernel (head_dim 64 or 128, rep <= 128, b*h_kv <=
    65535) or raise; CPU tensors take `flash_attention_fwd_plain`. q may be
    f32 or bf16 with any strides (rows contiguous) and is scaled in the kernel; bf16
    k/v are read in place, f32 k/v are cast by one `kv_to_bf16` launch.
    q_offset/k_offset (host ints >= 0): the global positions of the first
    query and key, for causal masking across sequence shards. correction:
    "eps" (default), "beta" (ties within `tol` of the max amplify it by
    `beta`, once per `correction_grain` keys) or "none".
    `flash_attention_fwd.launches` counts kernel launches (one a call).
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale, correction,
                                         q_offset=q_offset, k_offset=k_offset, beta=beta, tol=tol)
    _check_args(q, k, v, correction)
    q_offset, k_offset = check_offsets(q_offset, k_offset)
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    check_head_dim("B1 bf16", d)
    bq, _ = flash_tiling.grid(b * h_kv, h // h_kv, t, d)
    _, qk_scale = qk_scales(d, sm_scale)
    qk = _kernel_ready(q, (torch.float32, torch.bfloat16))
    if k.dtype == v.dtype == torch.bfloat16:
        kb, vb = _kernel_ready(k, (torch.bfloat16,)), _kernel_ready(v, (torch.bfloat16,))
    else:
        kb, vb = kv_to_bf16(_kernel_ready(k, (torch.float32,)), _kernel_ready(v, (torch.float32,)))
    if not qk.device == kb.device == vb.device:
        raise ValueError(f"q, k and v lie on {qk.device}, {kb.device} and {vb.device}")
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    status = _kernel()(
        qk.data_ptr(), *_strides(qk), int(qk.dtype == torch.float32), kb.data_ptr(),
        *_strides(kb), vb.data_ptr(), *_strides(vb), o.data_ptr(), lse.data_ptr(), b, h_kv,
        h // h_kv, t, s, bq, int(causal), q_offset, k_offset, qk_scale, d, RULES[correction],
        correction_grain(t, s, h // h_kv), beta, tol,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_status(status, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def tf32_split(x):
    """f32 x -> (big, small): big = x rounded to nearest TF32, ties away from
    zero (the low 13 bits cleared after adding half their range, as
    cvt.rna.tf32.f32), small = x - big, exact in f32."""
    big = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return big, x - big


def kv_split_tf32_plain(k, v):
    """The fp32 mode's K/V prep in plain PyTorch: f32 k, v [b, h_kv, s, d] ->
    (K big, K small [b * h_kv, s, d], V^T big, V^T small [b * h_kv, d, s8]),
    s8 = `flash_tiling.fp32_kv_cols(s)`. Column 8g + j of V^T holds key 8g +
    `flash_tiling.TF32_A_COLUMNS[j]` (the order in which the kernel's P
    fragments hold their keys); keys past s are 0."""
    b, h_kv, s, d = k.shape
    kb, ks = tf32_split(k.float().reshape(b * h_kv, s, d).contiguous())
    s8 = flash_tiling.fp32_kv_cols(s)
    vf = torch.zeros((b * h_kv, s8, d), dtype=torch.float32, device=v.device)
    vf[:, :s] = v.float().reshape(b * h_kv, s, d)
    order = torch.tensor(flash_tiling.TF32_A_COLUMNS, device=v.device)
    keys = (torch.arange(0, s8, 8, device=v.device)[:, None] + order).reshape(-1)
    vbt, vst = tf32_split(vf[:, keys].transpose(1, 2).contiguous())
    return kb, ks, vbt, vst


def kv_split_tf32(k, v):
    """`kv_split_tf32_plain`'s result, byte for byte, from one kernel launch
    for CUDA tensors (f32 k, v [b, h_kv, s, d], d 64 or 128, rows contiguous,
    16-byte aligned); CPU tensors take the plain version. `kv_split_tf32.launches`
    counts kernel launches."""
    if k.device.type == "cpu":
        return kv_split_tf32_plain(k, v)
    b, h_kv, s, d = k.shape
    check_head_dim("B1 fp32", d)
    if k.device.type != "cuda" or v.device != k.device:
        raise ValueError(f"expected CUDA tensors on one device, got {k.device} and {v.device}")
    if (k.dtype, v.dtype, v.shape) != (torch.float32, torch.float32, k.shape) \
            or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"kernel takes f32 k, v [b, h_kv, s, {d}] with rows contiguous")
    s8 = flash_tiling.fp32_kv_cols(s)
    kb = torch.empty((b * h_kv, s, d), dtype=torch.float32, device=k.device)
    ks = torch.empty_like(kb)
    vbt = torch.empty((b * h_kv, d, s8), dtype=torch.float32, device=k.device)
    vst = torch.empty_like(vbt)
    status = _kernel("qa_flash_kv_split_tf32")(
        k.data_ptr(), *_strides(k), v.data_ptr(), *_strides(v), kb.data_ptr(), ks.data_ptr(),
        vbt.data_ptr(), vst.data_ptr(), b, h_kv, s, d,
        torch.cuda.current_stream(k.device).cuda_stream)
    check_status(status, "flash_fwd kv_split_tf32")
    kv_split_tf32.launches += 1
    return kb, ks, vbt, vst


def flash_attention_fwd_fp32(q, k, v, causal=False, sm_scale=None, correction="eps", beta=BETA,
                             tol=APPROX_MAX_TOL):
    """The fp32 flash-attention forward: for CUDA tensors one `kv_split_tf32`
    launch and the 3xTF32 kernel (head_dim 64 or 128, any rep, b*h <= 65535; q, k, v
    read through their strides, rows contiguous), or
    `flash_attention_fwd_plain(precision="fp32")` for CPU tensors; correction,
    beta and tol as `flash_attention_fwd`'s. Returns (O f32 [b, h, t, d], lse
    f32 [b, h, t]); `flash_attention_fwd_fp32.launches` counts kernel launches
    (the prep's are `kv_split_tf32.launches`)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale, correction, "fp32",
                                         beta=beta, tol=tol)
    _check_args(q, k, v, correction)
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    check_head_dim("B1 fp32", d)
    flash_tiling.fp32_grid(b * h, t)
    _, qk_scale = qk_scales(d, sm_scale)
    qf, kf, vf = (_kernel_ready(x, (torch.float32,)) for x in (q, k, v))
    dev = qf.device
    if not dev == kf.device == vf.device:
        raise ValueError(f"q, k and v lie on {dev}, {kf.device} and {vf.device}")
    kb, ks, vbt, vst = kv_split_tf32(kf, vf)
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    status = _kernel("qa_flash_fwd_f32")(
        qf.data_ptr(), *_strides(qf), kb.data_ptr(), ks.data_ptr(), vbt.data_ptr(),
        vst.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, h_kv, t, s, int(causal), qk_scale, d,
        RULES[correction], correction_grain(t, s, h // h_kv, "fp32"), beta, tol,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_status(status, "flash_fwd_fp32")
    flash_attention_fwd_fp32.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd_fp32.launches = 0
kv_split_tf32.launches = 0
