"""The head dims the port's kernels take on the card (ops/common.py's
KERNEL_HEAD_DIMS and check_head_dim).

Every kernel in every mode takes head dim 64 or 128: B1 in both modes,
B2/B3 in both, the int8 family (B4, B5, B6, B7/B8), the four decode kernels
(B13-B16), B9, B11 and B12 in both modes and B10 in both. Head dim 32 is
refused naming ROADMAP B-f3 (what it still lacks), and nothing takes
another head dim. Pure Python: the check itself, then each wrapper's CUDA
branch on meta tensors (neither CPU nor CUDA, so a wrapper takes its kernel
path and must raise before it asks for a CUDA tensor), which shows that
every wrapper passes the check at 128 and then asks for CUDA tensors: none
refuses and none falls back to its plain version.
"""

import pytest
import torch

from quantizedattention_tpu_torch.ops import (
    attention_jvp_fwd,
    flash_attention_bwd,
    flash_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_bwd_dkv,
    int8_bwd_dq,
    int8_bwd_operands,
    quantize_qkv,
    sage_attention_int8,
    sage_attention_int8_inference,
)
from quantizedattention_tpu_torch.ops.common import KERNEL_HEAD_DIMS, check_head_dim
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd_fp32, kv_split_tf32
from quantizedattention_tpu_torch.ops.jvp_bwd import jvp_bwd_dkv, jvp_bwd_dq, jvp_bwd_operands
from quantizedattention_tpu_torch.ops.jvp_fwd import jvp_fwd_prep
from quantizedattention_tpu_torch.ops.jvp_tangent import _launch as tangent_launch
from quantizedattention_tpu_torch.ops.jvp_tangent import tangent_prep
from quantizedattention_tpu_torch.parallel import (
    decode_launch,
    kv4_cache,
    kv_cache,
    paged4_cache,
    paged_cache,
)

# the kernels that take head dim 128: every one
SLICE = set(KERNEL_HEAD_DIMS)
META = torch.device("meta")


@pytest.mark.parametrize("kernel", sorted(KERNEL_HEAD_DIMS))
def test_head_dim_128_only_in_the_slice(kernel):
    """Every kernel is in the slice: 64 and 128 pass, 32 is refused naming
    ROADMAP B-f3."""
    check_head_dim(kernel, 64)
    assert kernel in SLICE
    check_head_dim(kernel, 128)
    assert KERNEL_HEAD_DIMS[kernel] == (64, 128)
    with pytest.raises(ValueError, match="B-f3"):
        check_head_dim(kernel, 32)


@pytest.mark.parametrize("d", [0, 32, 80, 96, 112, 256])
@pytest.mark.parametrize("kernel", sorted(KERNEL_HEAD_DIMS))
def test_other_head_dims_refused_everywhere(kernel, d):
    with pytest.raises(ValueError, match="head_dim"):
        check_head_dim(kernel, d)


def test_every_kernel_has_an_entry():
    assert set(KERNEL_HEAD_DIMS) == {"B1 bf16", "B1 fp32", "B2/B3 fast", "B2/B3 exact", "B4",
                                     "B5", "B6", "B7/B8", "B9/B11/B12 fast",
                                     "B9/B11/B12 exact", "B10", "B13", "B14", "B15", "B16"}


def _qkv(d, h=4, h_kv=4, t=64):
    return [torch.empty((1, n, t, d), device=META) for n in (h, h_kv, h_kv)]


def _jvp_ops(d, fast):
    """B11/B12's operands on meta tensors (one head count)."""
    q, k, v = _qkv(d)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=META)
    return jvp_bwd_operands(q, k, v, q, k, v, o, o, lse, lse, o, o, fast=fast)


def _jvp_exact_slice(d):
    """Calls that reach the kernel path of the wrappers the last slice
    brought to 128: B2/B3 exact, B9, B11 and B12 exact, B10 in both modes
    and B10 exact's prep."""
    q, k, v = _qkv(d)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=META)
    return {
        "B2/B3 exact": lambda: flash_attention_bwd(q, k, v, o, lse, o, fast=False),
        "B9 exact": lambda: attention_jvp_fwd(q, k, v, q, k, v, fast=False),
        "B10 exact prep": lambda: tangent_prep(k, v, k, v),
        # the launches under attention_tangent_fwd's dispatcher op, which
        # meta tensors would send to its fake implementation
        "B10 fast": lambda: tangent_launch(q, k, v, o, lse, q, k, v, False, None, True),
        "B10 exact": lambda: tangent_launch(q, k, v, o, lse, q, k, v, False, None, False),
        "B11 exact": lambda: jvp_bwd_dkv(_jvp_ops(d, fast=False)),
        "B12 exact": lambda: jvp_bwd_dq(_jvp_ops(d, fast=False)),
    }


def _int8_residuals(b, h, h_kv, t, d):
    """B4's residuals at the JAX grain, on meta tensors."""
    from quantizedattention_tpu_torch.tune.config import int8_grain

    q_grain, kv_grain, q_pad, kv_pad = int8_grain(t, t, h // h_kv)
    return tuple((torch.empty((rows, pad, d), dtype=torch.int8, device=META),
                  torch.empty((rows, pad // grain), device=META))
                 for rows, pad, grain in ((b * h, q_pad, q_grain), (b * h_kv, kv_pad, kv_grain),
                                          (b * h_kv, kv_pad, kv_grain)))


def _int8_slice(d):
    """Calls that reach the kernel path of the int8 family's wrappers (B4,
    B5, B6, B7/B8 and B14), which take head dim 128 since B-f3's int8 slice."""
    q, k, v = _qkv(d, h_kv=2)
    dims = (1, 4, 64, 64, d)
    res = _int8_residuals(1, 4, 2, 64, d)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=META)
    ops = int8_bwd_operands(res, torch.empty((1, 2, 1, d), device=META), o, lse, o, dims)
    pool = paged_cache.init_paged_cache(2, 5, 2, 2, d, device=META)
    return {
        "B4": lambda: quantize_qkv(q, k, v),
        "B4 via sage_attention_int8": lambda: sage_attention_int8(q, k, v),
        "B5": lambda: int8_attention_fwd_from_quantized(res, dims),
        "B6": lambda: sage_attention_int8_inference(q, k, v),
        "B7": lambda: int8_bwd_dkv(ops),
        "B8": lambda: int8_bwd_dq(ops),
        "B14": lambda: paged_cache.paged_decode_attention(
            torch.empty((2, 4, d), device=META), pool),
    }


def _rcm_and_int4_slice(d):
    """Calls that reach the kernel path of the wrappers B-f3's rCM and int4
    slice brought to 128: B1 fp32 and its prep, B9 fast and its prep, B11
    and B12 fast, B15 and B16."""
    q, k, v = _qkv(d)
    pool = paged4_cache.init_paged4_cache(2, 5, 2, 2, d, device=META)
    return {
        "B1 fp32": lambda: flash_attention_fwd_fp32(q, k, v),
        "B1 fp32 prep": lambda: kv_split_tf32(k, v),
        "B9 fast": lambda: attention_jvp_fwd(q, k, v, q, k, v, fast=True),
        "B9 fast prep": lambda: jvp_fwd_prep(k, v, k, v),
        "B11 fast": lambda: jvp_bwd_dkv(_jvp_ops(d, fast=True)),
        "B12 fast": lambda: jvp_bwd_dq(_jvp_ops(d, fast=True)),
        "B15": lambda: kv4_cache.decode_attention_int4(
            torch.empty((2, 4, d), device=META), kv4_cache.init_kv4_cache(2, 2, 256, d, META)),
        "B16": lambda: paged4_cache.paged4_decode_attention(
            torch.empty((2, 4, d), device=META), pool),
    }


@pytest.mark.parametrize("name", sorted(_jvp_exact_slice(128)))
def test_jvp_exact_wrappers_take_128_then_want_cuda(name):
    """B2/B3 exact, B9, B11 and B12 exact, B10 in both modes and B10 exact's
    prep pass the head-dim check at 128 (and the launch geometry there) and
    then ask for CUDA tensors: no refusal and no fallback to the plain
    version."""
    with pytest.raises(ValueError, match="CUDA"):
        _jvp_exact_slice(128)[name]()


def _every_wrapper(d):
    return {**_jvp_exact_slice(d), **_int8_slice(d), **_rcm_and_int4_slice(d)}


@pytest.mark.parametrize("name", sorted(_every_wrapper(96)))
def test_wrappers_raise_at_other_head_dims(name):
    with pytest.raises(ValueError, match="head_dim"):
        _every_wrapper(96)[name]()


@pytest.mark.parametrize("name", sorted(_int8_slice(128)))
def test_int8_wrappers_take_128_then_want_cuda(name):
    """The int8 family's wrappers pass the head-dim check at 128 (and the
    launch geometry there) and then ask for CUDA tensors: no refusal and no
    fallback to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        _int8_slice(128)[name]()


@pytest.mark.parametrize("name", sorted(_rcm_and_int4_slice(128)))
def test_rcm_and_int4_wrappers_take_128_then_want_cuda(name):
    """B1 fp32, fast B9/B11/B12, B15 and B16 (and their preps) pass the
    head-dim check at 128 and then ask for CUDA tensors: no refusal and no
    fallback to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        _rcm_and_int4_slice(128)[name]()


@pytest.mark.parametrize("d", [128, 96])
def test_slice_wrappers_check_the_head_dim_first(d):
    """B1 bf16, fast B2/B3 and B13 pass the check at 128 and then want CUDA
    tensors; at 96 the check refuses first."""
    q, k, v = _qkv(d)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=META)
    cache = kv_cache.init_kv_cache(2, 2, 256, d, META)
    match = "CUDA" if d == 128 else "head_dim"
    for call in (lambda: flash_attention_fwd(q, k, v),
                 lambda: flash_attention_bwd(q, k, v, o, lse, o, fast=True),
                 lambda: kv_cache.decode_attention(torch.empty((2, 4, d), device=META), cache)):
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("entry,kernel", sorted(decode_launch.KERNEL_OF.items()))
def test_decode_launch_check(entry, kernel):
    """decode_launch's shared check lets 128 through for all four entries
    (B13-B16) and refuses other head dims."""
    decode_launch.check_kernel_rows(64, 8, 2, 2, entry)
    decode_launch.check_kernel_rows(128, 8, 2, 2, entry)
    assert KERNEL_HEAD_DIMS[kernel] == (64, 128)
    with pytest.raises(ValueError, match="head_dim"):
        decode_launch.check_kernel_rows(96, 8, 2, 2, entry)
