"""One launch path for the four decode kernels of csrc/cache_decode.cu: B13
(`qa_decode`, slotted int8), B14 (`qa_paged_decode`, paged int8), B15
(`qa_decode4`, slotted int4) and B16 (`qa_paged4_decode`, paged int4).

The wrappers in kv_cache.py, paged_cache.py, kv4_cache.py and
paged4_cache.py check their cache and call `launch` with the entry's name.
It takes z from `decode_tiling.grid` with the card's SM count (read once a
device, when the kernels' shared-memory attribute is set), allocates the
partials' scratch, and hands the entry one merge-counter buffer a (device,
stream), shared by all four kernels. Nothing is read back from the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quantizedattention_tpu_torch._build import load_kernel
from quantizedattention_tpu_torch.ops.common import check_head_dim, qk_scales
from quantizedattention_tpu_torch.parallel import decode_tiling
from quantizedattention_tpu_torch.utils.runtime import check_status, require_cuda

# entry -> (pointers, ints before qk_scale): q, the cache's tensors, o, lse,
# the two partials and the counters; q_f32, n, n_kv, group, spec, the
# entry's sizes, the head dim and z
_ARGS = {"qa_decode": (11, 8), "qa_paged_decode": (12, 10), "qa_decode4": (11, 8),
         "qa_paged4_decode": (12, 10)}
KERNEL_OF = {"qa_decode": "B13", "qa_paged_decode": "B14", "qa_decode4": "B15",
             "qa_paged4_decode": "B16"}


def check_kernel_rows(d: int, rows: int, n_kv: int, n: int, entry: str) -> None:
    """The decode kernels' limits: the entry's head dims (64 or 128), at
    most MAX_ROWS q rows (GQA group times spec) per kv head, grid dims within
    65535."""
    check_head_dim(KERNEL_OF[entry], d)
    if rows > decode_tiling.MAX_ROWS or n_kv > 65535 or n > 65535:
        raise ValueError(f"kernel takes group * spec <= {decode_tiling.MAX_ROWS} and grid dims "
                         f"<= 65535; got group * spec={rows}, n_kv={n_kv}, n={n}")


@functools.cache
def _entry(name: str):
    fn = getattr(load_kernel("cache_decode"), name)
    n_ptr, n_int = _ARGS[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _device_sms(dev: torch.device) -> int:
    """The card's SM count, after letting the kernels take their shared
    memory there (qa_decode_init, once a device)."""
    with torch.cuda.device(dev):
        fn = load_kernel("cache_decode").qa_decode_init
        fn.restype = ctypes.c_int
        check_status(fn(), "decode_init")
    return torch.cuda.get_device_properties(dev).multi_processor_count


_ARRIVED: dict[tuple[torch.device, int], torch.Tensor] = {}


def _arrived(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The merge's counters, one a (sequence, kv head): the last block of a
    pair to arrive merges its chunks. 0 between launches (the merging block
    resets its own). One buffer a (device, stream), for all four kernels:
    launches on one stream run one after another, so none shares its
    counters with a launch in flight; grown where a launch needs more."""
    buf = _ARRIVED.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _ARRIVED[dev, stream] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


def launch(entry: str, q, tensors, n_kv: int, capacity: int, sizes, sm_scale, return_lse,
           spec: int):
    """Launch `entry` of csrc/cache_decode.cu on q [n, n_kv * group * spec,
    d] (folded; f32 or bf16 as it comes, rounded to bf16 in the kernel,
    other types via f32): `tensors` are the cache's payloads, scales,
    (table) and lengths in the entry's order, `sizes` its ints after (n,
    n_kv, group, spec). The partials' scratch follows
    decode_tiling.scratch_shapes; the grid is sized from `capacity`, so
    nothing is read back from the card."""
    n, n_q, d = q.shape
    if n_q % (n_kv * spec) != 0:
        raise ValueError(f"{n_q} q rows not a multiple of {n_kv} kv heads x spec {spec}")
    group = n_q // (n_kv * spec)
    check_kernel_rows(d, n_q // n_kv, n_kv, n, entry)
    _, qk_scale = qk_scales(d, sm_scale)
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.float()  # the kernel rounds f32 to bf16, as .to(bfloat16) would
    q = q.contiguous()
    dev = require_cuda(q, *tensors)
    _, _, grid_z = decode_tiling.grid(n_kv, n, capacity, d, _device_sms(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    o = torch.empty((n, n_q, d), dtype=torch.float32, device=dev)
    lse = torch.empty((n, n_q), dtype=torch.float32, device=dev)
    acc_shape, ml_shape = decode_tiling.scratch_shapes(n, n_kv, n_q // n_kv, capacity, d)
    part_acc = torch.empty(acc_shape, dtype=torch.float32, device=dev)
    part_ml = torch.empty(ml_shape, dtype=torch.float32, device=dev)
    status = _entry(entry)(
        q.data_ptr(), *(t.data_ptr() for t in tensors), o.data_ptr(), lse.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), _arrived(dev, stream, n * n_kv).data_ptr(),
        int(q.dtype == torch.float32), n, n_kv, group, spec, *sizes, d, grid_z, qk_scale, stream,
    )
    check_status(status, entry)
    return (o, lse) if return_lse else o
