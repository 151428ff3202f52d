"""Continuous-batching scheduler: native C++ core with a pure-Python twin.

Counterpart of quantizedattention_tpu/serve/scheduler.py, over the same C++
source (native/scheduler.cpp, C ABI via ctypes), which this package builds
into its own build directory. The Python twin implements the identical
policy and is the differential-testing oracle for the native core.

Policy (both): FCFS; a waiting request is admitted the moment a slot is free
(prefill preferred over decode, keeping the decode batch full); a request
whose prompt_len + max_new_tokens exceeds the KV capacity is rejected at
submit.

The page allocator of the paged KV caches lives in the same C++ source
(`qa_pager_*`), again with a Python twin: a LIFO free list of pages in
which page 0 is reserved (page tables point unused entries at it) and an
allocation is all-or-nothing.
"""

from __future__ import annotations

import ctypes
from collections import deque
from dataclasses import dataclass

from quantizedattention_tpu_torch._build import load_native

IDLE, PREFILL, DECODE = 0, 1, 2


def _native_lib():
    lib = load_native("scheduler")
    lib.qa_sched_create.restype = ctypes.c_void_p
    lib.qa_sched_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.qa_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.qa_sched_submit.restype = ctypes.c_int32
    lib.qa_sched_submit.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3
    lib.qa_sched_next.restype = ctypes.c_int32
    lib.qa_sched_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.qa_sched_report_token.restype = ctypes.c_int32
    lib.qa_sched_report_token.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.qa_sched_requeue.restype = ctypes.c_int32
    lib.qa_sched_requeue.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("qa_sched_num_active", "qa_sched_num_waiting"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.qa_sched_num_completed.restype = ctypes.c_int64
    lib.qa_sched_num_completed.argtypes = [ctypes.c_void_p]
    lib.qa_sched_slot_request.restype = ctypes.c_int32
    lib.qa_sched_slot_request.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.qa_pager_create.restype = ctypes.c_void_p
    lib.qa_pager_create.argtypes = [ctypes.c_int32]
    lib.qa_pager_destroy.argtypes = [ctypes.c_void_p]
    lib.qa_pager_alloc.restype = ctypes.c_int32
    lib.qa_pager_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.qa_pager_free.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.qa_pager_num_free.restype = ctypes.c_int32
    lib.qa_pager_num_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeScheduler:
    """ctypes handle to the C++ scheduler."""

    def __init__(self, n_slots: int, max_len: int):
        self._lib = _native_lib()
        self._h = self._lib.qa_sched_create(n_slots, max_len)
        if not self._h:
            raise ValueError(f"bad scheduler args: n_slots={n_slots} max_len={max_len}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.qa_sched_destroy(self._h)
            self._h = None

    __del__ = close

    def submit(self, request_id: int, prompt_len: int, max_new_tokens: int) -> bool:
        return self._lib.qa_sched_submit(self._h, request_id, prompt_len, max_new_tokens) == 0

    def next_action(self) -> tuple[int, int, int]:
        """-> (action, request_id, slot); request_id/slot are -1 unless
        PREFILL. Only a PREFILL return mutates scheduler state, so a caller
        may probe and discard a DECODE/IDLE answer."""
        req = ctypes.c_int32(-1)
        slot = ctypes.c_int32(-1)
        act = self._lib.qa_sched_next(self._h, ctypes.byref(req), ctypes.byref(slot))
        return act, req.value, slot.value

    def report_token(self, slot: int, is_eos: bool) -> bool:
        """True if the request in `slot` just finished (slot freed)."""
        r = self._lib.qa_sched_report_token(self._h, slot, int(is_eos))
        if r < 0:
            raise ValueError(f"report_token on free/invalid slot {slot}")
        return bool(r)

    def requeue(self, slot: int) -> None:
        """Undo an admission: the request returns to the FRONT of the queue."""
        if self._lib.qa_sched_requeue(self._h, slot) < 0:
            raise ValueError(f"requeue on free/invalid slot {slot}")

    @property
    def num_active(self) -> int:
        return self._lib.qa_sched_num_active(self._h)

    @property
    def num_waiting(self) -> int:
        return self._lib.qa_sched_num_waiting(self._h)

    @property
    def num_completed(self) -> int:
        return self._lib.qa_sched_num_completed(self._h)

    def slot_request(self, slot: int) -> int:
        return self._lib.qa_sched_slot_request(self._h, slot)


@dataclass
class _Slot:
    request_id: int = -1
    generated: int = 0
    max_new_tokens: int = 0
    prompt_len: int = 0


class PyScheduler:
    """Pure-Python twin of native/scheduler.cpp (identical policy)."""

    def __init__(self, n_slots: int, max_len: int):
        if n_slots <= 0 or max_len <= 0:
            raise ValueError(f"bad scheduler args: n_slots={n_slots} max_len={max_len}")
        self.max_len = max_len
        self._slots = [_Slot() for _ in range(n_slots)]
        self._waiting: deque = deque()
        self.num_completed = 0

    def submit(self, request_id: int, prompt_len: int, max_new_tokens: int) -> bool:
        if prompt_len <= 0 or max_new_tokens <= 0 or prompt_len + max_new_tokens > self.max_len:
            return False
        self._waiting.append((request_id, prompt_len, max_new_tokens))
        return True

    def next_action(self) -> tuple[int, int, int]:
        if self._waiting:
            for i, s in enumerate(self._slots):
                if s.request_id < 0:
                    rid, plen, mnt = self._waiting.popleft()
                    self._slots[i] = _Slot(rid, 0, mnt, plen)
                    return PREFILL, rid, i
        if self.num_active > 0:
            return DECODE, -1, -1
        return IDLE, -1, -1

    def report_token(self, slot: int, is_eos: bool) -> bool:
        s = self._slots[slot]
        if s.request_id < 0:
            raise ValueError(f"report_token on free slot {slot}")
        s.generated += 1
        if is_eos or s.generated >= s.max_new_tokens:
            self._slots[slot] = _Slot()
            self.num_completed += 1
            return True
        return False

    def requeue(self, slot: int) -> None:
        s = self._slots[slot]
        if s.request_id < 0:
            raise ValueError(f"requeue on free slot {slot}")
        self._waiting.appendleft((s.request_id, s.prompt_len, s.max_new_tokens))
        self._slots[slot] = _Slot()

    @property
    def num_active(self) -> int:
        return sum(s.request_id >= 0 for s in self._slots)

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    def slot_request(self, slot: int) -> int:
        return self._slots[slot].request_id


class NativePager:
    """ctypes handle to the C++ page allocator of the paged KV caches."""

    def __init__(self, n_pages: int):
        self._lib = _native_lib()
        self._h = self._lib.qa_pager_create(n_pages)
        if not self._h:
            raise ValueError(f"bad pager args: n_pages={n_pages}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.qa_pager_destroy(self._h)
            self._h = None

    __del__ = close

    def alloc(self, n: int) -> list[int] | None:
        """n page ids, or None if fewer than n are free (all-or-nothing)."""
        if n <= 0:
            return None
        out = (ctypes.c_int32 * n)()
        if self._lib.qa_pager_alloc(self._h, n, out) != n:
            return None
        return list(out)

    def free(self, pages) -> None:
        """Return pages to the pool; page 0, ids out of range and pages
        already free are ignored."""
        arr = (ctypes.c_int32 * len(pages))(*pages)
        self._lib.qa_pager_free(self._h, len(pages), arr)

    @property
    def num_free(self) -> int:
        return self._lib.qa_pager_num_free(self._h)


class PyPager:
    """Pure-Python twin of the native page allocator (same LIFO policy)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"bad pager args: n_pages={n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved
        self._is_free = [False] + [True] * (n_pages - 1)

    def alloc(self, n: int) -> list[int] | None:
        if n <= 0 or n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._is_free[p] = False
        return pages

    def free(self, pages) -> None:
        # a double free would alias one page to two requests on the next alloc
        for p in pages:
            if 1 <= p < self.n_pages and not self._is_free[p]:
                self._free.append(p)
                self._is_free[p] = True

    @property
    def num_free(self) -> int:
        return len(self._free)


def make_pager(kind: str, n_pages: int):
    """"native" (the C++ allocator; raises if it cannot be built) or "python"."""
    if kind == "native":
        return NativePager(n_pages)
    if kind == "python":
        return PyPager(n_pages)
    raise ValueError(f"unknown pager {kind!r}")


def make_scheduler(kind: str, n_slots: int, max_len: int):
    """"native" (the C++ core; raises if it cannot be built) or "python"."""
    if kind == "native":
        return NativeScheduler(n_slots, max_len)
    if kind == "python":
        return PyScheduler(n_slots, max_len)
    raise ValueError(f"unknown scheduler {kind!r}")
