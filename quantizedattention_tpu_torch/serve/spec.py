"""Prompt-lookup drafting for speculative decoding (host-side policy).

Counterpart of quantizedattention_tpu/serve/spec.py. The engine's
speculative mode (`ServingEngine(spec_decode=k)`) proposes the next k tokens
of each slot by matching the sequence's own trailing n-gram against its
earlier occurrences in prompt + generation ("prompt lookup decoding"). No
draft model and no device work: the verify step
(models/transformer.py:verify_step_batched) checks every draft token
against the model's own target, so any draft is safe; a wrong one costs
nothing beyond the pass that runs anyway.

`propose_lookup` is the policy in Python. `propose_lookup_native` is the
same policy in C++ (`native/ngram.cpp`, shared with the JAX package),
compiled with g++ into `build/libngram.so` by `_build.load_native` and held
equal to the Python one by the tests. `make_lookup("native")` builds it or
raises: there is no silent fallback.
"""

from __future__ import annotations

import ctypes
import functools

from quantizedattention_tpu_torch._build import load_native


def propose_lookup(history: list[int], k: int, max_ngram: int = 3,
                   min_ngram: int = 1) -> list[int]:
    """Up to k continuation tokens for `history` by n-gram lookup.

    Tries the longest trailing n-gram first (n = max_ngram .. min_ngram);
    for the first n with an earlier occurrence (the most recent one wins,
    overlaps allowed, so periodic text extends itself), returns the tokens
    that followed it, truncated to k. Returns [] when nothing matches; the
    caller pads, and unverified padding is simply rejected.
    """
    min_ngram = max(1, min_ngram)  # clamped the same way in native/ngram.cpp
    if k < 1 or len(history) < min_ngram + 1:
        return []
    for n in range(min(max_ngram, len(history) - 1), min_ngram - 1, -1):
        suffix = history[-n:]
        for i in range(len(history) - n - 1, -1, -1):  # right to left: recency wins
            if history[i:i + n] == suffix:
                out = history[i + n:i + n + k]
                if out:
                    return out
    return []


@functools.cache
def _native():
    fn = load_native("ngram").qa_propose_lookup
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    return fn


def propose_lookup_native(history: list[int], k: int, max_ngram: int = 3,
                          min_ngram: int = 1) -> list[int]:
    """`propose_lookup` in C++ (native/ngram.cpp through ctypes): the same
    policy, without the interpreter's cost per comparison on the serving
    host's critical path. Raises if g++ or the library is missing."""
    fn = _native()
    n = len(history)
    hist = (ctypes.c_int32 * max(n, 1))(*history)
    out = (ctypes.c_int32 * max(k, 1))()
    count = fn(hist, n, k, max_ngram, min_ngram, out)
    return list(out[:count])


def make_lookup(kind: str = "native"):
    """The proposer the engine drafts with: "native" (built now; raises if it
    cannot be) or "python"."""
    if kind == "native":
        _native()
        return propose_lookup_native
    if kind == "python":
        return propose_lookup
    raise ValueError(f"unknown proposer {kind!r}: 'native' or 'python'")
