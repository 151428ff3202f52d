"""Automatic prefix caching for the paged KV cache (host-side policy).

Counterpart of quantizedattention_tpu/serve/prefix_store.py and
serve/_prefix_native.py. Requests whose prompts share a token prefix reuse
the quantized KV pages an earlier request already wrote; the engine
prefills only the tail, through the chunked prefill, which reads the cached
prefix through the slot's page table. The store is pure host policy: which
page ids go into a table row, and when a page may go back to the allocator.

  * A node is one FULL page of prompt tokens, keyed by (parent page id, the
    page's tokens): the chain of parents spells the whole prefix, so key
    equality is prefix equality, one probe a page.
  * Refcounts count the live table rows that use a page. Pages at refcount
    0 stay cached until pool pressure evicts them: leaves first (a child
    keys off its parent's id), least recently used first among leaves.
  * Only immutable pages enter: the first len(prompt) // page_size pages
    of a prefilled prompt. Decode writes at positions >= len(prompt), so a
    registered page is never written again.
  * Two admissions of the same prompt before either registers converge: a
    page whose content is already a node stays private to its slot, and
    its children chain under the canonical id.

`NativePrefixStore` binds native/prefix_store.cpp, which
quantizedattention_tpu_torch/_build.py compiles with g++ into
build/libprefix_store.so; `PyPrefixStore` implements the same policy and
is the differential-testing oracle. Unlike the JAX package's factory,
`make_prefix_store("native", ...)` builds the native store or raises: it
never falls back to the Python twin, as make_pager and make_scheduler do
not.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

from quantizedattention_tpu_torch._build import load_native


class _Node:
    __slots__ = ("page", "parent", "tokens", "ref", "children", "stamp")

    def __init__(self, page: int, parent: int, tokens: tuple):
        self.page = page
        self.parent = parent
        self.tokens = tokens
        self.ref = 0
        self.children = 0
        self.stamp = 0


class PyPrefixStore:
    """Pure-Python prefix store (the policy oracle of the native store).

    Tokens are sequences of ints; pages are allocator page ids. The store
    never talks to the pager: the engine moves pages between the two
    (evicted pages go back to the pager; registered pages leave it).
    """

    ROOT = -1

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"bad page_size {page_size}")
        self.page_size = page_size
        self._by_key: dict[tuple, _Node] = {}   # (parent, tokens) -> node
        self._by_page: dict[int, _Node] = {}    # page id -> node
        self._clock = 0
        self.hits = 0          # pages served by lookup()
        self.misses = 0        # full pages lookup() could not serve

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _full_pages(self, tokens: Sequence[int]):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(tokens[i * ps:(i + 1) * ps])

    def lookup(self, tokens: Sequence[int], max_pages: int | None = None) -> list[int]:
        """The longest chain of cached full pages matching `tokens`' prefix,
        at most `max_pages`, in prefix order. Takes no reference (acquire()
        once the admission is certain); bumps the chain's LRU stamps."""
        out: list[int] = []
        parent = self.ROOT
        for tup in self._full_pages(tokens):
            if max_pages is not None and len(out) >= max_pages:
                break
            node = self._by_key.get((parent, tup))
            if node is None:
                self.misses += 1
                break
            node.stamp = self._tick()
            out.append(node.page)
            parent = node.page
        self.hits += len(out)
        return out

    def acquire(self, pages: Sequence[int]) -> None:
        """One reference per page. A page that is not a store node raises
        ValueError, with the pages before it referenced, as the native
        store does."""
        for p in pages:
            node = self._by_page.get(p)
            if node is None:
                raise ValueError("acquire on non-store page")
            node.ref += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; the page stays cached at refcount 0
        until evicted. Pages not in the store, or at refcount 0, are
        ignored."""
        for p in pages:
            node = self._by_page.get(p)
            if node is not None and node.ref > 0:
                node.ref -= 1
                node.stamp = self._tick()

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> list[int]:
        """Offer a prefilled prompt's full pages (tokens: the whole prompt;
        pages: the slot's table row in prefix order, of which the first
        len(tokens) // page_size are considered). Returns the pages the
        store now owns, each with one reference held by the caller (an
        admission hit keeps its admission reference); the others stayed
        private (duplicates of a cached chain) and are the caller's to
        free."""
        owned: list[int] = []
        parent = self.ROOT
        for i, tup in enumerate(self._full_pages(tokens)):
            if i >= len(pages):
                break
            page = pages[i]
            node = self._by_key.get((parent, tup))
            if node is not None:
                if node.page == page:
                    owned.append(page)  # the caller's own admission hit
                parent = node.page
                continue
            node = _Node(page, parent, tup)
            node.ref = 1  # the registering owner
            node.stamp = self._tick()
            self._by_key[(parent, tup)] = node
            self._by_page[page] = node
            if parent != self.ROOT and parent in self._by_page:
                self._by_page[parent].children += 1
            owned.append(page)
            parent = page
        return owned

    def evict(self, n: int) -> list[int]:
        """Remove up to `n` refcount-0 leaf pages, least recently used
        first, and return them (the engine hands them back to the pager).
        Evicting a leaf may make its parent a leaf."""
        out: list[int] = []
        while len(out) < n:
            best: _Node | None = None
            for node in self._by_page.values():
                if node.ref == 0 and node.children == 0 and (
                        best is None or node.stamp < best.stamp):
                    best = node
            if best is None:
                break
            del self._by_key[(best.parent, best.tokens)]
            del self._by_page[best.page]
            if best.parent != self.ROOT and best.parent in self._by_page:
                self._by_page[best.parent].children -= 1
            out.append(best.page)
        return out

    @property
    def n_nodes(self) -> int:
        return len(self._by_page)

    @property
    def n_evictable(self) -> int:
        return sum(1 for n in self._by_page.values() if n.ref == 0 and n.children == 0)

    def refcount(self, page: int) -> int:
        node = self._by_page.get(page)
        return -1 if node is None else node.ref


def _native_lib():
    """native/prefix_store.cpp built into build/ and loaded, with the C
    entries' signatures (JAX serve/_prefix_native.py's)."""
    lib = load_native("prefix_store")
    i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    ip = ctypes.POINTER(i32)
    for name, restype, argtypes in (
            ("qa_pstore_create", p, [i32]),
            ("qa_pstore_destroy", None, [p]),
            ("qa_pstore_lookup", i32, [p, ip, i32, i32, ip]),
            ("qa_pstore_acquire", i32, [p, i32, ip]),
            ("qa_pstore_release", None, [p, i32, ip]),
            ("qa_pstore_register", i32, [p, ip, i32, i32, ip, ip]),
            ("qa_pstore_evict", i32, [p, i32, ip]),
            ("qa_pstore_num_nodes", i32, [p]),
            ("qa_pstore_num_evictable", i32, [p]),
            ("qa_pstore_hits", i64, [p]),
            ("qa_pstore_misses", i64, [p]),
            ("qa_pstore_refcount", i32, [p, i32])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int32 * max(len(values), 1))(*[int(v) for v in values])


class NativePrefixStore:
    """ctypes handle to the C++ prefix store (native/prefix_store.cpp)."""

    def __init__(self, page_size: int):
        self._lib = _native_lib()
        self._h = self._lib.qa_pstore_create(page_size)
        if not self._h:
            raise ValueError(f"bad page_size {page_size}")
        self.page_size = page_size

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.qa_pstore_destroy(self._h)
            self._h = None

    __del__ = close

    def lookup(self, tokens, max_pages: int | None = None) -> list[int]:
        cap = len(tokens) // self.page_size if max_pages is None else max_pages
        out = (ctypes.c_int32 * max(cap, 1))()
        n = self._lib.qa_pstore_lookup(self._h, _ints(tokens), len(tokens), cap, out)
        return list(out[:n])

    def acquire(self, pages) -> None:
        if self._lib.qa_pstore_acquire(self._h, len(pages), _ints(pages)) < 0:
            raise ValueError("acquire on non-store page")

    def release(self, pages) -> None:
        self._lib.qa_pstore_release(self._h, len(pages), _ints(pages))

    def register(self, tokens, pages) -> list[int]:
        out = (ctypes.c_int32 * max(len(pages), 1))()
        n = self._lib.qa_pstore_register(self._h, _ints(tokens), len(tokens), len(pages),
                                         _ints(pages), out)
        return list(out[:n])

    def evict(self, n: int) -> list[int]:
        out = (ctypes.c_int32 * max(n, 1))()
        got = self._lib.qa_pstore_evict(self._h, n, out)
        return list(out[:got])

    @property
    def n_nodes(self) -> int:
        return self._lib.qa_pstore_num_nodes(self._h)

    @property
    def n_evictable(self) -> int:
        return self._lib.qa_pstore_num_evictable(self._h)

    @property
    def hits(self) -> int:
        return self._lib.qa_pstore_hits(self._h)

    @property
    def misses(self) -> int:
        return self._lib.qa_pstore_misses(self._h)

    def refcount(self, page: int) -> int:
        return self._lib.qa_pstore_refcount(self._h, page)


def make_prefix_store(kind: str, page_size: int):
    """"native" (the C++ store; raises if it cannot be built) or "python"."""
    if kind == "native":
        return NativePrefixStore(page_size)
    if kind == "python":
        return PyPrefixStore(page_size)
    raise ValueError(f"unknown prefix store {kind!r}")
