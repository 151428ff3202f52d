"""Continuous-batching serving engine on a quantized KV cache (one device).

Counterpart of quantizedattention_tpu/serve/engine.py's single-device path:
  * requests join an FCFS queue (`submit`) owned by the scheduler
    (serve/scheduler.py);
  * each `step` runs ONE action: admit waiting requests into free cache
    slots with a fused prefill (all requests waiting at that moment go into
    one batched prefill), or run one bank of `decode_horizon` decode steps
    across every slot;
  * slots finish independently (EOS or budget) and free immediately.

Dispatch before fetch: every token-producing call (a prefill's first
tokens, a decode bank) is enqueued on the device and fetched to the host
only AFTER the next action has been enqueued. CUDA launches are
asynchronous, so the host's bookkeeping overlaps the device's work; only
the `.cpu()` of a token batch waits. Bookkeeping therefore lags one action:
a slot that finished inside a bank keeps decoding into its own cache until
the host sees it, and the surplus tokens are discarded.

Cache kinds (`cache`, `kv_quant`), as in the JAX engine: the slotted int8
cache (one max_seq row per slot; decode B13), the slotted int4 cache
(`kv_quant="int4"`; B15), the paged int8 pool (`cache="paged"`; B14) and
the paged int4 pool (both; B16). A paged request gets the pages of its whole
prompt + budget at admission, all or nothing, from the host's allocator;
when the pool is short it goes back to the front of the queue and the
engine decodes meanwhile; its pages are freed when the host records its
last token. A bank still in flight for a finished request runs before the
next prefill on the same stream, and after the host records the finish
the slot is inactive, so its appends never reach the recycled pages.

Prefill runs the config's attention: B1, or with attention="int8" the int8
SageAttention forward (B4 quantizes, B5 attends), as the JAX engine's
prefill does. `weight_quant="int8"` / `"int4"`
quantizes the params after the `param_dtype` cast (`quantize_lm_weights`,
scales kept f32), so every projection and the unembedding run B17 / B18.

Speculative decoding (`spec_decode=k`, the JAX engine's): each decode
action drafts k tokens per slot on the host by n-gram lookup over the
slot's own history (serve/spec.py), runs ONE verify pass over the last
token and the drafts (models/transformer.py:verify_step_batched; the
staircase of the cache kind's decode kernel) and records the 1..k+1 tokens
each slot emits. Greedy spec decode is token-exact with the plain engine;
sampled spec decode draws from the same distribution. Drafting needs each
slot's current history, so this mode fetches after every dispatch. A
verify appends k + 1 tokens before rolling the rejected ones back, so a
slot near max_seq writes past it: slotted caches get slack rows (a 128-row
block for int8, a 256-token pack block for int4) and a paged row's table
gets ceil((max_seq + k) / page_size) entries, the ones past its pages
pointing at the garbage page 0, where the overshoot lands and still
advances the row's length, so the staircase stays aligned.

Chunked prefill (`prefill_chunk=c`, a positive multiple of 128, and of
page_size when paged): a prompt longer than c is admitted chunk by chunk
(models/transformer.py:prefill_chunk), and while it is in flight `step()`
alternates one decode bank of the running slots with one chunk, so a long
prompt does not stall the decodes. The row's length grows chunk by chunk;
the slot joins the decode banks after its last chunk.

Prefix caching (`prefix_cache=True`; needs cache="paged" and
prefill_chunk): the full pages of every prefilled prompt are offered to a
prefix store (serve/prefix_store.py); a request whose prompt starts with a
cached chain takes those pages into its table row (the hit rounded down to
the chunk grid and kept below the prompt's end, so at least one token is
computed) and prefills only the tail, through the chunked path, which
reads the cached prefix through the table. Shared pages are released, not
freed, when a request finishes; under pool pressure the store evicts
unreferenced ones back to the pager.

Sampling: `top_k` / `top_p` filter the temperature-scaled logits
(models/transformer.py:Sampling) on every path: prefill, decode banks,
chunks and the verify pass's Gumbel draws. `adaptive_horizon=cap` sizes
each decode bank from the slots' remaining budgets, a power of two up to
cap (`_pick_horizon`); tokens equal the fixed-horizon engine's.

The JAX engine's mesh serving is not ported yet; asking for it raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from quantizedattention_tpu_torch.models.transformer import (
    Sampling,
    TransformerConfig,
    decode_horizon_batched,
    prefill_chunk as prefill_chunk_step,
    prefill_slot,
    prefill_slots,
    sampling_temperature,
    verify_step_batched,
)
from quantizedattention_tpu_torch.parallel.kv4_cache import init_kv4_cache
from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache
from quantizedattention_tpu_torch.parallel.paged4_cache import init_paged4_cache
from quantizedattention_tpu_torch.parallel.paged_cache import assign_pages, init_paged_cache
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_lm_weights,
)
from quantizedattention_tpu_torch.serve.prefix_store import make_prefix_store
from quantizedattention_tpu_torch.serve.scheduler import (
    DECODE,
    IDLE,
    PREFILL,
    make_pager,
    make_scheduler,
)
from quantizedattention_tpu_torch.serve.spec import make_lookup

# option -> the value that leaves it off; any other value is not ported yet
_UNPORTED = {"mesh": None}


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: list[int]
    tokens: list[int]          # generated tokens (includes EOS if hit)
    finish_reason: str         # "eos" | "length"
    ttft_s: float | None = None      # submit -> first token recorded
    duration_s: float | None = None  # submit -> completion


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _move(params, device, dtype=None):
    """The params tree on `device`, floating tensors cast to `dtype` if given;
    quantized weights move with their int8 payloads and f32 scales as they
    are."""
    if isinstance(params, dict):
        return {k: _move(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_move(v, device, dtype) for v in params]
    if isinstance(params, (QuantizedWeight, QuantizedWeight4)):
        return params.to(device)
    if dtype is not None and params.is_floating_point():
        return params.to(device=device, dtype=dtype)
    return params.to(device)


class ServingEngine:
    """Continuous-batching engine over `n_slots` KV-cache rows on `device`.

    params/cfg: a models.transformer LM (moved to `device`; `param_dtype`,
    e.g. torch.bfloat16, casts the floating weights first). weight_quant:
    None, "int8" or "int4" quantizes the (cast) weights for serving; params
    that already hold quantized weights are served as they are. eos_id:
    optional stop token. scheduler: "native" (the C++ core and page
    allocator) or "python" (their twins). decode_horizon: decode steps per
    dispatched bank (one token fetch per bank); adaptive_horizon: a cap
    that sizes each bank from the remaining budgets instead (same tokens,
    fewer dispatches). temperature > 0 samples with a torch.Generator
    seeded by `seed`, top_k > 0 / top_p < 1 filtered. prefill_chunk: admit
    prompts longer than it chunk by chunk, interleaved with decode banks;
    prefix_cache: share cached prompt pages (paged, chunked). cache:
    "slotted" or "paged";
    page_size (any positive even number) and n_pages (default
    1 + n_slots * ceil(max_seq / page_size), page 0 reserved) size the paged
    pool. kv_quant: None (int8) or "int4"; the slotted int4 cache needs
    max_seq a multiple of 256. spec_decode: k >= 1 drafts per slot and
    decode action (speculative decoding; needs decode_horizon 1), drafted
    by n-gram lookup up to spec_ngram tokens long with the `scheduler`
    kind's proposer ("native" builds native/ngram.cpp or raises).
    """

    def __init__(self, params, cfg: TransformerConfig, device, n_slots: int = 4,
                 eos_id: int | None = None, scheduler: str = "native",
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, param_dtype=None,
                 weight_quant: str | None = None, decode_horizon: int = 1,
                 prefill_chunk: int | None = None, adaptive_horizon: int | None = None,
                 prefix_cache: bool = False,
                 cache: str = "slotted", page_size: int = 128, n_pages: int | None = None,
                 kv_quant: str | None = None, spec_decode: int | None = None,
                 spec_ngram: int = 3, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported to the PyTorch package yet")
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError("weight_quant must be 'int8', 'int4', or None")
        if kv_quant not in (None, "int4"):
            raise ValueError("kv_quant must be 'int4' or None")
        if cache not in ("slotted", "paged"):
            raise ValueError(f"unknown cache kind {cache!r}")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if adaptive_horizon is not None and adaptive_horizon < 1:
            raise ValueError("adaptive_horizon must be >= 1")
        spec = Sampling(float(temperature), top_k, top_p)  # validates all three
        if spec_decode is not None:
            if spec_decode < 1:
                raise ValueError("spec_decode must be >= 1")
            if decode_horizon != 1 or adaptive_horizon is not None:
                raise ValueError("spec_decode replaces decode_horizon/adaptive_horizon")
        if prefill_chunk is not None:
            if prefill_chunk % 128 != 0 or prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be a positive multiple of 128")
            if cache == "paged" and prefill_chunk % page_size != 0:
                raise ValueError("prefill_chunk must be a multiple of page_size")
        if prefix_cache:
            if cache != "paged":
                raise ValueError("prefix_cache=True requires cache='paged'")
            if prefill_chunk is None:
                raise ValueError("prefix_cache=True requires prefill_chunk (the tail-only "
                                 "prefill rides the chunked-prefill path)")
        self.device = torch.device(device)
        self.params = _move(params, self.device, param_dtype)
        if weight_quant is not None:
            # after the param_dtype cast, so the scales stay f32
            self.params = quantize_lm_weights(self.params, bits=4 if weight_quant == "int4" else 8)
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.decode_horizon = decode_horizon
        self.adaptive_horizon = adaptive_horizon
        self.prefill_chunk = prefill_chunk
        # a float stays a float: the temperature-only paths are unchanged
        self.temperature = spec if (top_k or top_p < 1.0) else float(temperature)
        self.spec_decode = spec_decode
        self.spec_ngram = spec_ngram
        self._propose = make_lookup(scheduler) if spec_decode is not None else None
        self._seed = seed
        self._spec_dispatches = 0
        self._spec_stats = {"steps": 0, "emitted": 0, "accepted": 0}
        # a verify appends k + 1 tokens before its rollback: up to k past a
        # row's last token, whose position is below max_seq
        k = spec_decode or 0
        self._generator = None
        if sampling_temperature(self.temperature) > 0.0:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sched = make_scheduler(scheduler, n_slots, cfg.max_seq)
        self.cache_kind = cache
        self._pager = None
        self._prefix_store = None
        # page bookkeeping per slot: its private pages (returned to the pager
        # when it finishes), the store's pages it holds references on
        # (released), its whole table row in prefix order, and the tokens the
        # shared prefix covers (where its chunked prefill starts)
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_shared: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_row: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_prefix = [0] * n_slots
        if cache == "paged":
            # one allocator; the same page ids index every layer's pool, and
            # each layer's cache keeps its own copy of the table and lengths
            self._page_size = page_size
            if n_pages is None:  # page 0 reserved
                n_pages = 1 + n_slots * -(-cfg.max_seq // page_size)
            # the table entries past the row's pages hold page 0, so a
            # verify's overshoot lands there and advances the length like any
            # other token
            self._table_pages = -(-(cfg.max_seq + k) // page_size)
            self._pager = make_pager(scheduler, n_pages)
            if prefix_cache:
                self._prefix_store = make_prefix_store(scheduler, page_size)
            init = init_paged4_cache if kv_quant == "int4" else init_paged_cache
            self.caches = [init(cfg.n_kv_heads, n_pages, n_slots, self._table_pages,
                                cfg.head_dim, page_size, self.device)
                           for _ in range(cfg.n_layers)]
        else:
            # slack rows for a verify's overshoot: append_kv would shift a
            # write that overflows max_len left, onto live entries
            grain = 256 if kv_quant == "int4" else 128
            max_len = cfg.max_seq + (-(-(k + 1) // grain) * grain if k else 0)
            init = init_kv4_cache if kv_quant == "int4" else init_kv_cache
            self.caches = [init(n_slots, cfg.n_kv_heads, max_len, cfg.head_dim, self.device)
                           for _ in range(cfg.n_layers)]
        self.last_tok = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        self.active = torch.zeros((n_slots,), dtype=torch.bool, device=self.device)

        # the chunked prefill in flight, and whether a decode bank goes next
        self._pending: dict | None = None
        self._pending_decode_turn = False
        # (kind, device tokens, owners) in dispatch order; fetched lazily
        self._pending_fetches: list[tuple] = []
        self._ledger = {"dispatches": 0, "fetches": 0, "dispatch_s": 0.0, "fetch_s": 0.0}
        self._next_id = 0
        self._submitted_at: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._tokens_generated = 0
        self._last_run_tokens_per_s = None
        self._budgets: dict[int, int] = {}
        self._prompts: dict[int, list[int]] = {}
        self._outputs: dict[int, list[int]] = {}
        self._finished: dict[int, GenerationResult] = {}
        self._callbacks: dict[int, object] = {}
        self._slot_req = [-1] * n_slots

    # -- client side --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32, on_token=None) -> int:
        """Queue a prompt (sequence of int token ids); returns a request id.

        on_token: optional streaming callback `fn(request_id, token, done)`,
        invoked as tokens are recorded host-side. Raises ValueError if
        prompt + budget can never fit the KV capacity (or the page pool).
        """
        prompt = [int(t) for t in prompt]
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt token out of range [0, {self.cfg.vocab_size})")
        rid = self._next_id
        self._next_id += 1
        if self._pager is not None:
            n_need = -(-(len(prompt) + max_new_tokens) // self._page_size)
            usable = self.caches[0].n_pages - 1
            if n_need > usable:
                raise ValueError(f"request rejected: needs {n_need} pages > pool of {usable}")
        if not self.sched.submit(rid, len(prompt), max_new_tokens):
            raise ValueError(
                f"request rejected: prompt {len(prompt)} + budget {max_new_tokens} "
                f"> KV capacity {self.cfg.max_seq}")
        self._prompts[rid] = prompt
        self._outputs[rid] = []
        self._budgets[rid] = max_new_tokens
        self._submitted_at[rid] = time.perf_counter()
        if on_token is not None:
            self._callbacks[rid] = on_token
        return rid

    def run(self) -> dict[int, GenerationResult]:
        """Drive steps until queue and slots drain; returns all results."""
        t0 = time.perf_counter()
        n0 = self._tokens_generated
        self._ledger = {"dispatches": 0, "fetches": 0, "dispatch_s": 0.0, "fetch_s": 0.0}
        self._spec_stats = {"steps": 0, "emitted": 0, "accepted": 0}
        while self.step():
            pass
        dt = time.perf_counter() - t0
        self._ledger["wall_s"] = dt
        self._ledger["tokens"] = self._tokens_generated - n0
        self._ledger["other_host_s"] = max(
            0.0, dt - self._ledger["dispatch_s"] - self._ledger["fetch_s"])
        if dt > 0:
            self._last_run_tokens_per_s = (self._tokens_generated - n0) / dt
        out, self._finished = self._finished, {}
        return out

    def ledger(self) -> dict:
        """The last run()'s host-time decomposition: `dispatches`/`fetches`
        counts, `dispatch_s` (host time enqueueing device work), `fetch_s`
        (time blocked on token fetches, which includes waiting for the
        device), `other_host_s` (scheduling + Python), `wall_s`, `tokens`."""
        return dict(self._ledger)

    def stats(self) -> dict:
        """Serving observability: queue/slot occupancy, token and page counts."""
        s = {
            "active": self.sched.num_active,
            "waiting": self.sched.num_waiting,
            "completed": self.sched.num_completed,
            "tokens_generated": self._tokens_generated,
            "last_run_tokens_per_s": self._last_run_tokens_per_s,
            "cache": self.cache_kind,
            "decode_horizon": self.decode_horizon,
        }
        if self._pager is not None:
            s["pages_free"] = self._pager.num_free
        if self._prefix_store is not None:
            s["prefix_nodes"] = self._prefix_store.n_nodes
            s["prefix_hit_pages"] = self._prefix_store.hits
            s["prefix_miss_pages"] = self._prefix_store.misses
        if self.spec_decode is not None:
            sp = dict(self._spec_stats)
            # each slot-step emits exactly one token that is not a draft, so
            # slot-steps = emitted - accepted: tokens banked per model pass
            sp["tokens_per_pass"] = sp["emitted"] / max(1, sp["emitted"] - sp["accepted"])
            s["spec"] = sp
        s["ledger"] = dict(self._ledger)
        return s

    # -- engine side ---------------------------------------------------------

    def step(self) -> bool:
        """One engine action. False if idle.

        With a chunked prefill in flight, actions alternate between one
        decode bank of the running slots and one prompt chunk. Otherwise one
        scheduler action: a prefill or a decode bank."""
        if self._pending is not None:
            has_decodes = any(r >= 0 for r in self._slot_req)
            if self._pending_decode_turn and has_decodes:
                self._pending_decode_turn = False
                self._do_decode()
            else:
                self._pending_decode_turn = True
                self._do_prefill_chunk()
            return True
        action, rid, slot = self.sched.next_action()
        if action == IDLE:
            # drain pipelined fetches before declaring idle (their tokens
            # may finish requests or free slots)
            return self._flush_pending()
        if action == PREFILL:
            self._do_prefill(rid, slot)
        elif action == DECODE:
            self._do_decode()
        return True

    def _record(self, slot: int, token: int):
        rid = self._slot_req[slot]
        self._outputs[rid].append(token)
        self._tokens_generated += 1
        now = time.perf_counter()
        if rid not in self._ttft:
            self._ttft[rid] = now - self._submitted_at[rid]
        is_eos = self.eos_id is not None and token == self.eos_id
        finished = self.sched.report_token(slot, is_eos)
        cb = self._callbacks.get(rid)
        if cb is not None:
            cb(rid, token, finished)
            if finished:
                self._callbacks.pop(rid, None)
        if finished:
            self._finished[rid] = GenerationResult(
                request_id=rid,
                prompt=self._prompts.pop(rid),
                tokens=self._outputs.pop(rid),
                finish_reason="eos" if is_eos else "length",
                ttft_s=self._ttft.pop(rid),
                duration_s=now - self._submitted_at.pop(rid),
            )
            self._budgets.pop(rid, None)
            self._slot_req[slot] = -1
            self.active[slot] = False
            if self._slot_pages[slot]:
                self._pager.free(self._slot_pages[slot])
            if self._slot_shared[slot]:
                # shared pages stay cached in the store (evicted under pressure)
                self._prefix_store.release(self._slot_shared[slot])
            self._slot_pages[slot], self._slot_shared[slot], self._slot_row[slot] = [], [], []

    def _pad_len(self, prompt) -> int:
        if self._pager is not None:  # paged prompts fill whole pages
            return -(-max(len(prompt), 1) // self._page_size) * self._page_size
        # power-of-two bucket, clamped at the 128-rounded cache capacity
        return min(_bucket(len(prompt)), -(-self.cfg.max_seq // 128) * 128)

    def _admit_pages(self, rid: int, slot: int) -> bool:
        """Paged admission: the pages of the whole prompt + budget, all or
        nothing. With the prefix cache, the longest cached chain of the
        prompt's full pages comes first, rounded down to the chunk grid and
        kept below the prompt's end (its last token's logits must be
        computed), and referenced before anything is evicted; when the pool
        is short, the store's unreferenced pages are evicted to the pager.
        False, with the hit released and the request requeued at the
        queue's front, when the pool is still short: completions free
        pages, and submit() guarantees the request fits an empty pool."""
        ps = self._page_size
        prompt = self._prompts[rid]
        n_need = -(-(len(prompt) + self._budgets[rid]) // ps)
        store, hit = self._prefix_store, []
        if store is not None:
            chunk_pages = self.prefill_chunk // ps
            hit = store.lookup(prompt, max_pages=(len(prompt) - 1) // ps)
            hit = hit[: len(hit) // chunk_pages * chunk_pages]
            if hit:
                store.acquire(hit)
        n_fresh = n_need - len(hit)
        pages = self._pager.alloc(n_fresh)
        if pages is None and store is not None:
            evicted = store.evict(n_fresh - self._pager.num_free)
            if evicted:
                self._pager.free(evicted)
                pages = self._pager.alloc(n_fresh)
        if pages is None:
            if hit:
                store.release(hit)
            self.sched.requeue(slot)
            return False
        row = hit + pages
        self._slot_pages[slot], self._slot_shared[slot], self._slot_row[slot] = pages, hit, row
        self._slot_prefix[slot] = len(hit) * ps
        table_row = self._to_device(row + [0] * (self._table_pages - len(row)), torch.int32)
        for c in self.caches:
            assign_pages(c, slot, table_row)
        return True

    def _register_prefix(self, slot: int, rid: int):
        """Offer the prefilled prompt's full pages to the prefix store; the
        pages it adopts move from the slot's private list to its shared
        list (released, not freed, when the slot finishes)."""
        if self._prefix_store is None:
            return
        prompt = self._prompts[rid]
        n_full = len(prompt) // self._page_size
        if n_full == 0:
            return
        owned = self._prefix_store.register(prompt, self._slot_row[slot][:n_full])
        owned_set = set(owned)
        self._slot_shared[slot] = owned
        self._slot_pages[slot] = [p for p in self._slot_row[slot] if p not in owned_set]

    def _needs_chunking(self, prompt) -> bool:
        return self.prefill_chunk is not None and len(prompt) > self.prefill_chunk

    def _do_prefill(self, rid: int, slot: int):
        prompt = self._prompts[rid]
        if self._pager is not None and not self._admit_pages(rid, slot):
            if self.sched.num_active > 0:
                self._do_decode()
            return
        if self._needs_chunking(prompt) or self._slot_prefix[slot] > 0:
            # a prefix hit always takes the chunked path: it is the
            # tail-only prefill
            self._start_chunked_prefill(rid, slot, prompt)
            return
        # batched admission: while requests wait and slots are free the
        # scheduler keeps answering PREFILL; drain them into ONE prefill,
        # cut before a request that takes the chunked path
        batch = [(rid, slot, prompt)]
        while len(batch) < self.n_slots and self.sched.num_waiting > 0:
            action, rid2, slot2 = self.sched.next_action()
            if action != PREFILL:
                break
            prompt2 = self._prompts[rid2]
            if self._pager is not None and not self._admit_pages(rid2, slot2):
                break  # rid2 requeued; serve what we have
            if self._needs_chunking(prompt2) or self._slot_prefix[slot2] > 0:
                self._dispatch_prefills(batch)
                self._start_chunked_prefill(rid2, slot2, prompt2)
                return
            batch.append((rid2, slot2, prompt2))
        self._dispatch_prefills(batch)

    def _start_chunked_prefill(self, rid: int, slot: int, prompt):
        """Begin a chunked admission: the slot is reserved now, and step()
        interleaves decode banks between its chunks. With a prefix hit the
        first chunk starts at the cached boundary (a chunk-grid multiple)
        and reads the shared pages through the slot's table."""
        self._pending = {"rid": rid, "slot": slot, "prompt": prompt,
                         "next": self._slot_prefix[slot] // self.prefill_chunk}
        self._pending_decode_turn = True
        self._do_prefill_chunk()

    def _do_prefill_chunk(self):
        """Advance the chunked prefill in flight by one chunk; after the last
        one the slot joins the decode banks and its first token is fetched
        with the next flush."""
        p = self._pending
        prompt, slot, rid, i = p["prompt"], p["slot"], p["rid"], p["next"]
        chunk = self.prefill_chunk
        piece = prompt[i * chunk:(i + 1) * chunk]
        last = i == -(-len(prompt) // chunk) - 1
        t0 = time.perf_counter()
        tok, self.caches = prefill_chunk_step(
            self.params, self.caches, self._to_device(piece + [0] * (chunk - len(piece))),
            i * chunk, len(prompt), slot, self.cfg, last, self.temperature, self._generator)
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        if not last:
            p["next"] = i + 1
            return
        self._pending = None
        self._slot_req[slot] = rid
        self._register_prefix(slot, rid)
        self.last_tok[slot] = tok
        self.pos[slot] = len(prompt)
        self.active[slot] = True
        self._flush_pending()
        self._pending_fetches.append(("prefill", tok, (slot, rid)))

    def _to_device(self, data, dtype=None) -> torch.Tensor:
        """A host list as a device tensor. A blocking host-to-device copy
        would wait for all enqueued work (it synchronises the stream), so
        CUDA copies go through pinned memory without blocking."""
        t = torch.tensor(data, dtype=dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _dispatch_prefills(self, batch):
        t_pad = max(self._pad_len(p) for _, _, p in batch)
        t0 = time.perf_counter()
        if len(batch) == 1:
            rid, slot, prompt = batch[0]
            tokens = self._to_device(prompt + [0] * (t_pad - len(prompt)))
            first, self.caches = prefill_slot(
                self.params, self.caches, tokens, len(prompt), slot, self.cfg,
                self.temperature, self._generator)
            self.last_tok[slot] = first
            self.pos[slot] = len(prompt)
            self.active[slot] = True
            entry = ("prefill", first, (slot, rid))
        else:
            tokens = self._to_device([p + [0] * (t_pad - len(p)) for _, _, p in batch])
            true_lens = self._to_device([len(p) for _, _, p in batch])
            slots = self._to_device([s for _, s, _ in batch])
            first, self.caches = prefill_slots(
                self.params, self.caches, tokens, true_lens, slots, self.cfg,
                self.temperature, self._generator)
            self.last_tok[slots] = first
            self.pos[slots] = true_lens
            self.active[slots] = True
            entry = ("prefills", first, [(s, r) for r, s, _ in batch])
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        for rid_i, slot_i, _ in batch:
            self._slot_req[slot_i] = rid_i
            self._register_prefix(slot_i, rid_i)
        self._flush_pending()
        self._pending_fetches.append(entry)

    def _flush_pending(self) -> bool:
        """Fetch + record every previously dispatched token batch, in
        dispatch order. Returns True if anything was flushed."""
        if not self._pending_fetches:
            return False
        entries, self._pending_fetches = self._pending_fetches, []
        t0 = time.perf_counter()
        self._ledger["fetches"] += len(entries)
        for kind, arr, owners in entries:
            toks = arr.cpu().tolist()
            if kind == "bank":  # [n_steps, n_slots]
                for step_toks in toks:
                    for slot, rid in owners:
                        # the slot must still belong to the request it was
                        # decoding when the bank was dispatched
                        if self._slot_req[slot] == rid:
                            self._record(slot, step_toks[slot])
            elif kind == "prefills":  # [B] first tokens of a batched admission
                for tok, (slot, rid) in zip(toks, owners):
                    if self._slot_req[slot] == rid:
                        self._record(slot, tok)
            else:  # "prefill": scalar first token of one admission
                slot, rid = owners
                if self._slot_req[slot] == rid:
                    self._record(slot, toks)
        self._ledger["fetch_s"] += time.perf_counter() - t0
        return True

    def _pending_token_counts(self):
        """Tokens each (slot, rid) will record once the pending fetches
        flush: the lag the dispatch-before-fetch pipeline introduces."""
        counts: dict = {}
        for kind, arr, owners in self._pending_fetches:
            pairs = [owners] if kind == "prefill" else owners
            n = arr.shape[0] if kind == "bank" else 1
            for pair in pairs:
                counts[pair] = counts.get(pair, 0) + n
        return counts

    def _remaining(self, slots) -> list[int]:
        """Each slot's budget left once the pending fetches are recorded."""
        counts = self._pending_token_counts()
        return [self._budgets[self._slot_req[s]] - len(self._outputs[self._slot_req[s]])
                - counts.get((s, self._slot_req[s]), 0) for s in slots]

    def _pick_horizon(self, active_slots) -> int:
        """Bank size for this dispatch: `decode_horizon`, or with
        `adaptive_horizon` a power of two up to that cap sized from the
        slots' remaining budgets (the pending fetches counted): the
        smallest remaining, rounded down, while requests wait (a slot frees
        soon for them), else the largest, rounded up (fewest dispatches to
        drain; surplus rows are discarded at the flush)."""
        cap = self.adaptive_horizon
        if cap is None:
            return self.decode_horizon
        rem = [r for r in self._remaining(active_slots) if r > 0]
        if not rem:
            return 1
        if self.sched.num_waiting > 0:
            target = max(1, min(min(rem), cap))
            return 1 << (target.bit_length() - 1)
        target = max(1, min(max(rem), cap))
        return min(1 << (target - 1).bit_length(), cap)

    def _do_spec_decode(self):
        """One speculative decode action: draft on the host by n-gram lookup,
        dispatch one verify pass, fetch [n_slots, k + 2] (the emitted tokens
        and n_emit) once, and record each slot's n_emit tokens, discarding
        what a slot emits past its finish (EOS or budget).

        Drafting needs every slot's current history, so pending fetches are
        flushed first: this mode has no dispatch-before-fetch pipelining;
        the accepted drafts amortize the round trip instead."""
        self._flush_pending()
        active = [i for i in range(self.n_slots) if self._slot_req[i] >= 0]
        if not active:
            return
        k = self.spec_decode
        drafts = [[0] * k for _ in range(self.n_slots)]
        for s in active:
            rid = self._slot_req[s]
            prop = self._propose(self._prompts[rid] + self._outputs[rid], k,
                                 max_ngram=self.spec_ngram)
            drafts[s][:len(prop)] = prop
        t0 = time.perf_counter()
        seed = None
        if sampling_temperature(self.temperature) > 0.0:  # fresh draws for every dispatch
            seed = (self._seed << 32) | self._spec_dispatches
        self._spec_dispatches += 1
        emitted, n_emit, self.caches = verify_step_batched(
            self.params, self.caches, self.last_tok, self._to_device(drafts, torch.long),
            self.pos, self.active, self.cfg, self.temperature, seed)
        n = torch.arange(self.n_slots, device=self.device)
        self.last_tok = torch.where(self.active, emitted[n, n_emit - 1], self.last_tok)
        self.pos = self.pos + n_emit * self.active.long()
        packed = torch.cat([emitted, n_emit[:, None]], dim=1)  # one fetch
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = packed.cpu().tolist()
        self._ledger["fetches"] += 1
        self._ledger["fetch_s"] += time.perf_counter() - t0
        self._spec_stats["steps"] += 1
        for s in active:
            rid, count = self._slot_req[s], rows[s][-1]
            self._spec_stats["emitted"] += count
            self._spec_stats["accepted"] += count - 1
            for tok in rows[s][:count]:
                if self._slot_req[s] != rid:
                    break  # finished mid-emission: the rest is surplus
                self._record(s, tok)

    def _do_decode(self):
        if self.spec_decode is not None:
            return self._do_spec_decode()
        active_before = [i for i in range(self.n_slots) if self._slot_req[i] >= 0]
        if active_before and self._pending_fetches:
            # if the pending fetches already cover every active slot's
            # remaining budget, another bank is provably surplus: flush
            if all(r <= 0 for r in self._remaining(active_before)):
                self._flush_pending()
                return
        horizon = self._pick_horizon(active_before)
        t0 = time.perf_counter()
        bank, self.caches, self.last_tok, self.pos = decode_horizon_batched(
            self.params, self.caches, self.last_tok, self.pos, self.active, self.cfg,
            horizon, self.temperature, self._generator)
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        self._flush_pending()
        # the flush may have finished requests this (already dispatched)
        # bank is still decoding: their rows are surplus
        owners = [(s, self._slot_req[s]) for s in active_before if self._slot_req[s] >= 0]
        self._pending_fetches.append(("bank", bank, owners))
