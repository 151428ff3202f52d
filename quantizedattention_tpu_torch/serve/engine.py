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

The JAX engine's mesh serving, prefix cache, chunked prefill, adaptive
horizon and top-k/top-p sampling are not ported yet; asking for any of them
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from quantizedattention_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_horizon_batched,
    prefill_slot,
    prefill_slots,
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
from quantizedattention_tpu_torch.serve.scheduler import (
    DECODE,
    IDLE,
    PREFILL,
    make_pager,
    make_scheduler,
)
from quantizedattention_tpu_torch.serve.spec import make_lookup

# option -> the value that leaves it off; any other value is not ported yet
_UNPORTED = {
    "mesh": None, "prefix_cache": False, "prefill_chunk": None,
    "adaptive_horizon": None, "top_k": 0, "top_p": 1.0,
}


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
    dispatched bank (one token fetch per bank). temperature > 0 samples with
    a torch.Generator seeded by `seed`. cache: "slotted" or "paged";
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
                 temperature: float = 0.0, seed: int = 0, param_dtype=None,
                 weight_quant: str | None = None, decode_horizon: int = 1,
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
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if spec_decode is not None:
            if spec_decode < 1:
                raise ValueError("spec_decode must be >= 1")
            if decode_horizon != 1:
                raise ValueError("spec_decode replaces decode_horizon")
        self.device = torch.device(device)
        self.params = _move(params, self.device, param_dtype)
        if weight_quant is not None:
            # after the param_dtype cast, so the scales stay f32
            self.params = quantize_lm_weights(self.params, bits=4 if weight_quant == "int4" else 8)
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.decode_horizon = decode_horizon
        self.temperature = temperature
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
        if temperature > 0.0:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sched = make_scheduler(scheduler, n_slots, cfg.max_seq)
        self.cache_kind = cache
        self._pager = None
        # the pages each slot owns, returned to the pager when it finishes
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
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
        """One engine action (prefill XOR decode bank). False if idle."""
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
                self._slot_pages[slot] = []

    def _pad_len(self, prompt) -> int:
        if self._pager is not None:  # paged prompts fill whole pages
            return -(-max(len(prompt), 1) // self._page_size) * self._page_size
        # power-of-two bucket, clamped at the 128-rounded cache capacity
        return min(_bucket(len(prompt)), -(-self.cfg.max_seq // 128) * 128)

    def _admit_pages(self, rid: int, slot: int) -> bool:
        """Paged admission: the pages of the whole prompt + budget, all or
        nothing. False, with the request requeued at the queue's front, when
        the pool is short: completions free pages, and submit() guarantees
        the request fits an empty pool."""
        n_need = -(-(len(self._prompts[rid]) + self._budgets[rid]) // self._page_size)
        pages = self._pager.alloc(n_need)
        if pages is None:
            self.sched.requeue(slot)
            return False
        self._slot_pages[slot] = pages
        row = self._to_device(pages + [0] * (self._table_pages - len(pages)), torch.int32)
        for c in self.caches:
            assign_pages(c, slot, row)
        return True

    def _do_prefill(self, rid: int, slot: int):
        if self._pager is not None and not self._admit_pages(rid, slot):
            if self.sched.num_active > 0:
                self._do_decode()
            return
        # batched admission: while requests wait and slots are free the
        # scheduler keeps answering PREFILL; drain them into ONE prefill
        batch = [(rid, slot, self._prompts[rid])]
        while len(batch) < self.n_slots and self.sched.num_waiting > 0:
            action, rid2, slot2 = self.sched.next_action()
            if action != PREFILL:
                break
            if self._pager is not None and not self._admit_pages(rid2, slot2):
                break  # rid2 requeued; serve what we have
            batch.append((rid2, slot2, self._prompts[rid2]))
        self._dispatch_prefills(batch)

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
        if self.temperature > 0.0:  # fresh draws for every dispatch
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
            counts = self._pending_token_counts()

            def left(s):
                rid = self._slot_req[s]
                return self._budgets[rid] - len(self._outputs[rid]) - counts.get((s, rid), 0)

            if all(left(s) <= 0 for s in active_before):
                self._flush_pending()
                return
        t0 = time.perf_counter()
        bank, self.caches, self.last_tok, self.pos = decode_horizon_batched(
            self.params, self.caches, self.last_tok, self.pos, self.active, self.cfg,
            self.decode_horizon, self.temperature, self._generator)
        self._ledger["dispatches"] += 1
        self._ledger["dispatch_s"] += time.perf_counter() - t0
        self._flush_pending()
        # the flush may have finished requests this (already dispatched)
        # bank is still decoding: their rows are surplus
        owners = [(s, self._slot_req[s]) for s in active_before if self._slot_req[s] >= 0]
        self._pending_fetches.append(("bank", bank, owners))
