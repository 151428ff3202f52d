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

Mesh serving (`mesh=`, a parallel.make_attention_mesh DeviceMesh; the JAX
engine's mesh branch): one process per rank, each running this engine on
the same request stream. Slots split over `data` and heads over `model`
(the Megatron layout of models/sharded_train.py; int8 weights shard as
quantize_lm_specs says, int4 weights raise); each rank holds only its shard
of the params and its data shard's caches, a paged pool private to the
shard with shard-local page ids. Every rank keeps the whole host policy,
every shard's pager and prefix store included, identically, and records
every token: the mesh steps (below the class) share each shard's tokens
through one all_reduce. A request is admitted alone (no batched admission
under a mesh), and every step first checks over a gloo group on the host
that all ranks chose the same action and slot and hold the same tokens,
raising where they diverge instead of hanging in a collective. Draws are
keyed by (seed, global slot, position), so a seeded sampled run gives the
same tokens however the slots are split.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from quantizedattention_tpu_torch.models.sharded_train import local_config, shard_params
from quantizedattention_tpu_torch.models.transformer import (
    Sampling,
    TransformerConfig,
    _decode_logits,
    decode_bank,
    decode_horizon_batched,
    gumbel_draws,
    prefill_chunk as prefill_chunk_step,
    prefill_chunk_logits,
    prefill_slot,
    prefill_slot_logits,
    prefill_slots,
    sampling_temperature,
    verify_step_batched,
)
from quantizedattention_tpu_torch.parallel.kv4_cache import Int4KVCache, init_kv4_cache
from quantizedattention_tpu_torch.parallel.kv_cache import QuantizedKVCache, init_kv_cache
from quantizedattention_tpu_torch.parallel.mesh import axis_index, axis_size, is_mesh, psum
from quantizedattention_tpu_torch.parallel.paged4_cache import Paged4KVCache, init_paged4_cache
from quantizedattention_tpu_torch.parallel.paged_cache import (
    PagedKVCache,
    assign_pages,
    init_paged_cache,
)
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

# the lockstep check's code for a chunk of a chunked prefill (the
# scheduler's actions are IDLE, PREFILL and DECODE)
_CHUNK = 3


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
    kind's proposer ("native" builds native/ngram.cpp or raises). mesh: a
    parallel.make_attention_mesh DeviceMesh (context 1) for mesh serving;
    every rank builds its engine from the same full params and runs the
    same submits, and `device` is the rank's own. n_slots must divide over
    data, the heads over model, and weight_quant "int4" raises; n_pages
    then sizes each data shard's pool (default 1 + its slots *
    ceil(max_seq / page_size)).
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
                 spec_ngram: int = 3, mesh=None):
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
        n_shards = 1
        if mesh is not None:
            if not is_mesh(mesh):
                raise ValueError("mesh must be a DeviceMesh with 'data' and 'model' axes "
                                 "(parallel.make_attention_mesh)")
            if axis_size(mesh, "context") != 1:
                raise ValueError("mesh serving splits slots over data and heads over model; "
                                 "its context axis must be 1")
            if weight_quant == "int4":
                raise ValueError("weight_quant='int4' with mesh serving is not supported "
                                 "(split-half nibble packing does not split along the "
                                 "contraction axis; use 'int8')")
            local_config(cfg, mesh)  # ValueError unless the heads split over model
            n_shards = axis_size(mesh, "data")
            if n_slots % n_shards:
                raise ValueError(f"n_slots {n_slots} must divide the data axis ({n_shards})")
        self.device = torch.device(device)
        self.params = _move(params, self.device, param_dtype)
        if weight_quant is not None:
            # after the param_dtype cast, so the scales stay f32
            self.params = quantize_lm_weights(self.params, bits=4 if weight_quant == "int4" else 8)
        self._mesh = mesh
        slots_loc, kv_loc = n_slots // n_shards, cfg.n_kv_heads
        if mesh is not None:
            self.params = shard_params(self.params, cfg, mesh)
            kv_loc = local_config(cfg, mesh).n_kv_heads
            self._slots_per_shard = slots_loc
            # host-side checks go over gloo on CPU tensors: no device sync
            self._host_group = dist.new_group(backend="gloo")
            self._token_hash = 0
        self.cfg = cfg
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.decode_horizon = decode_horizon
        self.adaptive_horizon = adaptive_horizon
        self.prefill_chunk = prefill_chunk
        # a float stays a float: the temperature-only paths are unchanged
        self.temperature = spec if (top_k or top_p < 1.0) else float(temperature)
        if mesh is not None:
            self._mesh_decode = make_sharded_decode_step(mesh, cfg, self.temperature)
            self._mesh_prefill = make_sharded_prefill_slot(mesh, cfg, self.temperature)
            self._mesh_chunk = make_sharded_prefill_chunk(mesh, cfg, self.temperature)
            self._mesh_verify = make_sharded_verify_step(mesh, cfg, self.temperature)
            self._draws = 0  # sampled dispatches: a mesh draw's seed counter
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
        if sampling_temperature(self.temperature) > 0.0 and mesh is None:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sched = make_scheduler(scheduler, n_slots, cfg.max_seq)
        self.cache_kind = cache
        self._pagers = self._prefix_stores = None
        # page bookkeeping per slot: its private pages (returned to the pager
        # when it finishes), the store's pages it holds references on
        # (released), its whole table row in prefix order, and the tokens the
        # shared prefix covers (where its chunked prefill starts)
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_shared: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_row: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_prefix = [0] * n_slots
        if cache == "paged":
            # one allocator a data shard (one without a mesh); the same page
            # ids index every layer's pool, and each layer's cache keeps its
            # own copy of the table and lengths. Under a mesh every rank
            # keeps every shard's allocator and store, identically, and
            # holds the pool of its own shard only.
            self._page_size = page_size
            if n_pages is None:  # page 0 reserved
                n_pages = 1 + slots_loc * -(-cfg.max_seq // page_size)
            # the table entries past the row's pages hold page 0, so a
            # verify's overshoot lands there and advances the length like any
            # other token
            self._table_pages = -(-(cfg.max_seq + k) // page_size)
            self._pagers = [make_pager(scheduler, n_pages) for _ in range(n_shards)]
            if prefix_cache:
                self._prefix_stores = [make_prefix_store(scheduler, page_size)
                                       for _ in range(n_shards)]
            init = init_paged4_cache if kv_quant == "int4" else init_paged_cache
            self.caches = [init(kv_loc, n_pages, slots_loc, self._table_pages,
                                cfg.head_dim, page_size, self.device)
                           for _ in range(cfg.n_layers)]
        else:
            # slack rows for a verify's overshoot: append_kv would shift a
            # write that overflows max_len left, onto live entries
            grain = 256 if kv_quant == "int4" else 128
            max_len = cfg.max_seq + (-(-(k + 1) // grain) * grain if k else 0)
            init = init_kv4_cache if kv_quant == "int4" else init_kv_cache
            self.caches = [init(slots_loc, kv_loc, max_len, cfg.head_dim, self.device)
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
        if self._pagers is not None:  # the pool of one data shard
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
        if self._pagers is not None:
            s["pages_free"] = sum(p.num_free for p in self._pagers)
        if self._prefix_stores is not None:
            s["prefix_nodes"] = sum(st.n_nodes for st in self._prefix_stores)
            s["prefix_hit_pages"] = sum(st.hits for st in self._prefix_stores)
            s["prefix_miss_pages"] = sum(st.misses for st in self._prefix_stores)
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
                self._lockstep(DECODE, -1)
                self._pending_decode_turn = False
                self._do_decode()
            else:
                self._lockstep(_CHUNK, self._pending["slot"])
                self._pending_decode_turn = True
                self._do_prefill_chunk()
            return True
        action, rid, slot = self.sched.next_action()
        self._lockstep(action, slot)
        if action == IDLE:
            # drain pipelined fetches before declaring idle (their tokens
            # may finish requests or free slots)
            return self._flush_pending()
        if action == PREFILL:
            self._do_prefill(rid, slot)
        elif action == DECODE:
            self._do_decode()
        return True

    def _lockstep(self, action: int, slot: int):
        """Under a mesh: raise unless every rank chose this action and slot
        and has recorded the same tokens (their count and a running hash).
        One all_reduce (MAX of the values and of their negations) over the
        host's gloo group, on CPU tensors: it waits for no device work.
        Ranks whose host policies diverged would otherwise issue different
        collectives and hang."""
        if self._mesh is None:
            return
        mine = torch.tensor([action, slot, self._tokens_generated, self._token_hash])
        both = torch.cat([mine, -mine])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self._host_group)
        if not torch.equal(both[:4], -both[4:]):
            raise RuntimeError(
                f"mesh ranks diverged: (action, slot, tokens, token hash) here "
                f"{mine.tolist()}, max over ranks {both[:4].tolist()}, min {(-both[4:]).tolist()}")

    def _next_seed(self) -> int | None:
        """A mesh dispatch's draw seed when sampling: the engine's seed and
        the count of sampled dispatches, the same on every rank."""
        if sampling_temperature(self.temperature) == 0.0:
            return None
        self._draws += 1
        return (self._seed << 32) | self._draws

    def _shard(self, slot: int) -> int:
        """The data shard that owns `slot` (0 without a mesh)."""
        return 0 if self._mesh is None else slot // self._slots_per_shard

    def _record(self, slot: int, token: int):
        rid = self._slot_req[slot]
        self._outputs[rid].append(token)
        self._tokens_generated += 1
        if self._mesh is not None:
            self._token_hash = (self._token_hash * 1000003 + token + 1) % 2147483647
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
                self._pagers[self._shard(slot)].free(self._slot_pages[slot])
            if self._slot_shared[slot]:
                # shared pages stay cached in the store (evicted under pressure)
                self._prefix_stores[self._shard(slot)].release(self._slot_shared[slot])
            self._slot_pages[slot], self._slot_shared[slot], self._slot_row[slot] = [], [], []

    def _pad_len(self, prompt) -> int:
        if self._pagers is not None:  # paged prompts fill whole pages
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
        shard = self._shard(slot)
        pager = self._pagers[shard]
        store = None if self._prefix_stores is None else self._prefix_stores[shard]
        hit = []
        if store is not None:
            chunk_pages = self.prefill_chunk // ps
            hit = store.lookup(prompt, max_pages=(len(prompt) - 1) // ps)
            hit = hit[: len(hit) // chunk_pages * chunk_pages]
            if hit:
                store.acquire(hit)
        n_fresh = n_need - len(hit)
        pages = pager.alloc(n_fresh)
        if pages is None and store is not None:
            evicted = store.evict(n_fresh - pager.num_free)
            if evicted:
                pager.free(evicted)
                pages = pager.alloc(n_fresh)
        if pages is None:
            if hit:
                store.release(hit)
            self.sched.requeue(slot)
            return False
        row = hit + pages
        self._slot_pages[slot], self._slot_shared[slot], self._slot_row[slot] = pages, hit, row
        self._slot_prefix[slot] = len(hit) * ps
        if self._mesh is not None:  # only the owning shard holds the row
            own, slot = _owner(self._mesh, self.caches, slot)
            if not own:
                return True
        table_row = self._to_device(row + [0] * (self._table_pages - len(row)), torch.int32)
        for c in self.caches:
            assign_pages(c, slot, table_row)
        return True

    def _register_prefix(self, slot: int, rid: int):
        """Offer the prefilled prompt's full pages to the prefix store; the
        pages it adopts move from the slot's private list to its shared
        list (released, not freed, when the slot finishes)."""
        if self._prefix_stores is None:
            return
        prompt = self._prompts[rid]
        n_full = len(prompt) // self._page_size
        if n_full == 0:
            return
        owned = self._prefix_stores[self._shard(slot)].register(
            prompt, self._slot_row[slot][:n_full])
        owned_set = set(owned)
        self._slot_shared[slot] = owned
        self._slot_pages[slot] = [p for p in self._slot_row[slot] if p not in owned_set]

    def _needs_chunking(self, prompt) -> bool:
        return self.prefill_chunk is not None and len(prompt) > self.prefill_chunk

    def _do_prefill(self, rid: int, slot: int):
        prompt = self._prompts[rid]
        if self._pagers is not None and not self._admit_pages(rid, slot):
            if self.sched.num_active > 0:
                self._do_decode()
            return
        if self._needs_chunking(prompt) or self._slot_prefix[slot] > 0:
            # a prefix hit always takes the chunked path: it is the
            # tail-only prefill
            self._start_chunked_prefill(rid, slot, prompt)
            return
        # batched admission (one device only): while requests wait and slots
        # are free the scheduler keeps answering PREFILL; drain them into
        # ONE prefill, cut before a request that takes the chunked path
        batch = [(rid, slot, prompt)]
        while (self._mesh is None and len(batch) < self.n_slots
               and self.sched.num_waiting > 0):
            action, rid2, slot2 = self.sched.next_action()
            if action != PREFILL:
                break
            prompt2 = self._prompts[rid2]
            if self._pagers is not None and not self._admit_pages(rid2, slot2):
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
        tokens = self._to_device(piece + [0] * (chunk - len(piece)))
        t0 = time.perf_counter()
        if self._mesh is not None:
            tok, self.caches = self._mesh_chunk(self.params, self.caches, tokens, i * chunk,
                                                len(prompt), slot, last,
                                                self._next_seed() if last else None)
        else:
            tok, self.caches = prefill_chunk_step(
                self.params, self.caches, tokens, i * chunk, len(prompt), slot, self.cfg, last,
                self.temperature, self._generator)
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
            if self._mesh is not None:
                first, self.caches = self._mesh_prefill(self.params, self.caches, tokens,
                                                        len(prompt), slot, self._next_seed())
            else:
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
        drafts = self._to_device(drafts, torch.long)
        if self._mesh is not None:
            packed, self.caches, self.last_tok, self.pos = self._mesh_verify(
                self.params, self.caches, self.last_tok, drafts, self.pos, self.active, seed)
        else:
            emitted, n_emit, self.caches = verify_step_batched(
                self.params, self.caches, self.last_tok, drafts, self.pos, self.active,
                self.cfg, self.temperature, seed)
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
        if self._mesh is not None:
            seed = self._next_seed()
            bank, self.caches, self.last_tok, self.pos = decode_bank(
                lambda caches, last_tok, pos: self._mesh_decode(
                    self.params, caches, last_tok, pos, self.active, seed),
                self.caches, self.last_tok, self.pos, self.active, horizon)
        else:
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


# --------------------------------------------------------------------------
# Mesh serving: slots on `data`, heads on `model` (one process per rank)
# --------------------------------------------------------------------------
#
# The counterparts of the JAX engine's shard_map bodies (engine.py:1040-
# 1598). JAX runs one controller over every device; here every rank runs
# the same host policy on the same request stream and calls these per-rank
# functions on its own shards: params from models/sharded_train.py:
# shard_params, caches holding the rows of its data shard's slots and the
# kv heads of its model shard (a paged pool private to the data shard, its
# page ids shard-local). last_tok/pos/active are the full [n_slots] vectors
# on every rank; a step reads its data shard's rows and hands back the full
# vector of next tokens, so every rank's host records the same tokens.
#
# Collectives, all `dist.all_reduce` (parallel/mesh.py), issued by every
# rank in the same order: the psum over `model` after wo and after w2 in
# every layer, one psum over `data` of a zero-filled [n_slots] buffer that
# shares each shard's tokens, and in a chunk past the first the owner-masked
# psum over `data` that picks the owning shard's prefix merge. Decode and
# verify attention run per (slot, kv head): B13-B16 at the local head count,
# no communication.
#
# Sampling keys each draw by (seed, GLOBAL row, the position it predicts)
# through models/transformer.py:gumbel_draws, as the JAX mesh steps fold
# the global row into the step key, so a seeded run draws the same tokens
# however the slots are split over data.


def _mesh_psum(mesh):
    """The model-axis psum the projections' partial products go through."""
    return lambda x: psum(x.contiguous(), mesh, "model")


def _local_rows(mesh, n_slots: int) -> tuple[int, int]:
    """[lo, hi): the global slots of this rank's data shard."""
    n = n_slots // axis_size(mesh, "data")
    lo = axis_index(mesh, "data") * n
    return lo, lo + n


def _gather_rows(local: torch.Tensor, mesh, n_slots: int, lo: int) -> torch.Tensor:
    """The full [n_slots, ...] tensor on every rank from each data shard's
    rows: a zero-filled buffer holding this shard's rows, psum over data."""
    full = local.new_zeros((n_slots, *local.shape[1:]))
    full[lo:lo + local.shape[0]] = local
    return psum(full, mesh, "data")


def _owner(mesh, caches, slot: int) -> tuple[bool, int]:
    """(whether this rank's data shard owns global `slot`, its local row)."""
    c0 = caches[0]
    slots_loc = (c0.lengths if isinstance(c0, (PagedKVCache, Paged4KVCache)) else c0.length).shape[0]
    return slot // slots_loc == axis_index(mesh, "data"), slot % slots_loc


def _draw(logits, temperature, seed, rows, positions):
    """Greedy, or the (seed, row, position)-keyed draw under sampling;
    logits [n, s, vocab] -> [n, s]."""
    if sampling_temperature(temperature) == 0.0 or seed is None:
        return torch.argmax(logits, dim=-1)
    return gumbel_draws(logits.float(), temperature, seed, rows, positions)


def _sharded_decode_step(params, caches, last_tok, pos, active, mesh, cfg: TransformerConfig,
                         temperature=0.0, seed: int | None = None):
    """One decode step on this rank's shards (JAX engine.py:1040-1099):
    its data shard's rows of the full last_tok/pos/active [n_slots], its
    heads (cfg is the global config). Returns (next tokens [n_slots] on
    every rank, caches)."""
    lo, hi = _local_rows(mesh, last_tok.shape[0])
    logits, caches = _decode_logits(params, caches, last_tok[lo:hi], pos[lo:hi], active[lo:hi],
                                    local_config(cfg, mesh), _mesh_psum(mesh))
    rows = torch.arange(lo, hi, device=logits.device)
    tok = _draw(logits[:, None], temperature, seed, rows, pos[lo:hi, None].long() + 1)[:, 0]
    return _gather_rows(tok, mesh, last_tok.shape[0], lo), caches


def make_sharded_decode_step(mesh, cfg: TransformerConfig, temperature=0.0, horizon: int = 1):
    """The per-rank decode step (JAX engine.py:1288-1361): (params, caches,
    last_tok, pos, active, seed=None) -> (next_tok [n_slots], caches), or
    with horizon > 1 (bank [horizon, n_slots], caches, last_tok, pos), the
    contract of decode_horizon_batched. params and caches are this rank's
    shards (`serving_shardings`); seed keys the draws when sampling."""
    local_config(cfg, mesh)  # the heads must split over model

    def step(params, caches, last_tok, pos, active, seed=None):
        if sampling_temperature(temperature) > 0.0 and seed is None:
            raise ValueError("temperature > 0 requires a seed per step")

        def one(caches, last_tok, pos):
            return _sharded_decode_step(params, caches, last_tok, pos, active, mesh, cfg,
                                        temperature, seed)

        if horizon <= 1:
            return one(caches, last_tok, pos)
        return decode_bank(one, caches, last_tok, pos, active, horizon)

    return step


def make_sharded_verify_step(mesh, cfg: TransformerConfig, temperature=0.0):
    """The per-rank speculative verify step (JAX engine.py:1102-1211):
    (params, caches, last_tok, draft [n_slots, s - 1], pos, active,
    seed=None) -> (packed [n_slots, s + 1]: the emitted tokens and n_emit,
    caches, last_tok, pos), every output but the caches full on every rank.
    The staircase attention is per (slot, kv head); acceptance and rollback
    are per slot, on the rank's own rows."""
    lcfg = local_config(cfg, mesh)

    def step(params, caches, last_tok, draft, pos, active, seed=None):
        n_slots = last_tok.shape[0]
        lo, hi = _local_rows(mesh, n_slots)
        emitted, n_emit, caches = verify_step_batched(
            params, caches, last_tok[lo:hi], draft[lo:hi], pos[lo:hi], active[lo:hi], lcfg,
            temperature, seed, psum=_mesh_psum(mesh), row0=lo)
        packed = _gather_rows(torch.cat([emitted, n_emit[:, None]], dim=1), mesh, n_slots, lo)
        n_emit = packed[:, -1]
        new_last = packed[torch.arange(n_slots, device=packed.device), n_emit - 1]
        last_tok = torch.where(active, new_last, last_tok)
        return packed, caches, last_tok, pos + n_emit * active.long()

    return step


def _draw_first(logits, temperature, seed, slot: int, true_end: int):
    """A prefill's first token from its last logits [vocab]: greedy, or the
    draw keyed by (seed, global slot, the position it predicts)."""
    rows = torch.tensor([slot], device=logits.device)
    pos = torch.tensor([[true_end]], device=logits.device)
    return _draw(logits[None, None], temperature, seed, rows, pos)[0, 0]


def make_sharded_prefill_slot(mesh, cfg: TransformerConfig, temperature=0.0):
    """The per-rank fused prefill of one request into global cache row
    `slot` (JAX engine.py:1364-1444): every rank runs the prompt through its
    heads (activations replicated across data, psum over model after wo and
    w2), and only the data shard that owns the slot writes its cache
    (slotted row or private pool); models/transformer.py:prefill_slot_logits
    is the body. (params, caches, tokens [t_pad], true_len, slot, seed=None)
    -> (first token, the same on every rank; caches)."""
    lcfg = local_config(cfg, mesh)

    def prefill(params, caches, tokens, true_len: int, slot: int, seed=None):
        own, slot_loc = _owner(mesh, caches, slot)
        logits, caches = prefill_slot_logits(params, caches, tokens, true_len, slot_loc, lcfg,
                                             _mesh_psum(mesh), own)
        return _draw_first(logits, temperature, seed, slot, true_len), caches

    return prefill


def make_sharded_prefill_chunk(mesh, cfg: TransformerConfig, temperature=0.0):
    """The per-rank chunked prefill (JAX engine.py:1447-1578), with
    models/transformer.py:prefill_chunk's signature plus a seed, on
    prefill_chunk_logits' body. Chunk activations are replicated across
    data, so the chunk's causal part runs on every rank; the prefix lives
    only in the owning data shard's cache, so the owner merges it in by lse
    and one masked psum over data hands its merged output to every shard
    (the others add zeros). Only the owner writes the chunk."""
    lcfg = local_config(cfg, mesh)

    def prefill(params, caches, tokens, chunk_start: int, true_end: int, slot: int, last: bool,
                seed=None):
        own, slot_loc = _owner(mesh, caches, slot)
        logits, caches = prefill_chunk_logits(
            params, caches, tokens, chunk_start, true_end, slot_loc, lcfg, last,
            _mesh_psum(mesh), own, lambda o: psum(o.contiguous(), mesh, "data"))
        if logits is None:
            return None, caches
        return _draw_first(logits, temperature, seed, slot, true_end), caches

    return prefill


def cache_specs() -> QuantizedKVCache:
    """Spec tree of one layer's slotted int8 cache: slots on data, kv heads
    on model (JAX engine.py:1214-1221)."""
    payload, scales = ("data", "model", None, None), ("data", "model", None)
    return QuantizedKVCache(k_i8=payload, sk=scales, v_i8=payload, sv=scales, length=("data",))


def cache4_specs() -> Int4KVCache:
    """The slotted int4 cache's twin of `cache_specs`: the pack blocks run
    along the unsplit token axis, so packing and sharding never meet."""
    payload, scales = ("data", "model", None, None), ("data", "model", None)
    return Int4KVCache(k_p=payload, sk=scales, v_p=payload, sv=scales, length=("data",))


def paged_cache_specs() -> PagedKVCache:
    """Spec tree of one layer's paged int8 pool under the serving mesh: each
    data shard owns a PRIVATE pool (pages split on data, table values
    shard-local ids) and the table rows of its slots; kv heads on model."""
    pages, scales = ("model", "data", None, None), ("data", "model", None)
    return PagedKVCache(k_pages=pages, sk=scales, v_pages=pages, sv=scales,
                        page_table=("data", None), lengths=("data",))


def paged4_cache_specs() -> Paged4KVCache:
    """The paged int4 pool's twin of `paged_cache_specs`."""
    pages, scales = ("model", "data", None, None), ("data", "model", None)
    return Paged4KVCache(k_p=pages, sk=scales, v_p=pages, sv=scales,
                         page_table=("data", None), lengths=("data",))


def serving_shardings(cfg: TransformerConfig, cache: str = "slotted",
                      weight_quant: str | None = None, kv_quant: str | None = None):
    """(param specs, per-layer cache specs) of mesh serving (JAX
    engine.py:1581-1598); models/sharded_train.py:shard_tree cuts full
    trees to a rank's shards under them. weight_quant="int8": the params
    hold QuantizedWeight leaves, so the spec tree is their twin
    (quantize_lm_specs). JAX's third tree, the vectors' data sharding, has
    no counterpart: last_tok/pos/active are whole on every rank, whose host
    records every token."""
    from quantizedattention_tpu_torch.models.sharded_train import param_specs
    from quantizedattention_tpu_torch.quantize.weights import quantize_lm_specs

    pspecs = param_specs(cfg)
    if weight_quant is not None:
        pspecs = quantize_lm_specs(pspecs)
    if cache == "paged":
        one = paged4_cache_specs() if kv_quant == "int4" else paged_cache_specs()
    else:
        one = cache4_specs() if kv_quant == "int4" else cache_specs()
    return pspecs, [one for _ in range(cfg.n_layers)]
