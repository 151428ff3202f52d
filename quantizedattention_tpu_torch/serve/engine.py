"""Continuous-batching serving engine on the int8 KV cache (one device).

Counterpart of quantizedattention_tpu/serve/engine.py's single-device path
with the slotted int8 cache:
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

Prefill runs the config's attention: B1, or with attention="int8" the int8
SageAttention forward (B4 quantizes, B5 attends), as the JAX engine's
prefill does; decode runs B13 either way. `weight_quant="int8"` / `"int4"`
quantizes the params after the `param_dtype` cast (`quantize_lm_weights`,
scales kept f32), so every projection and the unembedding run B17 / B18.

The JAX engine's mesh serving, paged/int4 caches, speculative decoding,
prefix cache, chunked prefill, adaptive horizon and top-k/top-p sampling are
not ported yet; asking for any of them raises NotImplementedError.
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
)
from quantizedattention_tpu_torch.parallel.kv_cache import init_kv_cache
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_lm_weights,
)
from quantizedattention_tpu_torch.serve.scheduler import DECODE, IDLE, PREFILL, make_scheduler

# option -> the value that leaves it off; any other value is not ported yet
_UNPORTED = {
    "mesh": None, "cache": "slotted", "kv_quant": None, "spec_decode": None,
    "prefix_cache": False, "prefill_chunk": None,
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
    optional stop token. scheduler: "native" (the C++ core) or "python" (its
    twin). decode_horizon: decode steps per dispatched bank (one token fetch
    per bank). temperature > 0 samples with a torch.Generator seeded by
    `seed`.
    """

    def __init__(self, params, cfg: TransformerConfig, device, n_slots: int = 4,
                 eos_id: int | None = None, scheduler: str = "native",
                 temperature: float = 0.0, seed: int = 0, param_dtype=None,
                 weight_quant: str | None = None, decode_horizon: int = 1, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported to the PyTorch package yet")
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError("weight_quant must be 'int8', 'int4', or None")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
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
        self._generator = None
        if temperature > 0.0:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sched = make_scheduler(scheduler, n_slots, cfg.max_seq)
        self.caches = [init_kv_cache(n_slots, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim,
                                     self.device) for _ in range(cfg.n_layers)]
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
        prompt + budget can never fit the KV capacity.
        """
        prompt = [int(t) for t in prompt]
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt token out of range [0, {self.cfg.vocab_size})")
        rid = self._next_id
        self._next_id += 1
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
        """Serving observability: queue/slot occupancy and token counts."""
        return {
            "active": self.sched.num_active,
            "waiting": self.sched.num_waiting,
            "completed": self.sched.num_completed,
            "tokens_generated": self._tokens_generated,
            "last_run_tokens_per_s": self._last_run_tokens_per_s,
            "cache": "slotted",
            "decode_horizon": self.decode_horizon,
            "ledger": dict(self._ledger),
        }

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

    def _pad_len(self, prompt) -> int:
        # power-of-two bucket, clamped at the 128-rounded cache capacity
        return min(_bucket(len(prompt)), -(-self.cfg.max_seq // 128) * 128)

    def _do_prefill(self, rid: int, slot: int):
        # batched admission: while requests wait and slots are free the
        # scheduler keeps answering PREFILL; drain them into ONE prefill
        batch = [(rid, slot, self._prompts[rid])]
        while len(batch) < self.n_slots and self.sched.num_waiting > 0:
            action, rid2, slot2 = self.sched.next_action()
            if action != PREFILL:
                break
            batch.append((rid2, slot2, self._prompts[rid2]))
        self._dispatch_prefills(batch)

    def _to_device(self, data) -> torch.Tensor:
        """A host list as a device tensor. A blocking host-to-device copy
        would wait for all enqueued work (it synchronises the stream), so
        CUDA copies go through pinned memory without blocking."""
        t = torch.tensor(data)
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

    def _do_decode(self):
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
