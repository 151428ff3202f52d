"""Ring attention over the `context` axis, and merging partial attentions.

Counterpart of quantizedattention_tpu/parallel/ring.py: its bf16 and int8
rings, and the JVP ring (`ring_attention_jvp`, below). The sequence is split
over the ranks of the context axis; every rank keeps its query shard and the
key/value shards pass around the ring by `mesh.ppermute`, one hop a step.
At each step a rank attends its queries to the shard in front of it and
merges the normalized partial (O, lse) into its running result by their
exp2-domain lse (`_merge_partials`, JAX ring.py:52-62): the merge is
associative, so the ring's order does not matter. The next hop is posted
before the step's kernel (JAX ring.py:92), so on NCCL the transfer overlaps
it.

Causal: shard src sits at positions src * t_local on. A shard in the future
(src > idx) is skipped on the host: every rank knows src and idx, so no
device value is read. The shards in the past run whole.
- bf16: one B1 launch a live step with q_offset = idx * t_local and k_offset
  = src * t_local (the kernels' global offsets, B-f2), so the diagonal shard
  masks k <= q and the past ones mask nothing. K and V ride the ring in bf16
  (the kernels round them to bf16 anyway: the same numerics, half the bytes).
- int8: each rank quantizes its shard once (B4) with K smoothed by the
  GLOBAL token mean (`pmean` over the axis: softmax shift invariance needs
  the same shift for every key of a row), at the grain of its own shard
  (tune/config.py:int8_grain at (t_local, t_local), the grain of JAX's
  default_block_config("int8", t_local, t_local, d)). The int8 payloads and
  their scale tables ride the ring; B5 runs at the same global offsets as
  B1 (a past shard's causal mask covers it whole, so it masks no tile).

Both run through one torch.autograd.Function, `_Ring`, whose backward is a
ring too (JAX ring.py:137-190 and :246-292): the forward's shards rotate
again with the f32 dK/dV accumulators beside them; each rank adds dQ
locally and the visiting shard's dK/dV into the accumulators (B2 + B3 fast
on the bf16 ring, B7 + B8 on the int8 one), which hop on after every step:
after n hops they are home. A ring is its list of pieces a step
(`_contiguous_pieces` here, parallel/zigzag.py's chunk pairs) and its kind
(`_BF16`, `_Int8`). GQA: the unrepeated kv heads ride the ring and feed the
GQA-native kernels.

The JVP ring (`ring_attention_jvp`, JAX ring.py:362-529) carries (K, V, tK,
tV) around the same ring and runs B9 a live step (causal on the diagonal,
whole on a past shard, a future one skipped on the host; the diagonal has
t = s, so no offsets), merging the partials (O, tO, lse, mu) exactly in the
exp2 domain (`_merge_jvp_partials`). Its backward is the second-order ring:
the four f32 accumulators (dK, dV, dtK, dtV) ride beside the shards and
each live step runs B11 + B12 (`attention_jvp_bwd`) against the GLOBAL
(O, tO, lse, mu); a last hop brings the accumulators home.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.ops.flash_bwd import (
    bwd_operands,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from quantizedattention_tpu_torch.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu_torch.ops.int8_bwd import (
    int8_bwd_dkv,
    int8_bwd_dq,
    int8_bwd_operands,
)
from quantizedattention_tpu_torch.ops.int8_fwd import (
    int8_attention_fwd_from_quantized,
    quantize_qkv,
)
from quantizedattention_tpu_torch.ops.jvp_bwd import attention_jvp_bwd
from quantizedattention_tpu_torch.ops.jvp_fwd import attention_jvp_fwd
from quantizedattention_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    pmean,
    ppermute,
    ppermute_start,
)


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions (O [..., t, d], lse
    [..., t]) through their exp2-domain lse: O = (w1 O1 + w2 O2) / (w1 + w2)
    with w = exp2(lse - max). A row whose two lse are both -inf gives O = 0
    and lse -inf."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(lse1), torch.exp2(lse1 - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(lse2), torch.exp2(lse2 - m_safe), 0.0)
    l = w1 + w2
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    lse = torch.where(l == 0.0, -torch.inf, m + torch.log2(l_safe))
    return o, lse


def _empty_partial(q):
    """(O = 0, lse = -inf) for q [b, h, t, d]: the running result before the
    first step."""
    b, h, t, d = q.shape
    return (torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), -torch.inf, dtype=torch.float32, device=q.device))


def ring_steps(blk: list, mesh, axis: str):
    """The ring's n steps over `axis`: yields (step, src, the blocks of shard
    src in front of this rank), starting from this rank's own (src = idx).
    Each step's hop of the blocks to the next rank is posted before they are
    handed out and waited for after the caller's work on them."""
    n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    for step in range(n):
        pending = ppermute_start(blk, mesh, axis) if step < n - 1 else None
        yield step, (idx - step) % n, blk
        if pending is not None:
            blk = pending.wait()


def global_k_mean(k, mesh, axis: str) -> torch.Tensor:
    """K's token mean over the whole sequence, [b, h_kv, 1, d] f32: the shards'
    means averaged over `axis` (the shards hold equal token counts). The int8
    paths smooth every shard's K by it: softmax shift invariance needs the
    same shift for every key of a row."""
    return pmean(k.float().mean(dim=-2, keepdim=True), mesh, axis)


class _BF16:
    """The bf16 kind: B1 a piece; backward B2 + B3 fast. K and V ride the
    ring in bf16 (the kernels round them to bf16 anyway)."""

    @staticmethod
    def prepare(q, k, v, qs, ks, vs, mesh, axis):
        """(each q chunk's residuals, the ring's payload: K and V of each
        chunk, the extra saved tensors)."""
        return [(x,) for x in qs], [x.to(torch.bfloat16).contiguous()
                                    for kc in zip(ks, vs) for x in kc], []

    @staticmethod
    def forward(q_res, kv, dims, causal, q_offset, k_offset, sm_scale):
        return flash_attention_fwd(q_res[0], *kv, causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset, k_offset=k_offset)

    @staticmethod
    def operands(q_res, kv, extra, o, lse, do, dims, sm_scale):
        # q, dO, lse and D laid out once (one prep launch); each piece swaps
        # in the visiting K and V
        return bwd_operands(q_res[0], *kv, o, lse, do, True, sm_scale, fast=True)

    @staticmethod
    def backward(ops, kv, causal, q_offset, k_offset):
        piece = ops._replace(k=kv[0].reshape(ops.k.shape), v=kv[1].reshape(ops.v.shape),
                             causal=causal, q_offset=q_offset, k_offset=k_offset)
        return (*flash_bwd_dkv(piece), flash_bwd_dq(piece))


class _Int8:
    """The int8 kind: B4 once a chunk, with K smoothed by the GLOBAL token
    mean, B5 a piece at its global offsets; backward B7 + B8 at the same.
    The payloads and their scale tables ride the ring."""

    @staticmethod
    def prepare(q, k, v, qs, ks, vs, mesh, axis):
        k_mean = global_k_mean(k, mesh, axis)
        res = [quantize_qkv(*x, k_sub=k_mean) for x in zip(qs, ks, vs)]
        return [r[0] for r in res], [x for r in res for x in (*r[1], *r[2])], [k_mean]

    @staticmethod
    def forward(q_res, kv, dims, causal, q_offset, k_offset, sm_scale):
        return int8_attention_fwd_from_quantized((q_res, kv[:2], kv[2:]), dims, causal=causal,
                                                 sm_scale=sm_scale, q_offset=q_offset,
                                                 k_offset=k_offset)

    @staticmethod
    def operands(q_res, kv, extra, o, lse, do, dims, sm_scale):
        return int8_bwd_operands((q_res, kv[:2], kv[2:]), extra[0], o, lse, do, dims, True,
                                 sm_scale)

    @staticmethod
    def backward(ops, kv, causal, q_offset, k_offset):
        piece = ops._replace(k_i8=kv[0], sk=kv[1], v_i8=kv[2], sv=kv[3], causal=causal,
                             q_offset=q_offset, k_offset=k_offset)
        return (*int8_bwd_dkv(piece), int8_bwd_dq(piece))


_KINDS = {"bf16": _BF16, "int8": _Int8}


class _Ring(torch.autograd.Function):
    """A ring over `axis` whose local sequence is `n_chunks` equal chunks:
    `pieces(step, src, idx)` lists the (q chunk, kv chunk, causal, q_offset,
    k_offset) launches of each step, and `kind` (`_BF16`, `_Int8`) runs
    them. The backward rotates the payload again with each chunk's f32
    dK/dV accumulators beside it; after n hops they are home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, sm_scale, kind, pieces, n_chunks):
        idx = axis_index(mesh, axis)
        b, h, t, d = q.shape
        c = t // n_chunks
        dims = (b, h, c, c, d)
        qs, ks, vs = (x.chunk(n_chunks, 2) for x in (q, k, v))
        q_res, own, extra = kind.prepare(q, k, v, qs, ks, vs, mesh, axis)
        m = len(own) // n_chunks  # payload tensors a chunk
        outs = [_empty_partial(x) for x in qs]
        for step, src, blk in ring_steps(own, mesh, axis):
            for qc, kc, causal, q_off, k_off in pieces(step, src, idx):
                o_p, lse_p = kind.forward(q_res[qc], blk[kc * m:(kc + 1) * m], dims, causal,
                                          q_off, k_off, sm_scale)
                outs[qc] = _merge_partials(*outs[qc], o_p, lse_p)
        o = torch.cat([x[0] for x in outs], 2)
        lse = torch.cat([x[1] for x in outs], 2)
        ctx.save_for_backward(*(x for r in q_res for x in r), *own, *extra, o, lse)
        ctx.args = (mesh, axis, sm_scale, kind, pieces, n_chunks, dims, k.shape[1],
                    len(q_res[0]), len(own), q.dtype, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        mesh, axis, sm_scale, kind, pieces, n_chunks, dims, h_kv, n_q, n_own, q_dtype, \
            k_dtype, v_dtype = ctx.args
        *saved, o, lse = ctx.saved_tensors
        q_res = [saved[i * n_q:(i + 1) * n_q] for i in range(n_chunks)]
        own = saved[n_chunks * n_q:n_chunks * n_q + n_own]
        extra = saved[n_chunks * n_q + n_own:]
        idx = axis_index(mesh, axis)
        b, h, c, _, d = dims
        m = n_own // n_chunks
        ops = [kind.operands(q_res[i], own[:m], extra, *(x.chunk(n_chunks, 2)[i] for x in
                                                         (o, lse, do)), dims, sm_scale)
               for i in range(n_chunks)]
        dq = [torch.zeros((b * h_kv, h // h_kv, c, d), dtype=torch.float32, device=o.device)
              for _ in range(n_chunks)]
        acc = [torch.zeros((b * h_kv, c, d), dtype=torch.float32, device=o.device)
               for _ in range(2 * n_chunks)]  # dK, dV of each chunk in front
        for step, src, blk in ring_steps(own, mesh, axis):
            for qc, kc, causal, q_off, k_off in pieces(step, src, idx):
                dk_p, dv_p, dq_p = kind.backward(ops[qc], blk[kc * m:(kc + 1) * m], causal,
                                                 q_off, k_off)
                dq[qc] += dq_p
                acc[2 * kc] += dk_p
                acc[2 * kc + 1] += dv_p
            acc = ppermute(acc, mesh, axis)  # they follow their chunks: home after n hops
        shape = (b, h_kv, c * n_chunks, d)
        dk = torch.cat(acc[0::2], 1).reshape(shape)
        dv = torch.cat(acc[1::2], 1).reshape(shape)
        dq = torch.cat([x.reshape(b, h, c, d) for x in dq], 2)
        return (dq.to(q_dtype), dk.to(k_dtype), dv.to(v_dtype), *[None] * 6)


def _contiguous_pieces(causal: bool, t: int):
    """The contiguous ring's pieces: one a step, the whole shard src at the
    global offsets (q_offset idx * t, k_offset src * t), so the diagonal
    masks k <= q and the past shards mask nothing. A future shard (src >
    idx, causal) is skipped on the host: JAX's lax.cond on src < idx."""

    def pieces(step, src, idx):
        if causal and src > idx:
            return []
        return [(0, 0, causal, idx * t, src * t)]

    return pieces


def ring_attention(q, k, v, mesh, axis: str = "context", causal: bool = False,
                   sm_scale: float | None = None, kind: str = "bf16") -> torch.Tensor:
    """Ring attention on this rank's shards: q [b, h, t_local, d], k/v [b,
    h_kv, t_local, d], the sequence split identically over `axis` (rank
    coordinate i holds positions i * t_local on). kind "bf16" (B1; backward
    B2 + B3 fast) or "int8" (B4 once, B5 a live step; backward B7 + B8).
    Differentiable; returns this rank's O shard in f32."""
    if kind not in _KINDS:
        raise ValueError(f"unknown ring kind {kind!r}")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"q and k/v shards must hold the same tokens: {q.shape[2]} != "
                         f"{k.shape[2]}")
    return _Ring.apply(q, k, v, mesh, axis, sm_scale, _KINDS[kind],
                       _contiguous_pieces(causal, q.shape[2]), 1)


def make_ring_attention(mesh, kind: str = "bf16", causal: bool = False,
                        sm_scale: float | None = None, context_axis: str = "context"):
    """(q, k, v) -> O on this rank's (batch, head, sequence) block of `mesh`:
    batch on data, heads on model, tokens on context (`spec`; cut the blocks
    from full tensors with `shard_tensor`). The counterpart of JAX's
    make_ring_attention, on local blocks as parallel/sharded.py's
    make_sharded_attention."""

    def sharded(q, k, v):
        return ring_attention(q, k, v, mesh, context_axis, causal=causal, sm_scale=sm_scale,
                              kind=kind)

    sharded.spec = ("data", "model", context_axis, None)
    return sharded


# --------------------------------------------------------------------------
# The JVP ring: sequence-parallel (O, tO) for long-context rCM distillation
# --------------------------------------------------------------------------

def _merge_jvp_partials(acc, part):
    """Merge two normalized JVP partials (O, tO [..., t, d], lse, mu [..., t])
    exactly (JAX ring.py:375-391): with w = exp2(lse - max), O and mu are the
    w-weighted means, and tO the weighted mean of the de-centred tO + mu O
    less mu O. Both lse -inf gives zeros and lse -inf."""
    o1, to1, lse1, mu1 = acc
    o2, to2, lse2, mu2 = part
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(lse1), torch.exp2(lse1 - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(lse2), torch.exp2(lse2 - m_safe), 0.0)
    l = w1 + w2
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    mu = (mu1 * w1 + mu2 * w2) / l_safe
    num = ((to1 + mu1[..., None] * o1) * w1[..., None]
           + (to2 + mu2[..., None] * o2) * w2[..., None]) / l_safe[..., None]
    to = num - mu[..., None] * o
    lse = torch.where(l == 0.0, -torch.inf, m + torch.log2(l_safe))
    return o, to, lse, mu


def _live(causal: bool, src: int, idx: int):
    """Whether shard src is attended by this rank's queries, and causally:
    (live, causal of the piece)."""
    if not causal:
        return True, False
    return src <= idx, src == idx


class _RingJVP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, tq, tk, tv, mesh, axis, causal, sm_scale, fast):
        idx = axis_index(mesh, axis)
        o, lse = _empty_partial(q)
        acc = (o, torch.zeros_like(o), lse, torch.zeros_like(lse))
        own = [x.contiguous() for x in (k, v, tk, tv)]
        for _, src, blk in ring_steps(own, mesh, axis):
            live, piece_causal = _live(causal, src, idx)
            if live:
                part = attention_jvp_fwd(q, blk[0], blk[1], tq, blk[2], blk[3],
                                         causal=piece_causal, sm_scale=sm_scale, fast=fast)
                acc = _merge_jvp_partials(acc, part)
        o, to, lse, mu = acc
        ctx.save_for_backward(q, *own, tq, o, to, lse, mu)
        ctx.args = (mesh, axis, causal, sm_scale, fast, tuple(x.dtype for x in (q, k, v, tq, tk,
                                                                                tv)))
        return o, to

    @staticmethod
    def backward(ctx, do, dto):
        q, k, v, tk, tv, tq, o, to, lse, mu = ctx.saved_tensors
        mesh, axis, causal, sm_scale, fast, dtypes = ctx.args
        idx = axis_index(mesh, axis)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dtq = torch.zeros_like(dq)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for _ in range(4)]
        for _, src, blk in ring_steps([k, v, tk, tv], mesh, axis):
            live, piece_causal = _live(causal, src, idx)
            if live:
                dq_p, dk_p, dv_p, dtq_p, dtk_p, dtv_p = attention_jvp_bwd(
                    q, blk[0], blk[1], tq, blk[2], blk[3], o, to, lse, mu, do, dto,
                    causal=piece_causal, sm_scale=sm_scale, fast=fast)
                dq += dq_p
                dtq += dtq_p
                for a, g in zip(acc, (dk_p, dv_p, dtk_p, dtv_p)):
                    a += g
            acc = ppermute(acc, mesh, axis)  # they follow their shards: home after n hops
        grads = (dq, acc[0], acc[1], dtq, acc[2], acc[3])
        return (*(g.to(dt) for g, dt in zip(grads, dtypes)), None, None, None, None, None)


def ring_attention_jvp(q, k, v, tq, tk, tv, mesh, axis: str = "context", causal: bool = False,
                       sm_scale: float | None = None, fast: bool = False):
    """Sequence-parallel (O, tO) of attention and its tangent on this rank's
    shards: q/k/v and tq/tk/tv [b, h, t_local, d] (one head count), the
    sequence split identically over `axis`. B9 a live ring step (fast: its
    bf16-operand mode); differentiable in reverse mode in all six inputs
    through the second-order ring (B11 + B12 a live step). Returns this
    rank's (O, tO) shards in f32."""
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"q and k/v shards must hold the same tokens: {q.shape[2]} != "
                         f"{k.shape[2]}")
    return _RingJVP.apply(q, k, v, tq, tk, tv, mesh, axis, causal, sm_scale, fast)
