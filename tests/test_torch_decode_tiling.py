"""The decode kernels' launch geometry and arithmetic (csrc/cache_decode.cu,
one kernel body, geometry in parallel/decode_tiling.py, launch in
parallel/decode_launch.py): B13 over the slotted int8 cache, B14 over the
paged int8 pool, B15 over the slotted int4 cache and B16 over the paged
int4 pool. The kernels run only on the card; chip_smoke.py holds them
against their plain versions there.

Checked here, on the CPU, for both payloads:
(a) the maps: every token below the capacity falls in exactly one (chunk,
    tile, slot); a chunk stages each payload row once: int4, each byte row
    at the slot of its owner, the row and nibble a slot reads holding that
    slot's token, for the slotted pack blocks of 256, pages of 128 and 256
    and odd page sizes; int8, each live token's row at its own slot, for
    the slotted row and pages of 128, 256, 6 and 100; no page at or past
    ceil(length / page_size) is staged; the grid, the live chunks, the tiles
    and the merged chunks cover every live token; the wrappers' launch takes
    z from the grid of the capacity and reads no length on the host;
(b) a torch emulation of the kernel's arithmetic (the payload rows staged as
    the map says, the online softmax over 128-token tiles in token order,
    bf16(p * sv) against the integer V, the lse merge in chunk order)
    against the plain versions (`decode_attention_plain`,
    `paged_decode_attention_plain`, `decode_attention_int4_plain`,
    `paged4_decode_attention_plain`) with NaN/inf stale scales and junk
    pages, and against the JAX kernels (`decode_attention`,
    `paged_decode_attention`, `decode_attention_int4`,
    `paged4_decode_attention` and their verify forms) on finite scales,
    within chip_smoke.py's DECODE_TOL;
(c) the emulation's verify row j equal, bit for bit, to its spec = 1 run
    at length len - spec + 1 + j;
(d) the emulation on the paged pools' shuffled pages equal, bit for bit, to
    the slotted caches' on the same token values (B14 to B13, B16 to B15).
The grid, scratch and shared bytes are held at both head dims of the int8
instance (B13 takes 64 and 128: one block an SM at 128).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedattention_tpu.parallel import kv4_cache as j4
from quantizedattention_tpu.parallel import kv_cache as jkv
from quantizedattention_tpu.parallel import paged4_cache as jp4
from quantizedattention_tpu.parallel import paged_cache as jpc
from quantizedattention_tpu_torch.ops.common import qk_scales
from quantizedattention_tpu_torch.parallel import decode_launch as dl
from quantizedattention_tpu_torch.parallel import decode_tiling as dt
from quantizedattention_tpu_torch.parallel import kv4_cache as t4
from quantizedattention_tpu_torch.parallel import kv_cache as tkv
from quantizedattention_tpu_torch.parallel import paged4_cache as tp4
from quantizedattention_tpu_torch.parallel import paged_cache as tpc

torch.set_num_threads(2)

DECODE_TOL = 5e-3  # chip_smoke.py's: the tile and chunk order move where P rounds to bf16
LENGTHS = [0, 1, 127, 128, 255, 256, 257, 1000, 1280]
CAP = 1280
N_KV = 2
LAYOUTS = ["slotted", "paged128", "paged256"]


# --------------------------------------------------------------------------
# (a) the maps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [256, 128, 6, 100, 384, 512])
def test_every_token_has_one_slot_and_its_owner_holds_it(page_size):
    cap = 3 * 512
    seen = set()
    for t in range(cap):
        chunk, tile, slot = dt.token_slot(t)
        assert chunk * dt.CHUNK + tile * dt.TILE + slot == t
        assert 0 <= tile < dt.CHUNK // dt.TILE and 0 <= slot < dt.TILE
        seen.add((chunk, tile, slot))
        # the byte row staged at the owner's slot, and the nibble, hold token t
        s = t % dt.CHUNK
        own = dt.owner(page_size, s, chunk)
        page, row, _ = dt.slot_source(page_size, chunk * dt.CHUNK + own)
        _, own_row, hi = dt.slot_source(page_size, t)
        assert own_row == row and 0 <= own <= s
        assert page * page_size + row + (page_size // 2 if hi else 0) == t
    assert len(seen) == cap
    assert dt.n_chunks(cap) * dt.CHUNK >= cap


@pytest.mark.parametrize("page_size", [256, 128, 6, 100, 384, 512])
@pytest.mark.parametrize("length", [0, 1, 127, 128, 255, 257, 1000, 1536])
def test_each_byte_row_is_staged_once_per_chunk(page_size, length):
    cap = 1536
    half = page_size // 2
    for chunk in range(dt.live_chunks(length, cap)):
        rows = dt.staged_rows(page_size, chunk, length)
        assert len(set(rows.values())) == len(rows)  # a byte row once per chunk
        for s in range(dt.CHUNK):
            t = chunk * dt.CHUNK + s
            if t < length:  # every live token's row is staged, at its owner
                page, row, _ = dt.slot_source(page_size, t)
                assert rows[dt.owner(page_size, s, chunk)] == (page, row)
        # pages at or past ceil(length / page_size) are never read
        assert all(page < -(-length // page_size) for page, _ in rows.values())
        if page_size in (128, 256) and length >= (chunk + 1) * dt.CHUNK:
            # a pack block or whole pages: 128 rows feed both their tokens
            assert len(rows) == dt.CHUNK // 2
            assert all(dt.owner(page_size, s, chunk) == s for s in rows)
            assert all(row < half for _, row in rows.values())


@pytest.mark.parametrize("length", LENGTHS)
def test_live_chunks_tiles_and_merged_chunks_cover_the_live_tokens(length):
    covered = []
    for chunk in range(dt.live_chunks(length, CAP)):
        for tile in range(dt.tiles(length, chunk)):
            covered += range(chunk * dt.CHUNK + tile * dt.TILE,
                             chunk * dt.CHUNK + (tile + 1) * dt.TILE)
    assert set(range(length)) <= set(covered)
    assert all(t < length + dt.TILE - 1 for t in covered)
    assert dt.live_chunks(length, CAP) >= 1  # chunk 0 always runs
    for spec in (1, 2, 5):
        for r in range(2 * spec):
            lim = dt.row_limit(length, spec, r)
            assert dt.row_chunks(lim) <= dt.live_chunks(length, CAP)
            assert dt.row_chunks(lim) * dt.CHUNK >= max(lim, 0)


@pytest.mark.parametrize("d", dt.HEAD_DIMS_INT8)
@pytest.mark.parametrize("n_kv,n_seqs,capacity", [(16, 8, 1280), (4, 8, 1280), (4, 8, 1408),
                                                   (16, 1, 512), (2, 9, 1280), (16, 64, 256)])
@pytest.mark.parametrize("length", [0, 1, 255, 256, 304, 1000, 1280])
def test_blocks_take_every_live_chunk_once(n_kv, n_seqs, capacity, length, d):
    _, _, z = dt.grid(n_kv, n_seqs, capacity, head_dim=d)
    assert 1 <= z <= dt.n_chunks(capacity)
    assert n_kv * n_seqs * z <= max(dt.resident(d) * dt.H100_SMS, n_kv * n_seqs)
    taken = [c for b in range(z) for c in dt.block_chunks(b, z, length, capacity)]
    assert sorted(taken) == list(range(dt.live_chunks(length, capacity)))


@pytest.mark.parametrize("d", dt.HEAD_DIMS_INT8)
def test_grid_and_scratch_follow_the_capacity(d):
    # 256 blocks at 64 (two an SM), 128 at 128 (one an SM): none idle at the serving decode
    assert dt.grid(16, 8, 1280, head_dim=d) == (16, 8, 2 if d == 64 else 1)
    assert dt.grid(4, 8, 1280, head_dim=d) == (4, 8, 5 if d == 64 else 4)
    assert dt.grid(4, 8, 11 * 128, head_dim=d) == (4, 8, 6 if d == 64 else 4)
    assert dt.grid(16, 64, 1280, head_dim=d) == (16, 64, 1)
    acc, ml = dt.scratch_shapes(8, 16, 5, 1280, d)
    assert acc == (8, 16, 5, 5, d) and ml == (8, 16, 5, 5, 2)
    for bad in ((16, 0, 1280), (16, 70000, 1280), (16, 8, 0), (0, 8, 1280)):
        with pytest.raises(ValueError):
            dt.grid(*bad, head_dim=d)
    for payload in dt.PAYLOADS:  # resident(d) blocks an SM, each under the 227 KB a block may take
        assert dt.shared_bytes(payload, d) % 16 == 0
        assert dt.resident(d) * (dt.shared_bytes(payload, d) + 1024) <= 228 * 1024
        assert dt.shared_bytes(payload, d) <= 232_448
    assert dt.resident(d) == (2 if d == 64 else 1)
    assert dt.shared_bytes("int8", 64) < dt.shared_bytes("int4", 64)  # no slot sources
    with pytest.raises(ValueError):
        dt.shared_bytes("int2", d)
    with pytest.raises(ValueError):  # the int4 kernels (B15/B16) take head dim 64 or 128
        dt.shared_bytes("int4", 96)


# --------------------------------------------------------------------------
# The same token values in both layouts
# --------------------------------------------------------------------------


def _values(seed, n=len(LENGTHS), cap=CAP):
    """Random int4 token values [n, N_KV, cap, 64] of K and V and their
    scales [n, N_KV, cap]."""
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(rng.integers(-8, 8, (n, N_KV, cap, 64))).to(torch.int8)
            for _ in range(2))
    sk, sv = (torch.from_numpy(rng.uniform(0.02, 0.3, (n, N_KV, cap)).astype(np.float32))
              for _ in range(2))
    return k, sk, v, sv


def _stale(sk, sv, lengths):
    """NaN K scales and inf V scales past each row's length."""
    dead = torch.arange(sk.shape[-1])[None, None] >= torch.tensor(lengths)[:, None, None]
    return torch.where(dead, torch.nan, sk), torch.where(dead, torch.inf, sv)


def _slotted(k, sk, v, sv, lengths):
    pack = (lambda x: t4._pack_halves((x & 0x0F).to(torch.int8), t4.PACK))
    return t4.Int4KVCache(pack(k), sk, pack(v), sv, torch.tensor(lengths, dtype=torch.int32))


def _paged(k, sk, v, sv, lengths, page_size, seed):
    """The paged int4 pool of the same token values: each row's pages below
    its length shuffled across the pool; page 0, the rows' other pages and
    every unowned page hold random bytes, NaN K and inf V scales."""
    n, h, cap, d = k.shape
    max_pages = cap // page_size
    n_pages = 1 + n * max_pages
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = torch.zeros((n, max_pages), dtype=torch.int32)
    for s, length in enumerate(lengths):
        owned = -(-length // page_size)
        table[s, :owned] = perm[s * max_pages: s * max_pages + owned]
    pools = []
    for x, sc, junk in ((k, sk, torch.nan), (v, sv, torch.inf)):
        pay = torch.randint(-128, 128, (h, n_pages, page_size // 2, d), generator=gen,
                            dtype=torch.int8)
        scales = torch.full((n_pages, h, page_size), junk)
        dense = t4._pack_halves((x & 0x0F).to(torch.int8), page_size)
        dense = dense.reshape(n, h, max_pages, page_size // 2, d)
        owned = table > 0
        pay[:, table[owned].long()] = dense.transpose(0, 1)[:, owned]
        scales[table[owned].long()] = sc.reshape(n, h, max_pages, page_size).transpose(1, 2)[owned]
        pools += [pay, scales]
    return tp4.Paged4KVCache(*pools, table, torch.tensor(lengths, dtype=torch.int32))


def _cache(layout, vals, lengths, seed):
    if layout == "slotted":
        return _slotted(*vals, lengths)
    return _paged(*vals, lengths, int(layout[5:]), seed)


def _launch_args(monkeypatch, launch, q, cache, sms):
    """The entry and arguments of one wrapper launch with its CUDA calls
    stubbed on the CPU; any read of a tensor on the host fails."""
    calls = []

    def entry(name):
        return lambda *args: calls.append((name, args)) or 0

    def host_read(*_):
        raise AssertionError("the launch read a tensor on the host")

    monkeypatch.setattr(dl, "_entry", entry)
    monkeypatch.setattr(dl, "_device_sms", lambda dev: sms)
    monkeypatch.setattr(dl, "require_cuda", lambda *tensors: tensors[0].device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 7})())
    for method in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, method, host_read)
    launch(q, cache, None, False, 1)
    monkeypatch.undo()
    (name, args), = calls
    assert args[-1] == 7
    return name, args


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sms", [132, 8])  # z = 5 (every chunk) and 2
def test_wrappers_launch_decode_tilings_grid(monkeypatch, layout, sms):
    """The int4 wrappers' launch with its CUDA calls stubbed on the CPU: the
    z it passes is decode_tiling.grid's for the cache's capacity and the
    device's SMs, and it reads no length back to the host."""
    lengths = [0, 300, 1280]
    cache = _cache(layout, _values(5, n=len(lengths)), lengths, 5)
    q = _q(5, 4, 1)[:len(lengths)]
    name, args = _launch_args(monkeypatch, t4._launch if layout == "slotted" else tp4._launch,
                              q, cache, sms)
    assert name == ("qa_decode4" if layout == "slotted" else "qa_paged4_decode")
    # z, before qk_scale and the stream
    assert args[-3] == dt.grid(N_KV, len(lengths), CAP, q.shape[-1], sms)[2]


# --------------------------------------------------------------------------
# The emulation of the kernel's arithmetic
# --------------------------------------------------------------------------


def _capacity(cache):
    if isinstance(cache, (t4.Int4KVCache, tkv.QuantizedKVCache)):
        return cache.max_len
    return cache.page_table.shape[1] * cache.page_size


def _staged8(cache, seq, h, length):
    """One (sequence, kv head) of an int8 cache as its blocks stage it: for
    each chunk that runs, the rows of `staged_rows` at their slots (zeros
    where no row is staged) with their scales. Returns token-order K, sk,
    V, sv over the chunks' slots."""
    cap = _capacity(cache)
    if isinstance(cache, tkv.QuantizedKVCache):
        ps = cap
        def at(x, page, row):
            return x[seq, h, page * ps + row]
        at_scale = at
    else:
        ps, table = cache.page_size, cache.page_table[seq].long()
        def at(x, page, row):
            return x[h, table[page], row]
        def at_scale(x, page, row):
            return x[table[page], h, row]
    slots = dt.live_chunks(length, cap) * dt.CHUNK
    out = [torch.zeros(slots, 64), torch.zeros(slots), torch.zeros(slots, 64), torch.zeros(slots)]
    for chunk in range(dt.live_chunks(length, cap)):
        rows = dt.staged_rows(ps, chunk, length, "int8")
        if rows:
            slot = [chunk * dt.CHUNK + s for s in rows]
            page, row = (torch.tensor(c) for c in zip(*rows.values()))
            for i in (0, 2):
                out[i][slot] = at(cache[i], page, row).float()
                out[i + 1][slot] = at_scale(cache[i + 1], page, row)
    return out


def _staged(cache, seq, h, length):
    """One (sequence, kv head) as its blocks stage it: for each chunk that
    runs, the byte rows of `staged_rows` at their owner's slot (zeros where
    no row is staged), each slot's nibble, and the scales of the tokens below
    the length (zeros past it). Returns token-order K, sk, V, sv over the
    chunks' slots."""
    if isinstance(cache, (tkv.QuantizedKVCache, tpc.PagedKVCache)):
        return _staged8(cache, seq, h, length)
    if isinstance(cache, t4.Int4KVCache):
        ps, cap = t4.PACK, cache.max_len
        def rows_of(x, page, row):
            return x[seq, h, page * (ps // 2) + row]
        def scales_of(x, page, in_page):
            return x[seq, h, page * ps + in_page]
    else:
        ps, cap = cache.page_size, cache.page_table.shape[1] * cache.page_size
        table = cache.page_table[seq].long()
        def rows_of(x, page, row):
            return x[h, table[page], row]
        def scales_of(x, page, in_page):
            return x[table[page], h, in_page]
    slots = dt.live_chunks(length, cap) * dt.CHUNK
    out = [torch.zeros(slots, 64), torch.zeros(slots), torch.zeros(slots, 64), torch.zeros(slots)]
    for chunk in range(dt.live_chunks(length, cap)):
        rows = dt.staged_rows(ps, chunk, length)
        at, page, row, hi, s_at, s_page, s_in = [], [], [], [], [], [], []
        for s in range(dt.CHUNK):
            t = chunk * dt.CHUNK + s
            own = dt.owner(ps, s, chunk)
            if own in rows:
                at.append(t)
                page.append(rows[own][0])
                row.append(rows[own][1])
                hi.append(dt.slot_source(ps, t)[2])
            if t < length:
                s_at.append(t)
                s_page.append(dt.slot_source(ps, t)[0])
                s_in.append(t % ps)
        page, row, s_page, s_in = map(torch.tensor, (page, row, s_page, s_in))
        hi = torch.tensor(hi, dtype=torch.bool)[:, None]
        for i, (pay, sc) in enumerate(((cache[0], cache[1]), (cache[2], cache[3]))):
            if at:
                b = rows_of(pay, page, row).to(torch.int32)
                out[2 * i][at] = torch.where(hi, b >> 4, ((b & 15) ^ 8) - 8).float()
            if s_at:
                out[2 * i + 1][s_at] = scales_of(sc, s_page, s_in)
    return out


def _emulate(q, cache, spec=1, lengths=None):
    """The kernel's arithmetic on folded q [n, N_KV * rows, 64]: per q row, the
    chunks that run, each an online softmax over its 128-token tiles in
    order (s = (q . k) * (sk * qk_scale) masked at the row's limit, p =
    exp2(s - m), l sums p unrounded, acc += bf16(p * sv) . v, a tile the row
    does not see adding exact zeros), then the merge of the chunks holding a
    token the row sees, in chunk order. Each row alone, so a row's bits
    never depend on the others. `lengths` replaces the cache's."""
    n, n_q, d = q.shape
    rows = n_q // N_KV
    _, qk_scale = qk_scales(d, None)
    qb = q.to(torch.bfloat16).float()
    lengths = cache[-1].tolist() if lengths is None else lengths
    cap = _capacity(cache)
    o = torch.zeros(n, n_q, d)
    lse = torch.full((n, n_q), -torch.inf)
    ninf = torch.tensor(-torch.inf)
    for seq in range(n):
        length = min(max(lengths[seq], 0), cap)
        for h in range(N_KV):
            k, sk, v, sv = _staged(cache, seq, h, length)
            for r in range(rows):
                lim = dt.row_limit(length, spec, r)
                dots = (k * qb[seq, h * rows + r]).sum(-1)
                parts = []
                for chunk in range(dt.live_chunks(length, cap)):
                    m, l, acc = ninf, torch.tensor(0.0), torch.zeros(d)
                    for tile in range(dt.tiles(length, chunk)):
                        t0 = chunk * dt.CHUNK + tile * dt.TILE
                        sl = slice(t0, t0 + dt.TILE)
                        live = torch.arange(t0, t0 + dt.TILE) < lim
                        s = torch.where(live, dots[sl] * (sk[sl] * qk_scale), -torch.inf)
                        nm = torch.maximum(m, s.max())
                        alpha = torch.tensor(1.0) if nm == -torch.inf else torch.exp2(m - nm)
                        p = torch.where(live, torch.exp2(s - nm), 0.0)
                        l = l * alpha + p.sum()
                        w = torch.where(live, p * sv[sl], 0.0).to(torch.bfloat16).float()
                        acc = acc * alpha + (w[:, None] * v[sl]).sum(0)
                        m = nm
                    parts.append((acc, m, l))
                nc = dt.row_chunks(lim)
                if nc == 0:
                    continue
                mx = max(parts[c][1] for c in range(nc))
                big_l, big_o = torch.tensor(0.0), torch.zeros(d)
                for acc, m, l in parts[:nc]:
                    w = torch.exp2(m - mx)
                    big_l = big_l + l * w
                    big_o = big_o + acc * w
                o[seq, h * rows + r] = big_o / big_l
                lse[seq, h * rows + r] = mx + torch.log2(big_l)
    return o, lse


def _q(seed, group, spec):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((len(LENGTHS), N_KV * group * spec, 64),
                                                np.float32))


def _plain(layout, q, cache, spec):
    fn = t4.decode_attention_int4_plain if layout == "slotted" else tp4.paged4_decode_attention_plain
    return fn(q, cache, return_lse=True, spec=spec)


def _close(got, want, live):
    assert torch.isfinite(got[0]).all()
    assert (got[0] - want[0]).abs().max().item() <= DECODE_TOL
    assert (got[1][live] - want[1][live]).abs().max().item() <= DECODE_TOL
    assert torch.equal(torch.isneginf(got[1]), ~live)
    assert (got[0][~live] == 0).all()


def _live(lengths, rows, spec):
    lim = torch.tensor(lengths)[:, None] - (spec - 1) + torch.arange(N_KV * rows)[None] % spec
    return lim > 0


# --------------------------------------------------------------------------
# (b) the emulation against the plain versions and the JAX kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 1), (1, 2), (1, 5), (4, 5)])
def test_emulation_matches_plain_with_stale_scales(layout, group, spec):
    k, sk, v, sv = _values(1)
    sk, sv = _stale(sk, sv, LENGTHS)
    cache = _cache(layout, (k, sk, v, sv), LENGTHS, seed=2)
    q = _q(3, group, spec)
    _close(_emulate(q, cache, spec), _plain(layout, q, cache, spec),
           _live(LENGTHS, group * spec, spec))


def _jax_cache(cache):
    cls = j4.Int4KVCache if isinstance(cache, t4.Int4KVCache) else jp4.Paged4KVCache
    return cls(*(jnp.asarray(x.numpy()) for x in cache))


def _jax(layout, q, cache, spec):
    """The JAX kernel (interpret mode on the CPU) on the folded q: spec = 1
    through the decode entry (O and lse), else through the verify entry (O)."""
    jc = _jax_cache(cache)
    n, n_q, d = q.shape
    if spec == 1:
        fn = j4.decode_attention_int4 if layout == "slotted" else jp4.paged4_decode_attention
        o, lse = fn(jnp.asarray(q.numpy()), jc, return_lse=True)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    fn = j4.verify_decode_attention_int4 if layout == "slotted" else jp4.paged4_verify_attention
    o = fn(jnp.asarray(q.reshape(n, n_q // spec, spec, d).numpy()), jc)
    return torch.from_numpy(np.array(o)).reshape(n, n_q, d), None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 1), (1, 5)])
def test_emulation_matches_jax(layout, group, spec):
    vals = _values(4)
    cache = _cache(layout, vals, LENGTHS, seed=5)
    q = _q(6, group, spec)
    o, lse = _emulate(q, cache, spec)
    o_j, lse_j = _jax(layout, q, cache, spec)
    live = _live(LENGTHS, group * spec, spec)
    # only the live rows: the JAX verify kernel gives NaN for a query that
    # sees no token of a row that has some (its alpha is exp2(-inf - -inf))
    assert (o - o_j).abs()[live].max().item() <= DECODE_TOL
    assert (o[~live] == 0).all()
    if lse_j is not None:
        assert (lse[live] - lse_j[live]).abs().max().item() <= DECODE_TOL
        assert torch.isneginf(lse[~live]).all()


# --------------------------------------------------------------------------
# (c) verify rows and (d) B16 against B15, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("group,spec", [(1, 2), (1, 5), (4, 5)])
def test_verify_row_equals_spec1_at_its_length(layout, group, spec):
    k, sk, v, sv = _values(7)
    sk, sv = _stale(sk, sv, LENGTHS)
    cache = _cache(layout, (k, sk, v, sv), LENGTHS, seed=8)
    q = _q(9, group, spec)
    o, _ = _emulate(q, cache, spec)
    qv = q.reshape(len(LENGTHS), N_KV * group, spec, 64)
    ov = o.reshape(len(LENGTHS), N_KV * group, spec, 64)
    for j in range(spec):
        at = [max(n - spec + 1 + j, 0) for n in LENGTHS]
        one, _ = _emulate(qv[:, :, j].contiguous(), cache, 1, lengths=at)
        assert torch.equal(ov[:, :, j], one), f"row {j}"


@pytest.mark.parametrize("layout", ["paged128", "paged256"])
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 1), (1, 5)])
def test_paged_equals_slotted_bit_for_bit(layout, group, spec):
    k, sk, v, sv = _values(10)
    sk, sv = _stale(sk, sv, LENGTHS)
    q = _q(11, group, spec)
    got = _emulate(q, _cache(layout, (k, sk, v, sv), LENGTHS, seed=12), spec)
    want = _emulate(q, _cache("slotted", (k, sk, v, sv), LENGTHS, seed=12), spec)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert math.isinf(got[1][0, 0].item())  # length 0: O = 0, lse = -inf


# --------------------------------------------------------------------------
# The int8 payload (B13 slotted, B14 paged): (a) to (d)
# --------------------------------------------------------------------------

LAYOUTS8 = ["slotted", "paged128", "paged256", "paged6", "paged100"]


@pytest.mark.parametrize("page_size", [CAP, 128, 256, 6, 100])
@pytest.mark.parametrize("length", [0, 1, 127, 128, 255, 257, 1000, 1280])
def test_int8_every_live_token_is_staged_once_at_its_own_slot(page_size, length):
    cap = -(-CAP // page_size) * page_size  # the slotted row is one page of CAP tokens
    for chunk in range(dt.live_chunks(length, cap)):
        rows = dt.staged_rows(page_size, chunk, length, "int8")
        live = [s for s in range(dt.CHUNK) if chunk * dt.CHUNK + s < length]
        assert sorted(rows) == live  # each live token's row, at its own slot
        assert len(set(rows.values())) == len(rows)
        for s, (page, row) in rows.items():
            assert dt.owner(page_size, s, chunk, "int8") == s
            assert page * page_size + row == chunk * dt.CHUNK + s
            assert page < -(-length // page_size)  # no page past the length


def _values8(seed, n=len(LENGTHS), cap=CAP):
    """Random int8 token values [n, N_KV, cap, 64] of K and V and their
    scales [n, N_KV, cap] (chip_smoke.py's range)."""
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(rng.integers(-128, 128, (n, N_KV, cap, 64))).to(torch.int8)
            for _ in range(2))
    sk, sv = (torch.from_numpy(rng.uniform(0.002, 0.03, (n, N_KV, cap)).astype(np.float32))
              for _ in range(2))
    return k, sk, v, sv


def _paged8(k, sk, v, sv, lengths, page_size, seed):
    """The paged int8 pool of the same token values: each row's pages below
    its length shuffled across the pool; page 0, the rows' other pages and
    every unowned page hold random bytes, NaN K and inf V scales."""
    n, h, cap, d = k.shape
    max_pages = -(-cap // page_size)
    pad = max_pages * page_size - cap
    n_pages = 1 + n * max_pages
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = torch.zeros((n, max_pages), dtype=torch.int32)
    for s, length in enumerate(lengths):
        owned = -(-length // page_size)
        table[s, :owned] = perm[s * max_pages: s * max_pages + owned]
    owned = table > 0
    pools = []
    for x, sc, junk in ((k, sk, torch.nan), (v, sv, torch.inf)):
        pay = torch.randint(-128, 128, (h, n_pages, page_size, d), generator=gen, dtype=torch.int8)
        scales = torch.full((n_pages, h, page_size), junk)
        dense = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n, h, max_pages, page_size, d)
        pay[:, table[owned].long()] = dense.transpose(0, 1)[:, owned]
        dense_s = torch.nn.functional.pad(sc, (0, pad)).reshape(n, h, max_pages, page_size)
        scales[table[owned].long()] = dense_s.transpose(1, 2)[owned]
        pools += [pay, scales]
    return tpc.PagedKVCache(*pools, table, torch.tensor(lengths, dtype=torch.int32))


def _cache8(layout, vals, lengths, seed):
    if layout == "slotted":
        return tkv.QuantizedKVCache(*vals[:4], torch.tensor(lengths, dtype=torch.int32))
    return _paged8(*vals, lengths, int(layout[5:]), seed)


@pytest.mark.parametrize("layout", LAYOUTS8)
@pytest.mark.parametrize("sms", [132, 8])  # z = 5 (every chunk) and 2
def test_int8_wrappers_launch_decode_tilings_grid(monkeypatch, layout, sms):
    """The int8 wrappers' launch with its CUDA calls stubbed on the CPU: the
    z it passes is decode_tiling.grid's for the cache's capacity and the
    device's SMs, q goes in as it comes (f32, rounded in the kernel), and
    it reads no length back to the host."""
    lengths = [0, 300, 1280]
    cache = _cache8(layout, _values8(5, n=len(lengths)), lengths, 5)
    q = _q(5, 4, 1)[:len(lengths)]
    name, args = _launch_args(monkeypatch, tkv._launch if layout == "slotted" else tpc._launch,
                              q, cache, sms)
    assert name == ("qa_decode" if layout == "slotted" else "qa_paged_decode")
    assert args[-3] == dt.grid(N_KV, len(lengths), _capacity(cache), q.shape[-1], sms)[2]
    assert args[0] == q.data_ptr() and args[len(cache) + 6] == 1  # q's own f32, q_f32 = 1


def _plain8(layout, q, cache, spec):
    fn = tkv.decode_attention_plain if layout == "slotted" else tpc.paged_decode_attention_plain
    return fn(q, cache, return_lse=True, spec=spec)


@pytest.mark.parametrize("layout", LAYOUTS8)
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 1), (1, 5)])
def test_int8_emulation_matches_plain_with_stale_scales(layout, group, spec):
    k, sk, v, sv = _values8(21)
    sk, sv = _stale(sk, sv, LENGTHS)
    cache = _cache8(layout, (k, sk, v, sv), LENGTHS, seed=22)
    q = _q(23, group, spec)
    _close(_emulate(q, cache, spec), _plain8(layout, q, cache, spec),
           _live(LENGTHS, group * spec, spec))


def _jax8(layout, q, cache, spec):
    """The JAX int8 kernel (interpret mode on the CPU) on the folded q, as
    `_jax` for int4."""
    cls = jkv.QuantizedKVCache if layout == "slotted" else jpc.PagedKVCache
    jc = cls(*(jnp.asarray(x.numpy()) for x in cache))
    n, n_q, d = q.shape
    if spec == 1:
        fn = jkv.decode_attention if layout == "slotted" else jpc.paged_decode_attention
        o, lse = fn(jnp.asarray(q.numpy()), jc, return_lse=True)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    fn = jkv.verify_decode_attention if layout == "slotted" else jpc.paged_verify_attention
    o = fn(jnp.asarray(q.reshape(n, n_q // spec, spec, d).numpy()), jc)
    return torch.from_numpy(np.array(o)).reshape(n, n_q, d), None


@pytest.mark.parametrize("layout", ["slotted", "paged128", "paged256"])
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 1), (1, 5)])
def test_int8_emulation_matches_jax(layout, group, spec):
    cache = _cache8(layout, _values8(24), LENGTHS, seed=25)
    q = _q(26, group, spec)
    o, lse = _emulate(q, cache, spec)
    o_j, lse_j = _jax8(layout, q, cache, spec)
    live = _live(LENGTHS, group * spec, spec)
    # the live rows only, as for int4: JAX's verify gives NaN where a query sees nothing
    assert (o - o_j).abs()[live].max().item() <= DECODE_TOL
    assert (o[~live] == 0).all()
    if lse_j is not None:
        assert (lse[live] - lse_j[live]).abs().max().item() <= DECODE_TOL
        assert torch.isneginf(lse[~live]).all()


@pytest.mark.parametrize("layout", ["slotted", "paged128", "paged6"])
@pytest.mark.parametrize("group,spec", [(1, 2), (4, 5)])
def test_int8_verify_row_equals_spec1_at_its_length(layout, group, spec):
    k, sk, v, sv = _values8(27)
    sk, sv = _stale(sk, sv, LENGTHS)
    cache = _cache8(layout, (k, sk, v, sv), LENGTHS, seed=28)
    q = _q(29, group, spec)
    o, _ = _emulate(q, cache, spec)
    qv = q.reshape(len(LENGTHS), N_KV * group, spec, 64)
    ov = o.reshape(len(LENGTHS), N_KV * group, spec, 64)
    for j in range(spec):
        at = [max(n - spec + 1 + j, 0) for n in LENGTHS]
        one, _ = _emulate(qv[:, :, j].contiguous(), cache, 1, lengths=at)
        assert torch.equal(ov[:, :, j], one), f"row {j}"


@pytest.mark.parametrize("layout", ["paged128", "paged256", "paged6", "paged100"])
@pytest.mark.parametrize("group,spec", [(1, 1), (4, 5)])
def test_int8_paged_equals_slotted_bit_for_bit(layout, group, spec):
    k, sk, v, sv = _values8(30)
    sk, sv = _stale(sk, sv, LENGTHS)
    q = _q(31, group, spec)
    got = _emulate(q, _cache8(layout, (k, sk, v, sv), LENGTHS, seed=32), spec)
    want = _emulate(q, _cache8("slotted", (k, sk, v, sv), LENGTHS, seed=32), spec)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert math.isinf(got[1][0, 0].item())  # length 0: O = 0, lse = -inf
