// Decode attention over the four KV caches, for Hopper (sm_90a), plain C
// ABI: one query per sequence (spec == 1) or the speculative-verify
// staircase of `spec` consecutive queries. One kernel body, two payloads,
// four entries:
//
//   qa_decode        replaces quantizedattention_tpu/parallel/kv_cache.py:
//                    _decode_kernel (decode_kernel<int8>, B13);
//   qa_paged_decode  replaces quantizedattention_tpu/parallel/paged_cache.py:
//                    _paged_decode_kernel (decode_kernel<int8>, B14);
//   qa_decode4       replaces quantizedattention_tpu/parallel/kv4_cache.py:
//                    _decode4_kernel (decode_kernel<int4>, B15);
//   qa_paged4_decode replaces quantizedattention_tpu/parallel/paged4_cache.py:
//                    _paged4_decode_kernel (decode_kernel<int4>, B16).
//
// Numerics (the JAX kernels'): q and the integer K/V are taken as bf16 (int8
// and int4 values are exact in bf16, and so is each product with a bf16 q in
// f32), s = (q . k) * (sk * qk_scale) in f32, masked tokens get -inf, p =
// exp2(s - m) with the online running max over 128-token tiles in token
// order, l sums the UNROUNDED p, and the PV operand is bf16(p * sv) against
// the integer V. The q rows of a kv head fold (GQA group, spec) as r = g *
// spec + j; row r attends tokens t < length - (spec - 1) + r % spec, the JAX
// kernels' staircase, and a row with no live token gives O = 0 and lse =
// -inf.
//
// Layouts (the JAX package's). A sequence's tokens live in "pages" of ps
// tokens; page j of sequence s is table[s, j] (paged) or j itself (slotted:
// the int8 row is one page of max_len tokens, the int4 row's pages are its
// 256-token pack blocks). A page holds ps payload rows of int8 values, or
// ps/2 byte rows of int4 pairs: byte row r holds the page's token r in its
// low nibble and token r + ps/2 in its high nibble. Scales are per token,
// f32.
//
// What bounds them on this card: each step streams every live token's K and
// V payload (2 * 64 bytes for int8, 2 * 32 for int4) and two f32 scales once
// per (sequence, kv head), plus the row's page-table entries, and does about
// 4 * group FLOP per byte: far below the FLOP/byte ridge, so they are
// HBM-bound on the K/V stream at long lengths and latency-bound at the
// serving lengths (a few hundred tokens: 5.3 MB of int8 at 8 x 16 heads x
// 304 tokens, 1.6 us of HBM time).
//
// Design (geometry in parallel/decode_tiling.py), for the latency they are
// bound by:
// - A kv split with an lse merge. Chunk c is tokens [CH c, CH c + CH), CH =
//   256. The grid is (kv head, sequence, z), z = min(chunks of the capacity,
//   2 * SMs / pairs): sized from the capacity, never from a length (the
//   wrapper reads no length on the host), and no larger than the card holds
//   at once, so at the serving shape no block is launched only to find its
//   chunk past the length. Block z takes chunks z, z + Z, ... below the
//   length (chunk 0 always runs), each chunk's copies in flight while the one
//   before is computed. A chunk's unnormalised partial (acc, m, l) per q row
//   goes to scratch; the last block of the (kv head, sequence) to arrive
//   (through a counter it resets) merges them: a row's partials in chunk
//   order over the chunks holding a token it sees, M = max m_c, L = sum l_c
//   2^(m_c - M), O = sum acc_c 2^(m_c - M) / L, lse = M + log2 L. (A second
//   launch to merge was 0.7-2.6 us slower: kernel_probe.py decode4.)
// - Two round trips to device memory before the first product. The length,
//   the table entries of a thread's first copies (clamped into the row:
//   always in bounds) and q's first m-tile (cp.async to shared memory, so no
//   thread waits for q before the length) in one; every payload and scale
//   copy of the chunk at once with cp.async in the next, zero-filled
//   (nothing read) for a token past the length, so no page past the length,
//   page 0 included, is touched, and a stale scale never reaches a product.
// - The payload. int4: each packed byte row is staged once for both its
//   tokens, at the slot of its "owner" (the low-nibble token, or a
//   high-nibble token whose low partner lies in another chunk); a 256-token
//   pack block or whole pages of 128 or 256 fill a chunk's 128 rows exactly,
//   and the nibbles are widened where the fragments are built, on the logic
//   and bf16x2 FMA pipes (signed_nibbles_to_bf16x2). int8: each token's 64-
//   byte row is staged at its own slot, the rows swapped in pairs and their
//   32-byte halves every four rows (row8), so that both products' fragment
//   reads are free of bank conflicts; the bytes are widened by byte permutes
//   and f32 adds (widen4, widen_pair). No conversion instruction either way.
// - Every thread works at a group of 1: 8 warps, the chunk's two 128-token
//   tiles side by side, 32 tokens a warp; both products run on mma.sync
//   m16n8k16 with the q rows padded to 16 (m-tiles of 16 rows, one at G *
//   spec <= 16; rows 8-15 of a tile skip the softmax at G * spec <= 8). S
//   reads a token's 16-byte piece of K into B fragments directly (the head
//   dims permuted within a thread's k slots, q's A fragments permuted
//   alike); P's C fragments are PV's A fragments; PV reads 8 bytes of V per
//   token, the output columns permuted (column g of n-tile n is dim 8 g +
//   n). One exchange of the warps' row maxima gives the online softmax's m
//   after tile 0 (m0) and after tile 1 (m1): tile 0 takes p against m0, tile
//   1 against m1, and the block sums tile 0's warps * 2^(m0 - m1) + tile 1's,
//   in warp order.
// - Bits do not depend on the layout, on the other rows or on the block
//   that computes a chunk: a token's slot, and so its place in every
//   fragment and sum, is its index in the chunk, so B14 equals B13 and B16
//   equals B15 on the same K/V, bit for bit; a row's sums read no other row,
//   a tile or chunk a row does not see adds exact zeros (alpha = 1, p = 0 by
//   select) or is not merged, so verify row j equals the spec == 1 launch at
//   length len - spec + 1 + j, bit for bit.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;          // head dim
constexpr int TILE = 128;      // tokens an online-softmax step
constexpr int CHUNK4 = 256;    // tokens a chunk, int4 (decode_tiling.CHUNK)
constexpr int CHUNK8 = 256;    // tokens a chunk, int8 (decode_tiling.CHUNK)
constexpr int THREADS = 256;   // 8 warps: 4 a tile, 32 tokens each
constexpr int WARPS = THREADS / 32;
constexpr int RESIDENT = 2;    // blocks an SM holds (shared memory, registers)
constexpr int M_ROWS = 16;     // q rows an mma.sync m-tile
constexpr int RED_ROW = D + 1; // padded row of the warps' partial acc
constexpr int MERGE_REG = 8;   // chunks a merging thread holds in registers

struct Pool {
  const int8_t* k;
  const float* sk;
  const int8_t* v;
  const float* sv;
  const int* table;   // [n_seqs, max_pages], or nullptr: page j is j
  const int* length;  // [n_seqs]
  int ps;             // tokens per page
  int max_pages;      // pages a sequence can hold
  // element offsets: payload row r of page p of (seq, kv head) sits at
  // pay_seq * seq + pay_head * kvh + pay_page * p + r * D; the scale of
  // in-page token t at sc_seq * seq + sc_head * kvh + sc_page * p + t
  long long pay_seq, pay_head, pay_page;
  long long sc_seq, sc_head, sc_page;
};

// Pool of pages [n_kv, n_pages, rpp, D] payload rows, scales [n_pages, n_kv, ps].
Pool paged_pool(const void* k, const void* sk, const void* v, const void* sv,
                const void* table, const void* lengths, int n_kv, int n_pages, int ps,
                int max_pages, int rpp) {
  Pool p;
  p.k = static_cast<const int8_t*>(k);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const int8_t*>(v);
  p.sv = static_cast<const float*>(sv);
  p.table = static_cast<const int*>(table);
  p.length = static_cast<const int*>(lengths);
  p.ps = ps;
  p.max_pages = max_pages;
  p.pay_seq = 0;
  p.pay_head = static_cast<long long>(n_pages) * rpp * D;
  p.pay_page = static_cast<long long>(rpp) * D;
  p.sc_seq = 0;
  p.sc_head = ps;
  p.sc_page = static_cast<long long>(n_kv) * ps;
  return p;
}

// Where a launch keeps its partials (decode_tiling.scratch_shapes).
struct Partials {
  float* acc;    // [n_seqs, n_kv, n_chunks, rows, D]
  float* ml;     // [n_seqs, n_kv, n_chunks, rows, 2]: m, l
  int* arrived;  // [n_seqs * n_kv], 0 between launches
  int n_chunks;
};

// One chunk's copies in shared memory. int4 (PACKED): packed byte rows at
// their owner's slot, and each slot's source; int8: each token's row at
// row8(slot, 0).
template <bool PACKED, int CH>
struct Stage {
  uint8_t k[CH][D];
  uint8_t v[CH][D];
  uint16_t src[CH];  // slot -> its owner's row offset in bytes | its nibble's shift (0 or 4)
  float sk[CH];
  float sv[CH];
};

template <int CH>
struct Stage<false, CH> {
  uint8_t k[CH][D];
  uint8_t v[CH][D];
  float sk[CH];
  float sv[CH];
};

template <bool PACKED, int CH>
struct Smem {
  Stage<PACKED, CH> stage[2];  // the chunk computed and the next one's copies in flight
  float q[M_ROWS][D];  // q's first m-tile, f32 or (in its first half) bf16
  float red_max[WARPS][M_ROWS];  // warp w: tile w / (warps a tile)
  float red_acc[WARPS][M_ROWS][RED_ROW];
  float red_l[WARPS][M_ROWS];
  float m[M_ROWS];
  float alpha[M_ROWS];
  int merges;
};

template <bool PACKED, int CH>
constexpr size_t smem_bytes() {
  return (sizeof(Smem<PACKED, CH>) + 15) & ~static_cast<size_t>(15);
}

// Byte b of int8 slot s's row in a stage: rows swapped in pairs every other
// pair, and 32-byte halves swapped every four rows. S's reads (a quarter of
// a warp: two rows whole) and PV's (half a warp: 32 bytes of four rows two
// apart) then hit 32 distinct banks; 16-byte pieces stay whole.
__device__ __forceinline__ int row8(int s, int b) {
  return (s ^ ((s >> 1) & 1)) * D + (b ^ ((s << 3) & 32));
}

// 4 bytes global -> shared, asynchronously; zero-filled and nothing read
// when !live (hopper.cuh's cp_async16 takes 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// The pages of this thread's copies of chunk `ch`: payload pieces (slot
// tid / 4 + 64 i, 16 bytes at 16 (tid % 4)) and a scale (slot tid), from
// the table clamped into the row (always in bounds, whatever ch).
struct ChunkPages {
  int pay[4];
  int sc;
};

template <int CH>
__device__ __forceinline__ ChunkPages chunk_pages(const Pool& c, const int* trow, int ch, int tid) {
  ChunkPages pg;
#pragma unroll
  for (int i = 0; i < CH / 64; ++i) {
    const int pj = min((ch * CH + tid / 4 + 64 * i) / c.ps, c.max_pages - 1);
    pg.pay[i] = trow ? trow[pj] : pj;
  }
  const int pj = min((ch * CH + tid) / c.ps, c.max_pages - 1);
  pg.sc = trow ? trow[pj] : pj;
  return pg;
}

// Start chunk ch's copies into `st` as one group: int4, each byte row once,
// at its owner's slot (a high-nibble slot whose low partner is in the chunk
// reads the partner's); int8, each token's row at its slot; and the scales;
// zero-filled, nothing read, past `len`.
template <bool PACKED, int CH>
__device__ __forceinline__ void stage_chunk(Stage<PACKED, CH>& st, const Pool& c, int seq,
                                            int kvh, int ch, int len, const ChunkPages& pg,
                                            int tid) {
  const int t0 = ch * CH;
  const int half = c.ps / 2;
  const int j = tid % 4;
  const int8_t* k_seq = c.k + c.pay_seq * seq + c.pay_head * kvh;
  const int8_t* v_seq = c.v + c.pay_seq * seq + c.pay_head * kvh;
#pragma unroll
  for (int i = 0; i < CH / 64; ++i) {
    const int s = tid / 4 + 64 * i;
    const int in_page = (t0 + s) % c.ps;
    int row = in_page;
    int at = row8(s, 16 * j);
    if constexpr (PACKED) {
      const bool hi = in_page >= half;
      if (hi && s >= half) continue;  // its low partner's copy feeds it
      row = hi ? in_page - half : in_page;
      at = s * D + 16 * j;
    }
    const bool live = t0 + s < len;
    const long long off = c.pay_page * pg.pay[i] + static_cast<long long>(row) * D + 16 * j;
    cp_async16(&st.k[0][0] + at, live ? k_seq + off : c.k, live);
    cp_async16(&st.v[0][0] + at, live ? v_seq + off : c.v, live);
  }
  if (CH == THREADS || tid < CH) {
    const int in_page = (t0 + tid) % c.ps;
    if constexpr (PACKED) {
      const bool hi = in_page >= half;
      st.src[tid] = static_cast<uint16_t>((hi && tid >= half ? tid - half : tid) * D + (hi ? 4 : 0));
    }
    const bool live = t0 + tid < len;
    const long long off = c.sc_seq * seq + c.sc_head * kvh + c.sc_page * pg.sc + in_page;
    cp_async4(&st.sk[tid], live ? c.sk + off : c.sk, live);
    cp_async4(&st.sv[tid], live ? c.sv + off : c.sv, live);
  }
  cp_async_commit();
}

// The merge of one (kv head, sequence): row r's partials in chunk order over
// the chunks holding a token it sees (a chunk it does not see is not read);
// a row that sees none gets O = 0 and lse = -inf. pbase: the partial index
// of the pair's chunk 0. Loads go through L2 (__ldcg): they read what other
// blocks wrote during the launch; up to MERGE_REG chunks' loads are all
// issued before the first is used.
template <int CH>
__device__ void merge_rows(const Partials& part, size_t pbase, size_t head0, int len, int rows,
                           int spec, float* __restrict__ o, float* __restrict__ lse) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    const int lim = len - (spec - 1) + r % spec;
    const int nc = lim <= 0 ? 0 : min(part.n_chunks, (lim + CH - 1) / CH);
    float mc[MERGE_REG], lc[MERGE_REG], ac[MERGE_REG];
    float mx = -INFINITY;
#pragma unroll
    for (int ch = 0; ch < MERGE_REG; ++ch) {
      if (ch < nc) {
        const size_t at = (pbase + ch) * rows + r;
        mc[ch] = __ldcg(part.ml + at * 2);
        lc[ch] = __ldcg(part.ml + at * 2 + 1);
        ac[ch] = __ldcg(part.acc + at * D + d);
        mx = fmaxf(mx, mc[ch]);
      }
    }
    for (int ch = MERGE_REG; ch < nc; ++ch)
      mx = fmaxf(mx, __ldcg(part.ml + ((pbase + ch) * rows + r) * 2));
    float l = 0.f;
    float acc = 0.f;
#pragma unroll
    for (int ch = 0; ch < MERGE_REG; ++ch) {
      if (ch < nc) {
        const float w = exp2f(mc[ch] - mx);
        l = fmaf(lc[ch], w, l);
        acc = fmaf(ac[ch], w, acc);
      }
    }
    for (int ch = MERGE_REG; ch < nc; ++ch) {
      const size_t at = (pbase + ch) * rows + r;
      const float w = exp2f(__ldcg(part.ml + at * 2) - mx);
      l = fmaf(__ldcg(part.ml + at * 2 + 1), w, l);
      acc = fmaf(__ldcg(part.acc + at * D + d), w, acc);
    }
    o[(head0 + r) * D + d] = nc == 0 ? 0.f : acc / l;
    if (d == 0) lse[head0 + r] = nc == 0 ? -INFINITY : mx + log2f(l);
  }
}

// q's A fragments of m-tile mt (rows g and g + 8; zeros past `rows`), from
// bf16 q or from f32 q rounded to bf16 here, with the k slots permuted as
// decode_kernel's K fragments read them. int4 (PACKED): k slot (ks, 2 j +
// e) holds dim 16 j + 4 ks + 2 e and slot (ks, 2 j + 8 + e) dim 16 j + 4 ks
// + 2 e + 1; int8: slot (ks, 2 j + e) dim 16 j + 4 ks + e and slot (ks, 2 j
// + 8 + e) dim 16 j + 4 ks + 2 + e.
template <bool PACKED>
__device__ __forceinline__ void load_q(const void* __restrict__ q_kv, bool q_f32, int mt,
                                       int rows, int g, int j, uint32_t (&qa)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * M_ROWS + g + 8 * h;
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // bf16 pairs of dims 16 j + 2 i, + 1
    if (r < rows && q_f32) {
      const float4* qr = static_cast<const float4*>(q_kv) + (r * D + 16 * j) / 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = qr[i];
        w[2 * i] = as_u32(__floats2bfloat162_rn(f.x, f.y));
        w[2 * i + 1] = as_u32(__floats2bfloat162_rn(f.z, f.w));
      }
    } else if (r < rows) {
      const uint4* qr = static_cast<const uint4*>(q_kv) + (r * D + 16 * j) / 8;
      const uint4 lo = qr[0];
      const uint4 hi = qr[1];
      w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
      w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (PACKED) {
        qa[ks][h] = __byte_perm(w[2 * ks], w[2 * ks + 1], 0x5410);
        qa[ks][2 + h] = __byte_perm(w[2 * ks], w[2 * ks + 1], 0x7632);
      } else {
        qa[ks][h] = w[2 * ks];
        qa[ks][2 + h] = w[2 * ks + 1];
      }
    }
  }
}

template <bool PACKED, int CH>
__global__ void __launch_bounds__(THREADS, RESIDENT)
decode_kernel(const void* __restrict__ q,  // [n_seqs, n_kv * rows, D], f32 or bf16
              Pool c, Partials part,
              float* __restrict__ o,    // [n_seqs, n_kv * rows, D]
              float* __restrict__ lse,  // [n_seqs, n_kv * rows]
              int n_kv, int rows, int spec, float qk_scale, int q_f32) {
  // rows: q rows per kv head, the GQA group times spec (row r = g * spec + j)
  constexpr int TILES = CH / TILE;    // a chunk's tiles, side by side
  constexpr int WPT = WARPS / TILES;  // warps a tile
  constexpr int TPW = TILE / WPT;     // tokens a warp
  constexpr int NT = TPW / 8;         // S's n-tiles a warp
  constexpr int KK = TPW / 16;        // PV's k-steps a warp
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem<PACKED, CH>& sm = *reinterpret_cast<Smem<PACKED, CH>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tile = warp / WPT;   // this warp's tile of the chunk
  const int g = (tid % 32) / 4;  // fragment row / column group
  const int j = tid % 4;         // thread within the quad
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int chunk = blockIdx.z;  // the first of chunks z, z + gridDim.z, ...
  const int* trow = c.table ? c.table + static_cast<size_t>(seq) * c.max_pages : nullptr;
  const size_t pair = static_cast<size_t>(seq) * n_kv + kvh;
  const void* q_kv = static_cast<const uint8_t*>(q) + pair * rows * D * (q_f32 ? 4 : 2);

  // One round trip: the length, the table entries of this thread's first
  // copies and q's first m-tile (copied to shared memory, so that nothing
  // waits for it before the length is known); then every copy of the first
  // chunk at once, and each later chunk's copies while the one before is
  // computed.
  const int length = c.length[seq];
  ChunkPages pg = chunk_pages<CH>(c, trow, chunk, tid);
  if (tid * 16 < M_ROWS * D * (q_f32 ? 4 : 2)) {
    const bool live = tid * 16 < rows * D * (q_f32 ? 4 : 2);
    cp_async16(reinterpret_cast<uint8_t*>(sm.q) + tid * 16,
               live ? static_cast<const uint8_t*>(q_kv) + tid * 16 : q, live);
  }
  const int len = min(max(length, 0), c.max_pages * c.ps);
  const int n_live = max(1, (len + CH - 1) / CH);
  if (chunk >= n_live) {  // no copy may land after the block is gone
    cp_async_wait<0>();
    return;
  }
  stage_chunk(sm.stage[0], c, seq, kvh, chunk, len, pg, tid);
  pg = chunk_pages<CH>(c, trow, chunk + gridDim.z, tid);

  for (int ch = chunk, it = 0; ch < n_live; ch += gridDim.z, ++it) {
    const Stage<PACKED, CH>& st = sm.stage[it & 1];
    if (ch + gridDim.z < n_live) {
      stage_chunk(sm.stage[(it + 1) & 1], c, seq, kvh, ch + gridDim.z, len, pg, tid);
      pg = chunk_pages<CH>(c, trow, ch + 2 * gridDim.z, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = ch * CH;
    const int n_tiles = min(max((len - t0 + TILE - 1) / TILE, 0), TILES);
    const bool runs = tile < n_tiles;  // warp-uniform
    const int base = tile * TILE + (warp % WPT) * TPW;  // the warp's first slot
    const size_t prow = (pair * part.n_chunks + ch) * rows;
    const uint8_t* k_bytes = &st.k[0][0];
    const uint8_t* v_bytes = &st.v[0][0];
    for (int mt = 0; n_tiles > 0 && mt * M_ROWS < rows; ++mt) {
      uint32_t qa[4][4];  // q's A fragments of the m-tile
      load_q<PACKED>(mt == 0 ? static_cast<const void*>(sm.q) : q_kv, q_f32, mt, rows, g, j, qa);
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * M_ROWS + g + 8 * h;
        lim[h] = r < rows ? len - (spec - 1) + r % spec : 0;
      }
      // rows g + 8 hold a q row only past 8 live rows (warp-uniform)
      const bool two = rows - mt * M_ROWS > 8;
      // S = q k^T of the warp's tokens (column g of n-tile n is slot base +
      // 8 n + g), scaled and masked at each row's limit; the row maxima. The
      // n-tiles' products alternate: back-to-back mma.sync are independent
      float s[NT][4];
      float mx[2] = {-INFINITY, -INFINITY};
      if (runs) {
        uint32_t kw[NT][4];  // [n][ks]: the token's 4 dims 16 j + 4 ks .. + 3
        int sh[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          uint4 x;
          if constexpr (PACKED) {
            const int at = st.src[base + 8 * n + g];
            x = *reinterpret_cast<const uint4*>(k_bytes + (at & ~63) + 16 * j);
            sh[n] = at & 4;
          } else {
            x = *reinterpret_cast<const uint4*>(k_bytes + row8(base + 8 * n + g, 16 * j));
          }
          kw[n][0] = x.x, kw[n][1] = x.y, kw[n][2] = x.z, kw[n][3] = x.w;
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if constexpr (PACKED) {
              const uint32_t y = kw[n][ks] >> sh[n];
              mma_bf16(s[n], qa[ks], signed_nibbles_to_bf16x2(y), signed_nibbles_to_bf16x2(y >> 8));
            } else {
              const uint2 b = widen4(kw[n][ks]);
              mma_bf16(s[n], qa[ks], b.x, b.y);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = base + 8 * n + 2 * j + e;
            const float scale = st.sk[slot] * qk_scale;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (h == 1 && !two) continue;
              const float x = t0 + slot < lim[h] ? s[n][2 * h + e] * scale : -INFINITY;
              s[n][2 * h + e] = x;
              mx[h] = fmaxf(mx[h], x);
            }
          }
        }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
      }
      if (j == 0) {
        sm.red_max[warp][g] = mx[0];
        sm.red_max[warp][g + 8] = mx[1];
      }
      // PV's V bytes (slots base + 16 kk + 2 j + {0, 1, 8, 9}, 8 bytes at dim
      // 8 g; int4 words shifted to their nibble) and the scales sv, read
      // before the barrier
      uint32_t vw[KK][4][2];
      float sv[NT][2];
      if (runs) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          if constexpr (PACKED) {
            const uint32_t at01 =
                *reinterpret_cast<const uint32_t*>(&st.src[base + 16 * kk + 2 * j]);
            const uint32_t at89 =
                *reinterpret_cast<const uint32_t*>(&st.src[base + 16 * kk + 2 * j + 8]);
            const uint32_t at[4] = {at01 & 0xFFFF, at01 >> 16, at89 & 0xFFFF, at89 >> 16};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const uint2 x = *reinterpret_cast<const uint2*>(v_bytes + (at[u] & ~63u) + 8 * g);
              vw[kk][u][0] = x.x >> (at[u] & 4);
              vw[kk][u][1] = x.y >> (at[u] & 4);
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int slot = base + 16 * kk + 2 * j + (u & 1) + 8 * (u >> 1);
              const uint2 x = *reinterpret_cast<const uint2*>(v_bytes + row8(slot, 8 * g));
              vw[kk][u][0] = x.x;
              vw[kk][u][1] = x.y;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 v2 = *reinterpret_cast<const float2*>(&st.sv[base + 8 * n + 2 * j]);
          sv[n][0] = v2.x;
          sv[n][1] = v2.y;
        }
      }
      __syncthreads();

      // the online softmax's m after tile 0 (m0) and after tile 1 (m1); this
      // warp's tile takes p = exp2(s - m) against its own (0 past a row's
      // limit, by select), l sums p unrounded, acc = bf16(p * sv) . v; the
      // block then forms tile 0's sums * alpha + tile 1's, alpha = 2^(m0 - m1)
      float m[2], l[2] = {0.f, 0.f};
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m0 = -INFINITY, m1;
#pragma unroll
        for (int w = 0; w < WPT; ++w) m0 = fmaxf(m0, sm.red_max[w][g + 8 * h]);
        m1 = m0;
#pragma unroll
        for (int w = WPT; w < WARPS; ++w) m1 = fmaxf(m1, sm.red_max[w][g + 8 * h]);
        m[h] = tile == 0 ? m0 : m1;
        if (warp == 0 && j == 0) {
          sm.m[g + 8 * h] = m1;
          // no live token: m stays -inf, and exp2(-inf - -inf) would be NaN
          sm.alpha[g + 8 * h] = m1 == -INFINITY ? 1.f : exp2f(m0 - m1);
        }
      }
      if (runs) {
        // bf16(p * sv) forms PV's A fragments (n-tiles 2 kk, 2 kk + 1 -> step kk)
        uint32_t pa[KK][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = base + 8 * n + 2 * j + e;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              w[2 * h + e] = 0.f;
              if (h == 1 && !two) continue;
              const bool live = t0 + slot < lim[h];
              const float p = live ? exp2f(s[n][2 * h + e] - m[h]) : 0.f;
              l[h] += p;
              w[2 * h + e] = live ? p * sv[n][e] : 0.f;
            }
          }
          pa[n / 2][2 * (n % 2)] = as_u32(__floats2bfloat162_rn(w[0], w[1]));
          pa[n / 2][2 * (n % 2) + 1] = as_u32(__floats2bfloat162_rn(w[2], w[3]));
        }
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
        // PV: column g of n-tile n is dim 8 g + n
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if constexpr (PACKED)
              mma_bf16(acc[n], pa[kk], signed_nibble_pair(vw[kk][0][n / 4], vw[kk][1][n / 4], n % 4),
                       signed_nibble_pair(vw[kk][2][n / 4], vw[kk][3][n / 4], n % 4));
            else
              mma_bf16(acc[n], pa[kk], widen_pair(vw[kk][0][n / 4], vw[kk][1][n / 4], n % 4),
                       widen_pair(vw[kk][2][n / 4], vw[kk][3][n / 4], n % 4));
          }
      }

      // the warps' acc and l of the live rows; acc[n][2 h + e] (row g + 8 h,
      // dim 16 j + 8 e + n) sits at column 8 j + 32 e + n, so a store's 32
      // lanes hit 32 banks
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (mt * M_ROWS + g + 8 * h >= rows) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sm.red_acc[warp][g + 8 * h][8 * j + 32 * e + n] = acc[n][2 * h + e];
        if (j == 0) sm.red_l[warp][g + 8 * h] = l[h];
      }
      __syncthreads();
      // tile 0's sums (its warps in order) * alpha + tile 1's
      const int live_rows = min(rows - mt * M_ROWS, M_ROWS);
      for (int i = tid; i < live_rows * D; i += THREADS) {
        const int rr = i / D;
        const int col = i % D;
        const size_t at = prow + mt * M_ROWS + rr;
        float s0 = sm.red_acc[0][rr][col], s1 = TILES > 1 ? sm.red_acc[WPT % WARPS][rr][col] : 0.f;
#pragma unroll
        for (int w = 1; w < WPT; ++w) {
          s0 += sm.red_acc[w][rr][col];
          if (TILES > 1) s1 += sm.red_acc[(WPT + w) % WARPS][rr][col];
        }
        part.acc[at * D + 16 * (col % 32 / 8) + 8 * (col / 32) + col % 8] =
            fmaf(s0, sm.alpha[rr], s1);
        if (col == 0) {
          float l0 = sm.red_l[0][rr], l1 = TILES > 1 ? sm.red_l[WPT % WARPS][rr] : 0.f;
#pragma unroll
          for (int w = 1; w < WPT; ++w) {
            l0 += sm.red_l[w][rr];
            if (TILES > 1) l1 += sm.red_l[(WPT + w) % WARPS][rr];
          }
          part.ml[at * 2] = sm.m[rr];
          part.ml[at * 2 + 1] = fmaf(l0, sm.alpha[rr], l1);
        }
      }
    }
    // the stage is free for the copies two chunks on, red_* for the next chunk
    if (ch + gridDim.z < n_live) __syncthreads();
  }

  {  // the last block of the (kv head, sequence) merges
    // the block's partials are written; thread 0 orders them before its
    // arrival (a gpu-scope fence) and, in the last block, the others' before
    // the merge's reads. A pair that one block computes alone merges at once.
    const int arrivals = min(static_cast<int>(gridDim.z), n_live);
    __syncthreads();
    if (tid == 0) {
      int* flag = part.arrived + pair;
      __threadfence();
      sm.merges = arrivals == 1 || atomicAdd(flag, 1) == arrivals - 1;
      if (sm.merges && arrivals > 1) {
        atomicExch(flag, 0);  // every block has arrived: ready for the next launch
        __threadfence();
      }
    }
    __syncthreads();
    if (sm.merges) merge_rows<CH>(part, pair * part.n_chunks, pair * rows, len, rows, spec, o, lse);
  }
}

template <bool PACKED, int CH>
int launch(const void* q, int q_f32, const Pool& pool, void* part_acc, void* part_ml,
           void* arrived, void* o, void* lse, int n_seqs, int n_kv, int group, int spec,
           int grid_z, float qk_scale, void* stream) {
  const int capacity = pool.max_pages * pool.ps;
  const Partials part{static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                      static_cast<int*>(arrived), (capacity + CH - 1) / CH};
  if (spec < 1 || group < 1 || n_seqs < 1 || n_kv < 1 || pool.max_pages < 1 || grid_z < 1 ||
      grid_z > part.n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<PACKED, CH><<<dim3(n_kv, n_seqs, grid_z), THREADS, smem_bytes<PACKED, CH>(),
                              static_cast<cudaStream_t>(stream)>>>(
      q, pool, part, static_cast<float*>(o), static_cast<float*>(lse), n_kv, group * spec, spec,
      qk_scale, q_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes q [n_seqs, n_kv * group * spec, D], row (kv head, g, j),
// in f32 (q_f32 = 1, rounded to bf16 in the kernel) or bf16, the partials'
// scratch (decode_tiling.scratch_shapes), `arrived`: n_seqs * n_kv ints that
// are 0 (the last block of each pair merges and leaves them 0), and the
// grid's z (decode_tiling.grid). qa_decode_init must have run once on the
// device first.

// Slotted int8 (B13): payload [b, n_kv, max_len, D], scales [b, n_kv,
// max_len]; a row is one page of max_len tokens.
extern "C" int qa_decode(const void* q, const void* k, const void* sk, const void* v,
                         const void* sv, const void* length, void* o, void* lse, void* part_acc,
                         void* part_ml, void* arrived, int q_f32, int batch, int n_kv, int group,
                         int spec, int max_len, int grid_z, float qk_scale, void* stream) {
  if (max_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Pool p;
  p.k = static_cast<const int8_t*>(k);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const int8_t*>(v);
  p.sv = static_cast<const float*>(sv);
  p.table = nullptr;
  p.length = static_cast<const int*>(length);
  p.ps = max_len;
  p.max_pages = 1;
  p.pay_head = static_cast<long long>(max_len) * D;
  p.pay_seq = p.pay_head * n_kv;
  p.pay_page = p.pay_head;
  p.sc_head = max_len;
  p.sc_seq = static_cast<long long>(max_len) * n_kv;
  p.sc_page = max_len;
  return launch<false, CHUNK8>(q, q_f32, p, part_acc, part_ml, arrived, o, lse, batch, n_kv,
                               group, spec, grid_z, qk_scale, stream);
}

// Paged int8 (B14): pool [n_kv, n_pages, page_size, D], scales [n_pages,
// n_kv, page_size], table [n_seqs, max_pages]; any positive page size.
extern "C" int qa_paged_decode(const void* q, const void* k_pages, const void* sk,
                               const void* v_pages, const void* sv, const void* table,
                               const void* lengths, void* o, void* lse, void* part_acc,
                               void* part_ml, void* arrived, int q_f32, int n_seqs, int n_kv,
                               int group, int spec, int n_pages, int page_size, int max_pages,
                               int grid_z, float qk_scale, void* stream) {
  if (page_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool = paged_pool(k_pages, sk, v_pages, sv, table, lengths, n_kv, n_pages,
                               page_size, max_pages, page_size);
  return launch<false, CHUNK8>(q, q_f32, pool, part_acc, part_ml, arrived, o, lse, n_seqs, n_kv,
                               group, spec, grid_z, qk_scale, stream);
}

// Paged int4 (B16): pool [n_kv, n_pages, page_size / 2, D] byte rows, split
// half per page; an even page size.
extern "C" int qa_paged4_decode(const void* q, const void* k_p, const void* sk, const void* v_p,
                                const void* sv, const void* table, const void* lengths, void* o,
                                void* lse, void* part_acc, void* part_ml, void* arrived,
                                int q_f32, int n_seqs, int n_kv, int group, int spec, int n_pages,
                                int page_size, int max_pages, int grid_z, float qk_scale,
                                void* stream) {
  if (page_size <= 0 || page_size % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool = paged_pool(k_p, sk, v_p, sv, table, lengths, n_kv, n_pages, page_size,
                               max_pages, page_size / 2);
  return launch<true, CHUNK4>(q, q_f32, pool, part_acc, part_ml, arrived, o, lse, n_seqs, n_kv,
                              group, spec, grid_z, qk_scale, stream);
}

// Slotted int4 (B15): payload [b, n_kv, max_len/2, D], scales [b, n_kv,
// max_len]; the pages are the row's 256-token pack blocks, in order.
extern "C" int qa_decode4(const void* q, const void* k_p, const void* sk, const void* v_p,
                          const void* sv, const void* length, void* o, void* lse, void* part_acc,
                          void* part_ml, void* arrived, int q_f32, int batch, int n_kv, int group,
                          int spec, int max_len, int grid_z, float qk_scale, void* stream) {
  constexpr int PACK = 256;
  if (max_len <= 0 || max_len % PACK != 0) return static_cast<int>(cudaErrorInvalidValue);
  Pool p;
  p.k = static_cast<const int8_t*>(k_p);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const int8_t*>(v_p);
  p.sv = static_cast<const float*>(sv);
  p.table = nullptr;
  p.length = static_cast<const int*>(length);
  p.ps = PACK;
  p.max_pages = max_len / PACK;
  p.pay_head = static_cast<long long>(max_len / 2) * D;
  p.pay_seq = p.pay_head * n_kv;
  p.pay_page = static_cast<long long>(PACK / 2) * D;
  p.sc_head = max_len;
  p.sc_seq = static_cast<long long>(max_len) * n_kv;
  p.sc_page = PACK;
  return launch<true, CHUNK4>(q, q_f32, p, part_acc, part_ml, arrived, o, lse, batch, n_kv,
                              group, spec, grid_z, qk_scale, stream);
}

// A block's dynamic shared memory (decode_tiling.shared_bytes) for the int8
// (bits 8: B13/B14) or int4 (bits 4: B15/B16) payload; -1 for other bits.
extern "C" int qa_decode_smem_bytes(int bits) {
  return bits == 8   ? static_cast<int>(smem_bytes<false, CHUNK8>())
         : bits == 4 ? static_cast<int>(smem_bytes<true, CHUNK4>())
                     : -1;
}

// Lets both instances take their shared memory on the current device: once
// a device, before the first launch there.
extern "C" int qa_decode_init() {
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<false, CHUNK8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<false, CHUNK8>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_kernel<true, CHUNK4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<true, CHUNK4>()));
  return static_cast<int>(err);
}
