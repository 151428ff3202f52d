// Int8 flash-attention forward for Hopper (sm_90a), plain C ABI, on the int8
// payloads and scale tables of B4. It is B5, and the second of the fused
// inference forward's (B6) two launches.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/int8_fwd.py:
// _int8_fwd_kernel (B5) and _int8_fused_kernel (B6). Same numerics: S =
// Q_i8 K_i8^T is an exact integer (s8 x s8 -> s32, then f32: |S| <= 64 *
// 127^2 < 2^24, the value the TPU gets from bf16 dots on the same payloads);
// each row r and key tile scale it by c = (sq_r * sk) * qk_scale, with sq per
// (q head, q grain) and sk per kv grain; masked raw logits (causal k <= q on
// global positions, k + k_offset <= q + q_offset; keys past s) become 30000 /
// -c, so that the scaled logit is -30000 whatever the scale; the row max is
// max(raw) * c + EPS_BIAS; P = bf16(exp2(raw * c - m)) feeds both the PV
// product and the row sum l; acc = acc * alpha + (P V_i8) * sv with sv per kv
// grain; rows with l == 0 give O = 0; lse = m + log2(l) (exp2 domain). A row
// that sees no key at all (q_offset < k_offset) gives O = 0 and lse = -inf;
// the TPU kernel gives such a row inside a live tile a finite lse and the
// mean of its V (ROADMAP.md §C, C4).
//
// B6 is B4 then B5: its wrapper runs one B4 launch on the f32 or bf16 inputs
// that writes the payloads of Q, K (after the K-smoothing shift) and V and
// their scale tables into scratch, so K and V are quantized once per call
// (the Hopper counterpart of the TPU kernel's reuse_kv scratch), then this
// kernel on that scratch: O and lse equal B4 then B5 by construction.
//
// What bounds it on this card: at (4,16,2048,64), causal, the two products
// over 134 M visible pairs (17.2 G int8 operations for S, 17.2 G bf16 for
// PV) against ~25 MB of payloads would take 0.026 ms on the tensor cores.
// With head dim 64 the products are short and the softmax between them is
// long: 128 x 128 exponentials a tile and block (1,024 cycles of the SM's
// special-function units) plus ~6 other instructions an element, the S
// product's latency, and the V widening. The kernel before this design spent
// most of its time re-quantizing K and V in every q block (an IEEE division
// per element, O(t^2 / 64)), loading tiles without overlap and building PV's
// operands from scalar shared loads.
//
// Design:
//   - K and V are quantized once per call (B6: by B4 before this kernel),
//     never in the mainloop.
//   - One block of two warpgroups (256 threads, so each may hold up to 255
//     registers) per (batch * kv head, q tile of bq positions). Its 128 rows
//     hold the kv head's whole GQA group (row r -> group r / bq, position q0
//     + r % bq, bq = 128 / rep rounded down), so each K/V tile is fetched
//     once for all rep q heads; each warpgroup owns 64 rows.
//   - Thread 0 keeps KV_STAGES tiles of 128 keys in flight with TMA
//     (cp.async.bulk.tensor, 2-D maps over the [rows, 64] payloads) on
//     "full" mbarriers, KV_STAGES - 1 tiles ahead of the tile being
//     computed. All threads widen each V tile int8 -> bf16 (exact, by byte
//     permutes and one f32 subtraction, off the conversion pipe) into a ring
//     of VB_STAGES shared tiles laid out for wgmma, once per tile per block.
//   - S runs on wgmma.m64n128k32.s32.s8.s8: Q [rows, 64] and K [keys, 64] are
//     both K-major with a 64-byte swizzle (TMA writes K so; the threads
//     write Q so themselves). PV runs on wgmma.m64n64k16.f32.bf16.bf16 with
//     P as the A operand in registers (the S accumulator layout is the A
//     fragment layout, after the bf16 rounding) and V as a transposed
//     (MN-major) B from shared memory with the 128-byte swizzle. The row sums
//     of the rounded P come from the same A fragments times a ones matrix
//     (wgmma m64n8k16), not from the CUDA cores.
//   - Software pipeline: tile j's S is issued with tile j - 1's PV, and tile
//     j's V widening and softmax run while that PV is in flight; one barrier
//     of both warpgroups a tile publishes the widened V and frees the ring
//     stages of tile j - 1.
//   - A kv grain is a multiple of 128 tokens, so a tile never straddles one:
//     each tile's PV is taken into its own accumulator and folded in as
//     (P V_i8) * sv. The online softmax runs per 128-key tile (the TPU kernel
//     per kv grain, the plain version over whole rows), so P is rounded
//     against a different running max, as in B1. raw * c - m is one fma.
//   - Causal blocks stop at their last visible key tile. Masking (and its
//     sentinel's division) is applied only on tiles that reach past s or past
//     the block's first position; a row with no running max yet takes alpha
//     = 0 by select. The next tile's kv grain scales load a tile ahead.
//   - The global offsets enter as diag = q_offset - k_offset, which moves the
//     last tile and the masked ones, never the products a tile issues. A
//     block that sees no key still runs its first tile, wholly masked (the
//     pipeline's products are not under a branch), and the epilogue gives its
//     rows O = 0 and lse = -inf by select.
//
// Head dim 128 (FwdGeom<128>, chosen by the entry's d): the same body. An
// int8 row is then 128 bytes, so Q and K take the 128-byte swizzle (the TMA
// map's and the threads' own writes of Q) and S is four k32 steps; K/V tiles
// hold 64 keys, so S is m64n64 (32 registers) beside O's and the tile's PV
// accumulators (64 each) and P's two fragment sets (32). A 64-key tile still
// lies inside one kv grain (a multiple of 128), so the per-tile sv fold
// holds. The widened V rows are 256 bytes, stored as two 64-dim panels in the
// 128-byte swizzle, and PV is one m64n64 product a panel and k-step. At
// (4,16,2048,128) causal the products are 34.4 G int8 and 34.4 G bf16
// operations (0.052 ms on the tensor cores) against ~50 MB of payloads.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;          // rows per block: two warpgroups of 64
constexpr int THREADS = 256;     // two warpgroups, 8 warps: up to 255 registers a thread
constexpr int PANEL_ROW = 128;   // bytes of a widened V panel's row: 64 bf16, the 128-byte swizzle's span
constexpr int ONES_BYTES = 1024;
constexpr float EPS_BIAS = 1.0f / 256.0f;

// One kernel body for head dims 64 and 128 (ops/int8_tiling.py mirrors
// FwdGeom). An int8 row of D bytes: the 64-byte swizzle at 64, the 128-byte
// one at 128 (S's k-steps 0 .. D / 32 - 1, each 32 bytes on). The widened
// bf16 V rows are D / 64 panels of [BN, 64] in the 128-byte swizzle, and PV
// is one m64n64 product a panel and k-step into one half of O. At D = 128 a
// K/V tile holds 64 keys: S (m64n64, 32 registers), O and the tile's PV (64
// each) and P's two fragment sets (32) fit a thread; at 128 keys S and P
// alone would take 128.
template <int D>
struct FwdGeom {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int PANELS = D / 64;             // 64-column panels of a widened V row
  static constexpr int BN = D == 64 ? 128 : 64;     // keys per K/V tile
  static constexpr int NS = BN / 2;                 // S's accumulator registers a thread
  static constexpr int KV_STAGES = 3;               // int8 K/V tiles in flight
  static constexpr int VB_STAGES = 2;               // widened bf16 V tiles
  static constexpr int TILE_I8 = BN * D;            // bytes of an int8 K or V tile
  static constexpr int PANEL = BN * PANEL_ROW;      // bytes of a widened V panel
  static constexpr int TILE_BF16 = PANELS * PANEL;  // bytes of a widened V tile
  static constexpr int OFF_K = BM * D;              // Q tile first
  static constexpr int OFF_V = OFF_K + KV_STAGES * TILE_I8;
  static constexpr int OFF_VB = OFF_V + KV_STAGES * TILE_I8;
  static constexpr int OFF_BAR = OFF_VB + VB_STAGES * TILE_BF16;
  static constexpr int OFF_ONES = OFF_BAR + 128;  // bf16 ones: the B operand of P's row sums
  static constexpr int SMEM_BYTES = OFF_ONES + ONES_BYTES + 1024;  // + slack to align the base
  static_assert(KV_STAGES * 8 <= 128, "the barriers fit before the ones");
  static_assert(OFF_K % 1024 == 0 && TILE_I8 % 1024 == 0 && OFF_VB % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory fits an H100 SM");
};

// d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T, s8 x s8 -> s32, both from shared
// memory; accumulate = 0 zeroes d first.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S = Q_i8 K_i8^T of one tile, by its width: two k32 steps of m64n128 in
// the 64-byte swizzle at head dim 64, four of m64n64 in the 128-byte one at
// 128 (a step is 32 bytes on, +2, in both).
__device__ __forceinline__ void wgmma_s(int (&d)[64], uint64_t dq, uint64_t dk) {
  wgmma_s8_m64n128k32(d, dq, dk, 0);
  wgmma_s8_m64n128k32(d, dq + 2, dk + 2, 1);  // the next 32 bytes of d
}
__device__ __forceinline__ void wgmma_s(int (&d)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_s8_m64n64k32(d, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// Masks one tile's raw S (only where the tile reaches past s or past the
// block's first position) and converts it to f32; updates the running max m
// (scaled, +EPS_BIAS) and gives each row's alpha; writes P = bf16(exp2(raw *
// c - m)) as PV's A fragments (key tiles 2kk and 2kk + 1 of 8 keys are k-step
// kk). si[4 n + e]: row h = e / 2, key k0 + 8 n + cq + (e & 1); lim[h]: row h's
// last visible key under causal masking (its position + diag). NS: the
// tile's keys / 2.
template <int NS>
__device__ __forceinline__ void softmax_tile(const int (&si)[NS], uint32_t (&p)[NS / 8][4],
                                             float (&m)[2], float (&alpha)[2],
                                             const float (&c)[2], bool edge, int k0, int cq,
                                             const int (&lim)[2], int s, int causal) {
  float sc[NS];
  float mx[2] = {-INFINITY, -INFINITY};
  float sentinel[2] = {0.f, 0.f};  // the masked raw logit 30000 / -c, on edge tiles only
  if (edge) {
#pragma unroll
    for (int h = 0; h < 2; ++h) sentinel[h] = __fdiv_rn(30000.f, -c[h]);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i % 4) / 2;
    sc[i] = small_int_to_float(si[i]);  // |S| <= 128 * 128^2 = 2^21
    if (edge) {
      const int col = k0 + (i / 4) * 8 + cq + (i & 1);
      if (!(col < s && (!causal || col <= lim[h]))) sc[i] = sentinel[h];
    }
    mx[h] = fmaxf(mx[h], sc[i]);
  }
  float next_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    next_m[h] = fmaxf(m[h], __fadd_rn(__fmul_rn(quad_max(mx[h]), c[h]), EPS_BIAS));
    // a row with no running max yet takes alpha = 0 by select
    alpha[h] = m[h] == -INFINITY ? 0.f : exp2_ftz(m[h] - next_m[h]);
    m[h] = next_m[h];
  }
  // raw * c - m with one rounding (fma), then exp2 and the bf16 rounding
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p[n / 2][(n % 2) * 2 + h] =
          as_u32(__floats2bfloat162_rn(exp2_ftz(fmaf(sc[4 * n + 2 * h], c[h], -next_m[h])),
                                       exp2_ftz(fmaf(sc[4 * n + 2 * h + 1], c[h], -next_m[h]))));
  }
}

template <int P>
__device__ __forceinline__ void fence_all(float (&x)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p) reg_fence(x[p]);
}

// Q, K and V are B4's payloads: q read directly, K and V ([bh_kv * kv_pad,
// D] int8) through the TMA maps.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
int8_attn_kernel(const __grid_constant__ CUtensorMap k_map,  // 64-byte swizzle (128 at D = 128)
                 const __grid_constant__ CUtensorMap v_map,  // no swizzle
                 const int8_t* __restrict__ q,               // [bh_kv * rep, q_pad, D]
                 const float* __restrict__ sq,               // [bh_kv * rep, nq]
                 const float* __restrict__ sk,               // [bh_kv, nk]
                 const float* __restrict__ sv,               // [bh_kv, nk]
                 float* __restrict__ o,                      // [bh_kv * rep, t, D]
                 float* __restrict__ lse,                    // [bh_kv * rep, t]
                 int rep, int t, int s, int q_pad, int kv_pad, int nq, int nk, int q_grain,
                 int kv_grain, int bq, int causal, int diag, float qk_scale) {
  using G = FwdGeom<D>;
  constexpr int BN = G::BN, NS = G::NS, PANELS = G::PANELS, KV_STAGES = G::KV_STAGES;
  constexpr int VB_STAGES = G::VB_STAGES, TILE_I8 = G::TILE_I8, TILE_BF16 = G::TILE_BF16;
  constexpr uint64_t PANEL_DESC = G::PANEL >> 4;  // a descriptor's step from panel to panel
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto kv_full = [&](int i) { return bars + 8 * i; };

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  // Causal: a key is visible where key + k_offset <= position + q_offset, so
  // keys past the block's last query position, moved by diag = q_offset -
  // k_offset, are never visible. A block that sees none still runs tile 0,
  // wholly masked (see the epilogue).
  const int kv_hi = causal ? max(0, min(s, q0 + bq + diag)) : s;
  const int n_tiles = max(1, (kv_hi + BN - 1) / BN);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KV_STAGES; ++i) mbar_init(kv_full(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 fills the K/V ring by TMA: tiles 0 .. KV_STAGES - 1 now, tile j +
  // KV_STAGES - 1 at the start of tile j, into the stage of tile j - 1, which
  // every thread released before the barrier that ended tile j - 1.
  auto load_kv = [&](int j) {
    if (tid == 0 && j < n_tiles) {
      const int st = j % KV_STAGES;
      mbar_expect_tx(kv_full(st), 2 * TILE_I8);
      const int row = static_cast<int>(bh) * kv_pad + j * BN;
      tma_load_2d(base + G::OFF_K + st * TILE_I8, &k_map, kv_full(st), 0, row);
      tma_load_2d(base + G::OFF_V + st * TILE_I8, &v_map, kv_full(st), 0, row);
    }
  };
  for (int j = 0; j < KV_STAGES; ++j) load_kv(j);

  // The consumer warpgroups: wg owns block rows wg * 64 .. wg * 64 + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int rows = rep * bq;      // live rows of the block (<= BM)

  // This warpgroup's Q rows -> shared, int8, K-major: the 64-byte swizzle at
  // D = 64 (16-byte chunk c of row r at c ^ ((r >> 1) & 3)), the 128-byte one
  // at 128 (at c ^ (r & 7)); zeros for dead rows and positions past t. Then
  // the ones that sum each row of P.
  for (int c = tid % 128; c < 64 * (D / 16); c += 128) {
    const int r = wg * 64 + c / (D / 16), c16 = c % (D / 16);
    const int p = q0 + r % bq;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && p < t) {
      const size_t qrow = bh * rep + r / bq;
      val = *reinterpret_cast<const uint4*>(q + (qrow * q_pad + p) * D + c16 * 16);
    }
    const int sw = D == 64 ? (r >> 1) & 3 : r & 7;
    *reinterpret_cast<uint4*>(smem + r * D + ((c16 ^ sw) << 4)) = val;
  }
  for (int c = tid; c < ONES_BYTES / 16; c += THREADS)
    reinterpret_cast<uint4*>(smem + G::OFF_ONES)[c] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);  // bf16 1.0
  fence_proxy_async();
  named_barrier(1, THREADS);

  // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its
  // warp), each with its last visible key under causal masking, lim = its
  // position + diag (below 0: the row sees no key).
  const int ra = wg * 64 + warp * 16 + lane / 4;
  bool live[2];
  int lim[2];
  float sq_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const int pos = q0 + r % bq;
    lim[h] = pos + diag;
    live[h] = r < rows && pos < t;
    sq_r[h] = live[h] ? sq[(bh * rep + r / bq) * nq + pos / q_grain] : 1.f;
  }

  // Tile j's scale c = (sq_r * sk) * qk_scale per row, from its kv grain's sk.
  auto tile_scales = [&](float sk_t, float (&c)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) c[h] = __fmul_rn(__fmul_rn(sq_r[h], sk_t), qk_scale);
  };
  auto scale_at = [&](const float* table, int j) {
    return table[bh * nk + min(j, n_tiles - 1) * BN / kv_grain];
  };
  auto edge = [&](int j) {
    return j * BN + BN > s || (causal && j * BN + BN - 1 > q0 + diag);
  };

  const uint32_t q_at = base + wg * 64 * D;
  const uint64_t desc_q = D == 64 ? desc_kmajor_sw64(q_at) : desc_kmajor_sw128(q_at);
  const uint64_t desc_ones = desc_interleave(base + G::OFF_ONES);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[PANELS][32];  // O, panel p: head dims 64 p ..
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  // S of tile j, once its K/V stage has landed: issued and committed as one group.
  auto issue_s = [&](int j, int (&si)[NS]) {
    const int st = j % KV_STAGES;
    mbar_wait(kv_full(st), (j / KV_STAGES) & 1);
    const uint32_t k_at = base + G::OFF_K + st * TILE_I8;
    const uint64_t desc_k = D == 64 ? desc_kmajor_sw64(k_at) : desc_kmajor_sw128(k_at);
    wgmma_fence();
    wgmma_s(si, desc_q, desc_k);
    wgmma_commit();
  };
  // This thread's share of tile j's V, widened int8 -> bf16 into buffer j %
  // 2: the 16 bytes of key row r at head dims 16 c16 .. become two 16-byte
  // chunks of panel c16 / 4 in the 128-byte swizzle (chunk c of a panel's
  // row r at c ^ (r & 7)).
  auto widen_v = [&](int j) {
    const uint8_t* vi = smem + G::OFF_V + (j % KV_STAGES) * TILE_I8;
    uint8_t* vb = smem + G::OFF_VB + (j % VB_STAGES) * TILE_BF16;
#pragma unroll
    for (int i = 0; i < BN * (D / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (D / 16), c16 = c % (D / 16);
      const uint4 x = *reinterpret_cast<const uint4*>(vi + r * D + c16 * 16);
      uint8_t* row = vb + (c16 / 4) * G::PANEL + r * PANEL_ROW;
      const int c8 = 2 * (c16 % 4);
      *reinterpret_cast<uint4*>(row + ((c8 ^ (r & 7)) << 4)) = widen8(x.x, x.y);
      *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (r & 7)) << 4)) = widen8(x.z, x.w);
    }
  };
  // PV of tile j: BN / 16 k-steps of 16 keys (32 bytes of P's rows, 16 rows
  // = 2048 bytes of each V panel), one n64 product a panel, and the row sums;
  // issued and committed as one group.
  auto issue_pv = [&](int j, const uint32_t (&pa)[NS / 8][4], float (&pv)[PANELS][32],
                      float (&ls)[4]) {
    const uint64_t desc_v =
        desc_mnmajor_sw128(base + G::OFF_VB + (j % VB_STAGES) * TILE_BF16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(pv[p], pa[kk],
                                           desc_v + p * PANEL_DESC + kk * (16 * PANEL_ROW >> 4),
                                           kk > 0);
      wgmma_bf16_m64n8k16_rs(ls, pa[kk], desc_ones, kk > 0);
    }
    wgmma_commit();
  };
  // Once tile j's PV is done: acc = acc * alpha + (P V_i8) * sv, l = l *
  // alpha + rowsum(P); pv[p][4 n + e]: row e / 2, column 64 p + 8 n + cq +
  // (e & 1); ls[2 h]: row h.
  auto fold_pv = [&](float (&pv)[PANELS][32], float (&ls)[4], const float (&alpha_j)[2],
                     float sv_j) {
    fence_all(pv);
    reg_fence(ls);
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[p][i] =
            __fadd_rn(__fmul_rn(acc[p][i], alpha_j[(i % 4) / 2]), __fmul_rn(pv[p][i], sv_j));
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha_j[h] + ls[2 * h];
  };

  // Software pipeline: tile j's S, V widening and softmax run while tile j -
  // 1's PV is in flight. One barrier of both warpgroups a tile publishes
  // tile j's widened V and P (and retires tile j - 1's buffers).
  float alpha[2], c[2];
  uint32_t pa[NS / 8][4];
  float sk_next = scale_at(sk, 1), sv_prev = scale_at(sv, 0);
  {
    int si[NS];
    tile_scales(scale_at(sk, 0), c);
    issue_s(0, si);
    widen_v(0);
    wgmma_wait<0>();
    reg_fence(si);
    softmax_tile<NS>(si, pa, m, alpha, c, edge(0), 0, cq, lim, s, causal);
    fence_proxy_async();
    named_barrier(1, THREADS);
  }
  for (int j = 1; j < n_tiles; ++j) {
    load_kv(j + KV_STAGES - 1);
    const float sv_j = scale_at(sv, j);
    tile_scales(sk_next, c);
    sk_next = scale_at(sk, j + 1);
    int si[NS];
    float pv[PANELS][32], ls[4];
    issue_s(j, si);
    issue_pv(j - 1, pa, pv, ls);
    widen_v(j);
    const float alpha_prev[2] = {alpha[0], alpha[1]};
    wgmma_wait<1>();  // S of tile j is done; PV of tile j - 1 may still run
    reg_fence(si);
    uint32_t pb[NS / 8][4];
    softmax_tile<NS>(si, pb, m, alpha, c, edge(j), j * BN, cq, lim, s, causal);
    fence_proxy_async();
    wgmma_wait<0>();
    reg_fence(pa);
    fold_pv(pv, ls, alpha_prev, sv_prev);
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pb[kk][e];
    sv_prev = sv_j;
    named_barrier(1, THREADS);
  }
  {
    float pv[PANELS][32], ls[4];
    issue_pv(n_tiles - 1, pa, pv, ls);
    wgmma_wait<0>();
    fold_pv(pv, ls, alpha, sv_prev);
  }

  // Epilogue: O = acc / l (l == 0 -> 1), lse = m + log2(l). A row that sees
  // no key (causal, its position + diag < 0: every logit it met was the
  // sentinel) gets O = 0 and lse = -inf, whatever its accumulators hold.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = ra + 8 * h;
    const bool empty = causal && lim[h] < 0;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const size_t row = (bh * rep + r / bq) * t + q0 + r % bq;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 val = empty ? make_float2(0.f, 0.f)
                                 : make_float2(acc[p][4 * n + 2 * h] / l_safe,
                                               acc[p][4 * n + 2 * h + 1] / l_safe);
        *reinterpret_cast<float2*>(o + row * D + 64 * p + n * 8 + cq) = val;
      }
    if (lane % 4 == 0) lse[row] = empty ? -INFINITY : m[h] + log2f(l_safe);
  }
}

// A 2-D map over rows of D int8 bytes, boxes of BN rows.
template <int D>
bool payload_map(CUtensorMap* map, const void* ptr, int rows, CUtensorMapSwizzle swizzle) {
  return tensor_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, D, FwdGeom<D>::BN, D,
                       swizzle);
}

// The maps, the shared-memory attribute (once an instance) and the launch
// at head dim D.
template <int D>
int int8_fwd(const void* q, const void* k, const void* v, const void* sq, const void* sk,
             const void* sv, void* o, void* lse, int bh_kv, int rep, int t, int s, int q_pad,
             int kv_pad, int q_grain, int kv_grain, int bq, int causal, int diag, float qk_scale,
             cudaStream_t stream) {
  constexpr int SMEM = FwdGeom<D>::SMEM_BYTES;
  CUtensorMap k_map, v_map;
  if (!payload_map<D>(&k_map, k, bh_kv * kv_pad,
                      D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !payload_map<D>(&v_map, v, bh_kv * kv_pad, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((t + bq - 1) / bq, bh_kv);
  int8_attn_kernel<D><<<grid, THREADS, SMEM, stream>>>(
      k_map, v_map, static_cast<const int8_t*>(q), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<float*>(o),
      static_cast<float*>(lse), rep, t, s, q_pad, kv_pad, q_pad / q_grain, kv_pad / kv_grain,
      q_grain, kv_grain, bq, causal, diag, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes one block asks for at head dim d, 64 or 128
// (ops/int8_tiling.py's shared_bytes mirrors it); -1 for another d.
extern "C" int qa_int8_fwd_smem_bytes(int d) {
  return d == 64 ? FwdGeom<64>::SMEM_BYTES : d == 128 ? FwdGeom<128>::SMEM_BYTES : -1;
}

// B5: q [bh_kv * rep, q_pad, d], k/v [bh_kv, kv_pad, d] int8 payloads, d 64
// or 128, with their scale tables sq [bh_kv * rep, q_pad / q_grain], sk/sv
// [bh_kv, kv_pad / kv_grain] -> O [bh_kv * rep, t, d], lse [bh_kv * rep, t]
// (f32). bq query positions a block (rep * bq <= 128); kv_grain a multiple
// of 128. Causal masking is on global positions: query i sits at q_offset +
// i, key j at k_offset + j (both >= 0; a sequence shard's first token).
extern "C" int qa_int8_fwd(const void* q, const void* k, const void* v, const void* sq,
                           const void* sk, const void* sv, void* o, void* lse, int bh_kv, int rep,
                           int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain, int bq,
                           int causal, int q_offset, int k_offset, float qk_scale, int d,
                           void* stream) {
  if (bq < 1 || rep < 1 || rep * bq > BM || t < 1 || t > q_pad || s < 1 || s > kv_pad ||
      q_offset < 0 || k_offset < 0 || (d != 64 && d != 128) ||
      kv_pad % 128 || kv_grain % 128 || kv_pad % kv_grain || q_pad % q_grain || bh_kv < 1 ||
      bh_kv > 65535 ||
      static_cast<long long>(bh_kv) * kv_pad > 0x7fffffffLL)  // TMA row coordinates are int32
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = d == 64 ? &int8_fwd<64> : &int8_fwd<128>;
  return launch(q, k, v, sq, sk, sv, o, lse, bh_kv, rep, t, s, q_pad, kv_pad, q_grain, kv_grain,
                bq, causal, q_offset - k_offset, qk_scale, static_cast<cudaStream_t>(stream));
}
