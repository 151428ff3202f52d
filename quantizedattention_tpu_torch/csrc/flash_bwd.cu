// Corrected-bf16 flash-attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/flash_bwd.py:_dkv_kernel
// (B2: dK, dV) and :_dq_kernel (B3: dQ). Same arithmetic: Q arrives pre-scaled
// by sm_scale*log2(e) and dO by sm_scale (flash_bwd.py:231-234 folds both
// scales in); P = exp2(Q K^T - lse) is recomputed per tile against the
// forward's exp2-domain lse; dV += P^T dO; dP = dO V^T; dS = P (dP - D) with
// D = rowsum(dO o O) and the UNROUNDED f32 P; dK += dS^T Q; dQ += dS K. dK and
// dV are scaled back by 1/qk_scale and 1/sm_scale at the end. Masked logits
// (causal k <= q, keys past s) and rows past t give P = 0 exactly.
//
// Two modes, one C entry per kernel:
//   fast  - bf16 products with f32 accumulation, the operands rounded to bf16
//           where the TPU's DEFAULT-precision dots round them: q*qk_scale and k
//           for S, bf16(P) and dO*sm_scale for dV, dO*sm_scale and v for dP,
//           bf16(dS) and q*qk_scale for dK, bf16(dS) and k for dQ. One prep
//           launch (bwd_prep_kernel) writes the bf16 q_s and dO_s and the f32
//           D (and a copy of lse) from the model's q, dO and O, read through
//           their strides; f32 K and V take flash_fwd.cu's kv_to_bf16 launch.
//   exact - fp32 on the CUDA cores (FFMA), the bwd_exact=True path; simple
//           shared-memory tiles, slow by design. dP is summed in float64 and
//           D subtracted there before dS is rounded to f32: where dP - D
//           cancels (one visible key: O is bf16(V), so dP - D is dO . (V -
//           bf16(V)), about 2^-9 of dP), an f32 sum's rounding would be
//           amplified ~500x and differ with the summation order; in float64
//           the kernel and the plain version agree to f32 rounding.
//
// What bounds the fast kernels on this card: at (4,16,2048,64), causal, B2
// runs four bf16 products (S^T, dP^T, dV, dK) and B3 three (S, dP, dQ) over
// 134 M visible (q, k) pairs: 0.0695 and 0.0521 ms on the tensor cores,
// against 0.10-0.14 GB of operands and outputs (0.03-0.04 ms of HBM). Between
// the products each pair takes one exponential (the SM's 16 a cycle), two
// bf16 conversions and a few FMA-pipe operations, so the elementwise work is
// of the order of the products' and has to overlap them.
//
// Design of the fast kernels (the int8 backward's, csrc/int8_bwd.cu, without
// its int8 grains; the bf16 pieces as in the forward, csrc/flash_fwd.cu):
// blocks of two warpgroups (256 threads, up to 255 registers each), every
// product on wgmma with f32 accumulators in registers, tiles by TMA (128-byte
// swizzle; rows past t or s arrive as zeros) through a ring of stages on
// "full" mbarriers. Each warpgroup releases a stage once its products of that
// tile are done (a shared counter), while its next tile's first products run,
// and the second to release it refills it at once, so the warpgroups never
// wait for each other and one's elementwise work overlaps the other's
// products. Every product is issued at every tile (a warpgroup whose keys a
// causal tile cannot see computes it masked): a wgmma under a branch would
// serialize every wgmma of the kernel.
//   B2: one block per (batch * kv head, 128-key tile), each warpgroup 64 keys;
//       K and V resident in shared memory for the block's life (the A of S^T =
//       K Q^T and of dP^T = V dO^T). For each q head of the GQA group and each
//       64-row q tile that can see the block's keys (causal: from the diagonal
//       on), a stage holds the q_s and dO_s tiles and the tile's lse and D.
//       P^T and dS^T become the bf16 A fragments (registers) of dV += P^T dO
//       and dK += dS^T Q (B = the same dO and Q tiles, read MN-major). dK and
//       dV stay in registers across the group and every q tile. Key tile 0
//       (the most q tiles) starts first.
//   B3: one block per (batch * kv head, 128 rows); the rows hold the kv head's
//       whole GQA group (row r -> q head kv_head * rep + r / bq at position q0
//       + r % bq, bq = 128 / rep rounded down), each warpgroup 64 of them. Q
//       sits in shared memory (the A of S = Q K^T), dO is the bf16 A fragments
//       of dP = dO V^T, lse and D per row in registers. K and V tiles of 64 keys
//       stream through the ring; dS becomes the A of dQ += dS K (B = the same
//       K tile, MN-major). Causal blocks stop at their last visible key tile;
//       the blocks with the most key tiles start first.
// Each block owns its output rows: no atomics in global memory, the same bits
// every run.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;  // head dim

// --- fast: TMA rings and wgmma ---

constexpr int THREADS = 256;         // two warpgroups
constexpr int TILE = 64;             // q positions (B2) or keys (B3) a streamed tile
constexpr int BF_TILE = TILE * D * 2;  // bytes of a bf16 tile: rows of 128 bytes
constexpr int ROW_BYTES = TILE * 4;  // a tile's lse or D (f32)
constexpr int ACC = 32;              // f32 accumulator registers a thread (m64n64)

// B2: dK, dV. Shared layout from a 1024-byte aligned base: K, V [128, 64];
// stage st: the q_s and dO_s tiles at DKV_OFF_RING + 2 st BF_TILE, its lse and
// D at DKV_OFF_ROWS + 2 st ROW_BYTES; the mbarriers (full[stage], then K/V's)
// and the release counters.
constexpr int DKV_KEYS = 128;
constexpr int DKV_STAGES = 4;
constexpr int DKV_OFF_V = 2 * BF_TILE;
constexpr int DKV_OFF_RING = 4 * BF_TILE;
constexpr int DKV_OFF_ROWS = DKV_OFF_RING + DKV_STAGES * 2 * BF_TILE;
constexpr int DKV_OFF_BAR = DKV_OFF_ROWS + DKV_STAGES * 2 * ROW_BYTES;
constexpr int DKV_SMEM = DKV_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024

// B3: dQ. Q [128, 64]; stage st: the K and V tiles at DQ_OFF_RING + 2 st
// BF_TILE; the mbarriers and release counters.
constexpr int DQ_ROWS = 128;
constexpr int DQ_STAGES = 4;
constexpr int DQ_OFF_RING = 2 * BF_TILE;
constexpr int DQ_OFF_BAR = DQ_OFF_RING + DQ_STAGES * 2 * BF_TILE;
constexpr int DQ_SMEM = DQ_OFF_BAR + 128 + 1024;

constexpr int COUNTERS = 64;  // byte offset of the release counters in the barrier area
static_assert((DKV_STAGES + 1) * 8 <= COUNTERS && COUNTERS + DKV_STAGES * 4 <= 128 &&
                  DQ_STAGES * 8 <= COUNTERS && COUNTERS + DQ_STAGES * 4 <= 128,
              "the barriers and counters fit");
static_assert(DKV_OFF_RING % 1024 == 0 && DKV_OFF_ROWS % 1024 == 0 && DQ_OFF_RING % 1024 == 0,
              "swizzled tiles start on 1024 bytes");

// The A fragments (rows 16 warp + lane / 4, + 8 of the warpgroup's 64; k-step
// kk = accumulator columns 16 kk .. 16 kk + 15) of a product's bf16 input,
// from two f32 accumulator n-tiles' worth of values x[4].
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int n, const float (&x)[4]) {
  a[n / 2][(n % 2) * 2 + 0] = as_u32(__floats2bfloat162_rn(x[0], x[1]));
  a[n / 2][(n % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(x[2], x[3]));
}

// B2's P^T and dS^T of one tile, as the bf16 A fragments of dV and dK: P^T =
// exp2(S^T - lse_q), 0 where masked; dS^T = P^T (dP^T - D_q) with the
// unrounded P. st[4 n + e], dpt[4 n + e]: key key[e / 2], q column 8 n + cq +
// (e & 1), whose lse and D are rw[col], rw[64 + col]. MASK: the tile reaches
// past t or s or the causal diagonal.
template <bool MASK>
__device__ __forceinline__ void dkv_p_ds(const float (&st)[ACC], const float (&dpt)[ACC],
                                         const float* rw, int q0, int cq, const int (&key)[2],
                                         int s, int t, int causal, uint32_t (&pa)[4][4],
                                         uint32_t (&da)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(rw + 8 * n + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(rw + TILE + 8 * n + cq);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(st[4 * n + e] - ((e & 1) ? l2.y : l2.x));
      if (MASK) {
        const int pos = q0 + 8 * n + cq + (e & 1), k = key[e / 2];
        p[e] = k < s && pos < t && (!causal || k <= pos) ? p[e] : 0.f;
      }
      ds[e] = p[e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
    }
    pack_a(pa, n, p);
    pack_a(da, n, ds);
  }
}

// B3's dS of one tile, as the bf16 A fragments of dQ: P = exp2(S - lse), 0
// where masked; dS = P (dP - D) with the unrounded P. sc[4 n + e], dp[4 n +
// e]: row e / 2, key k0 + 8 n + cq + (e & 1). MASK: the tile reaches past s
// or the causal diagonal. (Dead rows have Q = dO = 0 and lse = D = 0: P = 1,
// dS = 0.)
template <bool MASK>
__device__ __forceinline__ void dq_ds(const float (&sc)[ACC], const float (&dp)[ACC],
                                      const float (&lse_r)[2], const float (&di_r)[2], int k0,
                                      int cq, const int (&pos)[2], int s, int causal,
                                      uint32_t (&dsa)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      float p = exp2_ftz(sc[4 * n + e] - lse_r[h]);
      if (MASK) {
        const int col = k0 + 8 * n + cq + (e & 1);
        p = col < s && (!causal || col <= pos[h]) ? p : 0.f;
      }
      ds[e] = p * (dp[4 * n + e] - di_r[h]);
    }
    pack_a(dsa, n, ds);
  }
}

__device__ __forceinline__ void zero(float (&x)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) x[i] = 0.f;
}

// ---------------------------------------------------------------------------
// B2 fast: dK, dV
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel_bf16(const __grid_constant__ CUtensorMap q_map,    // [bh_kv * rep, t, 64] bf16 q_s
                const __grid_constant__ CUtensorMap do_map,   // the same for dO_s
                const __grid_constant__ CUtensorMap k_map,    // [bh_kv, s, 64] bf16
                const __grid_constant__ CUtensorMap v_map,    // the same for V
                const __grid_constant__ CUtensorMap lse_map,  // [bh_kv * rep, t] f32, rows ld apart
                const __grid_constant__ CUtensorMap di_map,   // the same for D
                float* __restrict__ dk,                       // [bh_kv, s, D]
                float* __restrict__ dv,                       // [bh_kv, s, D]
                int rep, int t, int s, int causal, float dk_scale, float dv_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + DKV_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  const uint32_t kv_bar = full(DKV_STAGES);
  int* released = reinterpret_cast<int*>(smem + DKV_OFF_BAR + COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * DKV_KEYS;  // key tile 0, which sees the most q tiles, first
  const int n_qt = (t + TILE - 1) / TILE;
  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? min(k0 / TILE, n_qt) : 0;
  const int per_head = n_qt - j0;
  const int n_tiles = rep * per_head;  // tile i: q head i / per_head, q tile j0 + i % per_head

  init_ring(bars, released, DKV_STAGES + 1);

  // Tile i of the walk into stage i % DKV_STAGES: the q_s and dO_s tiles and
  // the tile's lse and D (positions past t arrive as zeros).
  auto load_tile = [&](int i) {
    const int st = i % DKV_STAGES;
    const int head = bh * rep + i / per_head;
    const int q0 = (j0 + i % per_head) * TILE;
    const uint32_t tiles = base + DKV_OFF_RING + st * 2 * BF_TILE;
    const uint32_t rows = base + DKV_OFF_ROWS + st * 2 * ROW_BYTES;
    mbar_expect_tx(full(st), 2 * BF_TILE + 2 * ROW_BYTES);
    tma_load_3d(tiles, &q_map, full(st), 0, q0, head);
    tma_load_3d(tiles + BF_TILE, &do_map, full(st), 0, q0, head);
    tma_load_4d(rows, &lse_map, full(st), q0, 0, head, 0);
    tma_load_4d(rows + ROW_BYTES, &di_map, full(st), q0, 0, head, 0);
  };
  // The block's K and V (keys past s arrive as zeros; a half wholly past s
  // is not loaded: its keys' rows of dK, dV, P^T and dS^T are never stored or
  // read), then the first stages. A block that no q tile sees loads nothing.
  if (tid == 0 && n_tiles > 0) {
    const int halves = k0 + 64 < s ? 2 : 1;
    mbar_expect_tx(kv_bar, halves * 2 * BF_TILE);
    for (int h = 0; h < halves; ++h) {
      tma_load_3d(base + h * BF_TILE, &k_map, kv_bar, 0, k0 + 64 * h, bh);
      tma_load_3d(base + DKV_OFF_V + h * BF_TILE, &v_map, kv_bar, 0, k0 + 64 * h, bh);
    }
    for (int i = 0; i < min(DKV_STAGES, n_tiles); ++i) load_tile(i);
  }

  // The consumer warpgroups: wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;                  // accumulator column pair
  const int kw0 = k0 + 64 * wg;                   // the warpgroup's first key
  const int kr = 64 * wg + 16 * warp + lane / 4;  // this thread's rows kr, kr + 8
  const int key[2] = {k0 + kr, k0 + kr + 8};
  const uint64_t desc_k = desc_kmajor_sw128(base + wg * BF_TILE);
  const uint64_t desc_v = desc_kmajor_sw128(base + DKV_OFF_V + wg * BF_TILE);

  float dv_acc[ACC], dk_acc[ACC], st_acc[ACC], dpt[ACC];
  uint32_t pa[4][4] = {}, da[4][4] = {};  // bf16 P^T and dS^T: the A of dV and dK
  zero(dv_acc);
  zero(dk_acc);
  zero(st_acc);
  zero(dpt);
  if (n_tiles > 0) mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % DKV_STAGES;
    const int q0 = (j0 + i % per_head) * TILE;
    const uint32_t tiles = base + DKV_OFF_RING + st * 2 * BF_TILE;
    mbar_wait(full(st), (i / DKV_STAGES) & 1);
    {  // S^T = K Q^T and dP^T = V dO^T (A and B K-major)
      const uint64_t desc_q = desc_kmajor_sw128(tiles);
      const uint64_t desc_do = desc_kmajor_sw128(tiles + BF_TILE);
      reg_fence(st_acc);
      reg_fence(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n64k16_ss(st_acc, desc_k + 2 * kk, desc_q + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n64k16_ss(dpt, desc_v + 2 * kk, desc_do + 2 * kk, kk > 0);
      wgmma_commit();
    }
    // the last tile's dV and dK are done (all but the newest group): its stage
    // is released while this tile's S^T and dP^T run
    wgmma_wait<1>();
    if (i > 0) release_stage(released, i - 1, DKV_STAGES, n_tiles, load_tile);
    wgmma_wait<0>();  // this tile's S^T and dP^T are done
    reg_fence(st_acc);
    reg_fence(dpt);
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    const float* rw = reinterpret_cast<const float*>(smem + DKV_OFF_ROWS + st * 2 * ROW_BYTES);
    // masking only where the tile reaches past t or s or the diagonal (a
    // warpgroup whose keys all lie past a causal tile gets P = 0)
    if (q0 + TILE > t || kw0 + 64 > s || (causal && q0 < kw0 + 63))
      dkv_p_ds<true>(st_acc, dpt, rw, q0, cq, key, s, t, causal, pa, da);
    else
      dkv_p_ds<false>(st_acc, dpt, rw, q0, cq, key, s, t, causal, pa, da);
    reg_fence(pa);
    reg_fence(da);
    {  // dV += P^T dO, dK += dS^T Q (both B MN-major: 16 q rows = 2048 bytes a k-step)
      const uint64_t desc_qt = desc_mnmajor_sw128(tiles);
      const uint64_t desc_dot = desc_mnmajor_sw128(tiles + BF_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc, pa[kk], desc_dot + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_acc, da[kk], desc_qt + 128 * kk, 1);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  reg_fence(dv_acc);
  reg_fence(dk_acc);
  reg_fence(pa);
  reg_fence(da);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (static_cast<size_t>(bh) * s + key[h]) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[4 * n + 2 * h] * dk_scale, dk_acc[4 * n + 2 * h + 1] * dk_scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[4 * n + 2 * h] * dv_scale, dv_acc[4 * n + 2 * h + 1] * dv_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// B3 fast: dQ
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
dq_kernel_bf16(const __grid_constant__ CUtensorMap k_map,  // [bh_kv, s, 64] bf16
               const __grid_constant__ CUtensorMap v_map,  // the same for V
               const __nv_bfloat16* __restrict__ q,        // [bh_kv * rep, t, D] q_s
               const __nv_bfloat16* __restrict__ dout,     // [bh_kv * rep, t, D] dO_s
               const float* __restrict__ lse,              // [bh_kv * rep, ld]
               const float* __restrict__ di,               // [bh_kv * rep, ld]
               float* __restrict__ dq,                     // [bh_kv * rep, t, D]
               int rep, int t, int s, int ld, int bq, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + DQ_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  int* released = reinterpret_cast<int*>(smem + DQ_OFF_BAR + COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // the last rows (the most key tiles) first
  // Causal: keys past the block's last query position (below t) are never
  // visible.
  const int kv_hi = causal ? min(s, min(t, q0 + bq)) : s;
  const int n_tiles = (kv_hi + TILE - 1) / TILE;

  init_ring(bars, released, DQ_STAGES);

  auto load_kv = [&](int j) {  // key tile j into stage j % DQ_STAGES
    const int st = j % DQ_STAGES;
    const uint32_t tiles = base + DQ_OFF_RING + st * 2 * BF_TILE;
    mbar_expect_tx(full(st), 2 * BF_TILE);
    tma_load_3d(tiles, &k_map, full(st), 0, j * TILE, bh);
    tma_load_3d(tiles + BF_TILE, &v_map, full(st), 0, j * TILE, bh);
  };
  if (tid == 0)
    for (int j = 0; j < min(DQ_STAGES, n_tiles); ++j) load_kv(j);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int rows = rep * bq;  // live rows of the block (<= DQ_ROWS)

  // Q rows of the whole GQA group -> shared, K-major with the 128-byte
  // swizzle (16-byte chunk c of row r at c ^ (r & 7)); zeros for dead rows
  // and positions past t. Every load is issued before the first store.
  constexpr int Q_PASSES = DQ_ROWS * (D / 8) / THREADS;
  uint4 qv[Q_PASSES];
#pragma unroll
  for (int i = 0; i < Q_PASSES; ++i) {
    const int c = tid + THREADS * i;
    const int r = c / (D / 8), c8 = c % (D / 8);
    const int p = q0 + r % bq;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && p < t)
      qv[i] = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(bh * rep + r / bq) * t + p) * D + c8 * 8);
  }
#pragma unroll
  for (int i = 0; i < Q_PASSES; ++i) {
    const int c = tid + THREADS * i;
    const int r = c / (D / 8), c8 = c % (D / 8);
    *reinterpret_cast<uint4*>(smem + r * 128 + ((c8 ^ (r & 7)) << 4)) = qv[i];
  }

  // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its
  // warp): dO as the A fragments of dP = dO V^T, lse and D.
  const int ra = wg * 64 + warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
  float lse_r[2], di_r[2];
  uint32_t doa[4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos[h] = q0 + r % bq;
    live[h] = r < rows && pos[h] < t;
    const size_t head = static_cast<size_t>(bh) * rep + r / bq;
    lse_r[h] = live[h] ? lse[head * ld + pos[h]] : 0.f;
    di_r[h] = live[h] ? di[head * ld + pos[h]] : 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(dout + (head * t + pos[h]) * D + 16 * kk + cq);
      doa[kk][h] = live[h] ? src[0] : 0u;
      doa[kk][2 + h] = live[h] ? src[4] : 0u;  // head dims + 8
    }
  }
  fence_proxy_async();  // Q, for wgmma
  named_barrier(1, THREADS);

  const uint64_t desc_q = desc_kmajor_sw128(base + wg * BF_TILE);
  float dq_acc[ACC], sc[ACC], dp[ACC];
  uint32_t dsa[4][4] = {};  // bf16 dS: the A of dQ
  zero(dq_acc);
  zero(sc);
  zero(dp);
  auto release = [&](int j) {
    release_stage(released, j, DQ_STAGES, n_tiles, load_kv);
  };

  // A tile's K and V are waited for while no product is in flight (tile 0
  // here, tile j + 1 before tile j's dQ): a wait's trap path with a product's
  // registers live makes ptxas inject a warpgroup.wait there (C7517).
  mbar_wait(full(0), 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % DQ_STAGES;
    const int k0 = j * TILE;
    const uint32_t tiles = base + DQ_OFF_RING + st * 2 * BF_TILE;
    {  // S = Q K^T (SS) and dP = dO V^T (A in registers); K and V K-major
      const uint64_t desc_kt = desc_kmajor_sw128(tiles);
      const uint64_t desc_vt = desc_kmajor_sw128(tiles + BF_TILE);
      reg_fence(sc);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n64k16_ss(sc, desc_q + 2 * kk, desc_kt + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_KMAJOR>(dp, doa[kk], desc_vt + 2 * kk, kk > 0);
      wgmma_commit();
    }
    // the last tile's dQ is done: its stage is released while this tile's S
    // and dP run
    wgmma_wait<1>();
    if (j > 0) release(j - 1);
    wgmma_wait<0>();  // this tile's S and dP are done
    reg_fence(sc);
    reg_fence(dp);
    reg_fence(dq_acc);
    reg_fence(dsa);
    // masking only where the tile reaches past s or the diagonal
    if (k0 + TILE > s || (causal && k0 + TILE - 1 > q0))
      dq_ds<true>(sc, dp, lse_r, di_r, k0, cq, pos, s, causal, dsa);
    else
      dq_ds<false>(sc, dp, lse_r, di_r, k0, cq, pos, s, causal, dsa);
    if (j + 1 < n_tiles) mbar_wait(full((j + 1) % DQ_STAGES), ((j + 1) / DQ_STAGES) & 1);
    reg_fence(dsa);
    {  // dQ += dS K (B = the K tile, MN-major)
      const uint64_t desc_kn = desc_mnmajor_sw128(tiles);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_acc, dsa[kk], desc_kn + 128 * kk, 1);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  reg_fence(dq_acc);
  reg_fence(dsa);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = ra + 8 * h;
    const size_t off = ((static_cast<size_t>(bh) * rep + r / bq) * t + pos[h]) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dq + off + 8 * n) =
          make_float2(dq_acc[4 * n + 2 * h], dq_acc[4 * n + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// Fast mode's operand prep: one launch for q, dO and O
// ---------------------------------------------------------------------------

// Eight elements of a row (f32 or bf16) as raw words: f32 fills both, bf16
// the first.
__device__ __forceinline__ void load8(uint4 (&w)[2], const void* base, long long off, int f32) {
  if (f32) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const float*>(base) + off);
    w[0] = src[0];
    w[1] = src[1];
  } else {
    w[0] = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off);
  }
}

// The eight values as f32 (a bf16's f32 is its bits in the upper half).
__device__ __forceinline__ void widen8_f32(float (&x)[8], const uint4 (&w)[2], int f32) {
  const uint32_t a[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
  if (f32) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(a[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(a[e] << 16);
      x[2 * e + 1] = __uint_as_float(a[e] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = as_u32(__floats2bfloat162_rn(x[2 * i], x[2 * i + 1]));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Rows {  // a [b, h, t, 64] tensor: base, f32 (else bf16), strides in elements
  const void* p;
  long long sb, sh, st;
  int f32;
  __device__ __forceinline__ long long at(int batch, int head, int tok) const {
    return batch * sb + head * sh + tok * st;
  }
};

// Grid (PREP_ROWS positions along t, b * h); eight threads a row, each eight
// elements, PREP_PASSES rows a thread with all loads issued before the
// first store. Per element: q_s = bf16(f32(q) * qk_scale), dos = f32(dO) *
// sm_scale, dO_s = bf16(dos); per row: D = the sum of dos * f32(O) (each
// product rounded, as the plain version's), and lse copied; D and lse go to
// rows ld floats apart.
constexpr int PREP_PASSES = 4;
constexpr int PREP_ROWS = PREP_PASSES * 256 / 8;
__global__ void __launch_bounds__(256)
bwd_prep_kernel(Rows q, Rows dout, Rows o, const float* __restrict__ lse,  // lse [b * h, t]
                __nv_bfloat16* __restrict__ qs, __nv_bfloat16* __restrict__ dos,  // [b*h, t, D]
                float* __restrict__ lse_out, float* __restrict__ di,  // [b * h, ld]
                int h, int t, int ld, float qk_scale, float sm_scale) {
  const int bh = blockIdx.y, batch = bh / h, head = bh % h;
  const int c8 = threadIdx.x % 8;
  const int tok0 = blockIdx.x * PREP_ROWS + threadIdx.x / 8;
  uint4 wq[PREP_PASSES][2] = {}, wd[PREP_PASSES][2] = {}, wo[PREP_PASSES][2] = {};
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + 32 * i;
    if (tok < t) {
      load8(wq[i], q.p, q.at(batch, head, tok) + 8 * c8, q.f32);
      load8(wd[i], dout.p, dout.at(batch, head, tok) + 8 * c8, dout.f32);
      load8(wo[i], o.p, o.at(batch, head, tok) + 8 * c8, o.f32);
    }
  }
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + 32 * i;
    float xq[8], xd[8], xo[8];
    widen8_f32(xq, wq[i], q.f32);
    widen8_f32(xd, wd[i], dout.f32);
    widen8_f32(xo, wo[i], o.f32);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xq[e] = __fmul_rn(xq[e], qk_scale);
      xd[e] = __fmul_rn(xd[e], sm_scale);
      part = __fadd_rn(part, __fmul_rn(xd[e], xo[e]));
    }
#pragma unroll
    for (int m = 1; m < 8; m *= 2) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, m));
    if (tok < t) {
      const size_t row = static_cast<size_t>(bh) * t + tok;
      reinterpret_cast<uint4*>(qs)[row * (D / 8) + c8] = pack8(xq);
      reinterpret_cast<uint4*>(dos)[row * (D / 8) + c8] = pack8(xd);
      if (c8 == 0) {
        di[static_cast<size_t>(bh) * ld + tok] = part;
        lse_out[static_cast<size_t>(bh) * ld + tok] = lse[row];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// exact: fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TE = 32;          // rows and keys per tile (exact)
constexpr int FROW = D + 1;     // padded shared row (f32)
constexpr int PROW = TE + 1;    // padded shared row of a P / dS tile (f32)
constexpr int THREADS_E = 256;  // exact kernels: thread = (row tid / 8, lane tid % 8)

// Rows row0 .. row0+TE-1 of a row-major [n, D] f32 matrix into a padded
// shared tile; rows at or past n are zero.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < TE * (D / 4); c += THREADS_E) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    float* o = &dst[r * FROW + col];
    o[0] = val.x;
    o[1] = val.y;
    o[2] = val.z;
    o[3] = val.w;
  }
}

// dS = P (dP - D): dP summed in float64 and the f32 D subtracted there (both
// exact in float64), the difference rounded to f32, times the f32 P.
__device__ __forceinline__ float exact_ds(float p, double dp, float d) {
  return p * static_cast<float>(dp - static_cast<double>(d));
}

// B2 exact: one block per (batch*kv_head, TE-key tile). Thread (r, c) =
// (tid / 8, tid % 8) owns key r of the tile: columns c + 8i of its dK/dV
// rows and of its P^T/dS^T rows.
__global__ void __launch_bounds__(THREADS_E)
dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               float* __restrict__ dk, float* __restrict__ dv,
               int rep, int t, int s, int causal, float dk_scale, float dv_scale) {
  __shared__ float k_s[TE * FROW];
  __shared__ float v_s[TE * FROW];
  __shared__ float q_s[TE * FROW];
  __shared__ float do_s[TE * FROW];
  __shared__ float p_s[TE * PROW];
  __shared__ float ds_s[TE * PROW];
  __shared__ float lse_s[TE];
  __shared__ float di_s[TE];

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * TE;
  const int key = k0 + r;

  load_tile_f32(k_s, k + bh * s * D, k0, s);
  load_tile_f32(v_s, v + bh * s * D, k0, s);

  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int j0 = causal ? k0 / TE : 0;
  const int n_qt = (t + TE - 1) / TE;
  for (int g = 0; g < rep; ++g) {
    const size_t row0 = (bh * rep + g) * t;
    for (int j = j0; j < n_qt; ++j) {
      const int q0 = j * TE;
      __syncthreads();
      load_tile_f32(q_s, q + row0 * D, q0, t);
      load_tile_f32(do_s, dout + row0 * D, q0, t);
      if (tid < TE) {
        const bool live = q0 + tid < t;
        lse_s[tid] = live ? lse[row0 + q0 + tid] : 0.f;
        di_s[tid] = live ? di[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      float st[TE / 8];
      double dpt[TE / 8];
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.0;
      }
      for (int d = 0; d < D; ++d) {
        const float kd = k_s[r * FROW + d];
        const double vd = v_s[r * FROW + d];
#pragma unroll
        for (int i = 0; i < TE / 8; ++i) {
          st[i] = fmaf(kd, q_s[(c + 8 * i) * FROW + d], st[i]);
          dpt[i] = fma(vd, static_cast<double>(do_s[(c + 8 * i) * FROW + d]), dpt[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) {
        const int col = c + 8 * i;
        const int pos = q0 + col;
        const bool valid = key < s && pos < t && (!causal || key <= pos);
        const float p = valid ? exp2f(st[i] - lse_s[col]) : 0.f;
        p_s[r * PROW + col] = p;
        ds_s[r * PROW + col] = exact_ds(p, dpt[i], di_s[col]);
      }
      __syncthreads();

      for (int col = 0; col < TE; ++col) {
        const float p = p_s[r * PROW + col];
        const float ds = ds_s[r * PROW + col];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          dv_acc[i] = fmaf(p, do_s[col * FROW + c + 8 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, q_s[col * FROW + c + 8 * i], dk_acc[i]);
        }
      }
    }
  }

  if (key < s) {
    const size_t off = (bh * s + key) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dk[off + 8 * i] = dk_acc[i] * dk_scale;
      dv[off + 8 * i] = dv_acc[i] * dv_scale;
    }
  }
}

// B3 exact: one block per (q head, TE-row q tile); blockIdx.y indexes the
// [bh_kv, rep] q heads, so the kv head is blockIdx.y / rep. Thread (r, c)
// owns row r: columns c + 8i of its dQ row and of its dS row.
__global__ void __launch_bounds__(THREADS_E)
dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dq, int rep, int t, int s, int causal) {
  __shared__ float q_s[TE * FROW];
  __shared__ float do_s[TE * FROW];
  __shared__ float k_s[TE * FROW];
  __shared__ float v_s[TE * FROW];
  __shared__ float ds_s[TE * PROW];

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t head = blockIdx.y;
  const size_t bh = head / rep;
  const int q0 = blockIdx.x * TE;
  const int pos = q0 + r;
  const bool live = pos < t;

  load_tile_f32(q_s, q + head * t * D, q0, t);
  load_tile_f32(do_s, dout + head * t * D, q0, t);
  const float lse_r = live ? lse[head * t + pos] : 0.f;
  const float di_r = live ? di[head * t + pos] : 0.f;

  float dq_acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + TE) : s;
  const int n_tiles = (kv_hi + TE - 1) / TE;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TE;
    __syncthreads();
    load_tile_f32(k_s, k + bh * s * D, k0, s);
    load_tile_f32(v_s, v + bh * s * D, k0, s);
    __syncthreads();

    float sc[TE / 8];
    double dp[TE / 8];
#pragma unroll
    for (int i = 0; i < TE / 8; ++i) {
      sc[i] = 0.f;
      dp[i] = 0.0;
    }
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * FROW + d];
      const double dod = do_s[r * FROW + d];
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) {
        sc[i] = fmaf(qd, k_s[(c + 8 * i) * FROW + d], sc[i]);
        dp[i] = fma(dod, static_cast<double>(v_s[(c + 8 * i) * FROW + d]), dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < TE / 8; ++i) {
      const int col = k0 + c + 8 * i;
      const bool valid = live && col < s && (!causal || col <= pos);
      const float p = valid ? exp2f(sc[i] - lse_r) : 0.f;
      ds_s[r * PROW + c + 8 * i] = exact_ds(p, dp[i], di_r);
    }
    __syncthreads();

    for (int kk = 0; kk < TE; ++kk) {
      const float ds = ds_s[r * PROW + kk];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) dq_acc[i] = fmaf(ds, k_s[kk * FROW + c + 8 * i], dq_acc[i]);
    }
  }

  if (live) {
    const size_t off = (head * t + pos) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dq[off + 8 * i] = dq_acc[i];
  }
}

// Raise a kernel's dynamic shared memory limit once.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// A [n, rows, 64] bf16 map (contiguous), boxes of 64 rows with the 128-byte
// swizzle; rows past `rows` arrive as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int n, int rows) {
  return tensor_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, rows, D, TILE, D,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// A map over n rows of t f32 (rows ld floats apart), boxes of 64 positions of
// one row; positions past t arrive as zeros.
bool row_map(CUtensorMap* map, const void* ptr, int n, int t, int ld) {
  const long long bytes = 4LL * ld;
  const long long stride[3] = {bytes, bytes, bytes * n};
  return tensor_map_4d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, n, 1, t, stride, 1, TILE,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

bool strides16(long long elem_bytes, long long sb, long long sh, long long st) {
  return (sb * elem_bytes) % 16 == 0 && (sh * elem_bytes) % 16 == 0 && (st * elem_bytes) % 16 == 0;
}

}  // namespace

// Shared bytes one fast block asks for (ops/flash_tiling.py mirrors them).
extern "C" int qa_flash_bwd_dkv_smem_bytes() { return DKV_SMEM; }
extern "C" int qa_flash_bwd_dq_smem_bytes() { return DQ_SMEM; }

// Fast mode's prep: q, dout, o [b, h, t, 64] (each f32 or bf16, strides in
// elements, rows contiguous, pointers and strides 16-byte aligned), lse [b *
// h, t] f32 -> qs, dos [b, h, t, 64] bf16 and lse_out, di [b * h, ld] f32
// (ld >= t), in one launch.
extern "C" int qa_flash_bwd_prep(const void* q, long long q_sb, long long q_sh, long long q_st,
                                 int q_f32, const void* dout, long long do_sb, long long do_sh,
                                 long long do_st, int do_f32, const void* o, long long o_sb,
                                 long long o_sh, long long o_st, int o_f32, const void* lse,
                                 void* qs, void* dos, void* lse_out, void* di, int b, int h,
                                 int t, int ld, float qk_scale, float sm_scale, void* stream) {
  if (b < 1 || h < 1 || static_cast<long long>(b) * h > 65535 || t < 1 || ld < t ||
      !aligned16(q) || !aligned16(dout) || !aligned16(o) || !aligned16(qs) || !aligned16(dos) ||
      !strides16(q_f32 ? 4 : 2, q_sb, q_sh, q_st) ||
      !strides16(do_f32 ? 4 : 2, do_sb, do_sh, do_st) ||
      !strides16(o_f32 ? 4 : 2, o_sb, o_sh, o_st))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + PREP_ROWS - 1) / PREP_ROWS, b * h);
  bwd_prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      Rows{q, q_sb, q_sh, q_st, q_f32}, Rows{dout, do_sb, do_sh, do_st, do_f32},
      Rows{o, o_sb, o_sh, o_st, o_f32}, static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(qs), static_cast<__nv_bfloat16*>(dos),
      static_cast<float*>(lse_out), static_cast<float*>(di), h, t, ld, qk_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// B2: dK, dV [bh_kv, s, D] f32. q/dout [bh_kv, rep, t, D], k/v [bh_kv, s, D]
// (contiguous): bf16 when fast, else f32; lse/di [bh_kv * rep, ld] f32 (fast:
// ld a multiple of 4, at least t; exact: ld == t).
extern "C" int qa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dk, void* dv, int bh_kv,
                                int rep, int t, int s, int ld, int causal, int fast,
                                float dk_scale, float dv_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh_kv < 1 || rep < 1 || t < 1 || s < 1 || ld < t)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!fast) {
    if (ld != t) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((s + TE - 1) / TE, bh_kv);
    dkv_kernel_f32<<<grid, THREADS_E, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), rep, t, s,
        causal, dk_scale, dv_scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_kt = (s + DKV_KEYS - 1) / DKV_KEYS;
  if (n_kt > 65535 || ld % 4 || static_cast<long long>(bh_kv) * rep > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, do_map, k_map, v_map, lse_map, di_map;
  if (!tile_map(&q_map, q, bh_kv * rep, t) || !tile_map(&do_map, dout, bh_kv * rep, t) ||
      !tile_map(&k_map, k, bh_kv, s) || !tile_map(&v_map, v, bh_kv, s) ||
      !row_map(&lse_map, lse, bh_kv * rep, t, ld) || !row_map(&di_map, di, bh_kv * rep, t, ld))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(dkv_kernel_bf16, DKV_SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh_kv, n_kt);
  dkv_kernel_bf16<<<grid, THREADS, DKV_SMEM, st>>>(q_map, do_map, k_map, v_map, lse_map, di_map,
                                                   static_cast<float*>(dk), static_cast<float*>(dv),
                                                   rep, t, s, causal, dk_scale, dv_scale);
  return static_cast<int>(cudaGetLastError());
}

// B3: dQ [bh_kv, rep, t, D] f32, same inputs as B2; bq query positions a fast
// block (rep * bq <= 128).
extern "C" int qa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq, int bh_kv, int rep,
                               int t, int s, int ld, int bq, int causal, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh_kv < 1 || rep < 1 || t < 1 || s < 1 || ld < t)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!fast) {
    if (ld != t || static_cast<long long>(bh_kv) * rep > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((t + TE - 1) / TE, bh_kv * rep);
    dq_kernel_f32<<<grid, THREADS_E, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<float*>(dq), rep, t, s, causal);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_qb = bq < 1 ? 0 : (t + bq - 1) / bq;
  if (bq < 1 || rep * bq > DQ_ROWS || n_qb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_map, v_map;
  if (!tile_map(&k_map, k, bh_kv, s) || !tile_map(&v_map, v, bh_kv, s))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(dq_kernel_bf16, DQ_SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh_kv, n_qb);
  dq_kernel_bf16<<<grid, THREADS, DQ_SMEM, st>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dq), rep,
      t, s, ld, bq, causal);
  return static_cast<int>(cudaGetLastError());
}
