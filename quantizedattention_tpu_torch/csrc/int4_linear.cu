// Weight-only int4 matmul for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/int4_linear.py:_kernel
// (B18). The weight is split-half packed: byte row r of packed [Kp/2, n]
// holds row r of the weight in its low nibble and row r + Kp/2 in its high
// nibble; scale [Kp/group, n] holds one f32 per (group of k rows, column),
// the lower half's groups first. Same numerics as the TPU kernel: x [m, Kp]
// in bf16 (the wrapper casts), each nibble entering the product exactly as a
// bf16 integer; for each group t the lower half's sub-dot is taken in f32,
// multiplied by scale row t and added to the accumulator, then the upper
// half's, multiplied by row n_groups + t; the scale never meets a bf16
// operand, and the result is cast to the output type once. One launch a
// call, no float atomics: the same inputs give the same bits.
//
// What bounds it on this card, and the two regimes (ops/linear_tiling.py
// chooses the launch and mirrors the constants below), as
// csrc/int8_linear.cu:
//
// 1. Streaming (m <= 64: decode, spec verify): the packed weight stream, a
//    quarter of bf16's bytes (Kp n / 2 / 3.35 TB/s: 0.63 us at 1024 x 4096).
//    A block takes BN = 64 or 128 columns and a contiguous range of 64-row
//    chunks of the packed rows, split over the blocks of a cluster (at most
//    8) and summed through distributed shared memory in rank order. A ring
//    stage (TMA, 4 stages) holds a packed chunk and the x columns of both
//    halves it meets. A thread reads 4 contiguous bytes of 4 packed rows and
//    turns each byte's nibbles into bf16 with masks, byte permutes and one
//    bf16x2 fma (no conversion instruction); the weights are the mma.sync's
//    A operand and x its B, as in int8_linear.cu. Each block takes the lower
//    half's sub-dot of a chunk, multiplies it by the group's lower scale row
//    and adds it to its accumulator, then the same for the upper half: a
//    group's sub-dot is split into 64-row pieces (by chunk, and where the k
//    split cuts a group, by block), each scaled on its own. That is only a
//    different f32 rounding of the same sum.
// 2. Tensor cores (m > 64: prefill): 2 m Kp n bf16 operations. A block of
//    128 x 128 outputs, two warpgroups, thread 0 issuing TMA into a ring of
//    4 stages. Stage j holds one 64-row chunk of one group's one half: the x
//    tile [128, 64] bf16 at columns h half + t group + c0 and the packed
//    tile [64, 128], both with the 128-byte swizzle; the stages walk group
//    t's lower half, then its upper half (each packed chunk arrives twice,
//    the second time mostly from L2). As in int8_linear.cu, the half's
//    nibbles are widened in registers into the A operand of
//    wgmma.m64n128k16 (x is B, from shared memory), chunk j + 1's while
//    chunk j's products run. A half's chunks run into one sub-accumulator,
//    zeroed by its first product; once its last products are done it is
//    folded in as acc += sub * s: JAX's order within a group, with one
//    sub-accumulator.
//
// group divides Kp/2 (JAX's rule: any positive divisor). A group that is a
// multiple of 64 runs the instances above. Any other group runs a second
// instance of each kernel (ANY): a 64-row chunk (the last one cut at Kp/2)
// meets one or more groups, and each piece (chunk and group) is a sub-dot of
// its own, scaled on its own and added; where a group is not a multiple of
// 16 one k16 step meets two groups, and each product sees only its group's
// rows of the widened A fragment (the others' are zeroed), so the step is
// issued once per group. The tensor-core instance drains each piece's
// products before it folds them: a slow path (PERF.md has its time).
//
// TMA needs 16-byte row strides and bases (n % 16 == 0 for the packed rows,
// Kp/2 % 4 == 0 for x's); where a shape does not give them, the same kernels
// fill the same shared layout with plain loads, masked element by element.

#include "hopper.cuh"

namespace {

constexpr int CHUNK = 64;        // packed rows a stage
constexpr int STREAM_MAX_M = 64;
constexpr int S_THREADS = 128;
constexpr int S_STAGES = 4;
constexpr int MAX_SPLIT = 8;
constexpr int TC_BM = 128, TC_BN = 128;
constexpr int TC_THREADS = 256;  // two warpgroups, 64 columns each
constexpr int TC_STAGES = 4;
constexpr int TC_X = TC_BM * CHUNK * 2;
constexpr int TC_STAGE = TC_X + CHUNK * TC_BN;
constexpr int TC_OFF_BAR = TC_STAGES * TC_STAGE;
constexpr int TC_SMEM = TC_OFF_BAR + 128 + 1024;

// Streaming stage layout: the x boxes [8 nt, 64] bf16 of the lower and the
// upper half (rows of 128 bytes, 128-byte swizzle), then the packed box
// [64, bn] (64-byte swizzle at bn 64, 128-byte at bn 128), each a multiple
// of 1024 bytes.
__host__ __device__ constexpr int stream_stage(int nt, int bn) {
  return 2 * nt * 8 * 128 + CHUNK * bn;
}

// Dynamic shared bytes of a streaming block: the ring (which the block's own
// partial reuses), the receive buffer of the cluster sum, the mbarriers, and
// 1024 bytes to align the swizzled boxes.
constexpr int stream_smem(int nt, int bn) {
  return S_STAGES * stream_stage(nt, bn) +
         4 * cluster_recv_floats(nt * 8 * bn, MAX_SPLIT, S_THREADS) + 128 + 1024;
}

// --- streaming regime ---

// As int8_linear.cu, the weights are the mma's A operand and x its B.
template <int NT, int BN, bool ANY>
__global__ void __launch_bounds__(S_THREADS, 1)
int4_stream_kernel(const __grid_constant__ CUtensorMap x_map,  // [m, 2 half] bf16, box [8 NT, 64]
                   const __grid_constant__ CUtensorMap w_map,  // [half, n] packed, box [64, BN]
                   const __nv_bfloat16* __restrict__ x,        // [m, 2 * half]
                   const int8_t* __restrict__ packed,          // [half, n]
                   const float* __restrict__ scale,            // [2 * half / group, n]
                   void* __restrict__ out,                     // [m, n] of out_type
                   int m, int n, int half, int group, int out_type, int tma) {
  constexpr int CW = BN / 32;
  constexpr int WK = S_THREADS / 32 / CW;
  constexpr int XB = NT * 8 * 128;  // bytes of one half's x box
  constexpr int STAGE = stream_stage(NT, BN);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* recv = reinterpret_cast<float*>(smem + S_STAGES * STAGE);
  const uint32_t bars =
      base + S_STAGES * STAGE + 4 * cluster_recv_floats(NT * 8 * BN, MAX_SPLIT, S_THREADS);
  auto full = [&](int st) { return bars + 8 * st; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cw = warp % CW, wk = warp / CW;
  const int g = lane / 4, q = lane % 4;
  const int split = gridDim.x;
  const int rank = cluster_ctarank();
  const int n0 = blockIdx.y * BN;
  const int kp = 2 * half;
  const int n_groups = half / group;
  const int chunks = ANY ? (half + CHUNK - 1) / CHUNK : half / CHUNK;
  const int c_lo = rank * chunks / split;
  const int n_local = (rank + 1) * chunks / split - c_lo;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S_STAGES; ++i) mbar_init(full(i), tma ? 1 : S_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto w_piece = [](int r, int p) { return BN == 128 ? p ^ (r & 7) : p ^ ((r >> 1) & 3); };
  // Local chunk i -> stage i % S_STAGES (packed row = lower-half x column),
  // by TMA or by every thread with masked loads in the same layout.
  auto load = [&](int i) {
    if (i >= n_local) return;
    const int st = i % S_STAGES, rb = (c_lo + i) * CHUNK;
    if (tma) {
      if (tid == 0) {
        mbar_expect_tx(full(st), STAGE);
        tma_load_2d(base + st * STAGE, &x_map, full(st), rb, 0);
        tma_load_2d(base + st * STAGE + XB, &x_map, full(st), half + rb, 0);
        tma_load_2d(base + st * STAGE + 2 * XB, &w_map, full(st), n0, rb);
      }
      return;
    }
    uint8_t* xs = smem + st * STAGE;
    for (int c = tid; c < 2 * m * 8; c += S_THREADS) {
      const int hz = c / (m * 8), r = (c / 8) % m, p = c % 8;
      const size_t src = (size_t)r * kp + hz * half + rb + p * 8;
      uint4* dst = reinterpret_cast<uint4*>(xs + hz * XB + r * 128 + ((p ^ (r & 7)) << 4));
      if constexpr (ANY) {  // columns past the half are 0
        uint16_t e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          e[u] = rb + p * 8 + u < half ? reinterpret_cast<const uint16_t*>(x)[src + u] : 0;
        *dst = *reinterpret_cast<const uint4*>(e);
      } else {
        *dst = *reinterpret_cast<const uint4*>(x + src);  // 16-byte aligned: kp % 128 == 0
      }
    }
    for (int c = tid; c < CHUNK * (BN / 16); c += S_THREADS) {
      const int r = c / (BN / 16), p = c % (BN / 16), gn = n0 + p * 16;
      const bool row = !ANY || rb + r < half;
      int8_t e[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        e[u] = row && gn + u < n ? packed[(size_t)(rb + r) * n + gn + u] : 0;
      *reinterpret_cast<uint4*>(xs + 2 * XB + r * BN + (w_piece(r, p) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    mbar_arrive(full(st));
  };

  // acc and sub [t][nt][e]: weight column C + 2t + e / 2 of the block's, x
  // row 8 nt + 2q + (e & 1), C = 32 cw + 4 g (as int8_linear.cu).
  const int C = cw * 32 + 4 * g;
  float acc[2][NT][4], sub[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // ANY: the chunk of packed rows rb .. rb + 63 (cut at half) in stage st,
  // one piece a group it meets and a half: the piece's rows of each
  // fragment only (a warp skips a k16 step outside the piece), its sub-dot
  // scaled by the group's row and added.
  auto any_chunk = [&](int st, int rb) {
    const uint8_t* ws = smem + st * STAGE + 2 * XB;
    const int r_end = min(rb + CHUNK, half);
#pragma unroll 1
    for (int hz = 0; hz < 2; ++hz) {  // lower half, then upper
      const uint8_t* xs = smem + st * STAGE + hz * XB;
      for (int tg = rb / group; tg * group < r_end; ++tg) {
        const int lo = max(rb, tg * group) - rb, hi = min(r_end, (tg + 1) * group) - rb;
        float sg[4];  // the group's scale row of this half at columns C .. C + 3
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sg[c] = n0 + C + c < n ? scale[(size_t)(hz * n_groups + tg) * n + n0 + C + c] : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sub[t][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < CHUNK / 16 / WK; ++ks) {
          const int kk = (ks * WK + wk) * 16;
          if (kk + 16 <= lo || kk >= hi) continue;
          uint32_t b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t* xr = xs + (nt * 8 + g) * 128 + 4 * q;
            b[nt][0] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8) ^ g) << 4));
            b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8 + 1) ^ g) << 4));
          }
          uint32_t p[4];  // packed rows kk + 2q, + 1, + 8, + 9: this half's nibbles
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int r = kk + 2 * q + (d & 1) + 8 * (d / 2);
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                ws + r * BN + (w_piece(r, C >> 4) << 4) + (C & 15));
            p[d] = hz ? high_nibbles(v) : low_nibbles(v);
          }
          // a fragment's low bf16 is row kk + 2q (+ 8), its high one the next row
          auto in = [&](int r) { return lo <= r && r < hi; };
          const int r0 = kk + 2 * q;
          const uint32_t m01 = (in(r0) ? 0xFFFFu : 0u) | (in(r0 + 1) ? 0xFFFF0000u : 0u);
          const uint32_t m89 = (in(r0 + 8) ? 0xFFFFu : 0u) | (in(r0 + 9) ? 0xFFFF0000u : 0u);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t a[4] = {nibble_pair(p[0], p[1], 2 * t) & m01,
                                   nibble_pair(p[0], p[1], 2 * t + 1) & m01,
                                   nibble_pair(p[2], p[3], 2 * t) & m89,
                                   nibble_pair(p[2], p[3], 2 * t + 1) & m89};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(sub[t][nt], a, b[nt][0], b[nt][1]);
          }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[t][nt][e] =
                  __fadd_rn(acc[t][nt][e], __fmul_rn(sub[t][nt][e], sg[2 * t + e / 2]));
      }
    }
  };

  for (int i = 0; i < S_STAGES; ++i) load(i);
  for (int i = 0; i < n_local; ++i) {
    const int st = i % S_STAGES;
    if constexpr (ANY) {
      mbar_wait(full(st), (i / S_STAGES) & 1);
      any_chunk(st, (c_lo + i) * CHUNK);
    } else {
      const int tg = (c_lo + i) * CHUNK / group;
      mbar_wait(full(st), (i / S_STAGES) & 1);
      const uint8_t* ws = smem + st * STAGE + 2 * XB;
#pragma unroll(NT < 8 ? 2 : 1)  // at NT 8 both halves at once would spill
      for (int hz = 0; hz < 2; ++hz) {  // lower half, then upper
        const uint8_t* xs = smem + st * STAGE + hz * XB;
        float s[4];  // the group's scale row of this half at columns C .. C + 3
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c] = n0 + C + c < n ? scale[(size_t)(hz * n_groups + tg) * n + n0 + C + c] : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sub[t][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < CHUNK / 16 / WK; ++ks) {
          const int kk = (ks * WK + wk) * 16;
          uint32_t b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t* xr = xs + (nt * 8 + g) * 128 + 4 * q;
            b[nt][0] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8) ^ g) << 4));
            b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8 + 1) ^ g) << 4));
          }
          uint32_t p[4];  // packed rows kk + 2q, + 1, + 8, + 9: this half's nibbles
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int r = kk + 2 * q + (d & 1) + 8 * (d / 2);
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                ws + r * BN + (w_piece(r, C >> 4) << 4) + (C & 15));
            p[d] = hz ? high_nibbles(v) : low_nibbles(v);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t a[4] = {
                nibble_pair(p[0], p[1], 2 * t), nibble_pair(p[0], p[1], 2 * t + 1),
                nibble_pair(p[2], p[3], 2 * t), nibble_pair(p[2], p[3], 2 * t + 1)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(sub[t][nt], a, b[nt][0], b[nt][1]);
          }
        }
        // acc += sub * s, the scale in f32
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[t][nt][e] =
                  __fadd_rn(acc[t][nt][e], __fmul_rn(sub[t][nt][e], s[2 * t + e / 2]));
      }
    }
    __syncthreads();  // every warp is done with stage st
    load(i + S_STAGES);
  }

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int z = 0; z < WK; ++z) {
    if (wk == z) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = (nt * 8 + 2 * q + (e & 1)) * BN + C + 2 * t + e / 2;
            red[idx] = z == 0 ? acc[t][nt][e] : __fadd_rn(red[idx], acc[t][nt][e]);
          }
    }
    __syncthreads();
  }
  cluster_reduce<S_THREADS>(red, recv, m * BN, split, rank, [&](int e, float sum) {
    const int gn = n0 + e % BN;
    if (gn < n) store_out(out, (size_t)(e / BN) * n + gn, sum, out_type);
  });
}

// --- tensor-core regime ---

// One thread's A fragments of a chunk, one m16n8k16 fragment a k16 step.
using AFrag = uint32_t[CHUNK / 16][4];

template <bool ANY>
__global__ void __launch_bounds__(TC_THREADS, 1)
int4_tc_kernel(const __grid_constant__ CUtensorMap x_map,  // [m, 2 half] bf16, box [128, 64]
               const __grid_constant__ CUtensorMap w_map,  // [half, n] packed, box [64, 128]
               const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
               const float* __restrict__ scale, void* __restrict__ out, int m, int n, int half,
               int group, int out_type, int tma) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto full = [&](int st) { return base + TC_OFF_BAR + 8 * st; };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kp = 2 * half;
  const int n_groups = half / group;
  const int cpg = group / CHUNK;    // chunks of a group's half: a run
  const int nk = ANY ? 2 * ((half + CHUNK - 1) / CHUNK) : 2 * half / CHUNK;  // each chunk twice
  // chunk j: run j / cpg = 2 t + h (group t's half h), chunk j % cpg of it;
  // ANY: packed chunk j / 2 (the last one cut at half), half j % 2
  auto x_col = [&](int j) {
    if constexpr (ANY) {
      return (j % 2) * half + (j / 2) * CHUNK;
    } else {
      const int run = j / cpg;
      return (run % 2) * half + (run / 2) * group + (j % cpg) * CHUNK;
    }
  };
  auto packed_row = [&](int j) {
    if constexpr (ANY)
      return (j / 2) * CHUNK;
    else
      return (j / cpg / 2) * group + (j % cpg) * CHUNK;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < TC_STAGES; ++i) mbar_init(full(i), tma ? 1 : TC_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk j -> stage j % TC_STAGES, both tiles with the 128-byte swizzle, by
  // TMA or by every thread (as int8_linear.cu).
  auto load = [&](int j) {
    if (j >= nk) return;
    const int st = j % TC_STAGES, xc = x_col(j), pr = packed_row(j);
    if (tma) {
      if (tid == 0) {
        mbar_expect_tx(full(st), TC_STAGE);
        tma_load_2d(base + st * TC_STAGE, &x_map, full(st), xc, m0);
        tma_load_2d(base + st * TC_STAGE + TC_X, &w_map, full(st), n0, pr);
      }
      return;
    }
    uint8_t* xs = smem + st * TC_STAGE;
    for (int c = tid; c < TC_BM * 8; c += TC_THREADS) {
      const int r = c / 8, p = c % 8, gr = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (ANY) {  // element by element, columns past the half 0
        uint16_t e[8] = {};
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (gr < m && pr + p * 8 + u < half)
            e[u] = reinterpret_cast<const uint16_t*>(x)[(size_t)gr * kp + xc + p * 8 + u];
        v = *reinterpret_cast<const uint4*>(e);
      } else {
        if (gr < m) v = *reinterpret_cast<const uint4*>(x + (size_t)gr * kp + xc + p * 8);
      }
      *reinterpret_cast<uint4*>(xs + r * 128 + ((p ^ (r & 7)) << 4)) = v;
    }
    for (int c = tid; c < CHUNK * (TC_BN / 16); c += TC_THREADS) {
      const int r = c / (TC_BN / 16), p = c % (TC_BN / 16), gn = n0 + p * 16;
      const bool row = !ANY || pr + r < half;
      int8_t e[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        e[u] = row && gn + u < n ? packed[(size_t)(pr + r) * n + gn + u] : 0;
      *reinterpret_cast<uint4*>(xs + TC_X + r * TC_BN + ((p ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    fence_proxy_async();
    mbar_arrive(full(st));
  };

  // The weights are the A operand, widened in registers from the chunk's
  // half (as int8_linear.cu: M row g (g + 8) of warp w is column C (C + 1),
  // C = 64 wg + 16 w + 2 g).
  const int C = 64 * wg + 16 * warp + 2 * g;
  auto widen = [&](int j, AFrag& a) {
    const int st = j % TC_STAGES;
    const bool upper = ANY ? j % 2 : (j / cpg) % 2;
    mbar_wait(full(st), (j / TC_STAGES) & 1);
    const uint8_t* wt = smem + st * TC_STAGE + TC_X;
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks) {
      uint32_t v[4];  // packed rows 16 ks + 2q, + 1, + 8, + 9: this half's nibbles
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int r = ks * 16 + 2 * q + (d & 1) + 8 * (d / 2);
        const uint32_t p = *reinterpret_cast<const uint16_t*>(
            wt + r * TC_BN + (((C >> 4) ^ (r & 7)) << 4) + (C & 15));
        v[d] = upper ? high_nibbles(p) : low_nibbles(p);
      }
      a[ks][0] = nibble_pair(v[0], v[1], 0);
      a[ks][1] = nibble_pair(v[0], v[1], 1);
      a[ks][2] = nibble_pair(v[2], v[3], 0);
      a[ks][3] = nibble_pair(v[2], v[3], 1);
    }
  };

  float acc[64], sub[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sub[i] = 0.f;
  // A run's first product zeroes sub.
  auto issue = [&](int j, const AFrag& a) {
    const uint64_t db = desc_kmajor_sw128(base + (j % TC_STAGES) * TC_STAGE);
    const bool first = j % cpg == 0;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks)
      wgmma_bf16_m64n128k16_rs(sub, a[ks], db + 2 * ks, !(first && ks == 0));
    wgmma_commit();
  };
  const int gc = n0 + C;
  // Chunk j's products run while chunk j + 1 is widened into the other A
  // set (free once chunk j - 1's products are done); once a run's last
  // products are done, acc += sub * s (sub[4 nn + 2 h + b] is at column C +
  // h) before the next run's first product zeroes sub. One barrier of both
  // warpgroups a chunk frees the stage of chunk j - 1 for its refill.
  auto step = [&](int j, const AFrag& cur, AFrag& next) {
    issue(j, cur);
    const bool run_end = j % cpg == cpg - 1;
    float s[2];
    if (run_end) {
      const float* srow = scale + (size_t)((j / cpg % 2) * n_groups + j / cpg / 2) * n;
      s[0] = gc < n ? srow[gc] : 0.f;
      s[1] = gc + 1 < n ? srow[gc + 1] : 0.f;
    }
    wgmma_wait<1>();
    if (j + 1 < nk) widen(j + 1, next);
    if (run_end) {
      wgmma_wait<0>();
      reg_fence(sub);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(sub[i], s[(i % 4) / 2]));
    }
    named_barrier(1, TC_THREADS);
    if (j >= 1) load(j - 1 + TC_STAGES);
  };
  for (int j = 0; j < TC_STAGES; ++j) load(j);
  if constexpr (ANY) {
    // Chunk j (packed rows rb .. rb + 63 cut at half, half j % 2) widened,
    // then one piece a group it meets: the piece's rows of the fragments
    // (the others zeroed), four products into sub, drained and folded with
    // the group's scale row. Then the stage is refilled.
    AFrag a0, am;
    for (int j = 0; j < nk; ++j) {
      widen(j, a0);
      const int rb = packed_row(j), r_end = min(rb + CHUNK, half), hz = j % 2;
      for (int tg = rb / group; tg * group < r_end; ++tg) {
        const int lo = max(rb, tg * group) - rb, hi = min(r_end, (tg + 1) * group) - rb;
        auto in = [&](int r) { return lo <= r && r < hi; };
#pragma unroll
        for (int ks = 0; ks < CHUNK / 16; ++ks) {
          const int r0 = ks * 16 + 2 * q;  // a fragment's low bf16 (+ 8), its high one the next row
          const uint32_t m01 = (in(r0) ? 0xFFFFu : 0u) | (in(r0 + 1) ? 0xFFFF0000u : 0u);
          const uint32_t m89 = (in(r0 + 8) ? 0xFFFFu : 0u) | (in(r0 + 9) ? 0xFFFF0000u : 0u);
          am[ks][0] = a0[ks][0] & m01;
          am[ks][1] = a0[ks][1] & m01;
          am[ks][2] = a0[ks][2] & m89;
          am[ks][3] = a0[ks][3] & m89;
        }
        const float* srow = scale + (size_t)(hz * n_groups + tg) * n;
        const float s0 = gc < n ? srow[gc] : 0.f, s1 = gc + 1 < n ? srow[gc + 1] : 0.f;
        const uint64_t db = desc_kmajor_sw128(base + (j % TC_STAGES) * TC_STAGE);
        reg_fence(am);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CHUNK / 16; ++ks)
          wgmma_bf16_m64n128k16_rs(sub, am[ks], db + 2 * ks, ks != 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sub);
#pragma unroll
        for (int i = 0; i < 64; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(sub[i], (i % 4) / 2 ? s1 : s0));
      }
      named_barrier(1, TC_THREADS);
      load(j + TC_STAGES);
    }
  } else {
    AFrag a0, a1;
    widen(0, a0);
    for (int j = 0; j < nk; j += 2) {
      step(j, a0, a1);
      if (j + 1 < nk) step(j + 1, a1, a0);
    }
  }

  // Epilogue: cast once, masked. acc[4 nn + 2 h + b]: column C + h, x row
  // 8 nn + 2 q + b.
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int nn = 0; nn < TC_BM / 8; ++nn)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int gr = m0 + 8 * nn + 2 * q + b;
      if (gr >= m) continue;
      const size_t o = (size_t)gr * n + gc;
      if (pairs && gc + 1 < n) {
        store_out2(out, o, acc[4 * nn + b], acc[4 * nn + 2 + b], out_type);
      } else {
        if (gc < n) store_out(out, o, acc[4 * nn + b], out_type);
        if (gc + 1 < n) store_out(out, o + 1, acc[4 * nn + 2 + b], out_type);
      }
    }
}

template <int NT, int BN, bool ANY>
int launch_stream(const void* x, const void* packed, const void* scale, void* out, int m, int n,
                  int half, int group, int out_type, int split, cudaStream_t stream) {
  constexpr int smem = stream_smem(NT, BN);
  const int tma = n % 16 == 0 && half % 4 == 0 && aligned16(x) && aligned16(packed);
  CUtensorMap x_map = {}, w_map = {};
  if (tma && (!tensor_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, 2 * half, NT * 8,
                             CHUNK, CU_TENSOR_MAP_SWIZZLE_128B) ||
              !tensor_map_2d(&w_map, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, n, CHUNK, BN,
                             BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_stream_kernel<NT, BN, ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + BN - 1) / BN);
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int4_stream_kernel<NT, BN, ANY>, x_map, w_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale), out, m, n, half,
      group, out_type, tma);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BN, bool ANY>
int launch_stream_m(const void* x, const void* packed, const void* scale, void* out, int m, int n,
                    int half, int group, int out_type, int split, cudaStream_t st) {
#define QA_LAUNCH(NT) \
  return launch_stream<NT, BN, ANY>(x, packed, scale, out, m, n, half, group, out_type, split, st)
  switch ((m + 7) / 8) {
    case 1: QA_LAUNCH(1);
    case 2: QA_LAUNCH(2);
    case 3: QA_LAUNCH(3);
    case 4: QA_LAUNCH(4);
    case 5: QA_LAUNCH(5);
    case 6: QA_LAUNCH(6);
    case 7: QA_LAUNCH(7);
    default: QA_LAUNCH(8);
  }
#undef QA_LAUNCH
}

template <bool ANY>
int launch_tc(const void* x, const void* packed, const void* scale, void* out, int m, int n,
              int half, int group, int out_type, cudaStream_t stream) {
  const int tma = n % 16 == 0 && half % 4 == 0 && aligned16(x) && aligned16(packed);
  CUtensorMap x_map = {}, w_map = {};
  if (tma && (!tensor_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, 2 * half, TC_BM,
                             CHUNK, CU_TENSOR_MAP_SWIZZLE_128B) ||
              !tensor_map_2d(&w_map, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, n, CHUNK,
                             TC_BN, CU_TENSOR_MAP_SWIZZLE_128B)))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_tc_kernel<ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM);
  int4_tc_kernel<ANY><<<grid, TC_THREADS, TC_SMEM, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), out, m, n, half, group, out_type, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes one block asks for at m rows and bn columns a block
// (ops/linear_tiling.py's shared_bytes mirrors it).
extern "C" int qa_int4_linear_smem_bytes(int m, int bn) {
  return m <= STREAM_MAX_M ? stream_smem((m + 7) / 8, bn) : TC_SMEM;
}

// x [m, 2 * half] bf16, packed [half, n] int8, scale [2 * half / group, n]
// f32 -> out [m, n] of out_type (0 f32, 1 bf16). group divides half (a
// multiple of 64 takes the first instances, any other the ANY ones). bn and
// split come from ops/linear_tiling.py, as for qa_int8_linear (the k chunks
// are 64-row chunks of the packed rows, the last one cut at half).
extern "C" int qa_int4_linear(const void* x, const void* packed, const void* scale, void* out,
                              int m, int n, int half, int group, int out_type, int bn, int split,
                              void* stream) {
  if (out_type < OUT_F32 || out_type > OUT_BF16 || m < 1 || n < 1 || group <= 0 ||
      half < group || half % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool any = group % CHUNK != 0;
  if (m <= STREAM_MAX_M) {
    if ((bn != 64 && bn != 128) || split < 1 || split > MAX_SPLIT ||
        split > (half + CHUNK - 1) / CHUNK || (n + bn - 1) / bn > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    auto* launch = bn == 128 ? (any ? &launch_stream_m<128, true> : &launch_stream_m<128, false>)
                             : (any ? &launch_stream_m<64, true> : &launch_stream_m<64, false>);
    return launch(x, packed, scale, out, m, n, half, group, out_type, split, st);
  }
  if (bn != TC_BN || split != 1 || (m + TC_BM - 1) / TC_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return any ? launch_tc<true>(x, packed, scale, out, m, n, half, group, out_type, st)
             : launch_tc<false>(x, packed, scale, out, m, n, half, group, out_type, st);
}
