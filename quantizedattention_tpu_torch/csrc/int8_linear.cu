// Weight-only int8 matmul for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/int8_linear.py:_kernel
// (B17). Same numerics: out[m, n] = (x[m, k] @ w_i8[k, n]) * scale[n], with x
// in bf16 (the wrapper casts), each int8 weight widened to bf16 (exact for
// |w| <= 128), bf16 products accumulated in f32 over all of k, the f32
// column scale applied once after the whole contraction and the result cast
// to the output type (f32 or bf16) once. Only the order of the f32 sums
// differs from the TPU kernel's. One launch a call, no float atomics: the
// same inputs give the same bits.
//
// What bounds it on this card, and the two regimes (ops/linear_tiling.py
// chooses the launch and mirrors the constants below):
//
// 1. Streaming (m <= 64: decode, spec verify). 2 m k n operations against k n
//    weight bytes: at m = 8, 16 operations a byte against the ~295 where
//    the tensor cores would take over, so the bound is the weight stream
//    (k n / 3.35 TB/s: 1.25 us at 1024 x 4096). The design fills the card
//    and keeps bytes in flight:
//    - A block takes BN = 64 or 128 columns (every weight row read as 64 or
//      128 contiguous bytes) and a contiguous range of 64-row k chunks; the
//      k split runs across the blocks of one thread-block cluster (at most
//      8, the portable size), chosen so that the serving shapes launch at
//      least 128 blocks.
//    - Thread 0 issues every chunk's TMA copies at once into a ring of 4
//      stages (the x box [8 nt, 64] bf16 and the weight box [64, BN], both
//      swizzled so the fragment reads below hit distinct banks).
//    - The weights are the m16n8k16 mma.sync's A operand (16 columns as M)
//      and x its B operand (8 rows as N), so at m <= 8 no product is padding.
//      A warp takes 16 columns (2 BN threads a block): a thread reads 2
//      contiguous bytes of 4 weight rows a k step, M rows g and g + 8 take
//      its two bytes (a permutation of the columns that the epilogue
//      undoes), and no byte is read twice.
//    - No conversion instruction: bytes become bf16 by byte permutes and
//      one f32 subtraction (widen_pair).
//    - The k split's sum, one cluster barrier: each block pushes its f32
//      partial into the shared memory of the block that owns each output
//      (distributed shared memory), and the owner adds the partials in
//      rank order, applies the scale and writes each output once. No
//      workspace, no second launch, no atomics.
// 2. Tensor cores (m > 64: prefill). 2 m k n bf16 operations (at m = 2048,
//    1024 x 4096: 17.2 G, 0.0174 ms at 989 TFLOP/s) against far fewer bytes.
//    A block of 128 x 128 outputs has two warpgroups (256 threads, so ptxas
//    allows 255 registers a thread); thread 0 keeps a ring of 4 stages in
//    flight by TMA: the x tile [128, 64] bf16 and the weight tile [64, 128]
//    int8, both with the 128-byte swizzle. The weights are the A operand of
//    wgmma.m64n128k16, widened in registers (a warpgroup takes 64 of the
//    columns as M, a thread 2 bytes of 4 rows a k step, no byte twice) and
//    x is B, K-major from shared memory: no bf16 copy of the weights is ever
//    written. Chunk j + 1 is widened into the other of two A register sets
//    while chunk j's products run; one barrier a chunk frees the stage of
//    chunk j - 1 for its refill.
//
// TMA needs 16-byte row strides and bases (k % 8 == 0 for x, n % 16 == 0
// for the weight). Where a shape does not give them, the same kernels fill
// the same shared layout with plain loads, masked element by element.

#include "hopper.cuh"

namespace {

constexpr int CHUNK = 64;        // k rows a stage
constexpr int STREAM_MAX_M = 64;
constexpr int S_STAGES = 4;
constexpr int MAX_SPLIT = 8;     // the portable cluster size
constexpr int TC_BM = 128, TC_BN = 128;
constexpr int TC_THREADS = 256;  // two warpgroups, 64 columns each
constexpr int TC_STAGES = 4;     // x + int8 weight tiles in flight
constexpr int TC_X = TC_BM * CHUNK * 2;
constexpr int TC_STAGE = TC_X + CHUNK * TC_BN;
constexpr int TC_OFF_BAR = TC_STAGES * TC_STAGE;
constexpr int TC_SMEM = TC_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024

// Streaming stage layout: the x box [8 nt, 64] bf16 (rows of 128 bytes,
// 128-byte swizzle), then the weight box [64, bn] (64-byte rows with the
// 64-byte swizzle at bn 64, 128-byte rows with the 128-byte swizzle at bn
// 128). Both are multiples of 1024 bytes, so every box stays aligned.
__host__ __device__ constexpr int stream_stage(int nt, int bn) {
  return nt * 8 * 128 + CHUNK * bn;
}

// Threads of a streaming block: a warp a 16 columns.
__host__ __device__ constexpr int stream_threads(int bn) { return 2 * bn; }

// Dynamic shared bytes of a streaming block: the ring (which the block's own
// partial reuses once its mainloop is done), the receive buffer of the
// cluster sum, the mbarriers, and 1024 bytes to align the swizzled boxes.
constexpr int stream_smem(int nt, int bn) {
  return S_STAGES * stream_stage(nt, bn) +
         4 * cluster_recv_floats(nt * 8 * bn, MAX_SPLIT, stream_threads(bn)) + 128 + 1024;
}

// --- streaming regime ---

// The weights are the mma's A operand (16 columns a tile, as 16 M rows) and
// x its B operand (8 rows a tile, as N), so m <= 8 rows waste no product.
template <int NT, int BN>
__global__ void __launch_bounds__(stream_threads(BN))
int8_stream_kernel(const __grid_constant__ CUtensorMap x_map,  // [m, k] bf16, box [8 NT, 64]
                   const __grid_constant__ CUtensorMap w_map,  // [k, n] int8, box [64, BN]
                   const __nv_bfloat16* __restrict__ x,        // [m, k]
                   const int8_t* __restrict__ w,               // [k, n]
                   const float* __restrict__ scale,            // [n]
                   void* __restrict__ out,                     // [m, n] of out_type
                   int m, int n, int k, int out_type, int tma) {
  constexpr int T = stream_threads(BN);
  constexpr int XB = NT * 8 * 128;  // bytes of the x box
  constexpr int STAGE = stream_stage(NT, BN);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* recv = reinterpret_cast<float*>(smem + S_STAGES * STAGE);
  const uint32_t bars =
      base + S_STAGES * STAGE + 4 * cluster_recv_floats(NT * 8 * BN, MAX_SPLIT, T);
  auto full = [&](int st) { return bars + 8 * st; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int split = gridDim.x;
  const int rank = cluster_ctarank();
  const int n0 = blockIdx.y * BN;
  const int chunks = (k + CHUNK - 1) / CHUNK;
  const int c_lo = rank * chunks / split;
  const int n_local = (rank + 1) * chunks / split - c_lo;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S_STAGES; ++i) mbar_init(full(i), tma ? 1 : T);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 16-byte piece p of weight row r in the swizzled box
  auto w_piece = [](int r, int p) { return BN == 128 ? p ^ (r & 7) : p ^ ((r >> 1) & 3); };
  // Local chunk i -> stage i % S_STAGES, by TMA from thread 0 (zeros outside
  // the arrays), or by every thread with masked loads in the same layout
  // (x rows m .. 8 NT - 1 are left as they are: they reach only output rows
  // that are never read).
  auto load = [&](int i) {
    if (i >= n_local) return;
    const int st = i % S_STAGES, kb = (c_lo + i) * CHUNK;
    if (tma) {
      if (tid == 0) {
        mbar_expect_tx(full(st), STAGE);
        tma_load_2d(base + st * STAGE, &x_map, full(st), kb, 0);
        tma_load_2d(base + st * STAGE + XB, &w_map, full(st), n0, kb);
      }
      return;
    }
    uint8_t* xs = smem + st * STAGE;
    for (int c = tid; c < m * 8; c += T) {
      const int r = c / 8, p = c % 8, gk = kb + p * 8;
      __nv_bfloat16 e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = gk + u < k ? x[(size_t)r * k + gk + u] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(xs + r * 128 + ((p ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    for (int c = tid; c < CHUNK * (BN / 16); c += T) {
      const int r = c / (BN / 16), p = c % (BN / 16), gk = kb + r, gn = n0 + p * 16;
      int8_t e[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) e[u] = gk < k && gn + u < n ? w[(size_t)gk * n + gn + u] : 0;
      *reinterpret_cast<uint4*>(xs + XB + r * BN + (w_piece(r, p) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    mbar_arrive(full(st));
  };

  // acc[nt][e]: weight column C + e / 2 of the block's, x row 8 nt + 2q + (e
  // & 1), C = 16 warp + 2 g: a thread reads 2 contiguous bytes of a weight
  // row, and M rows g, g + 8 of the warp's tile take its bytes 0 and 1.
  const int C = 16 * warp + 2 * g;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < S_STAGES; ++i) load(i);
  for (int i = 0; i < n_local; ++i) {
    const int st = i % S_STAGES;
    mbar_wait(full(st), (i / S_STAGES) & 1);
    const uint8_t* xs = smem + st * STAGE;
    const uint8_t* ws = xs + XB;
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 16) {
      uint32_t b[NT][2];  // x rows 8 nt + g, columns kk + 2q (+ 8)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr = xs + (nt * 8 + g) * 128 + 4 * q;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8) ^ g) << 4));
        b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + (((kk / 8 + 1) ^ g) << 4));
      }
      uint32_t wv[4];  // rows kk + 2q, + 1, + 8, + 9; bytes of columns C, C + 1
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int r = kk + 2 * q + (d & 1) + 8 * (d / 2);
        wv[d] = *reinterpret_cast<const uint16_t*>(ws + r * BN + (w_piece(r, C >> 4) << 4) +
                                                   (C & 15));
      }
      const uint32_t a[4] = {widen_pair(wv[0], wv[1], 0), widen_pair(wv[0], wv[1], 1),
                             widen_pair(wv[2], wv[3], 0), widen_pair(wv[2], wv[3], 1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
    }
    __syncthreads();  // every warp is done with stage st
    load(i + S_STAGES);
  }

  // This block's partial [8 NT, BN] f32 in the ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(nt * 8 + 2 * q + (e & 1)) * BN + C + e / 2] = acc[nt][e];
  __syncthreads();
  // The cluster's partials of rows < m summed in rank order, scaled, written
  // once.
  cluster_reduce<T>(red, recv, m * BN, split, rank, [&](int e, float sum) {
    const int gn = n0 + e % BN;
    if (gn < n) store_out(out, (size_t)(e / BN) * n + gn, __fmul_rn(sum, scale[gn]), out_type);
  });
}

// --- tensor-core regime ---

// One thread's A fragments of a chunk, one m16n8k16 fragment a k16 step.
using AFrag = uint32_t[CHUNK / 16][4];

__global__ void __launch_bounds__(TC_THREADS, 1)
int8_tc_kernel(const __grid_constant__ CUtensorMap x_map,  // [m, k] bf16, box [128, 64]
               const __grid_constant__ CUtensorMap w_map,  // [k, n] int8, box [64, 128]
               const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, void* __restrict__ out, int m, int n, int k,
               int out_type, int tma) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  auto full = [&](int st) { return base + TC_OFF_BAR + 8 * st; };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int nk = (k + CHUNK - 1) / CHUNK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < TC_STAGES; ++i) mbar_init(full(i), tma ? 1 : TC_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk j -> stage j % TC_STAGES: the x tile [128, 64] and the weight tile
  // [64, 128], both with the 128-byte swizzle (16-byte piece p of row r at p
  // ^ (r & 7)): by TMA from thread 0, or (strides TMA cannot take) by every
  // thread with masked loads in the same layout, published by each thread's
  // arrival.
  auto load = [&](int j) {
    if (j >= nk) return;
    const int st = j % TC_STAGES;
    if (tma) {
      if (tid == 0) {
        mbar_expect_tx(full(st), TC_STAGE);
        tma_load_2d(base + st * TC_STAGE, &x_map, full(st), j * CHUNK, m0);
        tma_load_2d(base + st * TC_STAGE + TC_X, &w_map, full(st), n0, j * CHUNK);
      }
      return;
    }
    uint8_t* xs = smem + st * TC_STAGE;
    for (int c = tid; c < TC_BM * 8; c += TC_THREADS) {
      const int r = c / 8, p = c % 8, gr = m0 + r, gk = j * CHUNK + p * 8;
      __nv_bfloat16 e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = gr < m && gk + u < k ? x[(size_t)gr * k + gk + u] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(xs + r * 128 + ((p ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    for (int c = tid; c < CHUNK * (TC_BN / 16); c += TC_THREADS) {
      const int r = c / (TC_BN / 16), p = c % (TC_BN / 16);
      const int gk = j * CHUNK + r, gn = n0 + p * 16;
      int8_t e[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) e[u] = gk < k && gn + u < n ? w[(size_t)gk * n + gn + u] : 0;
      *reinterpret_cast<uint4*>(xs + TC_X + r * TC_BN + ((p ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(e);
    }
    fence_proxy_async();
    mbar_arrive(full(st));
  };

  // The weights are the products' A operand, widened in registers, and x
  // their B operand: warpgroup wg takes the block's 64 columns wg * 64 ..,
  // all 128 x rows. M row g (g + 8) of warp w is column C (C + 1), C = 64 wg
  // + 16 w + 2 g: a thread reads 2 contiguous bytes of 4 weight rows a k
  // step, and no byte is read twice.
  const int C = 64 * wg + 16 * warp + 2 * g;
  auto widen = [&](int j, AFrag& a) {
    const int st = j % TC_STAGES;
    mbar_wait(full(st), (j / TC_STAGES) & 1);
    const uint8_t* wt = smem + st * TC_STAGE + TC_X;
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks) {
      uint32_t v[4];  // rows 16 ks + 2q, + 1, + 8, + 9
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int r = ks * 16 + 2 * q + (d & 1) + 8 * (d / 2);
        v[d] = *reinterpret_cast<const uint16_t*>(wt + r * TC_BN + (((C >> 4) ^ (r & 7)) << 4) +
                                                  (C & 15));
      }
      a[ks][0] = widen_pair(v[0], v[1], 0);
      a[ks][1] = widen_pair(v[0], v[1], 1);
      a[ks][2] = widen_pair(v[2], v[3], 0);
      a[ks][3] = widen_pair(v[2], v[3], 1);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // B: the x tile, K-major with the 128-byte swizzle (a k16 step is 32 bytes on).
  auto issue = [&](int j, const AFrag& a) {
    const uint64_t db = desc_kmajor_sw128(base + (j % TC_STAGES) * TC_STAGE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks) wgmma_bf16_m64n128k16_rs(acc, a[ks], db + 2 * ks, 1);
    wgmma_commit();
  };
  // Chunk j's products run while chunk j + 1 is widened into the other A set
  // (free once chunk j - 1's products are done); one barrier of both
  // warpgroups a chunk frees the stage of chunk j - 1 for its refill.
  auto step = [&](int j, const AFrag& cur, AFrag& next) {
    issue(j, cur);
    wgmma_wait<1>();
    if (j + 1 < nk) widen(j + 1, next);
    named_barrier(1, TC_THREADS);
    if (j >= 1) load(j - 1 + TC_STAGES);
  };
  for (int j = 0; j < TC_STAGES; ++j) load(j);
  AFrag a0, a1;
  widen(0, a0);
  for (int j = 0; j < nk; j += 2) {
    step(j, a0, a1);
    if (j + 1 < nk) step(j + 1, a1, a0);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // Epilogue: acc * scale in f32, cast once, masked. acc[4 nn + 2 h + b]:
  // column C + h, x row 8 nn + 2 q + b.
  const int gc = n0 + C;
  const float s0 = gc < n ? scale[gc] : 0.f, s1 = gc + 1 < n ? scale[gc + 1] : 0.f;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int nn = 0; nn < TC_BM / 8; ++nn)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int gr = m0 + 8 * nn + 2 * q + b;
      if (gr >= m) continue;
      const size_t o = (size_t)gr * n + gc;
      const float v0 = __fmul_rn(acc[4 * nn + b], s0), v1 = __fmul_rn(acc[4 * nn + 2 + b], s1);
      if (pairs && gc + 1 < n) {
        store_out2(out, o, v0, v1, out_type);
      } else {
        if (gc < n) store_out(out, o, v0, out_type);
        if (gc + 1 < n) store_out(out, o + 1, v1, out_type);
      }
    }
}

template <int NT, int BN>
int launch_stream(const void* x, const void* w, const void* scale, void* out, int m, int n, int k,
                  int out_type, int split, cudaStream_t stream) {
  constexpr int smem = stream_smem(NT, BN);
  const int tma = k % 8 == 0 && n % 16 == 0 && aligned16(x) && aligned16(w);
  CUtensorMap x_map = {}, w_map = {};
  if (tma && (!tensor_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, NT * 8, CHUNK,
                             CU_TENSOR_MAP_SWIZZLE_128B) ||
              !tensor_map_2d(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, CHUNK, BN,
                             BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_stream_kernel<NT, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + BN - 1) / BN);
  cfg.blockDim = dim3(stream_threads(BN));
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
      &cfg, int8_stream_kernel<NT, BN>, x_map, w_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale), out, m, n, k, out_type,
      tma);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BN>
int launch_stream_m(const void* x, const void* w, const void* scale, void* out, int m, int n,
                    int k, int out_type, int split, cudaStream_t st) {
  switch ((m + 7) / 8) {
    case 1: return launch_stream<1, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 2: return launch_stream<2, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 3: return launch_stream<3, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 4: return launch_stream<4, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 5: return launch_stream<5, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 6: return launch_stream<6, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    case 7: return launch_stream<7, BN>(x, w, scale, out, m, n, k, out_type, split, st);
    default: return launch_stream<8, BN>(x, w, scale, out, m, n, k, out_type, split, st);
  }
}

int launch_tc(const void* x, const void* w, const void* scale, void* out, int m, int n, int k,
              int out_type, cudaStream_t stream) {
  const int tma = k % 8 == 0 && n % 16 == 0 && aligned16(x) && aligned16(w);
  CUtensorMap x_map = {}, w_map = {};
  if (tma && (!tensor_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, TC_BM, CHUNK,
                             CU_TENSOR_MAP_SWIZZLE_128B) ||
              !tensor_map_2d(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, CHUNK, TC_BN,
                             CU_TENSOR_MAP_SWIZZLE_128B)))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM);
  int8_tc_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, m, n, k, out_type, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes one block asks for at m rows and bn columns a block
// (ops/linear_tiling.py's shared_bytes mirrors it).
extern "C" int qa_int8_linear_smem_bytes(int m, int bn) {
  return m <= STREAM_MAX_M ? stream_smem((m + 7) / 8, bn) : TC_SMEM;
}

// x [m, k] bf16, w [k, n] int8, scale [n] f32 -> out [m, n] of out_type
// (0 f32, 1 bf16). bn and split come from ops/linear_tiling.py: m <= 64
// streams with bn in {64, 128} columns a block and the k chunks split over
// `split` blocks of a cluster (1 <= split <= min(8, chunks)); m > 64 takes
// the tensor cores with bn 128 and split 1.
extern "C" int qa_int8_linear(const void* x, const void* w, const void* scale, void* out, int m,
                              int n, int k, int out_type, int bn, int split, void* stream) {
  const int chunks = (k + CHUNK - 1) / CHUNK;
  if (out_type < OUT_F32 || out_type > OUT_BF16 || m < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= STREAM_MAX_M) {
    if ((bn != 64 && bn != 128) || split < 1 || split > MAX_SPLIT || split > chunks ||
        (n + bn - 1) / bn > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return bn == 128 ? launch_stream_m<128>(x, w, scale, out, m, n, k, out_type, split, st)
                     : launch_stream_m<64>(x, w, scale, out, m, n, k, out_type, split, st);
  }
  if (bn != TC_BN || split != 1 || (m + TC_BM - 1) / TC_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(x, w, scale, out, m, n, k, out_type, st);
}
