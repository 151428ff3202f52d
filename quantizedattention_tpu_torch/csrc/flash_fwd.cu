// Corrected-bf16 flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/flash_fwd.py:_fwd_kernel
// (the Pallas online-softmax forward). Same numerics: Q arrives pre-scaled by
// sm_scale*log2(e) and rounded to bf16, S = Q K^T accumulates in f32, masked
// logits are MASK_VALUE (causal k <= q plus kv padding), the row max carries
// +EPS_BIAS, P = exp2(S - m) is rounded to bf16 before BOTH the PV product and
// the row sum l, and rows with l == 0 give O = 0. Outputs O f32 and the
// exp2-domain lse = m + log2(l).
//
// What bounds it on this card: at the serving prompt lengths (a few hundred
// tokens, head_dim 64) the whole prefill attention is a few MFLOP per head
// and a few hundred KB of K/V, so a launch is latency-bound (block count,
// synchronisation, shared-memory round trips), not bound by the tensor cores
// or HBM.
//
// Design (simple first): one block of 4 warps per (batch*kv_head, q tile).
// The block's 64 rows hold the kv head's WHOLE GQA group (row r -> group
// r / bq, position q0 + r % bq, bq = 64 / rep), so each K/V tile is read once
// for all rep q heads. K/V tiles of 64 keys go through shared memory;
// S and the PV product use bf16 mma.sync.m16n8k16 with f32 accumulation, and
// the online softmax runs on the S fragments in registers (a row's four
// owners reduce with quad shuffles), so P never touches shared memory. Causal
// blocks stop at the tile that holds their last query position. No
// cp.async/TMA pipelining and no wgmma yet: both are later work.
//
// precision="fp32" (flash_fwd_f32_kernel, entry qa_flash_fwd_f32): the same
// TPU kernel's fp32 mode (flash_fwd.py:255-260, Precision.HIGHEST), the
// primal of attention_jvp and the rCM prepass. Q arrives pre-scaled in f32,
// nothing is rounded, masked P is 0, the row max still carries +EPS_BIAS.
// Bound: fp32 products, 2 over every visible (q, k) pair against the 67
// TFLOP/s of the CUDA cores (the TPU's HIGHEST dots have no tensor-core
// counterpart short of 3xTF32). Design: FFMA in 4x4 register tiles, one
// block of 256 threads per (q head, 64-row q tile) over 64-key tiles (see the
// kernel). GQA reads kv head head / rep. No pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // rows per block: 4 warps x 16
constexpr int BN = 64;        // keys per kv tile
constexpr int SROW = D + 8;   // padded shared row (bf16): conflict-free fragment loads
constexpr int THREADS = 128;
constexpr float MASK_VALUE = -30000.0f;
constexpr float EPS_BIAS = 1.0f / 256.0f;

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,  // [bh_kv, rep, t, D], pre-scaled
                 const __nv_bfloat16* __restrict__ k,  // [bh_kv, s, D]
                 const __nv_bfloat16* __restrict__ v,  // [bh_kv, s, D]
                 float* __restrict__ o,                // [bh_kv, rep, t, D]
                 float* __restrict__ lse,              // [bh_kv, rep, t]
                 int rep, int t, int s, int bq, int causal) {
  __shared__ __align__(16) __nv_bfloat16 q_s[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = rep * bq;  // live rows of the block (<= BM)

  // Q rows -> shared (zeros for dead rows and ragged positions).
  for (int c = tid; c < BM * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int pos = q0 + r % bq;
      if (pos < t)
        val = *reinterpret_cast<const uint4*>(q + ((bh * rep + r / bq) * t + pos) * D + col);
    }
    *reinterpret_cast<uint4*>(&q_s[r * SROW + col]) = val;
  }
  __syncthreads();

  // This thread's two rows (fragment rows lane/4 and lane/4 + 8 of its warp).
  const int ra = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  int pos_r[2];
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos_r[h] = r < rows ? q0 + r % bq : q0;
  }

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = ld_u32(&q_s[ra * SROW + ks * 16 + cq]);
    qa[ks][1] = ld_u32(&q_s[(ra + 8) * SROW + ks * 16 + cq]);
    qa[ks][2] = ld_u32(&q_s[ra * SROW + ks * 16 + cq + 8]);
    qa[ks][3] = ld_u32(&q_s[(ra + 8) * SROW + ks * 16 + cq + 8]);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // Causal: keys past the block's last query position are never visible.
  const int kv_hi = causal ? min(s, q0 + bq) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BN * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (k0 + r < s) {
        const size_t off = (bh * s + k0 + r) * D + col;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&k_s[r * SROW + col]) = kv;
      *reinterpret_cast<uint4*>(&v_s[r * SROW + col]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* krow = &k_s[(nt * 8 + lane / 4) * SROW + cq];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma16816(sc[nt], qa[ks], ld_u32(krow + ks * 16), ld_u32(krow + ks * 16 + 8));
    }

    // Mask, row max (+EPS_BIAS), running-max update.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = col < s && (!causal || col <= pos_r[h]);
        if (!valid) sc[nt][e] = MASK_VALUE;
        mx[h] = fmaxf(mx[h], sc[nt][e]);
      }
    }
    float next_m[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      next_m[h] = fmaxf(m[h], quad_max(mx[h]) + EPS_BIAS);
      alpha[h] = exp2f(m[h] - next_m[h]);
      m[h] = next_m[h];
    }

    // P = bf16(exp2(S - m)); l sums the ROUNDED P. The S accumulator layout of
    // n-tiles (2kk, 2kk+1) is exactly the A-fragment layout of PV's k-step kk.
    uint32_t pa[BN / 16][4];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const __nv_bfloat162 p01 = __floats2bfloat162_rn(exp2f(sc[nt][0] - next_m[0]),
                                                       exp2f(sc[nt][1] - next_m[0]));
      const __nv_bfloat162 p23 = __floats2bfloat162_rn(exp2f(sc[nt][2] - next_m[1]),
                                                       exp2f(sc[nt][3] - next_m[1]));
      lsum[0] += __low2float(p01) + __high2float(p01);
      lsum[1] += __low2float(p23) + __high2float(p23);
      pa[nt / 2][(nt % 2) * 2 + 0] = as_u32(p01);
      pa[nt / 2][(nt % 2) * 2 + 1] = as_u32(p23);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(lsum[h]);

    // acc = acc * alpha + P V
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
      const int n = dt * 8 + lane / 4;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const __nv_bfloat16* vcol = &v_s[(kk * 16 + cq) * SROW + n];
        const uint32_t b0 = pack2(vcol[0], vcol[SROW]);
        const uint32_t b1 = pack2(vcol[8 * SROW], vcol[9 * SROW]);
        mma16816(acc[dt], pa[kk], b0, b1);
      }
    }
  }

  // Epilogue: O = acc / l (l == 0 -> 1), lse = m + log2(l).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= rows) continue;
    const int pos = q0 + r % bq;
    if (pos >= t) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const size_t row = (bh * rep + r / bq) * t + pos;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 val = make_float2(acc[dt][2 * h] / l_safe, acc[dt][2 * h + 1] / l_safe);
      *reinterpret_cast<float2*>(o + row * D + dt * 8 + cq) = val;
    }
    if (lane % 4 == 0) lse[row] = m[h] + log2f(l_safe);
  }
}

// ---------------------------------------------------------------------------
// precision="fp32": FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TF = 64;            // q rows per block and keys per tile
constexpr int LDF = TF + 4;       // padded row of an f32 tile (float4-aligned)
constexpr int THREADS_F = 256;    // thread = (row group tid / 16, column group tid % 16)

// max / sum over the sixteen threads of a row group (one half-warp)
__device__ __forceinline__ float group_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0+TF-1 of a row-major [n, D] f32 matrix into shared
// memory, transposed (dst[d * LDF + row]); rows at or past n are zero.
// Consecutive threads take consecutive rows, so the transposed stores hit
// consecutive banks.
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < TF * (D / 4); c += THREADS_F) {
    const int r = c % TF;
    const int col = (c / TF) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    dst[(col + 0) * LDF + r] = val.x;
    dst[(col + 1) * LDF + r] = val.y;
    dst[(col + 2) * LDF + r] = val.z;
    dst[(col + 3) * LDF + r] = val.w;
  }
}

// Rows row0 .. row0+TF-1 of a row-major [n, D] f32 matrix into a padded
// shared tile as they are; rows at or past n are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < TF * (D / 4); c += THREADS_F) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<float4*>(&dst[r * LDF + col]) = val;
  }
}

// acc[4][4] += a^T b over TF (or D) steps: a, b [steps][LDF], columns
// a0 .. a0+3 of a and b0 .. b0+3 of b, read as float4.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float* a, const float* b, int a0,
                                       int b0, int steps) {
  for (int d = 0; d < steps; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * LDF + a0]);
    const float4 y = *reinterpret_cast<const float4*>(&b[d * LDF + b0]);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// One block of 256 threads per (q head, 64-row q tile). Thread (g, c) =
// (tid / 16, tid % 16) owns rows 4g .. 4g+3 and, per 64-key tile, keys
// 4c .. 4c+3 of S and columns 4c .. 4c+3 of O: a 4x4 register tile per
// product from two float4 shared loads per step (Q and K stored transposed,
// P transposed, V as it is). A row group's sixteen owners are one
// half-warp: row max and sums reduce by shuffles, and its P rows pass to
// P V behind a __syncwarp.
__global__ void __launch_bounds__(THREADS_F)
flash_fwd_f32_kernel(const float* __restrict__ q,  // [b*h, t, D], pre-scaled by qk_scale
                     const float* __restrict__ k,  // [b*h_kv, s, D]
                     const float* __restrict__ v,  // [b*h_kv, s, D]
                     float* __restrict__ o,        // [b*h, t, D]
                     float* __restrict__ lse,      // [b*h, t]
                     int rep, int t, int s, int causal) {
  extern __shared__ __align__(16) float smem_f[];
  float* qt_s = smem_f;           // [D][LDF]: Q^T
  float* kt_s = qt_s + D * LDF;   // [D][LDF]: K^T
  float* v_s = kt_s + D * LDF;    // [TF][LDF]: V
  float* pt_s = v_s + TF * LDF;   // [TF][LDF]: P^T

  const int tid = threadIdx.x;
  const int g4 = (tid / 16) * 4;
  const int c4 = (tid % 16) * 4;
  const size_t head = blockIdx.y;
  const size_t kvh = head / rep;
  const int q0 = blockIdx.x * TF;

  load_transposed(qt_s, q + head * t * D, q0, t);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int kv_hi = causal ? min(s, q0 + TF) : s;
  const int n_tiles = (kv_hi + TF - 1) / TF;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * TF;
    __syncthreads();  // every thread is done with the previous K/V tile
    load_transposed(kt_s, k + kvh * s * D, k0, s);
    load_rows(v_s, v + kvh * s * D, k0, s);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    outer4(sc, qt_s, kt_s, g4, c4, D);

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + g4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c4 + j;
        if (!(col < s && (!causal || col <= pos))) sc[i][j] = MASK_VALUE;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float next_m = fmaxf(m[i], group_max16(mx) + EPS_BIAS);
      alpha[i] = exp2f(m[i] - next_m);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c4 + j;
        sc[i][j] = (col < s && (!causal || col <= pos)) ? exp2f(sc[i][j] - next_m) : 0.f;
        psum += sc[i][j];
      }
      l[i] = l[i] * alpha[i] + group_sum16(psum);
      m[i] = next_m;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt_s[(c4 + j) * LDF + g4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncwarp();  // a row group's P is written by its sixteen owners, all in this half-warp

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha[i];
    outer4(acc, pt_s, v_s, g4, c4, TF);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + g4 + i;
    if (pos >= t) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const size_t row = head * t + pos;
    *reinterpret_cast<float4*>(o + row * D + c4) =
        make_float4(acc[i][0] / l_safe, acc[i][1] / l_safe, acc[i][2] / l_safe,
                    acc[i][3] / l_safe);
    if (c4 == 0) lse[row] = m[i] + log2f(l_safe);
  }
}

}  // namespace

// precision="fp32": q [b*h, t, D] f32 pre-scaled by qk_scale, k/v
// [b*h_kv, s, D] f32 (h = h_kv * rep) -> O [b*h, t, D], lse [b*h, t] f32.
extern "C" int qa_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                int bh, int rep, int t, int s, int causal, void* stream) {
  const int smem = (2 * D + 2 * TF) * LDF * sizeof(float);  // 69,632 bytes
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + TF - 1) / TF, bh);
  flash_fwd_f32_kernel<<<grid, THREADS_F, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), rep, t, s, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh_kv, int rep, int t, int s, int causal, void* stream) {
  const int bq = BM / rep;
  const dim3 grid((t + bq - 1) / bq, bh_kv);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      rep, t, s, bq, causal);
  return static_cast<int>(cudaGetLastError());
}
