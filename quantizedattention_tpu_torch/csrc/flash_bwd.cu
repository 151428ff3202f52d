// Corrected-bf16 flash-attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/flash_bwd.py:_dkv_kernel
// (B2: dK, dV) and :_dq_kernel (B3: dQ). Same arithmetic: Q arrives pre-scaled
// by sm_scale*log2(e) and dO by sm_scale (the wrapper folds both scales in, as
// flash_bwd.py:231-234 does); P = exp2(Q K^T - lse) is recomputed per tile
// against the forward's exp2-domain lse; dV += P^T dO; dP = dO V^T;
// dS = P (dP - D) with D = rowsum(dO o O) computed once by the wrapper and the
// UNROUNDED f32 P; dK += dS^T Q; dQ += dS K. dK and dV are scaled back by
// 1/qk_scale and 1/sm_scale at the end. Masked logits (causal k <= q, kv
// padding) and rows past t give P = 0 exactly, so padding contributes nothing.
//
// Two modes, one C entry per kernel:
//   fast  - bf16 mma.sync.m16n8k16 with f32 accumulation. The operands are
//           rounded to bf16 where the TPU's DEFAULT-precision dots round them:
//           q*qk_scale and k for S, bf16(P) and dO*sm_scale for dV,
//           dO*sm_scale and v for dP, bf16(dS) and q*qk_scale for dK,
//           bf16(dS) and k for dQ (the wrapper hands in bf16 q/k/v/dO; P and
//           dS are rounded here).
//   exact - fp32 on the CUDA cores (FFMA), no rounding anywhere; the
//           bwd_exact=True path. Simple shared-memory tiles, slow by design.
//
// What bounds it on this card: at training shapes (seq 2048, head_dim 64) the
// backward is tensor-core bound: B2 runs 4 products (S, dV, dP, dK) and B3
// runs 3 (S, dP, dQ) over every visible (q, k) pair, against ~0.2 GB of
// operand traffic. The design keeps every product on the tensor cores and
// every intermediate (S, P, dP, dS) in registers: the accumulator layout of
// mma.sync is, two n-tiles at a time, exactly the A operand layout of the
// next product, so P^T and dS^T (B2) or dS (B3) go from accumulators to the
// tensor cores without touching shared memory.
//
// Design (simple first):
//   B2: one block of 4 warps per (batch*kv_head, 64-key tile); each warp owns
//       16 keys. The block loops over the rep q heads of its kv head and over
//       the q tiles that can see the key tile (causal: from the diagonal on),
//       computing the transposed tiles S^T = K Q^T and dP^T = V dO^T, so that
//       P^T and dS^T come out in the A layout of dV += P^T dO and
//       dK += dS^T Q. The block owns its dK/dV tile (no atomics: the race fix
//       of flash_bwd.py:11-14) and the GQA group sum stays in registers.
//   B3: one block per (batch*kv_head, q tile) whose 64 rows hold the kv head's
//       whole GQA group (row r -> group r / bq, position q0 + r % bq,
//       bq = 64 / rep), as the forward does; it loops over kv tiles up to the
//       diagonal and accumulates dQ += dS K.
//   Transposed B operands (dO and Q for B2, K for B3) come from shared memory
//   through ldmatrix.trans. No cp.async/TMA pipelining and no wgmma yet: both
//   are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // q rows per tile (fast): 4 warps x 16
constexpr int BN = 64;        // keys per tile (fast)
constexpr int SROW = D + 8;   // padded shared row (bf16): conflict-free fragment loads
constexpr int THREADS = 128;  // fast kernels: 4 warps

constexpr int TE = 32;          // rows and keys per tile (exact)
constexpr int FROW = D + 1;     // padded shared row (f32)
constexpr int PROW = TE + 1;    // padded shared row of a P / dS tile (f32)
constexpr int THREADS_E = 256;  // exact kernels: thread = (row tid / 8, lane tid % 8)

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// Four 8x8 bf16 matrices from shared memory, transposed on the way in.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Rows row0 .. row0+63 of a row-major [n, D] bf16 matrix into a padded shared
// tile; rows at or past n are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n) {
  for (int c = threadIdx.x; c < 64 * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(&dst[r * SROW + col]) = val;
  }
}

// A fragments (m16 x k16, four k-steps over D) of rows ra and ra + 8.
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const __nv_bfloat16* tile, int ra,
                                       int cq) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    a[ks][0] = ld_u32(&tile[ra * SROW + ks * 16 + cq]);
    a[ks][1] = ld_u32(&tile[(ra + 8) * SROW + ks * 16 + cq]);
    a[ks][2] = ld_u32(&tile[ra * SROW + ks * 16 + cq + 8]);
    a[ks][3] = ld_u32(&tile[(ra + 8) * SROW + ks * 16 + cq + 8]);
  }
}

// acc[16 x 64] = A[16 x D] * tile^T, tile = 64 rows of D (the n axis).
__device__ __forceinline__ void mma_abt(float acc[8][4], const uint32_t a[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  const int cq = (lane % 4) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* row = &tile[(nt * 8 + lane / 4) * SROW + cq];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma16816(acc[nt], a[ks], ld_u32(row + ks * 16), ld_u32(row + ks * 16 + 8));
  }
}

// Accumulators of a 16 x 64 tile -> bf16 A fragments of its four k-steps:
// n-tiles (2kk, 2kk+1) of the accumulator are k-step kk of the A operand.
__device__ __forceinline__ void acc_to_a(uint32_t a[4][4], const float x[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(x[nt][0], x[nt][1]);
    a[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// acc[16 x D] += A[16 x 64] * tile, tile = 64 rows (the k axis) of D columns,
// read transposed through ldmatrix.
__device__ __forceinline__ void mma_ab(float acc[D / 8][4], const uint32_t a[4][4],
                                       const __nv_bfloat16* tile, int lane) {
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4];
      ldsm_x4_trans(b, &tile[(kk * 16 + lrow) * SROW + dt * 8 + lcol]);
      mma16816(acc[dt], a[kk], b[0], b[1]);
      mma16816(acc[dt + 1], a[kk], b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fast: bf16 tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
dkv_kernel_bf16(const __nv_bfloat16* __restrict__ q,     // [bh_kv, rep, t, D] q*qk_scale
                const __nv_bfloat16* __restrict__ k,     // [bh_kv, s, D]
                const __nv_bfloat16* __restrict__ v,     // [bh_kv, s, D]
                const __nv_bfloat16* __restrict__ dout,  // [bh_kv, rep, t, D] dO*sm_scale
                const float* __restrict__ lse,           // [bh_kv, rep, t]
                const float* __restrict__ di,            // [bh_kv, rep, t]
                float* __restrict__ dk,                  // [bh_kv, s, D]
                float* __restrict__ dv,                  // [bh_kv, s, D]
                int rep, int t, int s, int causal, float dk_scale, float dv_scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 q_s[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 do_s[BM * SROW];
  __shared__ float lse_s[BM];
  __shared__ float di_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BN;

  load_tile(k_s, k + bh * s * D, k0, s);
  load_tile(v_s, v + bh * s * D, k0, s);
  __syncthreads();

  // This warp's 16 keys as A operands of S^T = K Q^T and dP^T = V dO^T.
  const int ra = warp * 16 + lane / 4;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a(ka, k_s, ra, cq);
  load_a(va, v_s, ra, cq);
  const int key[2] = {k0 + ra, k0 + ra + 8};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? k0 / BM : 0;
  const int n_qt = (t + BM - 1) / BM;
  for (int g = 0; g < rep; ++g) {
    const size_t row0 = (bh * rep + g) * t;  // row of (bh, g, position 0)
    for (int j = j0; j < n_qt; ++j) {
      const int q0 = j * BM;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile(q_s, q + row0 * D, q0, t);
      load_tile(do_s, dout + row0 * D, q0, t);
      if (tid < BM) {
        const bool live = q0 + tid < t;
        lse_s[tid] = live ? lse[row0 + q0 + tid] : 0.f;
        di_s[tid] = live ? di[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // P^T = exp2(K Q^T - lse_q): 16 keys x 64 q positions, 0 where masked.
      float pt[8][4];
      mma_abt(pt, ka, q_s, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + cq + (e & 1);
          const int pos = q0 + col;
          const int kk = key[e / 2];
          const bool valid = kk < s && pos < t && (!causal || kk <= pos);
          pt[nt][e] = valid ? exp2f(pt[nt][e] - lse_s[col]) : 0.f;
        }
      }
      uint32_t fa[4][4];
      acc_to_a(fa, pt);
      mma_ab(dv_acc, fa, do_s, lane);  // dV += bf16(P^T) dO

      // dS^T = P^T (V dO^T - D_q), with the unrounded P.
      float dst[8][4];
      mma_abt(dst, va, do_s, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[nt][e] = pt[nt][e] * (dst[nt][e] - di_s[nt * 8 + cq + (e & 1)]);
      }
      acc_to_a(fa, dst);
      mma_ab(dk_acc, fa, q_s, lane);  // dK += bf16(dS^T) Q
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (bh * s + key[h]) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(dk + off + dt * 8) =
          make_float2(dk_acc[dt][2 * h] * dk_scale, dk_acc[dt][2 * h + 1] * dk_scale);
      *reinterpret_cast<float2*>(dv + off + dt * 8) =
          make_float2(dv_acc[dt][2 * h] * dv_scale, dv_acc[dt][2 * h + 1] * dv_scale);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dq_kernel_bf16(const __nv_bfloat16* __restrict__ q,     // [bh_kv, rep, t, D] q*qk_scale
               const __nv_bfloat16* __restrict__ k,     // [bh_kv, s, D]
               const __nv_bfloat16* __restrict__ v,     // [bh_kv, s, D]
               const __nv_bfloat16* __restrict__ dout,  // [bh_kv, rep, t, D] dO*sm_scale
               const float* __restrict__ lse,           // [bh_kv, rep, t]
               const float* __restrict__ di,            // [bh_kv, rep, t]
               float* __restrict__ dq,                  // [bh_kv, rep, t, D]
               int rep, int t, int s, int bq, int causal) {
  __shared__ __align__(16) __nv_bfloat16 q_s[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 do_s[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = rep * bq;  // live rows of the block (<= BM)

  // Q and dO rows of the whole GQA group -> shared (zeros for dead rows).
  for (int c = tid; c < BM * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    uint4 dov = qv;
    if (r < rows && q0 + r % bq < t) {
      const size_t off = ((bh * rep + r / bq) * t + q0 + r % bq) * D + col;
      qv = *reinterpret_cast<const uint4*>(q + off);
      dov = *reinterpret_cast<const uint4*>(dout + off);
    }
    *reinterpret_cast<uint4*>(&q_s[r * SROW + col]) = qv;
    *reinterpret_cast<uint4*>(&do_s[r * SROW + col]) = dov;
  }
  __syncthreads();

  // This thread's two rows (fragment rows lane/4 and lane/4 + 8 of its warp).
  const int ra = warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos[h] = q0 + r % bq;
    live[h] = r < rows && pos[h] < t;
    const size_t row = (bh * rep + r / bq) * t + pos[h];
    lse_r[h] = live[h] ? lse[row] : 0.f;
    di_r[h] = live[h] ? di[row] : 0.f;
  }
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a(qa, q_s, ra, cq);
  load_a(doa, do_s, ra, cq);

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  // Causal: keys past the block's last query position are never visible.
  const int kv_hi = causal ? min(s, q0 + bq) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(k_s, k + bh * s * D, k0, s);
    load_tile(v_s, v + bh * s * D, k0, s);
    __syncthreads();

    // P = exp2(Q K^T - lse), 0 where masked.
    float p[8][4];
    mma_abt(p, qa, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = live[h] && col < s && (!causal || col <= pos[h]);
        p[nt][e] = valid ? exp2f(p[nt][e] - lse_r[h]) : 0.f;
      }
    }
    // dS = P (dO V^T - D), with the unrounded P.
    float ds[8][4];
    mma_abt(ds, doa, v_s, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (ds[nt][e] - di_r[e / 2]);
    }
    uint32_t fa[4][4];
    acc_to_a(fa, ds);
    mma_ab(dq_acc, fa, k_s, lane);  // dQ += bf16(dS) K
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = ra + 8 * h;
    const size_t off = ((bh * rep + r / bq) * t + pos[h]) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(dq + off + dt * 8) =
          make_float2(dq_acc[dt][2 * h], dq_acc[dt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// exact: fp32 on the CUDA cores
// ---------------------------------------------------------------------------

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

      float st[TE / 8], dpt[TE / 8];
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) st[i] = dpt[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = k_s[r * FROW + d];
        const float vd = v_s[r * FROW + d];
#pragma unroll
        for (int i = 0; i < TE / 8; ++i) {
          st[i] = fmaf(kd, q_s[(c + 8 * i) * FROW + d], st[i]);
          dpt[i] = fmaf(vd, do_s[(c + 8 * i) * FROW + d], dpt[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) {
        const int col = c + 8 * i;
        const int pos = q0 + col;
        const bool valid = key < s && pos < t && (!causal || key <= pos);
        const float p = valid ? exp2f(st[i] - lse_s[col]) : 0.f;
        p_s[r * PROW + col] = p;
        ds_s[r * PROW + col] = p * (dpt[i] - di_s[col]);
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

    float sc[TE / 8], dp[TE / 8];
#pragma unroll
    for (int i = 0; i < TE / 8; ++i) sc[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * FROW + d];
      const float dod = do_s[r * FROW + d];
#pragma unroll
      for (int i = 0; i < TE / 8; ++i) {
        sc[i] = fmaf(qd, k_s[(c + 8 * i) * FROW + d], sc[i]);
        dp[i] = fmaf(dod, v_s[(c + 8 * i) * FROW + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < TE / 8; ++i) {
      const int col = k0 + c + 8 * i;
      const bool valid = live && col < s && (!causal || col <= pos);
      const float p = valid ? exp2f(sc[i] - lse_r) : 0.f;
      ds_s[r * PROW + c + 8 * i] = p * (dp[i] - di_r);
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

}  // namespace

// B2: dK, dV [bh_kv, s, D] f32. q/dout [bh_kv, rep, t, D], k/v [bh_kv, s, D]:
// bf16 when fast, else f32; lse/di [bh_kv, rep, t] f32.
extern "C" int qa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dk, void* dv, int bh_kv,
                                int rep, int t, int s, int causal, int fast, float dk_scale,
                                float dv_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    const dim3 grid((s + BN - 1) / BN, bh_kv);
    dkv_kernel_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dk),
        static_cast<float*>(dv), rep, t, s, causal, dk_scale, dv_scale);
  } else {
    const dim3 grid((s + TE - 1) / TE, bh_kv);
    dkv_kernel_f32<<<grid, THREADS_E, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), rep, t, s,
        causal, dk_scale, dv_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// B3: dQ [bh_kv, rep, t, D] f32, same inputs as B2.
extern "C" int qa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq, int bh_kv, int rep,
                               int t, int s, int causal, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    const int bq = BM / rep;
    const dim3 grid((t + bq - 1) / bq, bh_kv);
    dq_kernel_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dq),
        rep, t, s, bq, causal);
  } else {
    const dim3 grid((t + TE - 1) / TE, bh_kv * rep);
    dq_kernel_f32<<<grid, THREADS_E, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<float*>(dq), rep, t, s, causal);
  }
  return static_cast<int>(cudaGetLastError());
}
