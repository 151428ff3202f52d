// Int8 flash-attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/int8_bwd.py:
// _int8_dkv_kernel (B7: dK, dV) and :_int8_dq_kernel (B8: dQ). Same
// arithmetic and rounding points, from the forward's residuals (int8 Q/K/V
// payloads, K smoothed, and their f32 scale tables; sq per (q head, q grain),
// sk and sv per (kv head, kv grain)):
//   P  = exp2(Q_i8 K_i8^T * c - lse), c = (sq * sk) * qk_scale, masked to 0,
//        in f32 (the integer logits are exact: int8 mma.sync, s8 x s8 -> s32);
//   dV += bf16(P)^T dO                     (bf16 mma, f32 accumulation)
//   dP  = (dO V_i8^T) * sv                 (V widened to bf16, exact)
//   dS  = P (dP - D) * sm_scale            (f32, the unrounded P; D from the wrapper)
//   dK += (bf16(dS)^T Q_i8) * sq           per (q head, q grain)
//   dQ += (bf16(dS) K_i8) * sk + rowsum(dS) * k_mean   per kv grain,
//        the rowsum over the f32 dS (the K-smoothing term).
// dO arrives in bf16 (as the JAX kernels' bf16 dots round it) and is not
// pre-scaled. The TPU kernel applies sq / sk after each grain's product, so
// a product whose scale changes with the grain runs into its own accumulator
// (dk_seg, dq_seg), folded into the main one with that grain's scale when
// the grain ends; no scale is folded into a bf16 operand before it rounds.
// Masked logits (causal k <= q, keys past s) and rows past t give P = 0.
//
// What bounds it on this card: at training shapes (seq 2048, head_dim 64)
// the backward is tensor-core bound: B7 runs one int8 product (S) and three
// bf16 products (dV, dP, dK) over every visible (q, k) pair, B8 one int8 (S)
// and two bf16 (dP, dQ), against a few tens of MB of operands. Every product
// runs on the tensor cores and every intermediate (S, P, dP, dS) stays in
// registers: two n-tiles of a mma.sync accumulator are exactly the A operand
// of the next product's k-step.
//
// Design (simple first), on B2/B3's (csrc/flash_bwd.cu):
//   B7: one block of 4 warps per (batch*kv_head, 64-key tile), each warp 16
//       keys; it loops over the rep q heads and the q tiles that can see its
//       keys, computing the transposed tiles S^T = K Q^T and dP^T = V dO^T so
//       that P^T and dS^T come out in the A layout of dV += P^T dO and
//       dK += dS^T Q. The block owns its dK/dV tile (no atomics) and sums the
//       GQA group in registers. A 64-key tile lies inside one kv grain (sk,
//       sv constant per block) and a 64-row q tile inside one q grain.
//   B8: one block per (batch*kv_head, q tile) whose 64 rows hold the kv
//       head's whole GQA group (row r -> group r / bq, position q0 + r % bq,
//       bq = 64 / rep), so sq is per row; it loops over kv tiles up to the
//       diagonal.
//   int8 tiles stay int8 in shared memory for the s8 mma; tiles that enter a
//   bf16 product (V, and Q in B7, K in B8) are widened to bf16 on their way
//   in. Transposed B operands come through ldmatrix.trans. No cp.async/TMA
//   pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // q rows per tile: 4 warps x 16
constexpr int BN = 64;        // keys per tile
constexpr int IROW = D + 16;  // padded shared row of an int8 tile (bytes)
constexpr int SROW = D + 8;   // padded shared row of a bf16 tile (elements)
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D[16x8] += A[16x32] (row) * B[32x8] (col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed on the way in.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 int8 -> 16 bf16 (exact: |x| <= 128), stored at dst.
__device__ __forceinline__ void widen16(__nv_bfloat16* dst, uint4 v) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16(static_cast<float>(b[2 * i]), static_cast<float>(b[2 * i + 1]));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// A fragments (m16 x k16, four k-steps over D) of rows ra and ra + 8 of a
// padded bf16 tile.
__device__ __forceinline__ void load_a_bf16(uint32_t a[D / 16][4], const __nv_bfloat16* tile,
                                            int ra, int cq) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    a[ks][0] = ld_u32(&tile[ra * SROW + ks * 16 + cq]);
    a[ks][1] = ld_u32(&tile[(ra + 8) * SROW + ks * 16 + cq]);
    a[ks][2] = ld_u32(&tile[ra * SROW + ks * 16 + cq + 8]);
    a[ks][3] = ld_u32(&tile[(ra + 8) * SROW + ks * 16 + cq + 8]);
  }
}

// A fragments (m16 x k32, two k-steps over D) of rows ra and ra + 8 of a
// padded int8 tile.
__device__ __forceinline__ void load_a_s8(uint32_t a[D / 32][4], const int8_t* tile, int ra,
                                          int c4) {
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks) {
    a[ks][0] = ld_u32(&tile[ra * IROW + ks * 32 + c4]);
    a[ks][1] = ld_u32(&tile[(ra + 8) * IROW + ks * 32 + c4]);
    a[ks][2] = ld_u32(&tile[ra * IROW + ks * 32 + 16 + c4]);
    a[ks][3] = ld_u32(&tile[(ra + 8) * IROW + ks * 32 + 16 + c4]);
  }
}

// acc[16 x 64] = A[16 x D] * tile^T in exact integers, tile = 64 int8 rows
// of D (the n axis), returned as f32.
__device__ __forceinline__ void mma_abt_s8(float acc[8][4], const uint32_t a[D / 32][4],
                                           const int8_t* tile, int lane) {
  const int c4 = (lane % 4) * 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    int acc_i[4] = {0, 0, 0, 0};
    const int8_t* row = &tile[(nt * 8 + lane / 4) * IROW + c4];
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks)
      mma_s8(acc_i, a[ks], ld_u32(row + ks * 32), ld_u32(row + ks * 32 + 16));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = static_cast<float>(acc_i[e]);
  }
}

// acc[16 x 64] = A[16 x D] * tile^T, tile = 64 bf16 rows of D (the n axis).
__device__ __forceinline__ void mma_abt_bf16(float acc[8][4], const uint32_t a[D / 16][4],
                                             const __nv_bfloat16* tile, int lane) {
  const int cq = (lane % 4) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* row = &tile[(nt * 8 + lane / 4) * SROW + cq];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16(acc[nt], a[ks], ld_u32(row + ks * 16), ld_u32(row + ks * 16 + 8));
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

// acc[16 x D] += A[16 x 64] * tile, tile = 64 bf16 rows (the k axis) of D
// columns, read transposed through ldmatrix.
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
      mma_bf16(acc[dt], a[kk], b[0], b[1]);
      mma_bf16(acc[dt + 1], a[kk], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float x[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) x[dt][0] = x[dt][1] = x[dt][2] = x[dt][3] = 0.f;
}

// 64 int8 rows row0.. of a [n_rows, D] payload into an int8 tile and, when
// wide != nullptr, widened into a bf16 tile; rows at or past n are zero.
__device__ __forceinline__ void load_i8_tile(int8_t* tile, __nv_bfloat16* wide,
                                             const int8_t* src, int row0, int n) {
  for (int c = threadIdx.x; c < 64 * (D / 16); c += THREADS) {
    const int r = c / (D / 16);
    const int col = (c % (D / 16)) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    if (tile) *reinterpret_cast<uint4*>(&tile[r * IROW + col]) = val;
    if (wide) widen16(&wide[r * SROW + col], val);
  }
}

// ---------------------------------------------------------------------------
// B7: dK, dV
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
int8_dkv_kernel(const int8_t* __restrict__ q,            // [bh_kv * rep, q_pad, D]
                const int8_t* __restrict__ k,            // [bh_kv, kv_pad, D]
                const int8_t* __restrict__ v,            // [bh_kv, kv_pad, D]
                const float* __restrict__ sq,            // [bh_kv * rep, q_pad / q_grain]
                const float* __restrict__ sk,            // [bh_kv, kv_pad / kv_grain]
                const float* __restrict__ sv,            // [bh_kv, kv_pad / kv_grain]
                const __nv_bfloat16* __restrict__ dout,  // [bh_kv * rep, t, D]
                const float* __restrict__ lse,           // [bh_kv * rep, t]
                const float* __restrict__ di,            // [bh_kv * rep, t]
                float* __restrict__ dk,                  // [bh_kv, s, D]
                float* __restrict__ dv,                  // [bh_kv, s, D]
                int rep, int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                int causal, float qk_scale, float sm_scale) {
  __shared__ __align__(16) int8_t k_s[BN * IROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];
  __shared__ __align__(16) int8_t q_s[BM * IROW];
  __shared__ __align__(16) __nv_bfloat16 qw_s[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 do_s[BM * SROW];
  __shared__ float lse_s[BM];
  __shared__ float di_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int c4 = (lane % 4) * 4;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BN;
  const int nq = q_pad / q_grain;
  const int nk = kv_pad / kv_grain;

  // rows past s hold the padded payload (k0 + 64 <= kv_pad); P masks them
  load_i8_tile(k_s, nullptr, k + bh * kv_pad * D, k0, kv_pad);
  load_i8_tile(nullptr, v_s, v + bh * kv_pad * D, k0, kv_pad);
  __syncthreads();

  // This warp's 16 keys as the A operand of S^T = K Q^T (int8).
  const int ra = warp * 16 + lane / 4;
  uint32_t ka[D / 32][4];
  load_a_s8(ka, k_s, ra, c4);
  const int key[2] = {k0 + ra, k0 + ra + 8};
  const float sk_b = sk[bh * nk + k0 / kv_grain];
  const float sv_b = sv[bh * nk + k0 / kv_grain];

  float dk_acc[D / 8][4], dv_acc[D / 8][4], dk_seg[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(dk_seg);

  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? k0 / BM : 0;
  const int n_qt = (t + BM - 1) / BM;
  for (int g = 0; g < rep; ++g) {
    const size_t head = bh * rep + g;
    for (int j = j0; j < n_qt; ++j) {
      const int q0 = j * BM;
      __syncthreads();  // every warp is done with the previous q tile
      load_i8_tile(q_s, qw_s, q + head * q_pad * D, q0, t);
      for (int c = tid; c < BM * (D / 8); c += THREADS) {
        const int r = c / (D / 8);
        const int col = (c % (D / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < t)
          val = *reinterpret_cast<const uint4*>(dout + (head * t + q0 + r) * D + col);
        *reinterpret_cast<uint4*>(&do_s[r * SROW + col]) = val;
      }
      if (tid < BM) {
        const bool live = q0 + tid < t;
        lse_s[tid] = live ? lse[head * t + q0 + tid] : 0.f;
        di_s[tid] = live ? di[head * t + q0 + tid] : 0.f;
      }
      __syncthreads();

      // the tile lies in one q grain: c = (sq * sk) * qk_scale is one number
      const float sq_t = sq[head * nq + q0 / q_grain];
      const float c = __fmul_rn(__fmul_rn(sq_t, sk_b), qk_scale);

      // P^T = exp2(raw * c - lse_q): 16 keys x 64 q positions, 0 where masked.
      float pt[8][4];
      mma_abt_s8(pt, ka, q_s, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + cq + (e & 1);
          const int pos = q0 + col;
          const int kk = key[e / 2];
          const bool valid = kk < s && pos < t && (!causal || kk <= pos);
          pt[nt][e] = valid ? exp2f(__fmul_rn(pt[nt][e], c) - lse_s[col]) : 0.f;
        }
      }
      uint32_t fa[4][4];
      acc_to_a(fa, pt);
      mma_ab(dv_acc, fa, do_s, lane);  // dV += bf16(P^T) dO

      // dS^T = P^T ((V dO^T) * sv - D_q) * sm_scale, with the unrounded P.
      float dst[8][4];
      {
        uint32_t va[D / 16][4];
        load_a_bf16(va, v_s, ra, cq);
        mma_abt_bf16(dst, va, do_s, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dp = __fmul_rn(dst[nt][e], sv_b);
          dst[nt][e] =
              __fmul_rn(__fmul_rn(pt[nt][e], dp - di_s[nt * 8 + cq + (e & 1)]), sm_scale);
        }
      }
      acc_to_a(fa, dst);
      mma_ab(dk_seg, fa, qw_s, lane);  // dK_seg += bf16(dS^T) Q_i8

      // the (q head, q grain) segment ends: dK += dK_seg * sq
      if (j + 1 == n_qt || ((j + 1) * BM) % q_grain == 0) {
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_acc[dt][e] = __fadd_rn(dk_acc[dt][e], __fmul_rn(dk_seg[dt][e], sq_t));
            dk_seg[dt][e] = 0.f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (bh * s + key[h]) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(dk + off + dt * 8) =
          make_float2(dk_acc[dt][2 * h], dk_acc[dt][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + off + dt * 8) =
          make_float2(dv_acc[dt][2 * h], dv_acc[dt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B8: dQ
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
int8_dq_kernel(const int8_t* __restrict__ q,            // [bh_kv * rep, q_pad, D]
               const int8_t* __restrict__ k,            // [bh_kv, kv_pad, D]
               const int8_t* __restrict__ v,            // [bh_kv, kv_pad, D]
               const float* __restrict__ sq,            // [bh_kv * rep, q_pad / q_grain]
               const float* __restrict__ sk,            // [bh_kv, kv_pad / kv_grain]
               const float* __restrict__ sv,            // [bh_kv, kv_pad / kv_grain]
               const __nv_bfloat16* __restrict__ dout,  // [bh_kv * rep, t, D]
               const float* __restrict__ lse,           // [bh_kv * rep, t]
               const float* __restrict__ di,            // [bh_kv * rep, t]
               const float* __restrict__ k_mean,        // [bh_kv, D]
               float* __restrict__ dq,                  // [bh_kv * rep, t, D]
               int rep, int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
               int bq, int causal, float qk_scale, float sm_scale) {
  __shared__ __align__(16) int8_t q_s[BM * IROW];
  __shared__ __align__(16) __nv_bfloat16 do_s[BM * SROW];
  __shared__ __align__(16) int8_t k_s[BN * IROW];
  __shared__ __align__(16) __nv_bfloat16 kw_s[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int c4 = (lane % 4) * 4;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = rep * bq;  // live rows of the block (<= BM)
  const int nq = q_pad / q_grain;
  const int nk = kv_pad / kv_grain;

  // Q (int8) and dO (bf16) rows of the whole GQA group -> shared (zeros for
  // dead rows and positions past t).
  for (int c = tid; c < BM * (D / 16); c += THREADS) {
    const int r = c / (D / 16);
    const int col = (c % (D / 16)) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && q0 + r % bq < t)
      val = *reinterpret_cast<const uint4*>(
          q + ((bh * rep + r / bq) * q_pad + q0 + r % bq) * D + col);
    *reinterpret_cast<uint4*>(&q_s[r * IROW + col]) = val;
  }
  for (int c = tid; c < BM * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && q0 + r % bq < t)
      val = *reinterpret_cast<const uint4*>(
          dout + ((bh * rep + r / bq) * t + q0 + r % bq) * D + col);
    *reinterpret_cast<uint4*>(&do_s[r * SROW + col]) = val;
  }
  __syncthreads();

  // This thread's two rows (fragment rows lane/4 and lane/4 + 8 of its warp).
  const int ra = warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
  float lse_r[2], di_r[2], sq_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos[h] = q0 + r % bq;
    live[h] = r < rows && pos[h] < t;
    const size_t head = bh * rep + r / bq;
    lse_r[h] = live[h] ? lse[head * t + pos[h]] : 0.f;
    di_r[h] = live[h] ? di[head * t + pos[h]] : 0.f;
    sq_r[h] = live[h] ? sq[head * nq + pos[h] / q_grain] : 1.f;
  }
  uint32_t qa[D / 32][4], doa[D / 16][4];
  load_a_s8(qa, q_s, ra, c4);
  load_a_bf16(doa, do_s, ra, cq);

  float dq_acc[D / 8][4], dq_seg[D / 8][4];
  zero(dq_acc);
  zero(dq_seg);
  float rs[2] = {0.f, 0.f};  // this thread's part of rowsum(dS) over the grain

  // Causal: keys past the block's last query position are never visible.
  const int kv_hi = causal ? min(s, q0 + bq) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_i8_tile(k_s, kw_s, k + bh * kv_pad * D, k0, kv_pad);
    load_i8_tile(nullptr, v_s, v + bh * kv_pad * D, k0, kv_pad);
    __syncthreads();

    const float sk_t = sk[bh * nk + k0 / kv_grain];
    const float sv_t = sv[bh * nk + k0 / kv_grain];
    float c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) c[h] = __fmul_rn(__fmul_rn(sq_r[h], sk_t), qk_scale);

    // P = exp2(raw * c - lse), 0 where masked.
    float p[8][4];
    mma_abt_s8(p, qa, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = live[h] && col < s && (!causal || col <= pos[h]);
        p[nt][e] = valid ? exp2f(__fmul_rn(p[nt][e], c[h]) - lse_r[h]) : 0.f;
      }
    }
    // dS = P ((dO V^T) * sv - D) * sm_scale, with the unrounded P.
    float ds[8][4];
    mma_abt_bf16(ds, doa, v_s, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float dp = __fmul_rn(ds[nt][e], sv_t);
        ds[nt][e] = __fmul_rn(__fmul_rn(p[nt][e], dp - di_r[h]), sm_scale);
        rs[h] += ds[nt][e];
      }
    }
    uint32_t fa[4][4];
    acc_to_a(fa, ds);
    mma_ab(dq_seg, fa, kw_s, lane);  // dQ_seg += bf16(dS) K_i8

    // the kv grain ends: dQ += dQ_seg * sk + rowsum(dS) * k_mean
    if (j + 1 == n_tiles || ((j + 1) * BN) % kv_grain == 0) {
      const float rsum[2] = {quad_sum(rs[0]), quad_sum(rs[1])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 km = *reinterpret_cast<const float2*>(k_mean + bh * D + dt * 8 + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float term = __fadd_rn(__fmul_rn(dq_seg[dt][e], sk_t),
                                       __fmul_rn(rsum[e / 2], (e & 1) ? km.y : km.x));
          dq_acc[dt][e] = __fadd_rn(dq_acc[dt][e], term);
          dq_seg[dt][e] = 0.f;
        }
      }
      rs[0] = rs[1] = 0.f;
    }
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

}  // namespace

// B7: dK, dV [bh_kv, s, D] f32. q/k/v int8 payloads, sq/sk/sv f32 scale
// tables, dout [bh_kv * rep, t, D] bf16, lse/di [bh_kv * rep, t] f32.
extern "C" int qa_int8_bwd_dkv(const void* q, const void* k, const void* v, const void* sq,
                               const void* sk, const void* sv, const void* dout, const void* lse,
                               const void* di, void* dk, void* dv, int bh_kv, int rep, int t,
                               int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                               int causal, float qk_scale, float sm_scale, void* stream) {
  const dim3 grid((s + BN - 1) / BN, bh_kv);
  int8_dkv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), rep, t, s,
      q_pad, kv_pad, q_grain, kv_grain, causal, qk_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// B8: dQ [bh_kv * rep, t, D] f32, same inputs as B7 plus k_mean [bh_kv, D].
extern "C" int qa_int8_bwd_dq(const void* q, const void* k, const void* v, const void* sq,
                              const void* sk, const void* sv, const void* dout, const void* lse,
                              const void* di, const void* k_mean, void* dq, int bh_kv, int rep,
                              int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                              int causal, float qk_scale, float sm_scale, void* stream) {
  const int bq = BM / rep;
  const dim3 grid((t + bq - 1) / bq, bh_kv);
  int8_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const float*>(k_mean), static_cast<float*>(dq),
      rep, t, s, q_pad, kv_pad, q_grain, kv_grain, bq, causal, qk_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
