// Weight-only int8 matmul for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/int8_linear.py:_kernel
// (B17). Same numerics: out[m, n] = (x[m, k] @ w_i8[k, n]) * scale[n], with x
// in bf16 (the wrapper casts), each int8 weight widened to bf16 (exact for
// |w| <= 128), bf16 mma.sync products accumulated in f32 over all of k, the
// f32 column scale applied once at the end and the result cast to the output
// type (f32 or bf16) once. Only the f32 summation order differs from the
// TPU kernel's.
//
// What bounds it on this card: at serving decode (m = 8 rows) the work is
// 2 * m * k * n operations against k * n weight bytes, far below the ~590
// int8-weight operations per byte where the tensor cores would take over:
// the weight stream, i.e. memory. At prefill (m = 2048) it is the bf16
// tensor cores.
//
// Design (simple first): one block per (m tile, n tile); a stage stages the x
// rows (bf16) and the weight rows (int8, widened to bf16 on their way into
// shared memory) of WK chunks of 64 k-rows, and warp (wm, wn, wk) runs bf16
// m16n8k16 mma.sync on its sub-tile of chunk wk. Two shapes:
//   - m <= 16 (decode): a 16 x 16 tile, 4 warps splitting k four ways and
//     summed through shared memory in a fixed order (no atomics, so the
//     result does not change from run to run). 16-column tiles give n / 16
//     blocks: 64 at n = 1024, 256 at 4096, 512 at 8192 for the card's 132
//     SMs; a 128-column tile would give 8 at n = 1024.
//   - m > 16 (prefill): a 64 x 64 tile, 2 x 2 warps of 32 x 32.
// Ragged m, n and k are masked; the 16-byte loads are taken where the row
// strides allow them (k % 8 == 0 for x, n % 16 == 0 for w). No cp.async/TMA
// pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // k rows of one warp's chunk

enum OutType { OUT_F32 = 0, OUT_BF16 = 1 };

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// 16 int8 -> 16 bf16 (exact), stored at dst.
__device__ __forceinline__ void widen16(__nv_bfloat16* dst, uint4 v) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack2(__float2bfloat16_rn(static_cast<float>(b[2 * i])),
                 __float2bfloat16_rn(static_cast<float>(b[2 * i + 1])));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_type) {
  if (out_type == OUT_F32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

template <int BM, int BN, int WM, int WN, int WK>
__global__ void __launch_bounds__(32 * WM * WN * WK)
int8_linear_kernel(const __nv_bfloat16* __restrict__ x,  // [m, k]
                   const int8_t* __restrict__ w,         // [k, n]
                   const float* __restrict__ scale,      // [n]
                   void* __restrict__ out,               // [m, n] of out_type
                   int m, int n, int k, int out_type) {
  constexpr int THREADS = 32 * WM * WN * WK;
  constexpr int TM = BM / (16 * WM);  // m16 tiles of a warp
  constexpr int TN = BN / (8 * WN);   // n8 tiles of a warp
  constexpr int KS = BK * WK;         // k rows of a stage
  constexpr int XROW = KS + 8;        // padded shared row of the x stage (bf16)
  constexpr int WROW = BN + 8;        // padded shared row of the w stage (bf16)
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XROW];
  __shared__ __align__(16) __nv_bfloat16 ws[KS * WROW];
  __shared__ float red[WK > 1 ? WK * BM * BN : 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wk = warp / (WM * WN);
  const int wm = (warp % (WM * WN)) / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool x_vec = k % 8 == 0;
  const bool w_vec = n % 16 == 0;

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kb = 0; kb < k; kb += KS) {
    __syncthreads();  // every warp is done with the previous stage
    for (int c = tid; c < BM * (KS / 8); c += THREADS) {
      const int r = c / (KS / 8);
      const int col = (c % (KS / 8)) * 8;
      const int gr = m0 + r, gk = kb + col;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < m) {
        const __nv_bfloat16* src = x + (size_t)gr * k + gk;
        if (x_vec && gk + 8 <= k) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16 e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = gk + i < k ? src[i] : __float2bfloat16_rn(0.f);
          val = make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]), pack2(e[4], e[5]),
                           pack2(e[6], e[7]));
        }
      }
      *reinterpret_cast<uint4*>(&xs[r * XROW + col]) = val;
    }
    for (int c = tid; c < KS * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16);
      const int col = (c % (BN / 16)) * 16;
      const int gk = kb + r, gn = n0 + col;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gk < k) {
        const int8_t* src = w + (size_t)gk * n + gn;
        if (w_vec && gn + 16 <= n) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          int8_t* e = reinterpret_cast<int8_t*>(&val);
#pragma unroll
          for (int i = 0; i < 16; ++i) e[i] = gn + i < n ? src[i] : 0;
        }
      }
      widen16(&ws[r * WROW + col], val);
    }
    __syncthreads();

    const int kw = wk * BK;  // this warp's chunk of the stage
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int ck = kw + kk + (lane % 4) * 2;
      uint32_t a[TM][4];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
        const int r = (wm * TM + tm) * 16 + lane / 4;
        a[tm][0] = ld_u32(&xs[r * XROW + ck]);
        a[tm][1] = ld_u32(&xs[(r + 8) * XROW + ck]);
        a[tm][2] = ld_u32(&xs[r * XROW + ck + 8]);
        a[tm][3] = ld_u32(&xs[(r + 8) * XROW + ck + 8]);
      }
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        const __nv_bfloat16* bcol = &ws[ck * WROW + (wn * TN + tn) * 8 + lane / 4];
        const uint32_t b0 = pack2(bcol[0], bcol[WROW]);
        const uint32_t b1 = pack2(bcol[8 * WROW], bcol[9 * WROW]);
#pragma unroll
        for (int tm = 0; tm < TM; ++tm) mma_bf16(acc[tm][tn], a[tm], b0, b1);
      }
    }
  }

  // Epilogue: (sum over the k-split warps, in warp order) * scale, cast once.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (wm * TM + tm) * 16 + lane / 4 + 8 * (e / 2);
        const int col = (wn * TN + tn) * 8 + (lane % 4) * 2 + (e & 1);
        if (WK > 1) {
          red[(wk * BM + r) * BN + col] = acc[tm][tn][e];
        } else if (m0 + r < m && n0 + col < n) {
          store_out(out, (size_t)(m0 + r) * n + n0 + col,
                    __fmul_rn(acc[tm][tn][e], scale[n0 + col]), out_type);
        }
      }
  if (WK > 1) {
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, col = i % BN;
      if (m0 + r >= m || n0 + col >= n) continue;
      float sum = red[i];
#pragma unroll
      for (int z = 1; z < WK; ++z) sum = __fadd_rn(sum, red[z * BM * BN + i]);
      store_out(out, (size_t)(m0 + r) * n + n0 + col, __fmul_rn(sum, scale[n0 + col]), out_type);
    }
  }
}

template <int BM, int BN, int WM, int WN, int WK>
int launch(const void* x, const void* w, const void* scale, void* out, int m, int n, int k,
           int out_type, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_linear_kernel<BM, BN, WM, WN, WK><<<grid, 32 * WM * WN * WK, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, m, n, k, out_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, k] bf16, w [k, n] int8, scale [n] f32 -> out [m, n] of out_type
// (0 f32, 1 bf16).
extern "C" int qa_int8_linear(const void* x, const void* w, const void* scale, void* out, int m,
                              int n, int k, int out_type, void* stream) {
  if (out_type < OUT_F32 || out_type > OUT_BF16 || (m + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) return launch<16, 16, 1, 1, 4>(x, w, scale, out, m, n, k, out_type, st);
  return launch<64, 64, 2, 2, 1>(x, w, scale, out, m, n, k, out_type, st);
}
