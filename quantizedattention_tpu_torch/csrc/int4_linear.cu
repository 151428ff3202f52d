// Weight-only int4 matmul for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/int4_linear.py:_kernel
// (B18). The weight is split-half packed: byte row r of packed [Kp/2, n]
// holds row r of the weight in its low nibble and row r + Kp/2 in its high
// nibble; scale [Kp/group, n] holds one f32 per (group of k rows, column),
// the lower half's groups first. Same numerics as the TPU kernel: x [m, Kp]
// in bf16 (the wrapper casts), each nibble sign-extended with shifts (exact in
// bf16); for each group t, the lower half's sub-dot and the upper half's
// sub-dot are each taken in f32 by bf16 mma.sync over the group's rows, each
// is multiplied by its own scale row and added to the accumulator (lower
// first), and the result is cast to the output type once. The scale never
// meets a bf16 operand. Only the f32 summation order of a sub-dot, and the
// order in which groups' terms are added (see the k split below), differ.
//
// What bounds it on this card: at serving decode (m = 8) the packed weight
// stream, a quarter of bf16's bytes: memory. At prefill the bf16 tensor cores.
//
// Design (simple first), as csrc/int8_linear.cu: one block per (m tile, n
// tile); a stage holds, for WK groups at once, a 64-row chunk of each group:
// the x columns of both halves (bf16) and the packed rows unpacked into a
// lower and an upper bf16 tile in shared memory. Warp (wm, wn, wk) takes
// group t0 + wk of the stage, keeps the two sub-dots in registers until the
// group's last chunk and then folds them into its accumulator with the two
// scale rows. Decode (m <= 16): 16 x 16 tiles, 4 warps on 4 groups at once,
// their accumulators summed through shared memory in a fixed order (the
// groups' terms are added per warp, then across warps); prefill: 64 x 64
// tiles, 2 x 2 warps, groups in order. group is a multiple of 64. No
// cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // byte rows of one warp's chunk

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

// 16 packed bytes -> 16 low-nibble and 16 high-nibble weights, sign-extended
// with shifts and widened to bf16 (exact), stored at lo and hi.
__device__ __forceinline__ void unpack16(__nv_bfloat16* lo, __nv_bfloat16* hi, uint4 v) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint32_t wl[8], wh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x0 = b[2 * i], x1 = b[2 * i + 1];  // sign-extended bytes
    const int l0 = static_cast<int>(static_cast<uint32_t>(x0) << 28) >> 28;
    const int l1 = static_cast<int>(static_cast<uint32_t>(x1) << 28) >> 28;
    wl[i] = pack2(__float2bfloat16_rn(static_cast<float>(l0)),
                  __float2bfloat16_rn(static_cast<float>(l1)));
    wh[i] = pack2(__float2bfloat16_rn(static_cast<float>(x0 >> 4)),
                  __float2bfloat16_rn(static_cast<float>(x1 >> 4)));
  }
  reinterpret_cast<uint4*>(lo)[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  reinterpret_cast<uint4*>(lo)[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
  reinterpret_cast<uint4*>(hi)[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
  reinterpret_cast<uint4*>(hi)[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_type) {
  if (out_type == OUT_F32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

template <int BM, int BN, int WM, int WN, int WK>
__global__ void __launch_bounds__(32 * WM * WN * WK)
int4_linear_kernel(const __nv_bfloat16* __restrict__ x,  // [m, 2 * half]
                   const int8_t* __restrict__ packed,    // [half, n]
                   const float* __restrict__ scale,      // [2 * half / group, n]
                   void* __restrict__ out,               // [m, n] of out_type
                   int m, int n, int half, int group, int out_type) {
  constexpr int THREADS = 32 * WM * WN * WK;
  constexpr int TM = BM / (16 * WM);  // m16 tiles of a warp
  constexpr int TN = BN / (8 * WN);   // n8 tiles of a warp
  constexpr int XROW = BK + 8;        // padded shared row of an x chunk (bf16)
  constexpr int WROW = BN + 8;        // padded shared row of a weight chunk (bf16)
  // [WK][half: 0 lower, 1 upper] chunks
  __shared__ __align__(16) __nv_bfloat16 xs[WK * 2 * BM * XROW];
  __shared__ __align__(16) __nv_bfloat16 ws[WK * 2 * BK * WROW];
  __shared__ float red[WK > 1 ? WK * BM * BN : 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wk = warp / (WM * WN);
  const int wm = (warp % (WM * WN)) / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kp = 2 * half;
  const int n_groups = half / group;  // groups per half
  const bool w_vec = n % 16 == 0;

  // this thread's columns, for the scale rows
  int cols[TN][2];
#pragma unroll
  for (int tn = 0; tn < TN; ++tn)
#pragma unroll
    for (int e = 0; e < 2; ++e) cols[tn][e] = n0 + (wn * TN + tn) * 8 + (lane % 4) * 2 + e;

  float acc[TM][TN][4], sub[2][TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sub[0][i][j][e] = sub[1][i][j][e] = 0.f;

  for (int t0 = 0; t0 < n_groups; t0 += WK) {
    for (int c0 = 0; c0 < group; c0 += BK) {
      __syncthreads();  // every warp is done with the previous stage
      // x: both halves' columns of chunk c0 of groups t0 .. t0 + WK - 1
      for (int c = tid; c < WK * 2 * BM * (BK / 8); c += THREADS) {
        const int col = (c % (BK / 8)) * 8;
        const int r = (c / (BK / 8)) % BM;
        const int hz = c / (BM * (BK / 8));  // (group in stage) * 2 + half
        const int t = t0 + hz / 2;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (t < n_groups && m0 + r < m)
          val = *reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + r) * kp + (hz % 2) * half + t * group + c0 + col);
        *reinterpret_cast<uint4*>(&xs[(hz * BM + r) * XROW + col]) = val;
      }
      // packed rows of the same chunk, unpacked into a lower and an upper tile
      for (int c = tid; c < WK * BK * (BN / 16); c += THREADS) {
        const int col = (c % (BN / 16)) * 16;
        const int r = (c / (BN / 16)) % BK;
        const int z = c / (BK * (BN / 16));
        const int t = t0 + z;
        const int gn = n0 + col;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (t < n_groups) {
          const int8_t* src = packed + (size_t)(t * group + c0 + r) * n + gn;
          if (w_vec && gn + 16 <= n) {
            val = *reinterpret_cast<const uint4*>(src);
          } else {
            int8_t* e = reinterpret_cast<int8_t*>(&val);
#pragma unroll
            for (int i = 0; i < 16; ++i) e[i] = gn + i < n ? src[i] : 0;
          }
        }
        unpack16(&ws[((z * 2) * BK + r) * WROW + col], &ws[((z * 2 + 1) * BK + r) * WROW + col],
                 val);
      }
      __syncthreads();

      // this warp's group: both sub-dots over the chunk
#pragma unroll
      for (int hz = 0; hz < 2; ++hz) {
        const __nv_bfloat16* xc = &xs[(wk * 2 + hz) * BM * XROW];
        const __nv_bfloat16* wc = &ws[(wk * 2 + hz) * BK * WROW];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          const int ck = kk + (lane % 4) * 2;
          uint32_t a[TM][4];
#pragma unroll
          for (int tm = 0; tm < TM; ++tm) {
            const int r = (wm * TM + tm) * 16 + lane / 4;
            a[tm][0] = ld_u32(&xc[r * XROW + ck]);
            a[tm][1] = ld_u32(&xc[(r + 8) * XROW + ck]);
            a[tm][2] = ld_u32(&xc[r * XROW + ck + 8]);
            a[tm][3] = ld_u32(&xc[(r + 8) * XROW + ck + 8]);
          }
#pragma unroll
          for (int tn = 0; tn < TN; ++tn) {
            const __nv_bfloat16* bcol = &wc[ck * WROW + (wn * TN + tn) * 8 + lane / 4];
            const uint32_t b0 = pack2(bcol[0], bcol[WROW]);
            const uint32_t b1 = pack2(bcol[8 * WROW], bcol[9 * WROW]);
#pragma unroll
            for (int tm = 0; tm < TM; ++tm) mma_bf16(sub[hz][tm][tn], a[tm], b0, b1);
          }
        }
      }
    }
    // the group's last chunk is in: acc += sub_lo * s_lo; acc += sub_hi * s_hi
    const int t = t0 + wk;
    if (t < n_groups) {
#pragma unroll
      for (int hz = 0; hz < 2; ++hz) {
        const float* srow = scale + (size_t)(hz * n_groups + t) * n;
#pragma unroll
        for (int tn = 0; tn < TN; ++tn) {
          const float s0 = cols[tn][0] < n ? srow[cols[tn][0]] : 0.f;
          const float s1 = cols[tn][1] < n ? srow[cols[tn][1]] : 0.f;
#pragma unroll
          for (int tm = 0; tm < TM; ++tm)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[tm][tn][e] = __fadd_rn(acc[tm][tn][e],
                                         __fmul_rn(sub[hz][tm][tn][e], (e & 1) ? s1 : s0));
              sub[hz][tm][tn][e] = 0.f;
            }
        }
      }
    }
  }

  // Epilogue: (sum over the group-split warps, in warp order), cast once.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (wm * TM + tm) * 16 + lane / 4 + 8 * (e / 2);
        const int col = cols[tn][e & 1] - n0;
        if (WK > 1)
          red[(wk * BM + r) * BN + col] = acc[tm][tn][e];
        else if (m0 + r < m && n0 + col < n)
          store_out(out, (size_t)(m0 + r) * n + n0 + col, acc[tm][tn][e], out_type);
      }
  if (WK > 1) {
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, col = i % BN;
      if (m0 + r >= m || n0 + col >= n) continue;
      float sum = red[i];
#pragma unroll
      for (int z = 1; z < WK; ++z) sum = __fadd_rn(sum, red[z * BM * BN + i]);
      store_out(out, (size_t)(m0 + r) * n + n0 + col, sum, out_type);
    }
  }
}

template <int BM, int BN, int WM, int WN, int WK>
int launch(const void* x, const void* packed, const void* scale, void* out, int m, int n,
           int half, int group, int out_type, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int4_linear_kernel<BM, BN, WM, WN, WK><<<grid, 32 * WM * WN * WK, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), out, m, n, half, group, out_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, 2 * half] bf16, packed [half, n] int8, scale [2 * half / group, n]
// f32 -> out [m, n] of out_type (0 f32, 1 bf16). group is a multiple
// of 64 and divides half.
extern "C" int qa_int4_linear(const void* x, const void* packed, const void* scale, void* out,
                              int m, int n, int half, int group, int out_type, void* stream) {
  if (out_type < OUT_F32 || out_type > OUT_BF16 || group <= 0 || group % BK != 0 ||
      half % group != 0 || (m + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) return launch<16, 16, 1, 1, 4>(x, packed, scale, out, m, n, half, group, out_type, st);
  return launch<64, 64, 2, 2, 1>(x, packed, scale, out, m, n, half, group, out_type, st);
}
