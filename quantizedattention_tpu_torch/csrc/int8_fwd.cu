// Int8 flash-attention forward on pre-quantized Q/K/V for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/int8_fwd.py:
// _int8_fwd_kernel (B5). Same numerics: S = Q_i8 K_i8^T is an exact integer
// (int8 mma.sync, s8 x s8 -> s32, then f32: |S| <= 64 * 127^2 < 2^24, the
// value the TPU gets from bf16 dots on the same payloads); each row r and key
// tile scale it by c = (sq_r * sk) * qk_scale, with sq per (q head, q grain)
// and sk per kv grain; masked raw logits (causal k <= q, keys past s) become
// 30000 / -c, so that the scaled logit is -30000 whatever the scale; the row
// max is max(raw) * c + EPS_BIAS; P = bf16(exp2(raw * c - m)) feeds both the
// PV product and the row sum l; acc = acc * alpha + (P V_i8) * sv with sv
// per kv grain; rows with l == 0 give O = 0; lse = m + log2(l) (exp2 domain).
//
// What bounds it on this card: at the training shape (4,16,2048,64), causal,
// the two products over 134 M visible pairs (17.2 G int8 operations for S,
// 17.2 G bf16 for PV) against ~25 MB of payloads: tensor-core bound.
//
// Design (simple first), on B1's (csrc/flash_fwd.cu): one block of 4 warps
// per (batch*kv_head, q tile) whose 64 rows hold the kv head's whole GQA
// group (row r -> group r / bq, position q0 + r % bq, bq = 64 / rep), so a
// K/V tile is read once for all rep q heads. K tiles stay int8 in shared
// memory (the B operand of m16n8k32 s8 mma); V tiles are widened to bf16 on
// their way into shared memory (exact) for the bf16 PV mma. The S
// accumulators of two n-tiles are the A fragment of one PV k-step, so P
// never touches shared memory. A 64-key tile never straddles a kv grain (a
// grain is a multiple of 128 tokens), so PV of one tile is taken into its own
// accumulator and folded in as (P V_i8) * sv: the rounding points of the
// TPU kernel, whose online softmax runs per kv grain. The kernel's online
// softmax runs per 64-key tile instead, so P is rounded against a different
// running max (as in B1). No cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // rows per block: 4 warps x 16
constexpr int BN = 64;        // keys per kv tile
constexpr int IROW = D + 16;  // padded shared row of an int8 tile (bytes)
constexpr int SROW = D + 8;   // padded shared row of a bf16 tile (elements)
constexpr int THREADS = 128;
constexpr float EPS_BIAS = 1.0f / 256.0f;

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

__global__ void __launch_bounds__(THREADS)
int8_fwd_kernel(const int8_t* __restrict__ q,    // [bh_kv * rep, q_pad, D]
                const int8_t* __restrict__ k,    // [bh_kv, kv_pad, D]
                const int8_t* __restrict__ v,    // [bh_kv, kv_pad, D]
                const float* __restrict__ sq,    // [bh_kv * rep, q_pad / q_grain]
                const float* __restrict__ sk,    // [bh_kv, kv_pad / kv_grain]
                const float* __restrict__ sv,    // [bh_kv, kv_pad / kv_grain]
                float* __restrict__ o,           // [bh_kv * rep, t, D]
                float* __restrict__ lse,         // [bh_kv * rep, t]
                int rep, int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                int bq, int causal, float qk_scale) {
  __shared__ __align__(16) int8_t q_s[BM * IROW];
  __shared__ __align__(16) int8_t k_s[BN * IROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int c4 = (lane % 4) * 4;  // int8 fragment column quad
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rows = rep * bq;  // live rows of the block (<= BM)
  const int nq = q_pad / q_grain;
  const int nk = kv_pad / kv_grain;

  // Q rows -> shared (zeros for dead rows and positions past t).
  for (int c = tid; c < BM * (D / 16); c += THREADS) {
    const int r = c / (D / 16);
    const int col = (c % (D / 16)) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && q0 + r % bq < t)
      val = *reinterpret_cast<const uint4*>(
          q + ((bh * rep + r / bq) * q_pad + q0 + r % bq) * D + col);
    *reinterpret_cast<uint4*>(&q_s[r * IROW + col]) = val;
  }
  __syncthreads();

  // This thread's two rows (fragment rows lane/4 and lane/4 + 8 of its warp).
  const int ra = warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
  float sq_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos[h] = q0 + r % bq;
    live[h] = r < rows && pos[h] < t;
    sq_r[h] = live[h] ? sq[(bh * rep + r / bq) * nq + pos[h] / q_grain] : 1.f;
  }

  uint32_t qa[D / 32][4];
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks) {
    qa[ks][0] = ld_u32(&q_s[ra * IROW + ks * 32 + c4]);
    qa[ks][1] = ld_u32(&q_s[(ra + 8) * IROW + ks * 32 + c4]);
    qa[ks][2] = ld_u32(&q_s[ra * IROW + ks * 32 + 16 + c4]);
    qa[ks][3] = ld_u32(&q_s[(ra + 8) * IROW + ks * 32 + 16 + c4]);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // Causal: keys past the block's last query position are never visible.
  const int kv_hi = causal ? min(s, q0 + bq) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BN * (D / 16); c += THREADS) {
      const int r = c / (D / 16);
      const int col = (c % (D / 16)) * 16;
      // rows past s hold the padded payload; they are masked below
      const size_t off = (bh * kv_pad + k0 + r) * D + col;
      *reinterpret_cast<uint4*>(&k_s[r * IROW + col]) = *reinterpret_cast<const uint4*>(k + off);
      widen16(&v_s[r * SROW + col], *reinterpret_cast<const uint4*>(v + off));
    }
    __syncthreads();

    const int grain = k0 / kv_grain;
    const float sk_t = sk[bh * nk + grain];
    const float sv_t = sv[bh * nk + grain];
    float c[2], sentinel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = __fmul_rn(__fmul_rn(sq_r[h], sk_t), qk_scale);
      sentinel[h] = __fdiv_rn(30000.f, -c[h]);
    }

    // Raw S = Q_i8 K_i8^T for this warp's 16 rows x 64 keys, exact.
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      int acc_i[4] = {0, 0, 0, 0};
      const int8_t* krow = &k_s[(nt * 8 + lane / 4) * IROW + c4];
#pragma unroll
      for (int ks = 0; ks < D / 32; ++ks)
        mma_s8(acc_i, qa[ks], ld_u32(krow + ks * 32), ld_u32(krow + ks * 32 + 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = static_cast<float>(acc_i[e]);
    }

    // Mask in the raw domain, row max (scaled, +EPS_BIAS), running-max update.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = col < s && (!causal || col <= pos[h]);
        if (!valid) sc[nt][e] = sentinel[h];
        mx[h] = fmaxf(mx[h], sc[nt][e]);
      }
    }
    float next_m[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      next_m[h] = fmaxf(m[h], __fadd_rn(__fmul_rn(quad_max(mx[h]), c[h]), EPS_BIAS));
      alpha[h] = exp2f(m[h] - next_m[h]);
      m[h] = next_m[h];
    }

    // P = bf16(exp2(raw * c - m)); l sums the ROUNDED P.
    uint32_t pa[BN / 16][4];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const __nv_bfloat162 p01 =
          __floats2bfloat162_rn(exp2f(__fmul_rn(sc[nt][0], c[0]) - next_m[0]),
                                exp2f(__fmul_rn(sc[nt][1], c[0]) - next_m[0]));
      const __nv_bfloat162 p23 =
          __floats2bfloat162_rn(exp2f(__fmul_rn(sc[nt][2], c[1]) - next_m[1]),
                                exp2f(__fmul_rn(sc[nt][3], c[1]) - next_m[1]));
      lsum[0] += __low2float(p01) + __high2float(p01);
      lsum[1] += __low2float(p23) + __high2float(p23);
      pa[nt / 2][(nt % 2) * 2 + 0] = as_u32(p01);
      pa[nt / 2][(nt % 2) * 2 + 1] = as_u32(p23);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(lsum[h]);

    // acc = acc * alpha + (P V_i8) * sv, the tile's PV in its own accumulator.
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
      const int n = dt * 8 + lane / 4;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const __nv_bfloat16* vcol = &v_s[(kk * 16 + cq) * SROW + n];
        mma_bf16(pv, pa[kk], pack2(vcol[0], vcol[SROW]), pack2(vcol[8 * SROW], vcol[9 * SROW]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[dt][e] = __fadd_rn(__fmul_rn(acc[dt][e], alpha[e / 2]), __fmul_rn(pv[e], sv_t));
    }
  }

  // Epilogue: O = acc / l (l == 0 -> 1), lse = m + log2(l).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = ra + 8 * h;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const size_t row = (bh * rep + r / bq) * t + pos[h];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 val = make_float2(acc[dt][2 * h] / l_safe, acc[dt][2 * h + 1] / l_safe);
      *reinterpret_cast<float2*>(o + row * D + dt * 8 + cq) = val;
    }
    if (lane % 4 == 0) lse[row] = m[h] + log2f(l_safe);
  }
}

}  // namespace

extern "C" int qa_int8_fwd(const void* q, const void* k, const void* v, const void* sq,
                           const void* sk, const void* sv, void* o, void* lse, int bh_kv, int rep,
                           int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                           int causal, float qk_scale, void* stream) {
  const int bq = BM / rep;
  const dim3 grid((t + bq - 1) / bq, bh_kv);
  int8_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(sq), static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<float*>(o), static_cast<float*>(lse), rep, t, s, q_pad, kv_pad, q_grain,
      kv_grain, bq, causal, qk_scale);
  return static_cast<int>(cudaGetLastError());
}
