// Int8 flash-attention forward for Hopper (sm_90a), plain C ABI: on
// pre-quantized Q/K/V (B5) and on Q/K/V in their floating type, quantized
// inside the kernel (B6). One kernel body serves both.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/int8_fwd.py:
// _int8_fwd_kernel (B5) and _int8_fused_kernel (B6). Same numerics: S =
// Q_i8 K_i8^T is an exact integer (int8 mma.sync, s8 x s8 -> s32, then f32:
// |S| <= 64 * 127^2 < 2^24, the value the TPU gets from bf16 dots on the same
// payloads); each row r and key tile scale it by c = (sq_r * sk) * qk_scale,
// with sq per (q head, q grain) and sk per kv grain; masked raw logits
// (causal k <= q, keys past s) become 30000 / -c, so that the scaled logit is
// -30000 whatever the scale; the row max is max(raw) * c + EPS_BIAS; P =
// bf16(exp2(raw * c - m)) feeds both the PV product and the row sum l; acc =
// acc * alpha + (P V_i8) * sv with sv per kv grain; rows with l == 0 give
// O = 0; lse = m + log2(l) (exp2 domain).
//
// The kernel is templated on the type of its Q/K/V tiles; only the tile
// loaders differ:
//   - int8_t (B5): the payloads and scale tables of B4 (csrc/quant_int8.cu),
//     rows padded to q_pad / kv_pad tokens;
//   - float or bf16 (B6): the inputs themselves, t / s tokens a row. B4's
//     absmax pass, run first with no payload output, writes the scale tables
//     at the same grain; each tile is then quantized on its way into shared
//     memory exactly as B4 quantizes (K minus the K-smoothing row ksub,
//     payload = clamp(rint(x / s)) with an IEEE division), so no int8 payload
//     is written to device memory and B6's O and lse equal B4 then B5 on the
//     same inputs by construction.
//
// What bounds it on this card: at (4,16,2048,64), causal, the two products
// over 134 M visible pairs (17.2 G int8 operations for S, 17.2 G bf16 for
// PV) against ~25 MB of payloads (B5) or ~50 MB of bf16 inputs (B6):
// tensor-core bound. B6's own extra work is the re-quantization of every K/V
// tile in every q block (an IEEE division per element, O(t^2 / 64)), which
// the TPU kernel's reuse_kv scratch avoids by keeping the quantized K/V
// resident; here that is left for later.
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

#include <type_traits>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // rows per block: 4 warps x 16
constexpr int BN = 64;        // keys per kv tile
constexpr int IROW = D + 16;  // padded shared row of an int8 tile (bytes)
constexpr int SROW = D + 8;   // padded shared row of a bf16 tile (elements)
constexpr int THREADS = 128;
constexpr int CHUNKS = D / 8;  // 8-element chunks of a token row
static_assert(THREADS % CHUNKS == 0, "a thread's chunks of a tile share one column");
constexpr float EPS_BIAS = 1.0f / 256.0f;

enum InType { IN_F32 = 0, IN_BF16 = 1 };

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

// 8 consecutive elements as floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// B4's payload: clamp(rint(v / s), -128, 127), an IEEE division.
__device__ __forceinline__ float quant1(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.f), 127.f);
}

// 8 values quantized by s, as 8 int8 bytes.
__device__ __forceinline__ uint2 quant8(const float v[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(quant1(v[i], s)));
    w[i / 4] |= byte << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

// 8 values quantized by s and widened to bf16 (exact), as 16 bytes.
__device__ __forceinline__ uint4 quant8_bf16(const float v[8], float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack2(__float2bfloat16_rn(quant1(v[2 * i], s)),
                 __float2bfloat16_rn(quant1(v[2 * i + 1], s)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// T = int8_t: q/k/v are payloads, rows q_len = q_pad and kv_len = kv_pad
// tokens long (B5). T = float or bf16: q/k/v are the inputs, rows q_len = t
// and kv_len = s tokens long, quantized here with the scales of B4's absmax
// pass; ksub is the K-smoothing row or null (B6).
template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_attn_kernel(const T* __restrict__ q,         // [bh_kv * rep, q_len, D]
                 const T* __restrict__ k,         // [bh_kv, kv_len, D]
                 const T* __restrict__ v,         // [bh_kv, kv_len, D]
                 const float* __restrict__ ksub,  // [bh_kv, D] or null (B6 only)
                 const float* __restrict__ sq,    // [bh_kv * rep, nq]
                 const float* __restrict__ sk,    // [bh_kv, nk]
                 const float* __restrict__ sv,    // [bh_kv, nk]
                 float* __restrict__ o,           // [bh_kv * rep, t, D]
                 float* __restrict__ lse,         // [bh_kv * rep, t]
                 int rep, int t, int s, int q_len, int kv_len, int nq, int nk, int q_grain,
                 int kv_grain, int bq, int causal, float qk_scale) {
  constexpr bool kPayload = std::is_same_v<T, int8_t>;
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

  // Q rows -> shared, int8 (zeros for dead rows and positions past t).
  if constexpr (kPayload) {
    for (int c = tid; c < BM * (D / 16); c += THREADS) {
      const int r = c / (D / 16);
      const int col = (c % (D / 16)) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && q0 + r % bq < t)
        val = *reinterpret_cast<const uint4*>(
            q + ((bh * rep + r / bq) * q_len + q0 + r % bq) * D + col);
      *reinterpret_cast<uint4*>(&q_s[r * IROW + col]) = val;
    }
  } else {  // quantized with the row's (q head, q grain) scale
    for (int c = tid; c < BM * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      uint2 val = make_uint2(0u, 0u);
      const int p = q0 + r % bq;
      if (r < rows && p < t) {
        const size_t qrow = bh * rep + r / bq;
        float x[8];
        load8(q + (qrow * q_len + p) * D + col, x);
        val = quant8(x, sq[qrow * nq + p / q_grain]);
      }
      *reinterpret_cast<uint2*>(&q_s[r * IROW + col]) = val;
    }
  }
  // B6: this thread's K/V chunks all sit at one column (THREADS % CHUNKS == 0)
  float sub[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!kPayload && ksub) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sub[i] = ksub[bh * D + (tid % CHUNKS) * 8 + i];
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
    const int grain = k0 / kv_grain;
    const float sk_t = sk[bh * nk + grain];
    const float sv_t = sv[bh * nk + grain];
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (kPayload) {
      for (int c = tid; c < BN * (D / 16); c += THREADS) {
        const int r = c / (D / 16);
        const int col = (c % (D / 16)) * 16;
        // rows past s hold the padded payload; they are masked below
        const size_t off = (bh * kv_len + k0 + r) * D + col;
        *reinterpret_cast<uint4*>(&k_s[r * IROW + col]) = *reinterpret_cast<const uint4*>(k + off);
        widen16(&v_s[r * SROW + col], *reinterpret_cast<const uint4*>(v + off));
      }
    } else {  // quantized with the tile's kv grain scales, K after the shift
      for (int c = tid; c < BN * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS;
        const int col = (c % CHUNKS) * 8;
        // keys past s are masked below: zeros (the padded V payload is zero too)
        uint2 kq = make_uint2(0u, 0u);
        uint4 vw = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < s) {
          const size_t off = (bh * kv_len + k0 + r) * D + col;
          float x[8];
          load8(k + off, x);
          if (ksub) {
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] -= sub[i];
          }
          kq = quant8(x, sk_t);
          load8(v + off, x);
          vw = quant8_bf16(x, sv_t);
        }
        *reinterpret_cast<uint2*>(&k_s[r * IROW + col]) = kq;
        *reinterpret_cast<uint4*>(&v_s[r * SROW + col]) = vw;
      }
    }
    __syncthreads();

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ksub, const void* sq,
           const void* sk, const void* sv, void* o, void* lse, int bh_kv, int rep, int t, int s,
           int q_len, int kv_len, int nq, int nk, int q_grain, int kv_grain, int causal,
           float qk_scale, cudaStream_t stream) {
  const int bq = BM / rep;
  const dim3 grid((t + bq - 1) / bq, bh_kv);
  int8_attn_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ksub), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<float*>(o),
      static_cast<float*>(lse), rep, t, s, q_len, kv_len, nq, nk, q_grain, kv_grain, bq, causal,
      qk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5: q [bh_kv * rep, q_pad, 64], k/v [bh_kv, kv_pad, 64] int8 payloads with
// their scale tables sq [bh_kv * rep, q_pad / q_grain], sk/sv [bh_kv,
// kv_pad / kv_grain] -> O [bh_kv * rep, t, 64], lse [bh_kv * rep, t] (f32).
extern "C" int qa_int8_fwd(const void* q, const void* k, const void* v, const void* sq,
                           const void* sk, const void* sv, void* o, void* lse, int bh_kv, int rep,
                           int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                           int causal, float qk_scale, void* stream) {
  return launch<int8_t>(q, k, v, nullptr, sq, sk, sv, o, lse, bh_kv, rep, t, s, q_pad, kv_pad,
                        q_pad / q_grain, kv_pad / kv_grain, q_grain, kv_grain, causal, qk_scale,
                        static_cast<cudaStream_t>(stream));
}

// B6's attention: q [bh_kv * rep, t, 64], k/v [bh_kv, s, 64] of in_type (0
// f32, 1 bf16), ksub [bh_kv, 64] f32 or null, and the scale tables that B4's
// absmax pass wrote for them at the same grain (sq [bh_kv * rep, q_pad /
// q_grain], sk/sv [bh_kv, kv_pad / kv_grain], K's after the shift) -> O
// [bh_kv * rep, t, 64], lse [bh_kv * rep, t] (f32). kv_grain is a multiple
// of 64.
extern "C" int qa_int8_fused(const void* q, const void* k, const void* v, const void* ksub,
                             const void* sq, const void* sk, const void* sv, void* o, void* lse,
                             int in_type, int bh_kv, int rep, int t, int s, int q_pad, int kv_pad,
                             int q_grain, int kv_grain, int causal, float qk_scale,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = q_pad / q_grain, nk = kv_pad / kv_grain;
  switch (in_type) {
    case IN_F32:
      return launch<float>(q, k, v, ksub, sq, sk, sv, o, lse, bh_kv, rep, t, s, t, s, nq, nk,
                           q_grain, kv_grain, causal, qk_scale, st);
    case IN_BF16:
      return launch<__nv_bfloat16>(q, k, v, ksub, sq, sk, sv, o, lse, bh_kv, rep, t, s, t, s, nq,
                                   nk, q_grain, kv_grain, causal, qk_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
