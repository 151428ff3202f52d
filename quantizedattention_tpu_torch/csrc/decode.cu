// Decode attention over the slotted int8 KV cache, for Hopper (sm_90a),
// plain C ABI: one query per row (spec == 1) or the speculative-verify
// staircase of `spec` consecutive queries per row.
//
// Replaces the TPU kernel quantizedattention_tpu/parallel/kv_cache.py:
// _decode_kernel, both its forms. Same numerics: q and the int8 K/V are
// taken as bf16 (int8 is exact in bf16), s = (q . k_i8) * (sk * qk_scale)
// accumulated in f32, masked keys get -inf, p = exp2(s - m) with the online
// running max, l sums the UNROUNDED p, and the PV operand is bf16(p * sv)
// against v_i8. The q-row axis of a kv head folds (GQA group, spec) as
// r = g * spec + j, and row r attends tokens t < len - (spec - 1) + r % spec
// (the JAX fold, kv_cache.py:313-314): query j of a verify sits at position
// len - spec + j and sees itself. A row with no live token (length 0, or a
// length below spec) gives O = 0 and lse = -inf.
//
// What bounds it on this card: each decode step streams every live token's
// K and V payload (2 * head_dim bytes) plus two f32 scales once per (slot,
// kv head) and does about 4 * group FLOP per byte, far below the card's
// FLOP/byte ridge, so the kernel is HBM-bound on the int8 K/V stream (and at
// short lengths, latency-bound).
//
// Design (simple first): one block of 128 threads per (kv head, slot) holds
// the kv head's whole GQA group times spec, so each K/V byte is read from
// HBM exactly once per step. The block walks only the tiles below the row's length; a
// tile's K/V rows and scales are staged in shared memory with 16-byte loads,
// and rows at or past the length are zero-filled there and never read from
// HBM: stale payloads or scales past a row's end (which can turn 0 * sv into
// NaN) cannot reach the sums. Scores use one thread per token, the softmax
// one warp per group row, and PV one thread per (group row, channel).
// The staircase is one per-row limit, applied where the scores are masked
// and where p is taken: the tile loop still runs to the length, so a tile
// holds tokens that one row sees and the next does not. A row with no live
// token in a tile gets p = 0 and alpha = 1 by select (exp2(-inf - -inf) is
// NaN), so row j is what the spec == 1 launch at length len - spec + 1 + j
// computes, bit for bit: the same tiles in the same order, and the extra
// tiles add exact zeros. Splitting the kv axis across blocks with an lse
// merge is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int TILE = 128;     // tokens per tile = threads per block
constexpr int KROW = D + 16;  // padded shared K row (bytes): conflict-free 16-byte reads
constexpr int THREADS = 128;

__host__ __device__ constexpr int float_words(int group) {
  // q [G][D], scores/weights [G][TILE], acc [G][D], m/l/alpha [G], sk/sv [TILE]
  return ((group * (2 * D + TILE + 3) + 2 * TILE) + 3) & ~3;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,  // [b, n_kv * G, D]
              const int8_t* __restrict__ k,         // [b, n_kv, L, D]
              const float* __restrict__ sk,         // [b, n_kv, L]
              const int8_t* __restrict__ v,         // [b, n_kv, L, D]
              const float* __restrict__ sv,         // [b, n_kv, L]
              const int* __restrict__ length,       // [b]
              float* __restrict__ o,                // [b, n_kv * G, D]
              float* __restrict__ lse,              // [b, n_kv * G]
              int n_kv, int G, int spec, int L, float qk_scale) {
  // G: q rows per kv head, the GQA group times spec (row r = g * spec + j)
  extern __shared__ __align__(16) float smem[];
  float* q_f = smem;
  float* w_s = q_f + G * D;       // scores, then bf16(p * sv)
  float* acc = w_s + G * TILE;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* sk_s = a_s + G;
  float* sv_s = sk_s + TILE;
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + float_words(G));
  int8_t* v_s = k_s + TILE * KROW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x;
  const int slot = blockIdx.y;
  const size_t head0 = static_cast<size_t>(slot) * n_kv * G + static_cast<size_t>(kvh) * G;
  const size_t tok0 = (static_cast<size_t>(slot) * n_kv + kvh) * L;
  const int len = min(max(length[slot], 0), L);

  for (int i = tid; i < G * D; i += THREADS) {
    q_f[i] = __bfloat162float(q[head0 * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    for (int c = tid; c < TILE * (D / 16); c += THREADS) {
      const int r = c / (D / 16);
      const int col = (c % (D / 16)) * 16;
      int4 kk = make_int4(0, 0, 0, 0);
      int4 vv = kk;
      if (r < n) {
        const size_t off = (tok0 + t0 + r) * D + col;
        kk = *reinterpret_cast<const int4*>(k + off);
        vv = *reinterpret_cast<const int4*>(v + off);
      }
      *reinterpret_cast<int4*>(k_s + r * KROW + col) = kk;
      *reinterpret_cast<int4*>(v_s + r * D + col) = vv;
    }
    sk_s[tid] = tid < n ? sk[tok0 + t0 + tid] : 0.f;
    sv_s[tid] = tid < n ? sv[tok0 + t0 + tid] : 0.f;
    __syncthreads();

    // Scores: thread tid owns token t0 + tid for every group row.
    {
      const int8_t* krow = k_s + tid * KROW;
      const float scale = sk_s[tid] * qk_scale;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_f + g * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 16) {
          const int4 chunk = *reinterpret_cast<const int4*>(krow + c);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&chunk);
#pragma unroll
          for (int e = 0; e < 16; ++e) dot = fmaf(qg[c + e], static_cast<float>(kb[e]), dot);
        }
        // spec == 1: t0 + tid < len is tid < n
        const int lim = len - (spec - 1) + g % spec;
        w_s[g * TILE + tid] = t0 + tid < lim ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: one warp per group row.
    for (int g = warp; g < G; g += THREADS / 32) {
      float x[TILE / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        x[i] = w_s[g * TILE + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
      const float m_prev = m_s[g];
      const float next_m = fmaxf(m_prev, warp_max(mx));
      const int live = len - (spec - 1) + g % spec - t0;  // this row's live slots
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const int r = lane + 32 * i;
        const float p = r < live ? exp2f(x[i] - next_m) : 0.f;
        psum += p;
        w_s[g * TILE + r] = __bfloat162float(__float2bfloat16_rn(p * sv_s[r]));
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        // no live token yet: m stays -inf, and exp2(-inf - -inf) would be NaN
        const float alpha = next_m == -INFINITY ? 1.f : exp2f(m_prev - next_m);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = next_m;
      }
    }
    __syncthreads();

    // acc = acc * alpha + bf16(p * sv) . v_i8: thread -> (group row, channel).
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i % D;
      const float* wg = w_s + g * TILE;
      float pv = 0.f;
      for (int r = 0; r < n; ++r) pv = fmaf(wg[r], static_cast<float>(v_s[r * D + d]), pv);
      acc[i] = acc[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += THREADS) {
    const float l = l_s[i / D];
    o[head0 * D + i] = acc[i] / (l == 0.f ? 1.f : l);
  }
  for (int g = tid; g < G; g += THREADS) {
    const float l = l_s[g];
    lse[head0 + g] = l == 0.f ? -INFINITY : m_s[g] + log2f(l);
  }
}

}  // namespace

// q [batch, n_kv * group * spec, D] with row (kv head, g, j); spec >= 1.
extern "C" int qa_decode(const void* q, const void* k, const void* sk, const void* v,
                         const void* sv, const void* length, void* o, void* lse, int batch,
                         int n_kv, int group, int spec, int max_len, float qk_scale,
                         void* stream) {
  if (spec < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = group * spec;
  const size_t bytes = static_cast<size_t>(float_words(rows)) * 4 + TILE * KROW + TILE * D;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<<<dim3(n_kv, batch), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(sk), static_cast<const int8_t*>(v),
      static_cast<const float*>(sv), static_cast<const int*>(length), static_cast<float*>(o),
      static_cast<float*>(lse), n_kv, rows, spec, max_len, qk_scale);
  return static_cast<int>(cudaGetLastError());
}
