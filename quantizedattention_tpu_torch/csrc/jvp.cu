// Forward-mode (JVP) attention and its second-order backward for Hopper
// (sm_90a), plain C ABI.
//
// Replaces four TPU kernels:
//   B9  quantizedattention_tpu/ops/jvp_fwd.py:_jvp_kernel          (O, tO, lse, mu)
//   B10 quantizedattention_tpu/ops/jvp_tangent.py:_tangent_kernel  (tO given O, lse)
//   B11 quantizedattention_tpu/ops/jvp_bwd.py:_jvp_dkv_kernel      (dK, dV, dtK, dtV)
//   B12 quantizedattention_tpu/ops/jvp_bwd.py:_jvp_dq_kernel       (dQ, dtQ)
//
// Shared tile math (p: softmax probabilities in the exp2 domain; tS, mu and
// the gradients in the natural domain):
//   S  = (Q K^T) * qk_scale (masked: causal k <= q and k < s)
//   tS = (tQ K^T + Q tK^T) * sm_scale
// B9 runs the online softmax with six accumulators (m, l, O, r, A, B):
//   p = exp2(S - m), 0 where masked; h = p tS; l += rowsum(p), r += rowsum(h),
//   O += p V, A += p tV, B += h V, each rescaled by exp2(m_old - m_new);
//   O /= l, tO = (A + B - r O) / l, lse = m + log2 l, mu = r / l. No eps bias.
// B10 recomputes p = exp2(S - lse) and accumulates acc += h V + p tV,
//   r += rowsum(h); tO = acc - r O.
// B11/B12 recompute p and tS and take the row terms lse, mu, c = rowsum(dtO o O)
//   and dhat = rowsum(dO o O) + rowsum(dtO o tO) - c mu from the wrapper:
//   tpb = dtO V^T, pbar = dO V^T + dtO tV^T + tpb (tS - mu) - c tS,
//   dS = p (pbar - dhat), tSb = p (tpb - c), tP = p (tS - mu);
//   dV = p^T dO + tP^T dtO, dtV = p^T dtO, dK = (dS^T Q + tSb^T tQ) sm_scale,
//   dtK = tSb^T Q sm_scale, dQ = (dS K + tSb tK) sm_scale, dtQ = tSb K sm_scale.
// Every masked entry (causal, keys past s, rows past t) gets p = 0 explicitly:
// nothing past t or s is read as data.
//
// Two modes, two kernels each:
//   fast  - bf16 tensor cores (mma.sync, f32 accumulation; the *_mma kernels
//           below): every product's operands are rounded to bf16 where they
//           enter it, as the TPU's DEFAULT-precision dots round them: q, k,
//           v, tq, tk, tv, dO and dtO, and p, h = p tS, dS, tSb and tP.
//           Sums, row terms and the rescaling stay f32. The rCM step's mode.
//   exact - fp32 on the CUDA cores (FFMA), nothing rounded
//           (Precision.HIGHEST): attention_jvp, the default of
//           attention_value_and_jvp, and the JVP ring's mode.
//
// What bounds them on this card: operations. Per visible (q, k) pair and
// head_dim column, B9 runs 6 products, B10 5, B11 12 and B12 9 (2 flops
// each), against ~0.1-0.25 GB of operands at (4, 16, 4096, 64): at the bf16
// tensor-core peak B11 is bound at ~1.7 ms, at the fp32 CUDA-core peak (67
// TFLOP/s) at ~25 ms.
//
// Ownership, both modes: B9, B10 and B12 own a q tile and loop over 32-key
// tiles up to the causal diagonal; B11 owns a key tile (its rows are keys)
// and loops over the 32-row q tiles that can see it, computing the
// transposed tile quantities. Each output tile has one owner and there are
// no atomics, so results repeat from run to run.
//
// Exact design (simple first): one block of 256 threads per (b*h, 32-row
// tile); thread (r, c) = (tid / 8, tid % 8) owns tile row r and output
// columns c + 8i. A row's eight owners sit in one warp: row max and sums
// reduce by shuffles, and the probability tiles pass to the second products
// through padded shared rows behind a __syncwarp. Operand tiles live in
// padded f32 rows (conflict-free column reads) in dynamic shared memory
// (57-82 KB). No register blocking and no pipelining yet.
// Fast design: below, beside its kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int T = 32;          // rows and keys per tile
constexpr int FROW = D + 1;    // padded shared row of an operand tile
constexpr int PROW = T + 1;    // padded shared row of a probability tile
constexpr int THREADS = 256;   // thread = (row tid / 8, column lane tid % 8)
constexpr int TILE = T * FROW;
constexpr int PTILE = T * PROW;
constexpr float MASK_VALUE = -30000.0f;

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Rows row0 .. row0+T-1 of a row-major [n, D] f32 matrix into a padded
// shared tile; rows at or past n are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < T * (D / 4); c += THREADS) {
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

// S, tQ K^T and Q tK^T of one row (a_*: row `ra` of tiles a, ta) against
// eight columns c + 8i of tiles b, tb: s = a.b, x = ta.b, y = a.tb.
__device__ __forceinline__ void logits(float s[T / 8], float x[T / 8], float y[T / 8],
                                       const float* a, const float* ta, const float* b,
                                       const float* tb, int ra, int c) {
#pragma unroll
  for (int i = 0; i < T / 8; ++i) s[i] = x[i] = y[i] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float ad = a[ra * FROW + d];
    const float tad = ta[ra * FROW + d];
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const float bd = b[(c + 8 * i) * FROW + d];
      s[i] = fmaf(ad, bd, s[i]);
      x[i] = fmaf(tad, bd, x[i]);
      y[i] = fmaf(ad, tb[(c + 8 * i) * FROW + d], y[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// B9: (O, tO, lse, mu) in one online-softmax pass
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
jvp_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ tq,
               const float* __restrict__ tk, const float* __restrict__ tv,
               float* __restrict__ o, float* __restrict__ to, float* __restrict__ lse,
               float* __restrict__ mu, int t, int s, int causal, float sm_scale,
               float qk_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* tq_s = q_s + TILE;
  float* k_s = tq_s + TILE;
  float* tk_s = k_s + TILE;
  float* v_s = tk_s + TILE;
  float* tv_s = v_s + TILE;
  float* p_s = tv_s + TILE;
  float* h_s = p_s + PTILE;

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int pos = q0 + r;
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_tile(q_s, q + bh * t * D, q0, t);
  load_tile(tq_s, tq + bh * t * D, q0, t);

  float m = -INFINITY, l = 0.f, rs = 0.f;
  float oacc[D / 8], aacc[D / 8], bacc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) oacc[i] = aacc[i] = bacc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + T) : s;
  const int n_tiles = (kv_hi + T - 1) / T;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * T;
    __syncthreads();  // every thread is done with the previous tiles
    load_tile(k_s, kb, k0, s);
    load_tile(tk_s, tkb, k0, s);
    load_tile(v_s, vb, k0, s);
    load_tile(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[T / 8], ta[T / 8], tb[T / 8];
    logits(sc, ta, tb, q_s, tq_s, k_s, tk_s, r, c);
    bool valid[T / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const int col = k0 + c + 8 * i;
      valid[i] = col < s && (!causal || col <= pos);
      sc[i] = valid[i] ? sc[i] * qk_scale : MASK_VALUE;
      mx = fmaxf(mx, sc[i]);
    }
    const float next_m = fmaxf(m, row_max8(mx));
    const float alpha = exp2f(m - next_m);
    float psum = 0.f, hsum = 0.f;
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const float p = valid[i] ? exp2f(sc[i] - next_m) : 0.f;
      const float h = p * ((ta[i] + tb[i]) * sm_scale);
      psum += p;
      hsum += h;
      p_s[r * PROW + c + 8 * i] = p;
      h_s[r * PROW + c + 8 * i] = h;
    }
    l = l * alpha + row_sum8(psum);
    rs = rs * alpha + row_sum8(hsum);
    m = next_m;
    __syncwarp();  // row r's p and h are written by its eight owners, all in this warp

#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[i] *= alpha;
      aacc[i] *= alpha;
      bacc[i] *= alpha;
    }
    for (int kk = 0; kk < T; ++kk) {
      const float p = p_s[r * PROW + kk];
      const float h = h_s[r * PROW + kk];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float vv = v_s[kk * FROW + c + 8 * i];
        oacc[i] = fmaf(p, vv, oacc[i]);
        aacc[i] = fmaf(p, tv_s[kk * FROW + c + 8 * i], aacc[i]);
        bacc[i] = fmaf(h, vv, bacc[i]);
      }
    }
  }

  if (pos < t) {
    const float l_safe = l == 0.f ? 1.f : l;
    const size_t row = bh * t + pos;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float ov = oacc[i] / l_safe;
      o[row * D + c + 8 * i] = ov;
      to[row * D + c + 8 * i] = (aacc[i] + bacc[i] - rs * ov) / l_safe;
    }
    if (c == 0) {
      lse[row] = m + log2f(l_safe);
      mu[row] = rs / l_safe;
    }
  }
}

// ---------------------------------------------------------------------------
// B10: tO given (O, lse)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
jvp_tangent_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ tq,
                   const float* __restrict__ tk, const float* __restrict__ tv,
                   const float* __restrict__ o, const float* __restrict__ lse,
                   float* __restrict__ to, int t, int s, int causal, float sm_scale,
                   float qk_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* tq_s = q_s + TILE;
  float* k_s = tq_s + TILE;
  float* tk_s = k_s + TILE;
  float* v_s = tk_s + TILE;
  float* tv_s = v_s + TILE;
  float* p_s = tv_s + TILE;
  float* h_s = p_s + PTILE;

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int pos = q0 + r;
  const bool live = pos < t;
  const size_t row = bh * t + pos;
  const float lse_r = live ? lse[row] : 0.f;
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_tile(q_s, q + bh * t * D, q0, t);
  load_tile(tq_s, tq + bh * t * D, q0, t);

  float hsum = 0.f;
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + T) : s;
  const int n_tiles = (kv_hi + T - 1) / T;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * T;
    __syncthreads();
    load_tile(k_s, kb, k0, s);
    load_tile(tk_s, tkb, k0, s);
    load_tile(v_s, vb, k0, s);
    load_tile(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[T / 8], ta[T / 8], tb[T / 8];
    logits(sc, ta, tb, q_s, tq_s, k_s, tk_s, r, c);
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const int col = k0 + c + 8 * i;
      const bool valid = live && col < s && (!causal || col <= pos);
      const float p = valid ? exp2f(sc[i] * qk_scale - lse_r) : 0.f;
      const float h = p * ((ta[i] + tb[i]) * sm_scale);
      hsum += h;
      p_s[r * PROW + c + 8 * i] = p;
      h_s[r * PROW + c + 8 * i] = h;
    }
    __syncwarp();

    for (int kk = 0; kk < T; ++kk) {
      const float p = p_s[r * PROW + kk];
      const float h = h_s[r * PROW + kk];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        acc[i] = fmaf(h, v_s[kk * FROW + c + 8 * i], fmaf(p, tv_s[kk * FROW + c + 8 * i], acc[i]));
    }
  }

  const float rsum = row_sum8(hsum);
  if (live) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      to[row * D + c + 8 * i] = acc[i] - rsum * o[row * D + c + 8 * i];
  }
}

// ---------------------------------------------------------------------------
// B11 / B12 shared (both modes): the recomputed tile quantities of one
// (row, key) entry
// ---------------------------------------------------------------------------

struct Terms {
  float p, tp, ds, tsb;
};

__device__ __forceinline__ Terms tile_terms(bool valid, float s, float ta, float tb, float tpb,
                                            float dov, float dtotv, float lse, float mu,
                                            float cr, float dhat, float sm_scale,
                                            float qk_scale) {
  Terms x;
  x.p = valid ? exp2f(s * qk_scale - lse) : 0.f;
  const float ts = (ta + tb) * sm_scale;
  const float tsmu = ts - mu;
  const float pbar = dov + dtotv + tpb * tsmu - cr * ts;
  x.ds = x.p * (pbar - dhat);
  x.tsb = x.p * (tpb - cr);
  x.tp = x.p * tsmu;
  return x;
}

// ---------------------------------------------------------------------------
// B11: dK, dV, dtK, dtV per 32-key tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
jvp_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ tq,
               const float* __restrict__ tk, const float* __restrict__ tv,
               const float* __restrict__ dout, const float* __restrict__ dtout,
               const float* __restrict__ lse, const float* __restrict__ mu,
               const float* __restrict__ crow, const float* __restrict__ dhat,
               float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dtk,
               float* __restrict__ dtv, int t, int s, int causal, float sm_scale,
               float qk_scale) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* tk_s = k_s + TILE;
  float* v_s = tk_s + TILE;
  float* tv_s = v_s + TILE;
  float* q_s = tv_s + TILE;
  float* tq_s = q_s + TILE;
  float* do_s = tq_s + TILE;
  float* dto_s = do_s + TILE;
  float* p_s = dto_s + TILE;  // transposed tiles: [key][q row]
  float* tp_s = p_s + PTILE;
  float* ds_s = tp_s + PTILE;
  float* tsb_s = ds_s + PTILE;
  float* lse_s = tsb_s + PTILE;
  float* mu_s = lse_s + T;
  float* c_s = mu_s + T;
  float* dh_s = c_s + T;

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * T;
  const int key = k0 + r;

  load_tile(k_s, k + bh * s * D, k0, s);
  load_tile(tk_s, tk + bh * s * D, k0, s);
  load_tile(v_s, v + bh * s * D, k0, s);
  load_tile(tv_s, tv + bh * s * D, k0, s);

  float dk_acc[D / 8], dv_acc[D / 8], dtk_acc[D / 8], dtv_acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dk_acc[i] = dv_acc[i] = dtk_acc[i] = dtv_acc[i] = 0.f;

  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? k0 / T : 0;
  const int n_qt = (t + T - 1) / T;
  const size_t qrow0 = bh * t;
  for (int j = j0; j < n_qt; ++j) {
    const int q0 = j * T;
    __syncthreads();
    load_tile(q_s, q + qrow0 * D, q0, t);
    load_tile(tq_s, tq + qrow0 * D, q0, t);
    load_tile(do_s, dout + qrow0 * D, q0, t);
    load_tile(dto_s, dtout + qrow0 * D, q0, t);
    if (tid < T) {
      const bool live = q0 + tid < t;
      const size_t rw = qrow0 + q0 + tid;
      lse_s[tid] = live ? lse[rw] : 0.f;
      mu_s[tid] = live ? mu[rw] : 0.f;
      c_s[tid] = live ? crow[rw] : 0.f;
      dh_s[tid] = live ? dhat[rw] : 0.f;
    }
    __syncthreads();

    // this thread's key against q rows c + 8i: S^T, (tQ K^T)^T, (Q tK^T)^T
    // and (dtO V^T)^T, (dO V^T)^T, (dtO tV^T)^T
    float sc[T / 8], ta[T / 8], tb[T / 8], tpb[T / 8], dov[T / 8], dtotv[T / 8];
    logits(sc, tb, ta, k_s, tk_s, q_s, tq_s, r, c);
    logits(tpb, dtotv, dov, v_s, tv_s, dto_s, do_s, r, c);
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const int col = c + 8 * i;
      const int pos = q0 + col;
      const bool valid = key < s && pos < t && (!causal || key <= pos);
      const Terms x = tile_terms(valid, sc[i], ta[i], tb[i], tpb[i], dov[i], dtotv[i],
                                 lse_s[col], mu_s[col], c_s[col], dh_s[col], sm_scale, qk_scale);
      p_s[r * PROW + col] = x.p;
      tp_s[r * PROW + col] = x.tp;
      ds_s[r * PROW + col] = x.ds;
      tsb_s[r * PROW + col] = x.tsb;
    }
    __syncwarp();

    for (int col = 0; col < T; ++col) {
      const float p = p_s[r * PROW + col];
      const float tp = tp_s[r * PROW + col];
      const float ds = ds_s[r * PROW + col];
      const float tsb = tsb_s[r * PROW + col];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int cc = col * FROW + c + 8 * i;
        const float dov_ = do_s[cc], dtov = dto_s[cc], qv = q_s[cc], tqv = tq_s[cc];
        dv_acc[i] = fmaf(tp, dtov, fmaf(p, dov_, dv_acc[i]));
        dtv_acc[i] = fmaf(p, dtov, dtv_acc[i]);
        dk_acc[i] = fmaf(tsb, tqv, fmaf(ds, qv, dk_acc[i]));
        dtk_acc[i] = fmaf(tsb, qv, dtk_acc[i]);
      }
    }
  }

  if (key < s) {
    const size_t off = (bh * s + key) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dk[off + 8 * i] = dk_acc[i] * sm_scale;
      dv[off + 8 * i] = dv_acc[i];
      dtk[off + 8 * i] = dtk_acc[i] * sm_scale;
      dtv[off + 8 * i] = dtv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// B12: dQ, dtQ per 32-row q tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
jvp_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ tq,
              const float* __restrict__ tk, const float* __restrict__ tv,
              const float* __restrict__ dout, const float* __restrict__ dtout,
              const float* __restrict__ lse, const float* __restrict__ mu,
              const float* __restrict__ crow, const float* __restrict__ dhat,
              float* __restrict__ dq, float* __restrict__ dtq, int t, int s, int causal,
              float sm_scale, float qk_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* tq_s = q_s + TILE;
  float* do_s = tq_s + TILE;
  float* dto_s = do_s + TILE;
  float* k_s = dto_s + TILE;
  float* tk_s = k_s + TILE;
  float* v_s = tk_s + TILE;
  float* tv_s = v_s + TILE;
  float* ds_s = tv_s + TILE;
  float* tsb_s = ds_s + PTILE;

  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int pos = q0 + r;
  const bool live = pos < t;
  const size_t row = bh * t + pos;
  const float lse_r = live ? lse[row] : 0.f;
  const float mu_r = live ? mu[row] : 0.f;
  const float c_r = live ? crow[row] : 0.f;
  const float dh_r = live ? dhat[row] : 0.f;
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_tile(q_s, q + bh * t * D, q0, t);
  load_tile(tq_s, tq + bh * t * D, q0, t);
  load_tile(do_s, dout + bh * t * D, q0, t);
  load_tile(dto_s, dtout + bh * t * D, q0, t);

  float dq_acc[D / 8], dtq_acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i] = dtq_acc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + T) : s;
  const int n_tiles = (kv_hi + T - 1) / T;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * T;
    __syncthreads();
    load_tile(k_s, kb, k0, s);
    load_tile(tk_s, tkb, k0, s);
    load_tile(v_s, vb, k0, s);
    load_tile(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[T / 8], ta[T / 8], tb[T / 8], tpb[T / 8], dov[T / 8], dtotv[T / 8];
    logits(sc, ta, tb, q_s, tq_s, k_s, tk_s, r, c);
    logits(tpb, dov, dtotv, dto_s, do_s, v_s, tv_s, r, c);
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const int col = k0 + c + 8 * i;
      const bool valid = live && col < s && (!causal || col <= pos);
      const Terms x = tile_terms(valid, sc[i], ta[i], tb[i], tpb[i], dov[i], dtotv[i], lse_r,
                                 mu_r, c_r, dh_r, sm_scale, qk_scale);
      ds_s[r * PROW + c + 8 * i] = x.ds;
      tsb_s[r * PROW + c + 8 * i] = x.tsb;
    }
    __syncwarp();

    for (int kk = 0; kk < T; ++kk) {
      const float ds = ds_s[r * PROW + kk];
      const float tsb = tsb_s[r * PROW + kk];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float kv = k_s[kk * FROW + c + 8 * i];
        dq_acc[i] = fmaf(tsb, tk_s[kk * FROW + c + 8 * i], fmaf(ds, kv, dq_acc[i]));
        dtq_acc[i] = fmaf(tsb, kv, dtq_acc[i]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dq[row * D + c + 8 * i] = dq_acc[i] * sm_scale;
      dtq[row * D + c + 8 * i] = dtq_acc[i] * sm_scale;
    }
  }
}

// ===========================================================================
// fast: bf16 tensor cores (mma.sync.m16n8k16, f32 accumulation)
// ===========================================================================
//
// The same tile math with every product on the tensor cores. Operands are
// rounded to bf16 where the TPU's DEFAULT-precision dots round them: q, k,
// v, tq, tk, tv, dO and dtO on their way into shared memory (f32 in global
// memory, round-to-nearest-even, as torch's .to(bfloat16)), and p, h, dS,
// tSb and tP where they become the A operand of the second products; tQ K^T
// and Q tK^T (B11/B12: dO V^T and dtO tV^T) sum in one f32 accumulator. The
// accumulator layout of mma.sync is, two n-tiles at a time, the A operand
// layout of the next product, so the probability tiles go from registers
// to the tensor cores without touching shared memory. A block is 4 warps;
// each warp owns 16 rows (B9, B10, B12: q rows, against 32-key tiles; B11:
// keys, against 32-row q tiles); its A fragments come from shared memory
// per 16-column k-step, the B operand of the second products through
// ldmatrix.trans.

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int BM = 64;             // rows a block owns: 4 warps x 16
constexpr int BT = 32;             // rows of the streamed tile (keys, or q rows for B11)
constexpr int SROW = D + 8;        // padded bf16 row: conflict-free fragment loads
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
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
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows row0 .. row0+ROWS-1 of a row-major [n, D] f32 matrix into a padded
// bf16 shared tile (rounded to nearest even); rows at or past n are zero.
template <int ROWS>
__device__ __forceinline__ void load_bf16(bf16* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < ROWS * (D / 4); c += MMA_THREADS) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&dst[r * SROW + col]);
    o[0] = __floats2bfloat162_rn(val.x, val.y);
    o[1] = __floats2bfloat162_rn(val.z, val.w);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// acc[16 x 8NT] += A B^T: A = rows ra, ra + 8 of tile a, B = rows 0 .. 8NT-1
// of tile b (the n axis), both [*, D] padded bf16, contracted over D.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                        int ra, int lane) {
  const int cq = (lane % 4) * 2;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t af[4] = {ld_u32(&a[ra * SROW + ks * 16 + cq]),
                            ld_u32(&a[(ra + 8) * SROW + ks * 16 + cq]),
                            ld_u32(&a[ra * SROW + ks * 16 + cq + 8]),
                            ld_u32(&a[(ra + 8) * SROW + ks * 16 + cq + 8])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* row = &b[(nt * 8 + lane / 4) * SROW + ks * 16 + cq];
      mma16816(acc[nt], af, ld_u32(row), ld_u32(row + 8));
    }
  }
}

// Accumulators of a 16 x 8NT tile -> bf16 A fragments of its NT/2 k-steps.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NT / 2][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(x[nt][0], x[nt][1]);
    a[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// acc[16 x D] += A[16 x 16KS] * tile, tile = 16KS rows (the k axis) of D
// columns, read transposed through ldmatrix.
template <int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                       const bf16* tile, int lane) {
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      ldsm_x4_trans(b, &tile[(kk * 16 + lrow) * SROW + dt * 8 + lcol]);
      mma16816(acc[dt], a[kk], b[0], b[1]);
      mma16816(acc[dt + 1], a[kk], b[2], b[3]);
    }
  }
}

constexpr int NT = BT / 8;  // n-tiles of a streamed tile
constexpr int KS = BT / 16;  // its k-steps as the A operand of a second product

// B9, fast.
__global__ void __launch_bounds__(MMA_THREADS)
jvp_fwd_mma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ tq,
            const float* __restrict__ tk, const float* __restrict__ tv,
            float* __restrict__ o, float* __restrict__ to, float* __restrict__ lse,
            float* __restrict__ mu, int t, int s, int causal, float sm_scale, float qk_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* tq_s = q_s + BM * SROW;
  bf16* k_s = tq_s + BM * SROW;
  bf16* tk_s = k_s + BT * SROW;
  bf16* v_s = tk_s + BT * SROW;
  bf16* tv_s = v_s + BT * SROW;

  const int lane = threadIdx.x % 32;
  const int ra = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's rows ra, ra + 8
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int pos[2] = {q0 + ra, q0 + ra + 8};
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_bf16<BM>(q_s, q + bh * t * D, q0, t);
  load_bf16<BM>(tq_s, tq + bh * t * D, q0, t);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float oacc[D / 8][4], aacc[D / 8][4], bacc[D / 8][4];
  zero(oacc);
  zero(aacc);
  zero(bacc);

  const int kv_hi = causal ? min(s, q0 + BM) : s;
  const int n_tiles = (kv_hi + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // every warp is done with the previous tiles
    load_bf16<BT>(k_s, kb, k0, s);
    load_bf16<BT>(tk_s, tkb, k0, s);
    load_bf16<BT>(v_s, vb, k0, s);
    load_bf16<BT>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[NT][4], ts[NT][4];
    zero(sc);
    zero(ts);
    mma_abt(sc, q_s, k_s, ra, lane);
    mma_abt(ts, tq_s, k_s, ra, lane);
    mma_abt(ts, q_s, tk_s, ra, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = col < s && (!causal || col <= pos[e / 2]);
        sc[nt][e] = valid ? sc[nt][e] * qk_scale : MASK_VALUE;
        mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
      }
    }
    float next_m[2], alpha[2], psum[2] = {0.f, 0.f}, hsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      next_m[h] = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2f(m[h] - next_m[h]);
      m[h] = next_m[h];
    }
    // p (0 where masked) and h = p tS, in place of S and tS
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = col < s && (!causal || col <= pos[e / 2]);
        const float p = valid ? exp2f(sc[nt][e] - next_m[e / 2]) : 0.f;
        ts[nt][e] = p * (ts[nt][e] * sm_scale);
        sc[nt][e] = p;
        psum[e / 2] += p;
        hsum[e / 2] += ts[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
      rs[h] = rs[h] * alpha[h] + quad_sum(hsum[h]);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        oacc[dt][e] *= alpha[e / 2];
        aacc[dt][e] *= alpha[e / 2];
        bacc[dt][e] *= alpha[e / 2];
      }
    }
    uint32_t pa[KS][4], ha[KS][4];
    acc_to_a(pa, sc);
    acc_to_a(ha, ts);
    mma_ab(oacc, pa, v_s, lane);   // O += P V
    mma_ab(aacc, pa, tv_s, lane);  // A += P tV
    mma_ab(bacc, ha, v_s, lane);   // B += H V
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pos[h] >= t) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const size_t row = bh * t + pos[h];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float o0 = oacc[dt][2 * h] / l_safe, o1 = oacc[dt][2 * h + 1] / l_safe;
      *reinterpret_cast<float2*>(o + row * D + dt * 8 + cq) = make_float2(o0, o1);
      *reinterpret_cast<float2*>(to + row * D + dt * 8 + cq) =
          make_float2((aacc[dt][2 * h] + bacc[dt][2 * h] - rs[h] * o0) / l_safe,
                      (aacc[dt][2 * h + 1] + bacc[dt][2 * h + 1] - rs[h] * o1) / l_safe);
    }
    if (lane % 4 == 0) {
      lse[row] = m[h] + log2f(l_safe);
      mu[row] = rs[h] / l_safe;
    }
  }
}

// B10, fast.
__global__ void __launch_bounds__(MMA_THREADS)
jvp_tangent_mma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ tq,
                const float* __restrict__ tk, const float* __restrict__ tv,
                const float* __restrict__ o, const float* __restrict__ lse,
                float* __restrict__ to, int t, int s, int causal, float sm_scale,
                float qk_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* tq_s = q_s + BM * SROW;
  bf16* k_s = tq_s + BM * SROW;
  bf16* tk_s = k_s + BT * SROW;
  bf16* v_s = tk_s + BT * SROW;
  bf16* tv_s = v_s + BT * SROW;

  const int lane = threadIdx.x % 32;
  const int ra = (threadIdx.x / 32) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  int pos[2];
  bool live[2];
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = q0 + ra + 8 * h;
    live[h] = pos[h] < t;
    lse_r[h] = live[h] ? lse[bh * t + pos[h]] : 0.f;
  }
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_bf16<BM>(q_s, q + bh * t * D, q0, t);
  load_bf16<BM>(tq_s, tq + bh * t * D, q0, t);

  float hsum[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  const int kv_hi = causal ? min(s, q0 + BM) : s;
  const int n_tiles = (kv_hi + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();
    load_bf16<BT>(k_s, kb, k0, s);
    load_bf16<BT>(tk_s, tkb, k0, s);
    load_bf16<BT>(v_s, vb, k0, s);
    load_bf16<BT>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[NT][4], ts[NT][4];
    zero(sc);
    zero(ts);
    mma_abt(sc, q_s, k_s, ra, lane);
    mma_abt(ts, tq_s, k_s, ra, lane);
    mma_abt(ts, q_s, tk_s, ra, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = live[h] && col < s && (!causal || col <= pos[h]);
        const float p = valid ? exp2f(sc[nt][e] * qk_scale - lse_r[h]) : 0.f;
        ts[nt][e] = p * (ts[nt][e] * sm_scale);
        sc[nt][e] = p;
        hsum[h] += ts[nt][e];
      }
    }
    uint32_t pa[KS][4], ha[KS][4];
    acc_to_a(pa, sc);
    acc_to_a(ha, ts);
    mma_ab(acc, ha, v_s, lane);   // acc += H V
    mma_ab(acc, pa, tv_s, lane);  // acc += P tV
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float r = quad_sum(hsum[h]);
    if (!live[h]) continue;
    const size_t row = bh * t + pos[h];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 ov = *reinterpret_cast<const float2*>(o + row * D + dt * 8 + cq);
      *reinterpret_cast<float2*>(to + row * D + dt * 8 + cq) =
          make_float2(acc[dt][2 * h] - r * ov.x, acc[dt][2 * h + 1] - r * ov.y);
    }
  }
}

// B11, fast: a warp owns 16 keys; its tile quantities are transposed
// ([key, q row]), so p^T, tP^T, dS^T and tSb^T come out in the A layout of
// dV, dtV, dK and dtK.
__global__ void __launch_bounds__(MMA_THREADS)
jvp_dkv_mma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ tq,
            const float* __restrict__ tk, const float* __restrict__ tv,
            const float* __restrict__ dout, const float* __restrict__ dtout,
            const float* __restrict__ lse, const float* __restrict__ mu,
            const float* __restrict__ crow, const float* __restrict__ dhat,
            float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dtk,
            float* __restrict__ dtv, int t, int s, int causal, float sm_scale,
            float qk_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* tk_s = k_s + BM * SROW;
  bf16* v_s = tk_s + BM * SROW;
  bf16* tv_s = v_s + BM * SROW;
  bf16* q_s = tv_s + BM * SROW;
  bf16* tq_s = q_s + BT * SROW;
  bf16* do_s = tq_s + BT * SROW;
  bf16* dto_s = do_s + BT * SROW;
  float* lse_s = reinterpret_cast<float*>(dto_s + BT * SROW);
  float* mu_s = lse_s + BT;
  float* c_s = mu_s + BT;
  float* dh_s = c_s + BT;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ra = (tid / 32) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int key[2] = {k0 + ra, k0 + ra + 8};

  load_bf16<BM>(k_s, k + bh * s * D, k0, s);
  load_bf16<BM>(tk_s, tk + bh * s * D, k0, s);
  load_bf16<BM>(v_s, v + bh * s * D, k0, s);
  load_bf16<BM>(tv_s, tv + bh * s * D, k0, s);

  float dk_acc[D / 8][4], dv_acc[D / 8][4], dtk_acc[D / 8][4], dtv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(dtk_acc);
  zero(dtv_acc);

  // Causal: q tiles wholly before the key block see none of its keys.
  const int j0 = causal ? k0 / BT : 0;
  const int n_qt = (t + BT - 1) / BT;
  const size_t qrow0 = bh * t;
  for (int j = j0; j < n_qt; ++j) {
    const int q0 = j * BT;
    __syncthreads();
    load_bf16<BT>(q_s, q + qrow0 * D, q0, t);
    load_bf16<BT>(tq_s, tq + qrow0 * D, q0, t);
    load_bf16<BT>(do_s, dout + qrow0 * D, q0, t);
    load_bf16<BT>(dto_s, dtout + qrow0 * D, q0, t);
    if (tid < BT) {
      const bool live = q0 + tid < t;
      const size_t rw = qrow0 + q0 + tid;
      lse_s[tid] = live ? lse[rw] : 0.f;
      mu_s[tid] = live ? mu[rw] : 0.f;
      c_s[tid] = live ? crow[rw] : 0.f;
      dh_s[tid] = live ? dhat[rw] : 0.f;
    }
    __syncthreads();

    // [16 keys x 32 q rows]: S^T, tS^T (both terms), tpb^T, and dO V^T + dtO tV^T
    float st[NT][4], tst[NT][4], tpbt[NT][4], pbt[NT][4];
    zero(st);
    zero(tst);
    zero(tpbt);
    zero(pbt);
    mma_abt(st, k_s, q_s, ra, lane);
    mma_abt(tst, k_s, tq_s, ra, lane);
    mma_abt(tst, tk_s, q_s, ra, lane);
    mma_abt(tpbt, v_s, dto_s, ra, lane);
    mma_abt(pbt, v_s, do_s, ra, lane);
    mma_abt(pbt, tv_s, dto_s, ra, lane);
    // p, tP, dS, tSb in place of S, tS, tpb, pbar (tS and the first two
    // pbar terms arrive summed, hence the zeros)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + cq + (e & 1);
        const int kk = key[e / 2];
        const bool valid = kk < s && q0 + col < t && (!causal || kk <= q0 + col);
        const Terms x = tile_terms(valid, st[nt][e], tst[nt][e], 0.f, tpbt[nt][e], pbt[nt][e],
                                   0.f, lse_s[col], mu_s[col], c_s[col], dh_s[col], sm_scale,
                                   qk_scale);
        st[nt][e] = x.p;
        tst[nt][e] = x.tp;
        tpbt[nt][e] = x.ds;
        pbt[nt][e] = x.tsb;
      }
    }
    uint32_t pa[KS][4], tpa[KS][4], dsa[KS][4], tsba[KS][4];
    acc_to_a(pa, st);
    acc_to_a(tpa, tst);
    acc_to_a(dsa, tpbt);
    acc_to_a(tsba, pbt);
    mma_ab(dv_acc, pa, do_s, lane);     // dV += p^T dO
    mma_ab(dv_acc, tpa, dto_s, lane);   //    + tP^T dtO
    mma_ab(dtv_acc, pa, dto_s, lane);   // dtV += p^T dtO
    mma_ab(dk_acc, dsa, q_s, lane);     // dK += dS^T Q
    mma_ab(dk_acc, tsba, tq_s, lane);   //    + tSb^T tQ
    mma_ab(dtk_acc, tsba, q_s, lane);   // dtK += tSb^T Q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (bh * s + key[h]) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(dk + off + dt * 8) =
          make_float2(dk_acc[dt][2 * h] * sm_scale, dk_acc[dt][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + off + dt * 8) =
          make_float2(dv_acc[dt][2 * h], dv_acc[dt][2 * h + 1]);
      *reinterpret_cast<float2*>(dtk + off + dt * 8) =
          make_float2(dtk_acc[dt][2 * h] * sm_scale, dtk_acc[dt][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dtv + off + dt * 8) =
          make_float2(dtv_acc[dt][2 * h], dtv_acc[dt][2 * h + 1]);
    }
  }
}

// B12, fast.
__global__ void __launch_bounds__(MMA_THREADS)
jvp_dq_mma(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ tq,
           const float* __restrict__ tk, const float* __restrict__ tv,
           const float* __restrict__ dout, const float* __restrict__ dtout,
           const float* __restrict__ lse, const float* __restrict__ mu,
           const float* __restrict__ crow, const float* __restrict__ dhat,
           float* __restrict__ dq, float* __restrict__ dtq, int t, int s, int causal,
           float sm_scale, float qk_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* tq_s = q_s + BM * SROW;
  bf16* do_s = tq_s + BM * SROW;
  bf16* dto_s = do_s + BM * SROW;
  bf16* k_s = dto_s + BM * SROW;
  bf16* tk_s = k_s + BT * SROW;
  bf16* v_s = tk_s + BT * SROW;
  bf16* tv_s = v_s + BT * SROW;

  const int lane = threadIdx.x % 32;
  const int ra = (threadIdx.x / 32) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  int pos[2];
  bool live[2];
  float lse_r[2], mu_r[2], c_r[2], dh_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = q0 + ra + 8 * h;
    live[h] = pos[h] < t;
    const size_t row = bh * t + pos[h];
    lse_r[h] = live[h] ? lse[row] : 0.f;
    mu_r[h] = live[h] ? mu[row] : 0.f;
    c_r[h] = live[h] ? crow[row] : 0.f;
    dh_r[h] = live[h] ? dhat[row] : 0.f;
  }
  const float* kb = k + bh * s * D;
  const float* tkb = tk + bh * s * D;
  const float* vb = v + bh * s * D;
  const float* tvb = tv + bh * s * D;

  load_bf16<BM>(q_s, q + bh * t * D, q0, t);
  load_bf16<BM>(tq_s, tq + bh * t * D, q0, t);
  load_bf16<BM>(do_s, dout + bh * t * D, q0, t);
  load_bf16<BM>(dto_s, dtout + bh * t * D, q0, t);

  float dq_acc[D / 8][4], dtq_acc[D / 8][4];
  zero(dq_acc);
  zero(dtq_acc);

  const int kv_hi = causal ? min(s, q0 + BM) : s;
  const int n_tiles = (kv_hi + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();
    load_bf16<BT>(k_s, kb, k0, s);
    load_bf16<BT>(tk_s, tkb, k0, s);
    load_bf16<BT>(v_s, vb, k0, s);
    load_bf16<BT>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[NT][4], ts[NT][4], tpb[NT][4], pb[NT][4];
    zero(sc);
    zero(ts);
    zero(tpb);
    zero(pb);
    mma_abt(sc, q_s, k_s, ra, lane);
    mma_abt(ts, tq_s, k_s, ra, lane);
    mma_abt(ts, q_s, tk_s, ra, lane);
    mma_abt(tpb, dto_s, v_s, ra, lane);
    mma_abt(pb, do_s, v_s, ra, lane);
    mma_abt(pb, dto_s, tv_s, ra, lane);
    // dS and tSb in place of S and tS (tS and the first two pbar terms
    // arrive summed, hence the zeros)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + cq + (e & 1);
        const bool valid = live[h] && col < s && (!causal || col <= pos[h]);
        const Terms x = tile_terms(valid, sc[nt][e], ts[nt][e], 0.f, tpb[nt][e], pb[nt][e], 0.f,
                                   lse_r[h], mu_r[h], c_r[h], dh_r[h], sm_scale, qk_scale);
        sc[nt][e] = x.ds;
        ts[nt][e] = x.tsb;
      }
    }
    uint32_t dsa[KS][4], tsba[KS][4];
    acc_to_a(dsa, sc);
    acc_to_a(tsba, ts);
    mma_ab(dq_acc, dsa, k_s, lane);     // dQ += dS K
    mma_ab(dq_acc, tsba, tk_s, lane);   //    + tSb tK
    mma_ab(dtq_acc, tsba, k_s, lane);   // dtQ += tSb K
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const size_t off = (bh * t + pos[h]) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(dq + off + dt * 8) =
          make_float2(dq_acc[dt][2 * h] * sm_scale, dq_acc[dt][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dtq + off + dt * 8) =
          make_float2(dtq_acc[dt][2 * h] * sm_scale, dtq_acc[dt][2 * h + 1] * sm_scale);
    }
  }
}

constexpr size_t TILE16 = BT * SROW * sizeof(bf16);   // a streamed bf16 tile
constexpr size_t BLOCK16 = BM * SROW * sizeof(bf16);  // a block's own bf16 tile

// Launch `kernel` with `threads` threads and `smem` bytes of dynamic shared
// memory (the limit is raised first: some need more than the 48 KB
// default); returns the cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

using cf = const float*;

}  // namespace

// Every tensor is f32 and contiguous: q-side [bh, t, D], kv-side [bh, s, D],
// row terms [bh, t].

// B9: O, tO [bh, t, D]; lse, mu [bh, t].
extern "C" int qa_jvp_fwd(const void* q, const void* k, const void* v, const void* tq,
                          const void* tk, const void* tv, void* o, void* to, void* lse, void* mu,
                          int bh, int t, int s, int causal, int fast, float sm_scale,
                          float qk_scale, void* stream) {
  if (fast)
    return launch(jvp_fwd_mma, dim3((t + BM - 1) / BM, bh), MMA_THREADS,
                  2 * BLOCK16 + 4 * TILE16, stream, cf(q), cf(k), cf(v), cf(tq), cf(tk), cf(tv),
                  static_cast<float*>(o), static_cast<float*>(to), static_cast<float*>(lse),
                  static_cast<float*>(mu), t, s, causal, sm_scale, qk_scale);
  return launch(jvp_fwd_kernel, dim3((t + T - 1) / T, bh), THREADS,
                (6 * TILE + 2 * PTILE) * sizeof(float), stream, cf(q), cf(k), cf(v), cf(tq),
                cf(tk), cf(tv), static_cast<float*>(o), static_cast<float*>(to),
                static_cast<float*>(lse), static_cast<float*>(mu), t, s, causal, sm_scale,
                qk_scale);
}

// B10: tO [bh, t, D] from O [bh, t, D] and lse [bh, t].
extern "C" int qa_jvp_tangent(const void* q, const void* k, const void* v, const void* tq,
                              const void* tk, const void* tv, const void* o, const void* lse,
                              void* to, int bh, int t, int s, int causal, int fast,
                              float sm_scale, float qk_scale, void* stream) {
  if (fast)
    return launch(jvp_tangent_mma, dim3((t + BM - 1) / BM, bh), MMA_THREADS,
                  2 * BLOCK16 + 4 * TILE16, stream, cf(q), cf(k), cf(v), cf(tq), cf(tk), cf(tv),
                  cf(o), cf(lse), static_cast<float*>(to), t, s, causal, sm_scale, qk_scale);
  return launch(jvp_tangent_kernel, dim3((t + T - 1) / T, bh), THREADS,
                (6 * TILE + 2 * PTILE) * sizeof(float), stream, cf(q), cf(k), cf(v), cf(tq),
                cf(tk), cf(tv), cf(o), cf(lse), static_cast<float*>(to), t, s, causal, sm_scale,
                qk_scale);
}

// B11: dK, dV, dtK, dtV [bh, s, D].
extern "C" int qa_jvp_bwd_dkv(const void* q, const void* k, const void* v, const void* tq,
                              const void* tk, const void* tv, const void* dout, const void* dtout,
                              const void* lse, const void* mu, const void* crow,
                              const void* dhat, void* dk, void* dv, void* dtk, void* dtv, int bh,
                              int t, int s, int causal, int fast, float sm_scale, float qk_scale,
                              void* stream) {
  if (fast)
    return launch(jvp_dkv_mma, dim3((s + BM - 1) / BM, bh), MMA_THREADS,
                  4 * BLOCK16 + 4 * TILE16 + 4 * BT * sizeof(float), stream, cf(q), cf(k),
                  cf(v), cf(tq), cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow),
                  cf(dhat), static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float*>(dtk), static_cast<float*>(dtv), t, s, causal, sm_scale,
                  qk_scale);
  return launch(jvp_dkv_kernel, dim3((s + T - 1) / T, bh), THREADS,
                (8 * TILE + 4 * PTILE + 4 * T) * sizeof(float), stream, cf(q), cf(k), cf(v),
                cf(tq), cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dtk),
                static_cast<float*>(dtv), t, s, causal, sm_scale, qk_scale);
}

// B12: dQ, dtQ [bh, t, D].
extern "C" int qa_jvp_bwd_dq(const void* q, const void* k, const void* v, const void* tq,
                             const void* tk, const void* tv, const void* dout, const void* dtout,
                             const void* lse, const void* mu, const void* crow, const void* dhat,
                             void* dq, void* dtq, int bh, int t, int s, int causal, int fast,
                             float sm_scale, float qk_scale, void* stream) {
  if (fast)
    return launch(jvp_dq_mma, dim3((t + BM - 1) / BM, bh), MMA_THREADS,
                  4 * BLOCK16 + 4 * TILE16, stream, cf(q), cf(k), cf(v), cf(tq), cf(tk), cf(tv),
                  cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                  static_cast<float*>(dq), static_cast<float*>(dtq), t, s, causal, sm_scale,
                  qk_scale);
  return launch(jvp_dq_kernel, dim3((t + T - 1) / T, bh), THREADS,
                (8 * TILE + 2 * PTILE) * sizeof(float), stream, cf(q), cf(k), cf(v), cf(tq),
                cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                static_cast<float*>(dq), static_cast<float*>(dtq), t, s, causal, sm_scale,
                qk_scale);
}
