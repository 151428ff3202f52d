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
// Two modes, a kernel each (B11 fast also a prep launch):
//   fast  - bf16 tensor cores (f32 accumulation; B9, B10, B12 on mma.sync,
//           the *_mma kernels, B11 on wgmma with a prep launch, jvp_dkv_wgmma
//           and jvp_bwd_prep_kernel): every product's operands are rounded to
//           bf16 where they enter it, as the TPU's DEFAULT-precision dots
//           round them: q, k, v, tq, tk, tv, dO and dtO, and p, h = p tS, dS,
//           tSb and tP.
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
// tiles up to the causal diagonal; B11 owns a key tile (its rows are keys:
// 32 exact, 128 fast) and loops over the 32-row q tiles that can see it,
// computing the transposed tile quantities. Each output tile has one owner
// and there are no atomics, so results repeat from run to run.
//
// Exact design (simple first): one block of 256 threads per (b*h, 32-row
// tile); thread (r, c) = (tid / 8, tid % 8) owns tile row r and output
// columns c + 8i. A row's eight owners sit in one warp: row max and sums
// reduce by shuffles, and the probability tiles pass to the second products
// through padded shared rows behind a __syncwarp. Operand tiles live in
// padded f32 rows (conflict-free column reads) in dynamic shared memory
// (57-82 KB). No register blocking and no pipelining yet.
// Fast design: below, beside its kernels.

#include <math.h>

#include "hopper.cuh"

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
// fast: bf16 tensor cores, f32 accumulation
// ===========================================================================
//
// The same tile math with every product on the tensor cores. Operands are
// rounded to bf16 where the TPU's DEFAULT-precision dots round them: q, k,
// v, tq, tk, tv, dO and dtO (round-to-nearest-even, as torch's
// .to(bfloat16)), and p, h, dS, tSb and tP where they become the A operand
// of the second products; tQ K^T and Q tK^T (B11/B12: dO V^T and dtO tV^T)
// sum in one f32 accumulator.
//
// B9, B10, B12 (mma.sync, the simple-first design): a block is 4 warps;
// each warp owns 16 q rows against 32-key tiles, rounded to bf16 on their
// way into shared memory; the mma.sync accumulator layout is, two n-tiles at
// a time, the A operand layout of the next product, so the probability
// tiles go from registers to the tensor cores; the B operand of the second
// products comes through ldmatrix.trans.
//
// B11 (jvp_dkv_wgmma, B2's design in csrc/flash_bwd.cu): one prep launch
// (jvp_bwd_prep_kernel) rounds the eight operands to bf16 once a call and
// copies the row terms lse, mu, c and dhat to rows ld floats apart (TMA wants
// 16-byte row starts). Then one block of two warpgroups per (b*h, 128-key
// tile), 64 keys each, K, tK, V and tV resident in shared memory (the A of
// the first products); the q-side tiles of 32 rows (Q, tQ, dO, dtO, their
// row terms) stream through a ring of TMA stages (128-byte swizzle, rows past
// t as zeros), refilled by the second warpgroup to release a stage. Per tile
// and warpgroup: S^T, tS^T (two products, one accumulator), tpb^T and the
// dO V^T + dtO tV^T part of pbar^T as wgmma m64n32k16 (B K-major); p^T,
// tP^T, dS^T and tSb^T as bf16 A fragments in registers; then dV, dtV, dK
// and dtK as wgmma m64n64k16 with the same q-side tiles as B, read
// MN-major. Four m64n64 accumulators (128 registers) stay live across the
// walk, hence 32-row tiles (the first products' four m64n32 accumulators
// take 64 more). A tile's stage is released while the next tile's first
// products run. Key tile 0 (causal: the most q tiles) starts first.

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

// ---------------------------------------------------------------------------
// B11 fast: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int JD_THREADS = 256;               // two warpgroups
constexpr int JD_KEYS = 128;                  // keys a block: 64 a warpgroup
constexpr int JD_ROWS = 32;                   // q rows a streamed tile
constexpr int JD_STAGES = 6;                  // q-side tiles in flight
constexpr int JD_TILE = JD_ROWS * D * 2;      // bytes of a bf16 q-side tile
constexpr int JD_HALF = 64 * D * 2;           // bytes of a warpgroup's 64 keys of K, tK, V or tV
constexpr int JD_ROW_BYTES = JD_ROWS * 4;     // a tile's lse, mu, c or dhat
// K, tK, V, tV at 2 JD_HALF each; stage st: Q, tQ, dO, dtO at JD_OFF_RING +
// 4 st JD_TILE and lse, mu, c, dhat at JD_OFF_ROWS + 4 st JD_ROW_BYTES; then
// the mbarriers (full[stage], then K/V's) and the release counters.
constexpr int JD_OFF_RING = 8 * JD_HALF;
constexpr int JD_OFF_ROWS = JD_OFF_RING + JD_STAGES * 4 * JD_TILE;
constexpr int JD_OFF_BAR = JD_OFF_ROWS + JD_STAGES * 4 * JD_ROW_BYTES;
constexpr int JD_COUNTERS = 64;
constexpr int JD_SMEM = JD_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
static_assert((JD_STAGES + 1) * 8 <= JD_COUNTERS && JD_COUNTERS + JD_STAGES * 4 <= 128,
              "the barriers and counters fit");
static_assert(JD_OFF_RING % 1024 == 0 && JD_OFF_ROWS % 1024 == 0,
              "swizzled tiles start on 1024 bytes");

// Four f32 values of two accumulator columns (rows r, r + 8) -> the bf16 A
// fragment words of k-step n / 2 (as flash_bwd.cu's pack_a).
template <int K>
__device__ __forceinline__ void pack_frag(uint32_t (&a)[K][4], int n, const float (&x)[4]) {
  a[n / 2][(n % 2) * 2 + 0] = pack_bf16(x[0], x[1]);
  a[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// One tile's p^T, tP^T, dS^T and tSb^T as the bf16 A fragments of the second
// products (tile_terms' arithmetic). x[4 n + e]: key key[e / 2], q row q0 +
// 8 n + cq + (e & 1), whose lse, mu, c and dhat are rw[col], rw[32 + col],
// rw[64 + col], rw[96 + col]. MASK: the tile reaches past t or s or the
// causal diagonal.
template <bool MASK>
__device__ __forceinline__ void dkv_terms(const float (&st)[16], const float (&tst)[16],
                                          const float (&tpbt)[16], const float (&pbt)[16],
                                          const float* rw, int q0, int cq, const int (&key)[2],
                                          int s, int t, int causal, float sm_scale,
                                          float qk_scale, uint32_t (&pa)[2][4],
                                          uint32_t (&tpa)[2][4], uint32_t (&dsa)[2][4],
                                          uint32_t (&tsba)[2][4]) {
#pragma unroll
  for (int n = 0; n < JD_ROWS / 8; ++n) {
    const float2 lse2 = *reinterpret_cast<const float2*>(rw + 8 * n + cq);
    const float2 mu2 = *reinterpret_cast<const float2*>(rw + JD_ROWS + 8 * n + cq);
    const float2 c2 = *reinterpret_cast<const float2*>(rw + 2 * JD_ROWS + 8 * n + cq);
    const float2 dh2 = *reinterpret_cast<const float2*>(rw + 3 * JD_ROWS + 8 * n + cq);
    float p[4], tp[4], ds[4], tsb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, odd = e & 1;
      float pe = exp2_ftz(st[i] * qk_scale - (odd ? lse2.y : lse2.x));
      if (MASK) {
        const int pos = q0 + 8 * n + cq + odd, k = key[e / 2];
        pe = k < s && pos < t && (!causal || k <= pos) ? pe : 0.f;
      }
      const float cr = odd ? c2.y : c2.x;
      const float ts = tst[i] * sm_scale;
      const float tsmu = ts - (odd ? mu2.y : mu2.x);
      const float pbar = pbt[i] + tpbt[i] * tsmu - cr * ts;
      p[e] = pe;
      ds[e] = pe * (pbar - (odd ? dh2.y : dh2.x));
      tsb[e] = pe * (tpbt[i] - cr);
      tp[e] = pe * tsmu;
    }
    pack_frag(pa, n, p);
    pack_frag(tpa, n, tp);
    pack_frag(dsa, n, ds);
    pack_frag(tsba, n, tsb);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

__global__ void __launch_bounds__(JD_THREADS, 1)
jvp_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,    // [bh, t, 64] bf16 q
              const __grid_constant__ CUtensorMap tq_map,   // the same for tq
              const __grid_constant__ CUtensorMap do_map,   // dO
              const __grid_constant__ CUtensorMap dto_map,  // dtO
              const __grid_constant__ CUtensorMap k_map,    // [bh, s, 64] bf16 k
              const __grid_constant__ CUtensorMap tk_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap tv_map,
              const __grid_constant__ CUtensorMap row_map,  // [4, bh, ld] f32 lse, mu, c, dhat
              float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dtk,
              float* __restrict__ dtv,  // [bh, s, D]
              int t, int s, int causal, float sm_scale, float qk_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + JD_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  const uint32_t kv_bar = full(JD_STAGES);
  int* released = reinterpret_cast<int*>(smem + JD_OFF_BAR + JD_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * JD_KEYS;  // key tile 0, which sees the most q tiles, first
  const int n_qt = (t + JD_ROWS - 1) / JD_ROWS;
  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? min(k0 / JD_ROWS, n_qt) : 0;
  const int n_tiles = n_qt - j0;

  init_ring(bars, released, JD_STAGES + 1);

  // Tile i of the walk (q rows (j0 + i) 32 ..) into stage i % JD_STAGES.
  auto load_tile = [&](int i) {
    const int st = i % JD_STAGES;
    const int q0 = (j0 + i) * JD_ROWS;
    const uint32_t tiles = base + JD_OFF_RING + st * 4 * JD_TILE;
    const uint32_t rows = base + JD_OFF_ROWS + st * 4 * JD_ROW_BYTES;
    mbar_expect_tx(full(st), 4 * JD_TILE + 4 * JD_ROW_BYTES);
    tma_load_3d(tiles, &q_map, full(st), 0, q0, bh);
    tma_load_3d(tiles + JD_TILE, &tq_map, full(st), 0, q0, bh);
    tma_load_3d(tiles + 2 * JD_TILE, &do_map, full(st), 0, q0, bh);
    tma_load_3d(tiles + 3 * JD_TILE, &dto_map, full(st), 0, q0, bh);
#pragma unroll
    for (int term = 0; term < 4; ++term)
      tma_load_4d(rows + term * JD_ROW_BYTES, &row_map, full(st), q0, 0, bh, term);
  };
  // The block's K, tK, V, tV (keys past s arrive as zeros; a half wholly
  // past s is not loaded: its keys' rows are never stored), then the first
  // stages. A block that no q tile sees loads nothing and stores zeros.
  if (tid == 0 && n_tiles > 0) {
    const int halves = k0 + 64 < s ? 2 : 1;
    mbar_expect_tx(kv_bar, halves * 4 * JD_HALF);
    for (int h = 0; h < halves; ++h) {
      tma_load_3d(base + h * JD_HALF, &k_map, kv_bar, 0, k0 + 64 * h, bh);
      tma_load_3d(base + (2 + h) * JD_HALF, &tk_map, kv_bar, 0, k0 + 64 * h, bh);
      tma_load_3d(base + (4 + h) * JD_HALF, &v_map, kv_bar, 0, k0 + 64 * h, bh);
      tma_load_3d(base + (6 + h) * JD_HALF, &tv_map, kv_bar, 0, k0 + 64 * h, bh);
    }
    for (int i = 0; i < min(JD_STAGES, n_tiles); ++i) load_tile(i);
  }

  // wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int kw0 = k0 + 64 * wg;
  const int key[2] = {kw0 + 16 * warp + lane / 4, kw0 + 16 * warp + lane / 4 + 8};
  const uint64_t desc_k = desc_kmajor_sw128(base + wg * JD_HALF);
  const uint64_t desc_tk = desc_kmajor_sw128(base + (2 + wg) * JD_HALF);
  const uint64_t desc_v = desc_kmajor_sw128(base + (4 + wg) * JD_HALF);
  const uint64_t desc_tv = desc_kmajor_sw128(base + (6 + wg) * JD_HALF);

  float dk_acc[32], dv_acc[32], dtk_acc[32], dtv_acc[32];
  float st_acc[16], ts_acc[16], tpb_acc[16], pb_acc[16];  // S^T, tS^T, tpb^T, pbar^T's products
  uint32_t pa[2][4] = {}, tpa[2][4] = {}, dsa[2][4] = {}, tsba[2][4] = {};
  zero(dk_acc);
  zero(dv_acc);
  zero(dtk_acc);
  zero(dtv_acc);
  zero(st_acc);
  zero(ts_acc);
  zero(tpb_acc);
  zero(pb_acc);
  if (n_tiles > 0) mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % JD_STAGES;
    const int q0 = (j0 + i) * JD_ROWS;
    const uint32_t tiles = base + JD_OFF_RING + st * 4 * JD_TILE;
    mbar_wait(full(st), (i / JD_STAGES) & 1);
    {  // the first products, A = the block's keys, B = the q-side tiles (K-major)
      const uint64_t dq = desc_kmajor_sw128(tiles), dtq = desc_kmajor_sw128(tiles + JD_TILE);
      const uint64_t ddo = desc_kmajor_sw128(tiles + 2 * JD_TILE);
      const uint64_t ddto = desc_kmajor_sw128(tiles + 3 * JD_TILE);
      reg_fence(st_acc);
      reg_fence(ts_acc);
      reg_fence(tpb_acc);
      reg_fence(pb_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
        wgmma_bf16_m64n32k16_ss(st_acc, desc_k + 2 * kk, dq + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // tS^T = K tQ^T + tK Q^T
        wgmma_bf16_m64n32k16_ss(ts_acc, desc_k + 2 * kk, dtq + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n32k16_ss(ts_acc, desc_tk + 2 * kk, dq + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // tpb^T = V dtO^T
        wgmma_bf16_m64n32k16_ss(tpb_acc, desc_v + 2 * kk, ddto + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // V dO^T + tV dtO^T
        wgmma_bf16_m64n32k16_ss(pb_acc, desc_v + 2 * kk, ddo + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n32k16_ss(pb_acc, desc_tv + 2 * kk, ddto + 2 * kk, 1);
      wgmma_commit();
    }
    // the last tile's second products are done (all but the newest group):
    // its stage is released while this tile's first products run
    wgmma_wait<1>();
    if (i > 0) release_stage(released, i - 1, JD_STAGES, n_tiles, load_tile);
    wgmma_wait<0>();
    reg_fence(st_acc);
    reg_fence(ts_acc);
    reg_fence(tpb_acc);
    reg_fence(pb_acc);
    reg_fence(pa);
    reg_fence(tpa);
    reg_fence(dsa);
    reg_fence(tsba);
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(dtk_acc);
    reg_fence(dtv_acc);
    const float* rw =
        reinterpret_cast<const float*>(smem + JD_OFF_ROWS + st * 4 * JD_ROW_BYTES);
    if (q0 + JD_ROWS > t || kw0 + 64 > s || (causal && q0 < kw0 + 63))
      dkv_terms<true>(st_acc, ts_acc, tpb_acc, pb_acc, rw, q0, cq, key, s, t, causal, sm_scale,
                      qk_scale, pa, tpa, dsa, tsba);
    else
      dkv_terms<false>(st_acc, ts_acc, tpb_acc, pb_acc, rw, q0, cq, key, s, t, causal, sm_scale,
                       qk_scale, pa, tpa, dsa, tsba);
    reg_fence(pa);
    reg_fence(tpa);
    reg_fence(dsa);
    reg_fence(tsba);
    {  // the second products, B = the same tiles read MN-major (16 q rows = 2048 bytes a k-step)
      const uint64_t dq = desc_mnmajor_sw128(tiles), dtq = desc_mnmajor_sw128(tiles + JD_TILE);
      const uint64_t ddo = desc_mnmajor_sw128(tiles + 2 * JD_TILE);
      const uint64_t ddto = desc_mnmajor_sw128(tiles + 3 * JD_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < JD_ROWS / 16; ++kk) {  // dV += p^T dO + tP^T dtO
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc, pa[kk], ddo + 128 * kk, 1);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc, tpa[kk], ddto + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < JD_ROWS / 16; ++kk)  // dtV += p^T dtO
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dtv_acc, pa[kk], ddto + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < JD_ROWS / 16; ++kk) {  // dK += dS^T Q + tSb^T tQ
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_acc, dsa[kk], dq + 128 * kk, 1);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_acc, tsba[kk], dtq + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < JD_ROWS / 16; ++kk)  // dtK += tSb^T Q
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dtk_acc, tsba[kk], dq + 128 * kk, 1);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  reg_fence(dk_acc);
  reg_fence(dv_acc);
  reg_fence(dtk_acc);
  reg_fence(dtv_acc);
  reg_fence(pa);
  reg_fence(tpa);
  reg_fence(dsa);
  reg_fence(tsba);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (static_cast<size_t>(bh) * s + key[h]) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * h;
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[i] * sm_scale, dk_acc[i + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) = make_float2(dv_acc[i], dv_acc[i + 1]);
      *reinterpret_cast<float2*>(dtk + off + 8 * n) =
          make_float2(dtk_acc[i] * sm_scale, dtk_acc[i + 1] * sm_scale);
      *reinterpret_cast<float2*>(dtv + off + 8 * n) = make_float2(dtv_acc[i], dtv_acc[i + 1]);
    }
  }
}

// B11's prep, one launch: the eight contiguous f32 operands (q, k, v, tq,
// tk, tv, dO, dtO: [bh, t, 64] or [bh, s, 64]) -> bf16 (round to nearest
// even), and the row terms lse, mu, c, dhat ([bh, t] each) -> [4, bh, ld]. Grid (rows /
// PREP_ROWS rounded up, bh, 9): z < 8 converts operand z, eight elements a
// thread in PREP_PASSES rows, every load issued before the first store; z ==
// 8 copies the row terms.
struct PrepArgs {
  const float* src[8];
  __nv_bfloat16* dst[8];
  const float* rows[4];
};
constexpr int PREP_PASSES = 4;
constexpr int PREP_ROWS = PREP_PASSES * 256 / 8;
constexpr int Q_SIDE = 0xC9;  // the operands of t rows: q, tq, dO, dtO (bits 0, 3, 6, 7)

__global__ void __launch_bounds__(256)
jvp_bwd_prep_kernel(PrepArgs args, float* __restrict__ rows_out, int bh_n, int t, int s, int ld) {
  const int z = blockIdx.z, bh = blockIdx.y, tid = threadIdx.x;
  const int tok0 = blockIdx.x * PREP_ROWS;
  if (z == 8) {
    for (int i = tid; i < 4 * PREP_ROWS; i += 256) {
      const int term = i / PREP_ROWS, tok = tok0 + i % PREP_ROWS;
      if (tok < t)
        rows_out[(static_cast<size_t>(term) * bh_n + bh) * ld + tok] =
            args.rows[term][static_cast<size_t>(bh) * t + tok];
    }
    return;
  }
  const int n = (Q_SIDE >> z) & 1 ? t : s, c8 = tid % 8;
  const float* src = args.src[z] + static_cast<size_t>(bh) * n * D;
  uint4* dst = reinterpret_cast<uint4*>(args.dst[z] + static_cast<size_t>(bh) * n * D);
  float4 x[PREP_PASSES][2] = {};
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + tid / 8 + 32 * i;
    if (tok < n) {
      const float4* row = reinterpret_cast<const float4*>(src + static_cast<size_t>(tok) * D);
      x[i][0] = row[2 * c8];
      x[i][1] = row[2 * c8 + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + tid / 8 + 32 * i;
    if (tok < n)
      dst[static_cast<size_t>(tok) * (D / 8) + c8] =
          make_uint4(pack_bf16(x[i][0].x, x[i][0].y), pack_bf16(x[i][0].z, x[i][0].w),
                     pack_bf16(x[i][1].x, x[i][1].y), pack_bf16(x[i][1].z, x[i][1].w));
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

// B11 exact: dK, dV, dtK, dtV [bh, s, D] (fast mode: qa_jvp_bwd_dkv_bf16).
extern "C" int qa_jvp_bwd_dkv(const void* q, const void* k, const void* v, const void* tq,
                              const void* tk, const void* tv, const void* dout, const void* dtout,
                              const void* lse, const void* mu, const void* crow,
                              const void* dhat, void* dk, void* dv, void* dtk, void* dtv, int bh,
                              int t, int s, int causal, int fast, float sm_scale, float qk_scale,
                              void* stream) {
  if (fast) return static_cast<int>(cudaErrorInvalidValue);
  return launch(jvp_dkv_kernel, dim3((s + T - 1) / T, bh), THREADS,
                (8 * TILE + 4 * PTILE + 4 * T) * sizeof(float), stream, cf(q), cf(k), cf(v),
                cf(tq), cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dtk),
                static_cast<float*>(dtv), t, s, causal, sm_scale, qk_scale);
}

// Shared bytes one B11 fast block asks for (ops/jvp_tiling.py mirrors it).
extern "C" int qa_jvp_bwd_dkv_smem_bytes() { return JD_SMEM; }

// B11 fast's prep: src = q, k, v, tq, tk, tv, dO, dtO (q-side [bh, t, 64],
// kv-side [bh, s, 64]) f32, rows = lse, mu, c, dhat [bh, t] f32, all contiguous and 16-byte
// aligned -> dst (the same eight in bf16) and rows_out [4, bh, ld] (ld >= t,
// a multiple of 4), in one launch.
extern "C" int qa_jvp_bwd_prep(const void* const* src, void* const* dst, const void* const* rows,
                               void* rows_out, int bh, int t, int s, int ld, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || ld < t || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  PrepArgs args;
  for (int i = 0; i < 8; ++i) {
    if (!aligned16(src[i]) || !aligned16(dst[i])) return static_cast<int>(cudaErrorInvalidValue);
    args.src[i] = static_cast<const float*>(src[i]);
    args.dst[i] = static_cast<__nv_bfloat16*>(dst[i]);
  }
  for (int i = 0; i < 4; ++i) args.rows[i] = static_cast<const float*>(rows[i]);
  const dim3 grid(((t > s ? t : s) + PREP_ROWS - 1) / PREP_ROWS, bh, 9);
  jvp_bwd_prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<float*>(rows_out), bh, t, s, ld);
  return static_cast<int>(cudaGetLastError());
}

// B11 fast: the prep's q, k, v, tq, tk, tv, dO, dtO (bf16, contiguous) and
// rows [4, bh, ld] -> dK, dV, dtK, dtV [bh, s, D] f32.
extern "C" int qa_jvp_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* tq,
                                   const void* tk, const void* tv, const void* dout,
                                   const void* dtout, const void* rows, void* dk, void* dv,
                                   void* dtk, void* dtv, int bh, int t, int s, int ld, int causal,
                                   float sm_scale, float qk_scale, void* stream) {
  const int n_kt = (s + JD_KEYS - 1) / JD_KEYS;
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || ld < t || ld % 4 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap q_map, tq_map, do_map, dto_map, k_map, tk_map, v_map, tv_map, row_map;
  const long long rb = 4LL * ld;
  const long long row_stride[3] = {rb, rb, rb * bh};
  if (!tensor_map_3d(&q_map, q, b16, 2, bh, t, D, JD_ROWS, D, sw) ||
      !tensor_map_3d(&tq_map, tq, b16, 2, bh, t, D, JD_ROWS, D, sw) ||
      !tensor_map_3d(&do_map, dout, b16, 2, bh, t, D, JD_ROWS, D, sw) ||
      !tensor_map_3d(&dto_map, dtout, b16, 2, bh, t, D, JD_ROWS, D, sw) ||
      !tensor_map_3d(&k_map, k, b16, 2, bh, s, D, 64, D, sw) ||
      !tensor_map_3d(&tk_map, tk, b16, 2, bh, s, D, 64, D, sw) ||
      !tensor_map_3d(&v_map, v, b16, 2, bh, s, D, 64, D, sw) ||
      !tensor_map_3d(&tv_map, tv, b16, 2, bh, s, D, 64, D, sw) ||
      !tensor_map_4d(&row_map, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh, 1, t, row_stride, 1,
                     JD_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(jvp_dkv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, JD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  jvp_dkv_wgmma<<<dim3(bh, n_kt), JD_THREADS, JD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, tq_map, do_map, dto_map, k_map, tk_map, v_map, tv_map, row_map,
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dtk),
      static_cast<float*>(dtv), t, s, causal, sm_scale, qk_scale);
  return static_cast<int>(cudaGetLastError());
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
