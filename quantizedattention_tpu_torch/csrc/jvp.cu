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
// Two modes, a kernel each (B9, B11 and B12 fast also a prep launch):
//   fast  - bf16 tensor cores (f32 accumulation; B10 on mma.sync,
//           jvp_tangent_mma; B9, B11 and B12 on wgmma: jvp_fwd_wgmma after
//           jvp_fwd_prep_kernel, jvp_dkv_wgmma and jvp_dq_wgmma after one
//           shared jvp_bwd_prep_kernel): every product's operands are rounded
//           to bf16 where they enter it, as the TPU's DEFAULT-precision dots
//           round them: q, k, v, tq, tk, tv, dO and dtO, and p, h = p tS, dS,
//           tSb and tP.
//           Sums, row terms and the rescaling stay f32. The rCM step's mode.
//   exact - nothing rounded (Precision.HIGHEST): attention_jvp, the default
//           of attention_value_and_jvp, and the JVP ring's mode. B9, B11 and
//           B12 in fp32 on the CUDA cores (FFMA); B10 (what
//           torch.func.jvp of attention_jvp runs) in 3xTF32 on wgmma,
//           jvp_tangent_tf32 (jvp_tangent_tf32_128 at head dim 128) after
//           tangent_prep_kernel.
//
// Head dims: every kernel takes 64 and 128, an instance each (a template on
// the head dim; B10 exact a kernel of its own at 128, below); the entries
// take d and dispatch.
//
// What bounds them on this card: operations. Per visible (q, k) pair and
// head_dim column, B9 runs 6 products, B10 5, B11 12 and B12 9 (2 flops
// each), against ~0.1-0.25 GB of operands at (4, 16, 4096, 64): at the bf16
// tensor-core peak B11 is bound at ~1.7 ms, at the fp32 CUDA-core peak (67
// TFLOP/s) at ~25 ms.
//
// Ownership, both modes: B9, B10 and B12 own a q tile (32 rows exact, 64
// for B10 fast and for B10 exact at 128, 128 for B9 and B12 fast and B10
// exact at 64) and loop over key tiles (32 keys; 64 for B9 fast at 64) up
// to the causal diagonal; B11 owns a key
// tile (its rows are keys: 32 exact, 128 fast) and loops over the 32-row q
// tiles that can see it, computing the transposed tile quantities. Each
// output tile has one owner (B10 exact may split a tile's keys into ranges,
// whose sums a second launch adds in a fixed order) and there are no
// atomics, so results repeat from run to run.
//
// Exact design of B9, B11 and B12 (simple first): one block of 256 threads
// per (b*h, 32-row tile); thread (r, c) = (tid / 8, tid % 8) owns tile row r and output
// columns c + 8i (8 of them at head dim 64, 16 at 128). A row's eight owners sit in one
// warp: row max and sums reduce by shuffles, and the probability tiles pass to the second
// products through padded shared rows behind a __syncwarp. Operand tiles live in padded
// f32 rows (d + 1 floats: conflict-free column reads) in dynamic shared memory (57-82 KB
// at 64, 105-146 KB at 128; qa_jvp_exact_smem_bytes). No register blocking and no
// pipelining yet.
// B10 exact's design and the fast designs: below, beside their kernels.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int T = 32;          // rows and keys per tile
constexpr int PROW = T + 1;    // padded shared row of a probability tile
constexpr int THREADS = 256;   // thread = (row tid / 8, column lane tid % 8)
constexpr int PTILE = T * PROW;
// An operand tile at head dim D: T padded f32 rows of D + 1 floats.
__host__ __device__ constexpr int ftile(int d) { return T * (d + 1); }
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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n) {
  constexpr int FROW = D + 1;
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
template <int D>
__device__ __forceinline__ void logits(float s[T / 8], float x[T / 8], float y[T / 8],
                                       const float* a, const float* ta, const float* b,
                                       const float* tb, int ra, int c) {
  constexpr int FROW = D + 1;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
jvp_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ tq,
               const float* __restrict__ tk, const float* __restrict__ tv,
               float* __restrict__ o, float* __restrict__ to, float* __restrict__ lse,
               float* __restrict__ mu, int t, int s, int causal, float sm_scale,
               float qk_scale) {
  constexpr int FROW = D + 1, TILE = ftile(D);
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

  load_tile<D>(q_s, q + bh * t * D, q0, t);
  load_tile<D>(tq_s, tq + bh * t * D, q0, t);

  float m = -INFINITY, l = 0.f, rs = 0.f;
  float oacc[D / 8], aacc[D / 8], bacc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) oacc[i] = aacc[i] = bacc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + T) : s;
  const int n_tiles = (kv_hi + T - 1) / T;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * T;
    __syncthreads();  // every thread is done with the previous tiles
    load_tile<D>(k_s, kb, k0, s);
    load_tile<D>(tk_s, tkb, k0, s);
    load_tile<D>(v_s, vb, k0, s);
    load_tile<D>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[T / 8], ta[T / 8], tb[T / 8];
    logits<D>(sc, ta, tb, q_s, tq_s, k_s, tk_s, r, c);
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

template <int D>
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
  constexpr int FROW = D + 1, TILE = ftile(D);
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

  load_tile<D>(k_s, k + bh * s * D, k0, s);
  load_tile<D>(tk_s, tk + bh * s * D, k0, s);
  load_tile<D>(v_s, v + bh * s * D, k0, s);
  load_tile<D>(tv_s, tv + bh * s * D, k0, s);

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
    load_tile<D>(q_s, q + qrow0 * D, q0, t);
    load_tile<D>(tq_s, tq + qrow0 * D, q0, t);
    load_tile<D>(do_s, dout + qrow0 * D, q0, t);
    load_tile<D>(dto_s, dtout + qrow0 * D, q0, t);
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
    logits<D>(sc, tb, ta, k_s, tk_s, q_s, tq_s, r, c);
    logits<D>(tpb, dtotv, dov, v_s, tv_s, dto_s, do_s, r, c);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
jvp_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ tq,
              const float* __restrict__ tk, const float* __restrict__ tv,
              const float* __restrict__ dout, const float* __restrict__ dtout,
              const float* __restrict__ lse, const float* __restrict__ mu,
              const float* __restrict__ crow, const float* __restrict__ dhat,
              float* __restrict__ dq, float* __restrict__ dtq, int t, int s, int causal,
              float sm_scale, float qk_scale) {
  constexpr int FROW = D + 1, TILE = ftile(D);
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

  load_tile<D>(q_s, q + bh * t * D, q0, t);
  load_tile<D>(tq_s, tq + bh * t * D, q0, t);
  load_tile<D>(do_s, dout + bh * t * D, q0, t);
  load_tile<D>(dto_s, dtout + bh * t * D, q0, t);

  float dq_acc[D / 8], dtq_acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i] = dtq_acc[i] = 0.f;

  const int kv_hi = causal ? min(s, q0 + T) : s;
  const int n_tiles = (kv_hi + T - 1) / T;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * T;
    __syncthreads();
    load_tile<D>(k_s, kb, k0, s);
    load_tile<D>(tk_s, tkb, k0, s);
    load_tile<D>(v_s, vb, k0, s);
    load_tile<D>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[T / 8], ta[T / 8], tb[T / 8], tpb[T / 8], dov[T / 8], dtotv[T / 8];
    logits<D>(sc, ta, tb, q_s, tq_s, k_s, tk_s, r, c);
    logits<D>(tpb, dov, dtotv, dto_s, do_s, v_s, tv_s, r, c);
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
// B10 (mma.sync, the simple-first design): a block is 4 warps; each warp
// owns 16 q rows against 32-key tiles, rounded to bf16 on their way into
// shared memory; the mma.sync accumulator layout is, two n-tiles at a time,
// the A operand layout of the next product, so the probability tiles go from
// registers to the tensor cores; the B operand of the second products comes
// through ldmatrix.trans.
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
//
// B12 (jvp_dq_wgmma, B3's design) reads the same prep: one block of two
// warpgroups per (b*h, 128 q rows), 64 rows each, its Q, tQ, dO and dtO
// resident in shared memory (loaded once by TMA; the A of the first
// products) and each row's lse, mu, c and dhat in registers; K, tK, V and tV
// tiles of 32 keys stream through a ring of 8 TMA stages (keys past s as
// zeros) with B11's release scheme. Per tile and warpgroup: S, tS (two
// products, one accumulator), tpb and dO V^T + dtO tV^T as wgmma m64n32k16
// (B K-major); dS and tSb as bf16 A fragments in registers; then dQ += dS K
// + tSb tK and dtQ += tSb K as wgmma m64n64k16 with the same K and tK tiles
// as B, read MN-major. Two m64n64 outputs (64 registers) and four m64n32
// first products (64) stay live, hence 32-key tiles. Causal blocks stop at
// their last visible key tile; the blocks with the most key tiles start
// first.
//
// B9 (jvp_fwd_wgmma, B1's designs in csrc/flash_fwd.cu): one prep launch
// (jvp_fwd_prep_kernel) reads K, V, tK and tV through their strides (the
// DiT's [b, s, h, d] views) and writes them as contiguous bf16; Q and tQ are
// read through their strides and rounded inside the kernel, as B1 bf16 does.
// One block of two warpgroups per (b*h, 128 q rows); K, tK, V, tV tiles of
// 64 keys through a ring of 4 TMA stages refilled by the second warpgroup to
// release a stage. Per tile and warpgroup: S and tS as wgmma m64n64k16 (A =
// Q, tQ from shared memory); the online softmax in registers (l and r sum
// the unrounded p and h); then O += P V, A += P tV, B += H V as wgmma
// m64n64k16 with the rounded P and H as register A fragments and V, tV read
// MN-major, issued with the next tile's S and tS and waited for together (B1
// fp32's pipeline: one set of fragments, the two warpgroups' softmaxes under
// each other's products). Three m64n64 outputs (96 registers), S and tS (64)
// and P and H (32) stay live: 232 registers. B1 bf16's pipeline (tile j's
// softmax under tile j - 1's products) needs two sets of fragments: at
// 64-key tiles it spilled, and at 32 keys it ran slower than this design.
//
// Head dim 128 (the HD = 128 instances of B9, B11, B12 fast and their
// preps). Every bf16 tile is two 64-dim panels,
// each its own TMA box (below), and a product whose N is the head dim is two
// m64n64 products into two accumulators; an m64 x 128 f32 accumulator takes
// 64 registers a thread and every tile twice the shared bytes, so:
//   B11 would hold dK, dtK, dV and dtV (256 registers): its outputs split
//     over two launches of the same body, one of dV and dtV (the first
//     products S^T and tS^T only; K and tK resident), one of dK and dtK (all
//     four first products); each holds two m64 x 128 sums (128 registers),
//     K, tK, V, tV resident (128 KB) and a ring of 3 q-side stages. The
//     first products run twice (6 + 3 of the 12 products of a tile pair,
//     against 6): 15 / 12 of B11's work at 64.
//   B12 keeps its design: dQ and dtQ (128 registers), 32-key tiles, Q, tQ,
//     dO, dtO resident (128 KB) and a ring of 3 K-side stages.
//   B9 walks 32-key tiles (S and tS: 32 registers) and sums tO's two parts
//     (P tV and H V) in one accumulator, so O and that sum take 128
//     registers; a ring of 4 stages (32 KB each).

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int BM = 64;             // rows a block owns: 4 warps x 16
constexpr int BT = 32;             // rows of the streamed tile (keys, or q rows for B11)
// A padded bf16 row at head dim d: conflict-free fragment loads.
__host__ __device__ constexpr int srow(int d) { return d + 8; }
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
template <int D, int ROWS>
__device__ __forceinline__ void load_bf16(bf16* dst, const float* src, int row0, int n) {
  constexpr int SROW = srow(D);
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
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                        int ra, int lane) {
  constexpr int SROW = srow(D);
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
template <int D, int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                       const bf16* tile, int lane) {
  constexpr int SROW = srow(D);
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

// B10, fast, at head dim D (64 or 128: a warp's tO takes D / 2 registers).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
jvp_tangent_mma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ tq,
                const float* __restrict__ tk, const float* __restrict__ tv,
                const float* __restrict__ o, const float* __restrict__ lse,
                float* __restrict__ to, int t, int s, int causal, float sm_scale,
                float qk_scale) {
  constexpr int SROW = srow(D);
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

  load_bf16<D, BM>(q_s, q + bh * t * D, q0, t);
  load_bf16<D, BM>(tq_s, tq + bh * t * D, q0, t);

  float hsum[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  const int kv_hi = causal ? min(s, q0 + BM) : s;
  const int n_tiles = (kv_hi + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();
    load_bf16<D, BT>(k_s, kb, k0, s);
    load_bf16<D, BT>(tk_s, tkb, k0, s);
    load_bf16<D, BT>(v_s, vb, k0, s);
    load_bf16<D, BT>(tv_s, tvb, k0, s);
    __syncthreads();

    float sc[NT][4], ts[NT][4];
    zero(sc);
    zero(ts);
    mma_abt<D>(sc, q_s, k_s, ra, lane);
    mma_abt<D>(ts, tq_s, k_s, ra, lane);
    mma_abt<D>(ts, q_s, tk_s, ra, lane);
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
    mma_ab<D>(acc, ha, v_s, lane);   // acc += H V
    mma_ab<D>(acc, pa, tv_s, lane);  // acc += P tV
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

// ---------------------------------------------------------------------------
// The fast kernels at head dim HD (64 or 128): bf16 panels
// ---------------------------------------------------------------------------
//
// A bf16 tile of HD head dims is HD / 64 panels of [rows, 64] in the 128-byte
// swizzle (a row of 128 dims is twice its span), each its own TMA box, as
// flash_bwd.cu's at 128: a product contracted over the head dim takes HD / 16
// k-steps, those from 4 on in the next panel, and a product whose N is the
// head dim is one m64n64 product a panel, into an accumulator a panel. At 64
// every layout, product and sum is the 64-only kernels'.

// The descriptor of k-step kk (16 head dims) of a K-major bf16 tile whose
// panels lie `panel` bytes apart.
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk, int panel) {
  return desc + (kk / 4) * static_cast<uint64_t>(panel >> 4) + 2 * (kk % 4);
}

template <int P>
__device__ __forceinline__ void zero_all(float (&x)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[p][i] = 0.f;
}

template <int P>
__device__ __forceinline__ void fence_all(float (&x)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p) reg_fence(x[p]);
}

// A [n, rows, HD] bf16 map (contiguous), boxes of box_rows rows x 64 head
// dims (a panel) with the 128-byte swizzle; rows past `rows` arrive as zeros.
bool panel_map(CUtensorMap* map, const void* ptr, int n, int rows, int hd, int box_rows) {
  return tensor_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, rows, hd, box_rows, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// B11 fast: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int JD_THREADS = 256;               // two warpgroups
constexpr int JD_KEYS = 128;                  // keys a block: 64 a warpgroup
constexpr int JD_ROWS = 32;                   // q rows a streamed tile
constexpr int JD_ROW_BYTES = JD_ROWS * 4;     // a tile's lse, mu, c or dhat
constexpr int JD_COUNTERS = 64;
// The outputs a block computes: all four at head dim 64; at 128, where four
// m64 x 128 accumulators would take 256 registers a thread, dV and dtV
// (DKV_V: the first products S^T and tS^T only, K and tK resident) or dK and
// dtK (DKV_K), a launch each.
enum DkvPart { DKV_ALL = 0, DKV_V = 1, DKV_K = 2 };

// B11's geometry at head dim HD (ops/jvp_tiling.py mirrors it). Shared
// layout from a 1024-byte aligned base: K, tK, V, tV at 2 HALF each
// (warpgroup w's 64 keys at w HALF, panels HALF_PANEL apart); stage st: Q,
// tQ, dO, dtO at OFF_RING + 4 st TILE (panels TILE_PANEL apart) and lse, mu,
// c, dhat at OFF_ROWS + 4 st JD_ROW_BYTES; then the mbarriers (full[stage],
// then K/V's) and the release counters.
template <int HD>
struct JdGeom {
  static constexpr int PANELS = HD / 64;
  static constexpr int STAGES = HD == 64 ? 6 : 3;   // q-side tiles in flight
  static constexpr int TILE = JD_ROWS * HD * 2;     // bytes of a bf16 q-side tile
  static constexpr int TILE_PANEL = JD_ROWS * 128;  // bytes of one of its panels
  static constexpr int HALF = 64 * HD * 2;          // a warpgroup's 64 keys of K, tK, V or tV
  static constexpr int HALF_PANEL = 64 * 128;
  static constexpr int OFF_RING = 8 * HALF;
  static constexpr int OFF_ROWS = OFF_RING + STAGES * 4 * TILE;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 4 * JD_ROW_BYTES;
  static constexpr int SMEM = OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
  static_assert((STAGES + 1) * 8 <= JD_COUNTERS && JD_COUNTERS + STAGES * 4 <= 128,
                "the barriers and counters fit");
  static_assert(OFF_RING % 1024 == 0 && OFF_ROWS % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
  static_assert(SMEM <= 232448, "a block's shared memory fits an H100 SM");
};

// Four f32 values of two accumulator columns (rows r, r + 8) -> the bf16 A
// fragment words of k-step n / 2 (as flash_bwd.cu's pack_a).
template <int K>
__device__ __forceinline__ void pack_frag(uint32_t (&a)[K][4], int n, const float (&x)[4]) {
  a[n / 2][(n % 2) * 2 + 0] = pack_bf16(x[0], x[1]);
  a[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// One tile's p^T, tP^T, dS^T and tSb^T as the bf16 A fragments of the second
// products (tile_terms' arithmetic): all four for DKV_ALL, p^T and tP^T for
// DKV_V (tpbt and pbt unread), dS^T and tSb^T for DKV_K. x[4 n + e]: key
// key[e / 2], q row q0 + 8 n + cq + (e & 1), whose lse, mu, c and dhat are
// rw[col], rw[32 + col], rw[64 + col], rw[96 + col]. MASK: the tile reaches
// past t or s or the causal diagonal.
template <bool MASK, int PART>
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
    float2 c2 = make_float2(0.f, 0.f), dh2 = c2;
    if constexpr (PART != DKV_V) {
      c2 = *reinterpret_cast<const float2*>(rw + 2 * JD_ROWS + 8 * n + cq);
      dh2 = *reinterpret_cast<const float2*>(rw + 3 * JD_ROWS + 8 * n + cq);
    }
    float p[4], tp[4], ds[4], tsb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, odd = e & 1;
      float pe = exp2_ftz(st[i] * qk_scale - (odd ? lse2.y : lse2.x));
      if (MASK) {
        const int pos = q0 + 8 * n + cq + odd, k = key[e / 2];
        pe = k < s && pos < t && (!causal || k <= pos) ? pe : 0.f;
      }
      const float ts = tst[i] * sm_scale;
      const float tsmu = ts - (odd ? mu2.y : mu2.x);
      p[e] = pe;
      tp[e] = pe * tsmu;
      if constexpr (PART != DKV_V) {
        const float cr = odd ? c2.y : c2.x;
        const float pbar = pbt[i] + tpbt[i] * tsmu - cr * ts;
        ds[e] = pe * (pbar - (odd ? dh2.y : dh2.x));
        tsb[e] = pe * (tpbt[i] - cr);
      }
    }
    if constexpr (PART != DKV_K) {
      pack_frag(pa, n, p);
      pack_frag(tpa, n, tp);
    }
    if constexpr (PART != DKV_V) {
      pack_frag(dsa, n, ds);
      pack_frag(tsba, n, tsb);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

template <int HD, int PART>
__global__ void __launch_bounds__(JD_THREADS, 1)
jvp_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,    // [bh, t, HD] bf16 q
              const __grid_constant__ CUtensorMap tq_map,   // the same for tq
              const __grid_constant__ CUtensorMap do_map,   // dO
              const __grid_constant__ CUtensorMap dto_map,  // dtO
              const __grid_constant__ CUtensorMap k_map,    // [bh, s, HD] bf16 k
              const __grid_constant__ CUtensorMap tk_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap tv_map,
              const __grid_constant__ CUtensorMap row_map,  // [4, bh, ld] f32 lse, mu, c, dhat
              float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dtk,
              float* __restrict__ dtv,  // [bh, s, HD]
              int t, int s, int causal, float sm_scale, float qk_scale) {
  using G = JdGeom<HD>;
  constexpr int P = G::PANELS, STAGES = G::STAGES, TILE = G::TILE;
  constexpr int TP = G::TILE_PANEL, HALF = G::HALF, HP = G::HALF_PANEL;
  constexpr bool V_OUT = PART != DKV_K, K_OUT = PART != DKV_V;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  const uint32_t kv_bar = full(STAGES);
  int* released = reinterpret_cast<int*>(smem + G::OFF_BAR + JD_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * JD_KEYS;  // key tile 0, which sees the most q tiles, first
  const int n_qt = (t + JD_ROWS - 1) / JD_ROWS;
  // Causal: q tiles wholly before the key tile see none of its keys.
  const int j0 = causal ? min(k0 / JD_ROWS, n_qt) : 0;
  const int n_tiles = n_qt - j0;

  init_ring(bars, released, STAGES + 1);

  // Tile i of the walk (q rows (j0 + i) 32 ..) into stage i % STAGES.
  auto load_tile = [&](int i) {
    const int st = i % STAGES;
    const int q0 = (j0 + i) * JD_ROWS;
    const uint32_t tiles = base + G::OFF_RING + st * 4 * TILE;
    const uint32_t rows = base + G::OFF_ROWS + st * 4 * JD_ROW_BYTES;
    mbar_expect_tx(full(st), 4 * TILE + 4 * JD_ROW_BYTES);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tma_load_3d(tiles + p * TP, &q_map, full(st), 64 * p, q0, bh);
      tma_load_3d(tiles + TILE + p * TP, &tq_map, full(st), 64 * p, q0, bh);
      tma_load_3d(tiles + 2 * TILE + p * TP, &do_map, full(st), 64 * p, q0, bh);
      tma_load_3d(tiles + 3 * TILE + p * TP, &dto_map, full(st), 64 * p, q0, bh);
    }
#pragma unroll
    for (int term = 0; term < 4; ++term)
      tma_load_4d(rows + term * JD_ROW_BYTES, &row_map, full(st), q0, 0, bh, term);
  };
  // The block's K, tK, V, tV (keys past s arrive as zeros; a half wholly
  // past s is not loaded: its keys' rows are never stored; DKV_V reads no V
  // or tV), then the first stages. A block that no q tile sees loads
  // nothing and stores zeros.
  if (tid == 0 && n_tiles > 0) {
    const int halves = k0 + 64 < s ? 2 : 1;
    mbar_expect_tx(kv_bar, halves * (K_OUT ? 4 : 2) * HALF);
    for (int h = 0; h < halves; ++h) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tma_load_3d(base + h * HALF + p * HP, &k_map, kv_bar, 64 * p, k0 + 64 * h, bh);
        tma_load_3d(base + (2 + h) * HALF + p * HP, &tk_map, kv_bar, 64 * p, k0 + 64 * h, bh);
        if constexpr (K_OUT) {
          tma_load_3d(base + (4 + h) * HALF + p * HP, &v_map, kv_bar, 64 * p, k0 + 64 * h, bh);
          tma_load_3d(base + (6 + h) * HALF + p * HP, &tv_map, kv_bar, 64 * p, k0 + 64 * h, bh);
        }
      }
    }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_tile(i);
  }

  // wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int kw0 = k0 + 64 * wg;
  const int key[2] = {kw0 + 16 * warp + lane / 4, kw0 + 16 * warp + lane / 4 + 8};
  const uint64_t desc_k = desc_kmajor_sw128(base + wg * HALF);
  const uint64_t desc_tk = desc_kmajor_sw128(base + (2 + wg) * HALF);
  const uint64_t desc_v = desc_kmajor_sw128(base + (4 + wg) * HALF);
  const uint64_t desc_tv = desc_kmajor_sw128(base + (6 + wg) * HALF);

  float dk_acc[P][32], dv_acc[P][32], dtk_acc[P][32], dtv_acc[P][32];  // panel p: dims 64 p ..
  float st_acc[16], ts_acc[16], tpb_acc[16], pb_acc[16];  // S^T, tS^T, tpb^T, pbar^T's products
  uint32_t pa[2][4] = {}, tpa[2][4] = {}, dsa[2][4] = {}, tsba[2][4] = {};
  // The registers the products read or write: their last writes stay before
  // wgmma.fence (C7513), and their reads after the wait.
  auto fence_firsts = [&]() {
    reg_fence(st_acc);
    reg_fence(ts_acc);
    if constexpr (K_OUT) {
      reg_fence(tpb_acc);
      reg_fence(pb_acc);
    }
  };
  auto fence_frags = [&]() {
    if constexpr (V_OUT) {
      reg_fence(pa);
      reg_fence(tpa);
    }
    if constexpr (K_OUT) {
      reg_fence(dsa);
      reg_fence(tsba);
    }
  };
  auto fence_outs = [&]() {
    if constexpr (K_OUT) {
      fence_all(dk_acc);
      fence_all(dtk_acc);
    }
    if constexpr (V_OUT) {
      fence_all(dv_acc);
      fence_all(dtv_acc);
    }
  };
  if constexpr (K_OUT) {
    zero_all(dk_acc);
    zero_all(dtk_acc);
    zero(tpb_acc);
    zero(pb_acc);
  }
  if constexpr (V_OUT) {
    zero_all(dv_acc);
    zero_all(dtv_acc);
  }
  zero(st_acc);
  zero(ts_acc);
  if (n_tiles > 0) mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int q0 = (j0 + i) * JD_ROWS;
    const uint32_t tiles = base + G::OFF_RING + st * 4 * TILE;
    mbar_wait(full(st), (i / STAGES) & 1);
    {  // the first products, A = the block's keys, B = the q-side tiles (K-major)
      const uint64_t dq = desc_kmajor_sw128(tiles), dtq = desc_kmajor_sw128(tiles + TILE);
      const uint64_t ddo = desc_kmajor_sw128(tiles + 2 * TILE);
      const uint64_t ddto = desc_kmajor_sw128(tiles + 3 * TILE);
      fence_firsts();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // S^T = K Q^T
        wgmma_bf16_m64n32k16_ss(st_acc, kstep(desc_k, kk, HP), kstep(dq, kk, TP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // tS^T = K tQ^T + tK Q^T
        wgmma_bf16_m64n32k16_ss(ts_acc, kstep(desc_k, kk, HP), kstep(dtq, kk, TP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_bf16_m64n32k16_ss(ts_acc, kstep(desc_tk, kk, HP), kstep(dq, kk, TP), 1);
      if constexpr (K_OUT) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)  // tpb^T = V dtO^T
          wgmma_bf16_m64n32k16_ss(tpb_acc, kstep(desc_v, kk, HP), kstep(ddto, kk, TP), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)  // V dO^T + tV dtO^T
          wgmma_bf16_m64n32k16_ss(pb_acc, kstep(desc_v, kk, HP), kstep(ddo, kk, TP), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_bf16_m64n32k16_ss(pb_acc, kstep(desc_tv, kk, HP), kstep(ddto, kk, TP), 1);
      }
      wgmma_commit();
    }
    // the last tile's second products are done (all but the newest group):
    // its stage is released while this tile's first products run
    wgmma_wait<1>();
    if (i > 0) release_stage(released, i - 1, STAGES, n_tiles, load_tile);
    wgmma_wait<0>();
    fence_firsts();
    fence_frags();
    fence_outs();
    const float* rw =
        reinterpret_cast<const float*>(smem + G::OFF_ROWS + st * 4 * JD_ROW_BYTES);
    if (q0 + JD_ROWS > t || kw0 + 64 > s || (causal && q0 < kw0 + 63))
      dkv_terms<true, PART>(st_acc, ts_acc, tpb_acc, pb_acc, rw, q0, cq, key, s, t, causal,
                            sm_scale, qk_scale, pa, tpa, dsa, tsba);
    else
      dkv_terms<false, PART>(st_acc, ts_acc, tpb_acc, pb_acc, rw, q0, cq, key, s, t, causal,
                             sm_scale, qk_scale, pa, tpa, dsa, tsba);
    fence_frags();
    // the second products, B = the same tiles read MN-major (16 q rows =
    // 2048 bytes a k-step), panel p into the outputs' panel p
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint64_t dq = desc_mnmajor_sw128(tiles + p * TP);
      const uint64_t dtq = desc_mnmajor_sw128(tiles + TILE + p * TP);
      const uint64_t ddo = desc_mnmajor_sw128(tiles + 2 * TILE + p * TP);
      const uint64_t ddto = desc_mnmajor_sw128(tiles + 3 * TILE + p * TP);
      if constexpr (V_OUT) {
#pragma unroll
        for (int kk = 0; kk < JD_ROWS / 16; ++kk) {  // dV += p^T dO + tP^T dtO
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc[p], pa[kk], ddo + 128 * kk, 1);
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc[p], tpa[kk], ddto + 128 * kk, 1);
        }
#pragma unroll
        for (int kk = 0; kk < JD_ROWS / 16; ++kk)  // dtV += p^T dtO
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dtv_acc[p], pa[kk], ddto + 128 * kk, 1);
      }
      if constexpr (K_OUT) {
#pragma unroll
        for (int kk = 0; kk < JD_ROWS / 16; ++kk) {  // dK += dS^T Q + tSb^T tQ
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_acc[p], dsa[kk], dq + 128 * kk, 1);
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_acc[p], tsba[kk], dtq + 128 * kk, 1);
        }
#pragma unroll
        for (int kk = 0; kk < JD_ROWS / 16; ++kk)  // dtK += tSb^T Q
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dtk_acc[p], tsba[kk], dq + 128 * kk, 1);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_outs();
  fence_frags();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (static_cast<size_t>(bh) * s + key[h]) * HD + cq;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * h;
        const size_t at = off + 64 * p + 8 * n;
        if constexpr (K_OUT) {
          *reinterpret_cast<float2*>(dk + at) =
              make_float2(dk_acc[p][i] * sm_scale, dk_acc[p][i + 1] * sm_scale);
          *reinterpret_cast<float2*>(dtk + at) =
              make_float2(dtk_acc[p][i] * sm_scale, dtk_acc[p][i + 1] * sm_scale);
        }
        if constexpr (V_OUT) {
          *reinterpret_cast<float2*>(dv + at) = make_float2(dv_acc[p][i], dv_acc[p][i + 1]);
          *reinterpret_cast<float2*>(dtv + at) = make_float2(dtv_acc[p][i], dtv_acc[p][i + 1]);
        }
      }
  }
}

// B11's prep, one launch: the eight contiguous f32 operands (q, k, v, tq,
// tk, tv, dO, dtO: [bh, t, HD] or [bh, s, HD]) -> bf16 (round to nearest
// even), and the row terms lse, mu, c, dhat ([bh, t] each) -> [4, bh, ld].
// Grid (rows / prep_rows(HD) rounded up, bh, 9): z < 8 converts operand z,
// eight elements a thread in PREP_PASSES rows, every load issued before the
// first store; z == 8 copies the row terms.
struct PrepArgs {
  const float* src[8];
  __nv_bfloat16* dst[8];
  const float* rows[4];
};
constexpr int PREP_PASSES = 4;
constexpr int Q_SIDE = 0xC9;  // the operands of t rows: q, tq, dO, dtO (bits 0, 3, 6, 7)
// rows a prep block takes: HD / 8 threads a row
__host__ __device__ constexpr int prep_rows(int hd) { return PREP_PASSES * 256 / (hd / 8); }

template <int HD>
__global__ void __launch_bounds__(256)
jvp_bwd_prep_kernel(PrepArgs args, float* __restrict__ rows_out, int bh_n, int t, int s, int ld) {
  constexpr int CH = HD / 8, ROWS = prep_rows(HD);
  const int z = blockIdx.z, bh = blockIdx.y, tid = threadIdx.x;
  const int tok0 = blockIdx.x * ROWS;
  if (z == 8) {
    for (int i = tid; i < 4 * ROWS; i += 256) {
      const int term = i / ROWS, tok = tok0 + i % ROWS;
      if (tok < t)
        rows_out[(static_cast<size_t>(term) * bh_n + bh) * ld + tok] =
            args.rows[term][static_cast<size_t>(bh) * t + tok];
    }
    return;
  }
  const int n = (Q_SIDE >> z) & 1 ? t : s, c8 = tid % CH;
  const float* src = args.src[z] + static_cast<size_t>(bh) * n * HD;
  uint4* dst = reinterpret_cast<uint4*>(args.dst[z] + static_cast<size_t>(bh) * n * HD);
  float4 x[PREP_PASSES][2] = {};
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + tid / CH + (256 / CH) * i;
    if (tok < n) {
      const float4* row = reinterpret_cast<const float4*>(src + static_cast<size_t>(tok) * HD);
      x[i][0] = row[2 * c8];
      x[i][1] = row[2 * c8 + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < PREP_PASSES; ++i) {
    const int tok = tok0 + tid / CH + (256 / CH) * i;
    if (tok < n)
      dst[static_cast<size_t>(tok) * CH + c8] =
          make_uint4(pack_bf16(x[i][0].x, x[i][0].y), pack_bf16(x[i][0].z, x[i][0].w),
                     pack_bf16(x[i][1].x, x[i][1].y), pack_bf16(x[i][1].z, x[i][1].w));
  }
}

// An m64 x 32 or m64 x 64 product's k-step, both operands K-major from shared
// memory (N = 16 or 32 accumulator registers): the first one into d, whose
// old values it neither reads nor keeps alive, and the next ones.
template <int N>
__device__ __forceinline__ void ss_first(float (&d)[N], uint64_t da, uint64_t db) {
  if constexpr (N == 16)
    wgmma_bf16_m64n32k16_ss_zero(d, da, db);
  else
    wgmma_bf16_m64n64k16_ss_zero(d, da, db);
}
template <int N>
__device__ __forceinline__ void ss_step(float (&d)[N], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 16)
    wgmma_bf16_m64n32k16_ss(d, da, db, accumulate);
  else
    wgmma_bf16_m64n64k16_ss(d, da, db, accumulate);
}

// ---------------------------------------------------------------------------
// B12 fast: TMA ring + wgmma, on B11's prep
// ---------------------------------------------------------------------------

constexpr int JQ_THREADS = 256;            // two warpgroups
constexpr int JQ_ROWS = 128;               // q rows a block: 64 a warpgroup
constexpr int JQ_KEYS = 32;                // keys a streamed tile
constexpr int JQ_ACC = JQ_KEYS / 2;        // f32 registers of an m64 x JQ_KEYS accumulator
constexpr int JQ_KS = JQ_KEYS / 16;        // its k-steps as the A of a second product
constexpr int RING_COUNTERS = 128;

// B12's geometry at head dim HD (ops/jvp_tiling.py mirrors it): Q, tQ, dO,
// dtO at QTILE each (panels Q_PANEL apart; warpgroup w's 64 rows at 64 w
// 128 bytes within each panel); stage st: K, tK, V, tV at OFF_RING + 4 st
// TILE (panels K_PANEL apart); then a 256-byte barrier area: the mbarriers
// (full[stage], then the q side's) and, RING_COUNTERS bytes on, the release
// counters.
template <int HD>
struct JqGeom {
  static constexpr int STAGES = HD == 64 ? 256 / JQ_KEYS : 3;  // K-side tiles in flight
  static constexpr int QTILE = JQ_ROWS * HD * 2;  // bytes of the block's bf16 Q, tQ, dO or dtO
  static constexpr int Q_PANEL = JQ_ROWS * 128;
  static constexpr int TILE = JQ_KEYS * HD * 2;   // bytes of a bf16 K, tK, V or tV tile
  static constexpr int K_PANEL = JQ_KEYS * 128;
  static constexpr int OFF_RING = 4 * QTILE;
  static constexpr int OFF_BAR = OFF_RING + STAGES * 4 * TILE;
  static constexpr int SMEM = OFF_BAR + 256 + 1024;  // + slack to align the base to 1024
  static_assert((STAGES + 1) * 8 <= RING_COUNTERS && RING_COUNTERS + (STAGES + 1) * 4 <= 256,
                "the barriers and counters fit");
  static_assert(SMEM <= 232448, "a block's shared memory fits an H100 SM");
};

// One tile's dS and tSb as the bf16 A fragments of dQ and dtQ (tile_terms'
// arithmetic; tS and dO V^T + dtO tV^T arrive summed). x[4 n + e]: row pos[e
// / 2], key k0 + 8 n + cq + (e & 1). MASK: the tile reaches past s or the
// causal diagonal. (Rows past t have Q = tQ = dO = dtO = 0 and row terms 0:
// p = 1, dS = tSb = 0.)
template <bool MASK>
__device__ __forceinline__ void dq_terms(const float (&sc)[JQ_ACC], const float (&tsc)[JQ_ACC],
                                         const float (&tpb)[JQ_ACC], const float (&pb)[JQ_ACC],
                                         const float (&lse)[2], const float (&mu)[2],
                                         const float (&cr)[2], const float (&dh)[2], int k0,
                                         int cq, const int (&pos)[2], int s, int causal,
                                         float sm_scale, float qk_scale,
                                         uint32_t (&dsa)[JQ_KS][4], uint32_t (&tsba)[JQ_KS][4]) {
#pragma unroll
  for (int n = 0; n < JQ_KEYS / 8; ++n) {
    float ds[4], tsb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, h = e / 2;
      float p = exp2_ftz(sc[i] * qk_scale - lse[h]);
      if (MASK) {
        const int col = k0 + 8 * n + cq + (e & 1);
        p = col < s && (!causal || col <= pos[h]) ? p : 0.f;
      }
      const float ts = tsc[i] * sm_scale;
      const float pbar = pb[i] + tpb[i] * (ts - mu[h]) - cr[h] * ts;
      ds[e] = p * (pbar - dh[h]);
      tsb[e] = p * (tpb[i] - cr[h]);
    }
    pack_frag(dsa, n, ds);
    pack_frag(tsba, n, tsb);
  }
}

template <int HD>
__global__ void __launch_bounds__(JQ_THREADS, 1)
jvp_dq_wgmma(const __grid_constant__ CUtensorMap q_map,    // [bh, t, HD] bf16 q, boxes of 128 rows
             const __grid_constant__ CUtensorMap tq_map,   // the same for tq
             const __grid_constant__ CUtensorMap do_map,   // dO
             const __grid_constant__ CUtensorMap dto_map,  // dtO
             const __grid_constant__ CUtensorMap k_map,    // [bh, s, HD] bf16 k, boxes of 32 keys
             const __grid_constant__ CUtensorMap tk_map,
             const __grid_constant__ CUtensorMap v_map,
             const __grid_constant__ CUtensorMap tv_map,
             const float* __restrict__ rows,  // [4, bh, ld] f32 lse, mu, c, dhat
             float* __restrict__ dq, float* __restrict__ dtq,  // [bh, t, HD]
             int t, int s, int ld, int causal, float sm_scale, float qk_scale) {
  using G = JqGeom<HD>;
  constexpr int P = HD / 64, STAGES = G::STAGES, TILE = G::TILE, QTILE = G::QTILE;
  constexpr int QP = G::Q_PANEL, KP = G::K_PANEL;
  // At 64 a tile's second products run under the next tile's first ones; at
  // 128 they are drained at the tile's end, so that dS and tSb (16
  // registers) are dead while the next first products' 64 are written
  // (with them live, the 128 registers of dQ and dtQ left too few).
  constexpr bool OVERLAP = HD == 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  const uint32_t q_bar = full(STAGES);
  int* released = reinterpret_cast<int*>(smem + G::OFF_BAR + RING_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * JQ_ROWS;  // the last rows (the most key tiles) first
  // Causal: keys past the block's last query position (below t) are never visible.
  const int kv_hi = causal ? min(s, min(t, q0 + JQ_ROWS)) : s;
  const int n_tiles = (kv_hi + JQ_KEYS - 1) / JQ_KEYS;

  init_ring(bars, released, STAGES + 1);

  // Key tile j into stage j % STAGES (keys past s arrive as zeros).
  auto load_tile = [&](int j) {
    const int st = j % STAGES;
    const uint32_t tiles = base + G::OFF_RING + st * 4 * TILE;
    mbar_expect_tx(full(st), 4 * TILE);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tma_load_3d(tiles + p * KP, &k_map, full(st), 64 * p, j * JQ_KEYS, bh);
      tma_load_3d(tiles + TILE + p * KP, &tk_map, full(st), 64 * p, j * JQ_KEYS, bh);
      tma_load_3d(tiles + 2 * TILE + p * KP, &v_map, full(st), 64 * p, j * JQ_KEYS, bh);
      tma_load_3d(tiles + 3 * TILE + p * KP, &tv_map, full(st), 64 * p, j * JQ_KEYS, bh);
    }
  };
  // The block's Q, tQ, dO and dtO (rows past t arrive as zeros), then the
  // first stages.
  if (tid == 0) {
    mbar_expect_tx(q_bar, 4 * QTILE);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tma_load_3d(base + p * QP, &q_map, q_bar, 64 * p, q0, bh);
      tma_load_3d(base + QTILE + p * QP, &tq_map, q_bar, 64 * p, q0, bh);
      tma_load_3d(base + 2 * QTILE + p * QP, &do_map, q_bar, 64 * p, q0, bh);
      tma_load_3d(base + 3 * QTILE + p * QP, &dto_map, q_bar, 64 * p, q0, bh);
    }
    for (int j = 0; j < min(STAGES, n_tiles); ++j) load_tile(j);
  }

  // wg owns rows q0 + 64 wg .. + 63; this thread rows pos[0], pos[1] and
  // their row terms.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int qw0 = q0 + 64 * wg;
  const int pos[2] = {qw0 + 16 * warp + lane / 4, qw0 + 16 * warp + lane / 4 + 8};
  const size_t term = static_cast<size_t>(gridDim.x) * ld;  // floats from one row term to the next
  float lse_r[2], mu_r[2], c_r[2], dh_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = pos[h] < t;
    const float* rw = rows + static_cast<size_t>(bh) * ld + pos[h];
    lse_r[h] = live ? rw[0] : 0.f;
    mu_r[h] = live ? rw[term] : 0.f;
    c_r[h] = live ? rw[2 * term] : 0.f;
    dh_r[h] = live ? rw[3 * term] : 0.f;
  }
  // the warpgroup's rows of the q-side tiles, a descriptor each (stepping
  // tQ's, dO's and dtO's from Q's reorders the d=64 SASS, a few % slower)
  const uint32_t qs = base + wg * 64 * 128;
  const uint64_t desc_q = desc_kmajor_sw128(qs), desc_tq = desc_kmajor_sw128(qs + QTILE);
  const uint64_t desc_do = desc_kmajor_sw128(qs + 2 * QTILE);
  const uint64_t desc_dto = desc_kmajor_sw128(qs + 3 * QTILE);

  float dq_acc[P][32], dtq_acc[P][32];  // panel p: head dims 64 p ..
  // S, tS, tpb and dO V^T + dtO tV^T
  float s_acc[JQ_ACC], ts_acc[JQ_ACC], tpb_acc[JQ_ACC], pb_acc[JQ_ACC];
  uint32_t dsa[JQ_KS][4] = {}, tsba[JQ_KS][4] = {};  // bf16 dS and tSb: the A of dQ and dtQ
  zero_all(dq_acc);
  zero_all(dtq_acc);
  zero(s_acc);
  zero(ts_acc);
  zero(tpb_acc);
  zero(pb_acc);
  mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const int k0 = j * JQ_KEYS;
    const uint32_t tiles = base + G::OFF_RING + st * 4 * TILE;
    mbar_wait(full(st), (j / STAGES) & 1);
    {  // the first products, A = the block's q-side rows, B = the key tiles (K-major)
      const uint64_t dk = desc_kmajor_sw128(tiles), dtk = desc_kmajor_sw128(tiles + TILE);
      const uint64_t dv = desc_kmajor_sw128(tiles + 2 * TILE);
      const uint64_t dtv = desc_kmajor_sw128(tiles + 3 * TILE);
      reg_fence(s_acc);
      reg_fence(ts_acc);
      reg_fence(tpb_acc);
      reg_fence(pb_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // S = Q K^T
        ss_step(s_acc, kstep(desc_q, kk, QP), kstep(dk, kk, KP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // tS = tQ K^T + Q tK^T
        ss_step(ts_acc, kstep(desc_tq, kk, QP), kstep(dk, kk, KP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ss_step(ts_acc, kstep(desc_q, kk, QP), kstep(dtk, kk, KP), 1);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // tpb = dtO V^T
        ss_step(tpb_acc, kstep(desc_dto, kk, QP), kstep(dv, kk, KP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // dO V^T + dtO tV^T
        ss_step(pb_acc, kstep(desc_do, kk, QP), kstep(dv, kk, KP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ss_step(pb_acc, kstep(desc_dto, kk, QP), kstep(dtv, kk, KP), 1);
      wgmma_commit();
    }
    if constexpr (OVERLAP) {
      // the last tile's second products are done (all but the newest group):
      // its stage is released while this tile's first products run
      wgmma_wait<1>();
      if (j > 0) release_stage(released, j - 1, STAGES, n_tiles, load_tile);
    }
    wgmma_wait<0>();
    reg_fence(s_acc);
    reg_fence(ts_acc);
    reg_fence(tpb_acc);
    reg_fence(pb_acc);
    reg_fence(dsa);
    reg_fence(tsba);
    fence_all(dq_acc);
    fence_all(dtq_acc);
    // masking only where the tile reaches past s or the warpgroup's diagonal
    if (k0 + JQ_KEYS > s || (causal && k0 + JQ_KEYS - 1 > qw0))
      dq_terms<true>(s_acc, ts_acc, tpb_acc, pb_acc, lse_r, mu_r, c_r, dh_r, k0, cq, pos, s,
                     causal, sm_scale, qk_scale, dsa, tsba);
    else
      dq_terms<false>(s_acc, ts_acc, tpb_acc, pb_acc, lse_r, mu_r, c_r, dh_r, k0, cq, pos, s,
                      causal, sm_scale, qk_scale, dsa, tsba);
    reg_fence(dsa);
    reg_fence(tsba);
    // dQ += dS K + tSb tK, dtQ += tSb K (B = the same K and tK tiles read
    // MN-major: 16 keys = 2048 bytes a k-step), panel p into the outputs'
    // panel p
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint64_t dk = desc_mnmajor_sw128(tiles + p * KP);
      const uint64_t dtk = desc_mnmajor_sw128(tiles + TILE + p * KP);
#pragma unroll
      for (int kk = 0; kk < JQ_KEYS / 16; ++kk) {
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_acc[p], dsa[kk], dk + 128 * kk, 1);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_acc[p], tsba[kk], dtk + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < JQ_KEYS / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dtq_acc[p], tsba[kk], dk + 128 * kk, 1);
    }
    wgmma_commit();
    if constexpr (!OVERLAP) {  // drained here: dS and tSb die with the tile
      wgmma_wait<0>();
      fence_all(dq_acc);
      fence_all(dtq_acc);
      reg_fence(dsa);
      reg_fence(tsba);
      release_stage(released, j, STAGES, n_tiles, load_tile);
    }
  }
  wgmma_wait<0>();
  fence_all(dq_acc);
  fence_all(dtq_acc);
  reg_fence(dsa);
  reg_fence(tsba);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pos[h] >= t) continue;
    const size_t off = (static_cast<size_t>(bh) * t + pos[h]) * HD + cq;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * h;
        *reinterpret_cast<float2*>(dq + off + 64 * p + 8 * n) =
            make_float2(dq_acc[p][i] * sm_scale, dq_acc[p][i + 1] * sm_scale);
        *reinterpret_cast<float2*>(dtq + off + 64 * p + 8 * n) =
            make_float2(dtq_acc[p][i] * sm_scale, dtq_acc[p][i + 1] * sm_scale);
      }
  }
}

// ---------------------------------------------------------------------------
// B9 fast: TMA ring + wgmma, with a K-side prep launch
// ---------------------------------------------------------------------------

constexpr int JF_THREADS = 256;            // two warpgroups
constexpr int JF_ROWS = 128;               // q rows a block: 64 a warpgroup

// B9's geometry at head dim HD (ops/jvp_tiling.py mirrors it): Q, tQ at
// QTILE each (panels Q_PANEL apart, warpgroup w's rows at 64 w 128 bytes in
// each); stage st: K, tK, V, tV at OFF_RING + 4 st TILE (panels K_PANEL
// apart); then the 256-byte barrier area (full[stage]; release counters
// RING_COUNTERS bytes on). At 128, O and tO's sum take 128 registers a
// thread: 32-key tiles, and tO's two parts (A = P tV, B = H V) sum in one
// accumulator (NT = 1; two at 64, added at the end).
template <int HD>
struct JfGeom {
  static constexpr int KEYS = HD == 64 ? 64 : 32;  // keys a K-side tile
  static constexpr int STAGES = 4;                 // tiles in flight: 256 keys at 64, 128 at 128
  static constexpr int NT = HD == 64 ? 2 : 1;      // tO's accumulators
  static constexpr int ACC = KEYS / 2;             // f32 registers of an m64 x KEYS accumulator
  static constexpr int KS = KEYS / 16;             // its k-steps as the A of a second product
  static constexpr int QTILE = JF_ROWS * HD * 2;   // bytes of the block's bf16 Q or tQ
  static constexpr int Q_PANEL = JF_ROWS * 128;
  static constexpr int TILE = KEYS * HD * 2;       // bytes of a bf16 K, tK, V or tV tile
  static constexpr int K_PANEL = KEYS * 128;
  static constexpr int OFF_RING = 2 * QTILE;
  static constexpr int OFF_BAR = OFF_RING + STAGES * 4 * TILE;
  static constexpr int SMEM = OFF_BAR + 256 + 1024;  // + slack to align the base to 1024
  static_assert(STAGES * 8 <= RING_COUNTERS, "the barriers fit");
  static_assert(SMEM <= 232448, "a block's shared memory fits an H100 SM");
};

// One tile's online-softmax step (the exact kernel's arithmetic): S (f32 Q K^T) -> S
// qk_scale, MASK_VALUE where masked (MASK: the tile reaches past s or past the
// warpgroup's first position); the running max m and each row's alpha; p =
// exp2(S - m), 0 where masked, and h = p tS sm_scale, rounded to bf16 as the A
// fragments of the second products; l and r, this thread's partial row sums of
// the unrounded p and h, rescaled by alpha. x[4 n + e]: row pos[e / 2], key k0
// + 8 n + cq + (e & 1).
template <bool MASK, int KEYS>
__device__ __forceinline__ void fwd_terms(float (&sc)[KEYS / 2], const float (&tc)[KEYS / 2],
                                          uint32_t (&pa)[KEYS / 16][4],
                                          uint32_t (&ha)[KEYS / 16][4], float (&m)[2],
                                          float (&l)[2], float (&r)[2], float (&alpha)[2], int k0,
                                          int cq, const int (&pos)[2], int s, int causal,
                                          float sm_scale, float qk_scale) {
  auto visible = [&](int i) {
    const int col = k0 + (i / 4) * 8 + cq + (i & 1);
    return col < s && (!causal || col <= pos[(i % 4) / 2]);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) {
    sc[i] = MASK && !visible(i) ? MASK_VALUE : sc[i] * qk_scale;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float next = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2_ftz(m[h] - next);  // 0 while m is -inf
    m[h] = next;
  }
  float lsum[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KEYS / 8; ++n) {
    float p[4], hp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, h = e / 2;
      p[e] = MASK && !visible(i) ? 0.f : exp2_ftz(sc[i] - m[h]);
      hp[e] = p[e] * (tc[i] * sm_scale);
      lsum[h] += p[e];
      rsum[h] += hp[e];
    }
    pack_frag(pa, n, p);
    pack_frag(ha, n, hp);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l[h] * alpha[h] + lsum[h];
    r[h] = r[h] * alpha[h] + rsum[h];
  }
}

template <int HD>
__global__ void __launch_bounds__(JF_THREADS, 1)
jvp_fwd_wgmma(const __grid_constant__ CUtensorMap k_map,   // [bh, s, HD] bf16 k, boxes of KEYS
              const __grid_constant__ CUtensorMap v_map,   // the same for v
              const __grid_constant__ CUtensorMap tk_map,  // tk
              const __grid_constant__ CUtensorMap tv_map,  // tv
              const float* __restrict__ q,  // [b, h, t, HD] f32, strides in elements
              long long q_sb, long long q_sh, long long q_st,
              const float* __restrict__ tq, long long tq_sb, long long tq_sh, long long tq_st,
              float* __restrict__ o, float* __restrict__ to,    // [bh, t, HD]
              float* __restrict__ lse, float* __restrict__ mu,  // [bh, t]
              int heads, int t, int s, int causal, float sm_scale, float qk_scale) {
  using G = JfGeom<HD>;
  constexpr int P = HD / 64, KEYS = G::KEYS, STAGES = G::STAGES, NT = G::NT;
  constexpr int TILE = G::TILE, QP = G::Q_PANEL, KP = G::K_PANEL;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  int* released = reinterpret_cast<int*>(smem + G::OFF_BAR + RING_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const long long batch = bh / heads, head = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * JF_ROWS;  // the last rows (the most key tiles) first
  const int kv_hi = causal ? min(s, min(t, q0 + JF_ROWS)) : s;
  const int n_tiles = (kv_hi + KEYS - 1) / KEYS;

  init_ring(bars, released, STAGES);
  // Tile j into stage j % STAGES: K, tK, V, tV (keys past s arrive as
  // zeros). Thread 0 loads the first stages; the second warpgroup to release
  // a stage refills it.
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    const uint32_t dst = base + G::OFF_RING + st * 4 * TILE;
    mbar_expect_tx(full(st), 4 * TILE);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tma_load_3d(dst + p * KP, &k_map, full(st), 64 * p, j * KEYS, bh);
      tma_load_3d(dst + TILE + p * KP, &tk_map, full(st), 64 * p, j * KEYS, bh);
      tma_load_3d(dst + 2 * TILE + p * KP, &v_map, full(st), 64 * p, j * KEYS, bh);
      tma_load_3d(dst + 3 * TILE + p * KP, &tv_map, full(st), 64 * p, j * KEYS, bh);
    }
  };
  if (tid == 0)
    for (int j = 0; j < min(STAGES, n_tiles); ++j) load_kv(j);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int qw0 = q0 + 64 * wg;   // the warpgroup's first row

  // This warpgroup's Q and tQ rows -> shared memory in bf16 (round to nearest
  // even, as .to(bfloat16)), K-major with the 128-byte swizzle (16-byte chunk
  // c of a panel's row r at c ^ (r & 7)); zeros past t. Every load of a pass
  // (both at 64; Q, then tQ at 128) is issued before its first conversion.
  constexpr int CH = HD / 8;                    // 16-byte chunks of 8 a row
  constexpr int Q_PASSES = 64 * CH / 128;       // chunks of 8 a thread, each of Q and tQ
  constexpr int XB = HD == 64 ? 2 : 1;          // of Q and tQ a pass
#pragma unroll
  for (int x0 = 0; x0 < 2; x0 += XB) {
    uint4 qraw[XB][Q_PASSES][2];
#pragma unroll
    for (int xi = 0; xi < XB; ++xi)
#pragma unroll
      for (int i = 0; i < Q_PASSES; ++i) {
        const int c = tid % 128 + 128 * i, p = qw0 + c / CH, c8 = c % CH;
        qraw[xi][i][0] = qraw[xi][i][1] = make_uint4(0u, 0u, 0u, 0u);
        if (p < t) {
          const float* row = x0 + xi ? tq + batch * tq_sb + head * tq_sh + p * tq_st
                                     : q + batch * q_sb + head * q_sh + p * q_st;
          const uint4* src = reinterpret_cast<const uint4*>(row + c8 * 8);
          qraw[xi][i][0] = src[0];
          qraw[xi][i][1] = src[1];
        }
      }
#pragma unroll
    for (int xi = 0; xi < XB; ++xi)
#pragma unroll
      for (int i = 0; i < Q_PASSES; ++i) {
        const int c = tid % 128 + 128 * i, r = wg * 64 + c / CH, c8 = c % CH;
        const uint4 a = qraw[xi][i][0], b = qraw[xi][i][1];
        *reinterpret_cast<uint4*>(smem + (x0 + xi) * G::QTILE + (c8 / 8) * QP + r * 128 +
                                  (((c8 % 8) ^ (r & 7)) << 4)) =
            make_uint4(pack_bf16(__uint_as_float(a.x), __uint_as_float(a.y)),
                       pack_bf16(__uint_as_float(a.z), __uint_as_float(a.w)),
                       pack_bf16(__uint_as_float(b.x), __uint_as_float(b.y)),
                       pack_bf16(__uint_as_float(b.z), __uint_as_float(b.w)));
      }
  }
  fence_proxy_async();  // Q and tQ, for wgmma
  named_barrier(1 + wg, 128);

  const int pos[2] = {qw0 + 16 * warp + lane / 4, qw0 + 16 * warp + lane / 4 + 8};
  auto edge = [&](int j) {
    return j * KEYS + KEYS > s || (causal && j * KEYS + KEYS - 1 > qw0);
  };
  const uint32_t qs = base + wg * 64 * 128;
  const uint64_t desc_q = desc_kmajor_sw128(qs), desc_tq = desc_kmajor_sw128(qs + G::QTILE);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  // O and tO's parts (panel p: head dims 64 p ..), each rescaled by alpha:
  // tacc[0] = A = P tV and tacc[NT - 1] = B = H V
  float oacc[P][32], tacc[NT][P][32];
  zero_all(oacc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) zero_all(tacc[nt]);

  auto stage = [&](int j) { return base + G::OFF_RING + (j % STAGES) * 4 * TILE; };
  float sc[G::ACC], tc[G::ACC];                     // a tile's S and tS
  uint32_t pa[G::KS][4] = {}, ha[G::KS][4] = {};  // its bf16 P and H: the A of the second products
  // The registers the products read or write: their last writes stay
  // before wgmma.fence (C7513), and their reads after the wait.
  auto fence_regs = [&]() {
    reg_fence(sc);
    reg_fence(tc);
    fence_all(oacc);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) fence_all(tacc[nt]);
    reg_fence(pa);
    reg_fence(ha);
  };
  // S = Q K^T and tS = tQ K^T + Q tK^T of the tile in stage `st`.
  auto issue_s = [&](uint32_t st) {
    const uint64_t dk = desc_kmajor_sw128(st), dtk = desc_kmajor_sw128(st + TILE);
    ss_first(sc, desc_q, dk);
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) ss_step(sc, kstep(desc_q, kk, QP), kstep(dk, kk, KP), 1);
    ss_first(tc, desc_tq, dk);
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk)
      ss_step(tc, kstep(desc_tq, kk, QP), kstep(dk, kk, KP), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ss_step(tc, kstep(desc_q, kk, QP), kstep(dtk, kk, KP), 1);
  };
  // O += P V, A += P tV, B += H V of the tile in stage `st`: k-steps of 16
  // keys (2048 bytes of the V and tV tiles' panels, read MN-major).
  auto issue_out = [&](uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint64_t dv = desc_mnmajor_sw128(st + 2 * TILE + p * KP);
        const uint64_t dtv = desc_mnmajor_sw128(st + 3 * TILE + p * KP);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(oacc[p], pa[kk], dv + 128 * kk, 1);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(tacc[0][p], pa[kk], dtv + 128 * kk, 1);
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(tacc[NT - 1][p], ha[kk], dv + 128 * kk, 1);
      }
  };

  // The mainloop, B1 fp32's (csrc/flash_fwd.cu): tile j's softmax, then its
  // second products and the next tile's S and tS issued together (the last
  // tile's S again at the end: a wgmma under a branch would serialize them
  // all) and both waited for, so no product is in flight across the loop's
  // back edge (C7515) or while a ring wait's trap path is live (C7517); then
  // the stage is released. One set of fragments: the two warpgroups'
  // softmaxes overlap each other's products.
  mbar_wait(full(0), 0);
  fence_regs();
  wgmma_fence();
  issue_s(stage(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs();
  for (int j = 0; j < n_tiles; ++j) {
    float alpha[2];
    if (edge(j))
      fwd_terms<true, KEYS>(sc, tc, pa, ha, m, l, rs, alpha, j * KEYS, cq, pos, s, causal,
                            sm_scale, qk_scale);
    else
      fwd_terms<false, KEYS>(sc, tc, pa, ha, m, l, rs, alpha, j * KEYS, cq, pos, s, causal,
                             sm_scale, qk_scale);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float a = alpha[(i % 4) / 2];
        oacc[p][i] *= a;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) tacc[nt][p][i] *= a;
      }
    const int jn = min(j + 1, n_tiles - 1);
    if (j + 1 < n_tiles) mbar_wait(full(jn % STAGES), (jn / STAGES) & 1);
    fence_regs();
    wgmma_fence();
    issue_out(stage(j));
    issue_s(stage(jn));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs();
    release_stage(released, j, STAGES, n_tiles, load_kv);
  }

  // O = acc / l, tO = (A + B - r O) / l (l == 0 -> 1), lse = m + log2(l), mu
  // = r / l; rows past t store nothing.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]), rsum = quad_sum(rs[h]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (pos[h] >= t) continue;
    const size_t row = static_cast<size_t>(bh) * t + pos[h];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * h;
        const float o0 = oacc[p][i] / l_safe, o1 = oacc[p][i + 1] / l_safe;
        const float t0 = NT == 2 ? tacc[0][p][i] + tacc[NT - 1][p][i] : tacc[0][p][i];
        const float t1 = NT == 2 ? tacc[0][p][i + 1] + tacc[NT - 1][p][i + 1] : tacc[0][p][i + 1];
        const size_t at = row * HD + 64 * p + 8 * n + cq;
        *reinterpret_cast<float2*>(o + at) = make_float2(o0, o1);
        *reinterpret_cast<float2*>(to + at) =
            make_float2((t0 - rsum * o0) / l_safe, (t1 - rsum * o1) / l_safe);
      }
    if (lane % 4 == 0) {
      lse[row] = m[h] + log2f(l_safe);
      mu[row] = rsum / l_safe;
    }
  }
}

// B9 fast's K-side prep, one launch: k, v, tk, tv ([b, h, s, HD] f32, any
// strides, rows contiguous) -> contiguous bf16 [b * h, s, HD] (round to
// nearest even). Grid (s / fwd_prep_rows(HD) rounded up, b * h, 4): z is the
// operand; a thread converts 8 elements of a row in each of 8 rows, every
// load issued before its first store.
struct FwdPrepArgs {
  const float* src[4];
  long long stride[4][3];  // batch, head, token strides in elements
  __nv_bfloat16* dst[4];
};
constexpr int FP_PASSES = 8;
// rows of each operand a prep block converts: HD / 8 threads a row
__host__ __device__ constexpr int fwd_prep_rows(int hd) { return FP_PASSES * 256 / (hd / 8); }

template <int HD>
__global__ void __launch_bounds__(256)
jvp_fwd_prep_kernel(FwdPrepArgs args, int heads, int s) {
  constexpr int CH = HD / 8;
  const int z = blockIdx.z, bh = blockIdx.y, c8 = threadIdx.x % CH;
  const int tok0 = blockIdx.x * fwd_prep_rows(HD) + threadIdx.x / CH;
  const float* src = args.src[z] + (bh / heads) * args.stride[z][0] +
                     (bh % heads) * args.stride[z][1];
  const long long st = args.stride[z][2];
  uint4* dst = reinterpret_cast<uint4*>(args.dst[z] + static_cast<size_t>(bh) * s * HD);
  float4 x[FP_PASSES][2] = {};
#pragma unroll
  for (int i = 0; i < FP_PASSES; ++i) {
    const int tok = tok0 + (256 / CH) * i;
    if (tok < s) {
      const float4* row = reinterpret_cast<const float4*>(src + tok * st + c8 * 8);
      x[i][0] = row[0];
      x[i][1] = row[1];
    }
  }
#pragma unroll
  for (int i = 0; i < FP_PASSES; ++i) {
    const int tok = tok0 + (256 / CH) * i;
    if (tok < s)
      dst[static_cast<size_t>(tok) * CH + c8] =
          make_uint4(pack_bf16(x[i][0].x, x[i][0].y), pack_bf16(x[i][0].z, x[i][0].w),
                     pack_bf16(x[i][1].x, x[i][1].y), pack_bf16(x[i][1].z, x[i][1].w));
  }
}

// ---------------------------------------------------------------------------
// B10 exact: 3xTF32 on wgmma
// ---------------------------------------------------------------------------
//
// tO = sum over keys of (h V + p tV) - r O, p = exp2(S qk_scale - lse) (0
// where masked), h = p tS sm_scale, r = rowsum(h), with lse given: p is final
// on first touch, so acc and r are plain sums over keys (no rescaling) and a
// block may take any range of key tiles; the ranges' sums are added in a
// fixed order (tangent_merge_kernel), so results repeat bit for bit. Each of
// the five products (S = Q K^T, tS = tQ K^T + Q tK^T, h V, p tV) runs as
// 3xTF32 on wgmma (x = big + small, hopper.cuh; big.big + big.small +
// small.big).
//
// Bound: operations. 15 TF32 products over every visible (q, k) pair at 495
// TFLOP/s; the operands are 8 f32 tensors read once.
// Design: B1 fp32's in a wider form. One prep launch (tangent_prep_kernel)
// writes K and tK big and small [bh, s, 64] (the K-major B of S and tS) and
// V and tV as V^T big and small [bh, 64, s8] in tf32_a_column order (the B
// of h V and p tV, whose A fragments come from the S / tS accumulators).
// Then blocks of two warpgroups per (bh, 128 rows, key range z), 64 rows
// each, grid (q blocks, bh, z): both warpgroups walk the range's 32-key
// tiles through a 3-stage TMA ring (64 KB a stage: eight [32 x 64] f32
// operands), refilled by the second warpgroup to release a stage. Q big, Q
// small and tQ big sit in registers as A fragments (96 registers), tQ small
// in shared memory (its product SS). A tile: S and tS issued together (72
// wgmma m64n32k8) and waited for; p and h split into TF32 A fragments in
// registers; the 24 wgmma m64n64k8 of the tile's h V + p tV issued into a
// fresh accumulator and waited for, then added to acc in f32; the stage
// released. Nothing is in flight across the loop's back edge (C7515) or at
// a ring wait (C7517). The epilogue writes tO = acc - r O, or, when the keys
// are split (z > 1), the range's acc and r for the merge.

constexpr int TG_THREADS = 256;            // two warpgroups
constexpr int TG_ROWS = 128;               // q rows a block: 64 a warpgroup
constexpr int TG_KEYS = 32;                // keys a tile
constexpr int TG_STAGES = 3;               // tiles in flight
constexpr int TG_KBLK = TG_KEYS * 128;     // a [32 keys x 32 dims] f32 block: rows of 128 bytes
constexpr int TG_VBLK = 64 * 128;          // a [64 dims x 32 keys] f32 block
constexpr int TG_QBLK = 64 * 128;          // a [64 rows x 32 dims] f32 block of tQ small
// A stage: K big, K small, tK big, tK small (two K blocks each: dims 0-31,
// 32-63), then V^T big, V^T small, tV^T big, tV^T small (a V block each).
constexpr int TG_KS = 2 * TG_KBLK, TG_TKB = 4 * TG_KBLK, TG_TKS = 6 * TG_KBLK;
constexpr int TG_VB = 8 * TG_KBLK, TG_VS = TG_VB + TG_VBLK, TG_TVB = TG_VB + 2 * TG_VBLK,
              TG_TVS = TG_VB + 3 * TG_VBLK;
constexpr int TG_STAGE = 8 * TG_KBLK + 4 * TG_VBLK;
constexpr int TG_OFF_RING = 2 * 2 * TG_QBLK;  // tQ small first: two blocks a warpgroup
constexpr int TG_OFF_BAR = TG_OFF_RING + TG_STAGES * TG_STAGE;
constexpr int TG_COUNTERS = 64;  // byte offset of the release counters in the barrier area
constexpr int TG_SMEM = TG_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
static_assert(TG_STAGES * 8 <= TG_COUNTERS && TG_COUNTERS + TG_STAGES * 4 <= 128, "barriers fit");
static_assert(TG_SMEM <= 232448, "a block's shared memory fits an H100 SM");

// The prep's two pairs: (K, V) at z = 0, (tK, tV) at z = 1.
struct SplitArgs {
  const float* k[2];
  const float* v[2];
  long long k_st[2][3], v_st[2][3];  // batch, head, token strides in elements
  float* out[2][4];                  // big, small [bh, s, 64]; V^T big, small [bh, 64, s8]
};

// f32 strides (in elements) that keep 16-byte rows 16-byte aligned.
bool strides16(const long long (&st)[3]) {
  return st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}

// Grid (s / 64 rounded up, bh, 2): a block takes 64 keys of one pair, at
// head dim D (64 or 128).
template <int D>
__global__ void __launch_bounds__(256)
tangent_prep_kernel(SplitArgs a, int heads, int s, int s8) {
  __shared__ float v_s[SPLIT_KEYS][D + 1];
  const int z = blockIdx.z, bh = blockIdx.y;
  const long long batch = bh / heads, head = bh % heads;
  const size_t kv_at = static_cast<size_t>(bh) * s * D, vt_at = static_cast<size_t>(bh) * D * s8;
  kv_split_tf32_tile<D>(a.k[z] + batch * a.k_st[z][0] + head * a.k_st[z][1], a.k_st[z][2],
                     a.v[z] + batch * a.v_st[z][0] + head * a.v_st[z][1], a.v_st[z][2],
                     a.out[z][0] + kv_at, a.out[z][1] + kv_at, a.out[z][2] + vt_at,
                     a.out[z][3] + vt_at, blockIdx.x * SPLIT_KEYS, s, s8, v_s);
}

// k-step kk of a K-major f32 operand stored as 128-byte-row blocks of 32
// columns, `blk` bytes apart.
__device__ __forceinline__ uint64_t desc_tf32(uint32_t addr, int kk, int blk) {
  return desc_kmajor_sw128(addr + (kk / 4) * blk) + 2 * (kk % 4);
}

// One tile's p and h from its S and tS accumulators (m64n32: element i is
// row ra + 8 ((i % 4) / 2), key k0 + 8 (i / 4) + 2c + (i & 1)), split into
// the TF32 A fragments of h V and p tV (k-step n = keys 8n .. 8n + 7 in
// tf32_a_column order); hsum gathers this thread's part of r. MASK: the
// tile reaches past s or, causal, past the warpgroup's first row. N = 16
// (m64n32, 32 keys) or 8 (m64n16, 16 keys: the head-dim-128 kernel).
template <bool MASK, int N>
__device__ __forceinline__ void tangent_terms(const float (&sacc)[N], const float (&tsacc)[N],
                                              uint32_t (&pb)[N / 4][4], uint32_t (&ps)[N / 4][4],
                                              uint32_t (&hb)[N / 4][4], uint32_t (&hs)[N / 4][4],
                                              float (&hsum)[2], const float (&lse)[2],
                                              const int (&pos)[2], int k0, int c2, int s,
                                              int causal, float sm_scale, float qk_scale) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h2 = (i % 4) / 2, col = k0 + (i / 4) * 8 + c2 + (i & 1);
    const bool visible = !MASK || (col < s && (!causal || col <= pos[h2]));
    const float p = visible ? exp2f(sacc[i] * qk_scale - lse[h2]) : 0.f;
    const float h = p * (tsacc[i] * sm_scale);
    hsum[h2] += h;
    const int f = h2 + 2 * (i & 1);  // accumulator column 2c + (i & 1) -> fragment column c + 4 (i & 1)
    const float p_big = tf32_big(p), h_big = tf32_big(h);
    pb[i / 4][f] = __float_as_uint(p_big);
    ps[i / 4][f] = __float_as_uint(p - p_big);
    hb[i / 4][f] = __float_as_uint(h_big);
    hs[i / 4][f] = __float_as_uint(h - h_big);
  }
}

__global__ void __launch_bounds__(TG_THREADS, 1)
jvp_tangent_tf32(const __grid_constant__ CUtensorMap kb_map,    // [bh, s, 64] K big
                 const __grid_constant__ CUtensorMap ks_map,    // K small
                 const __grid_constant__ CUtensorMap tkb_map,   // tK big
                 const __grid_constant__ CUtensorMap tks_map,   // tK small
                 const __grid_constant__ CUtensorMap vb_map,    // [bh, 64, s8] V^T big
                 const __grid_constant__ CUtensorMap vs_map,    // V^T small
                 const __grid_constant__ CUtensorMap tvb_map,   // tV^T big
                 const __grid_constant__ CUtensorMap tvs_map,   // tV^T small
                 const float* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
                 const float* __restrict__ tq, long long tq_sb, long long tq_sh, long long tq_st,
                 const float* __restrict__ o, long long o_sb, long long o_sh, long long o_st,
                 const float* __restrict__ lse, long long l_sb, long long l_sh, long long l_st,
                 float* __restrict__ to,    // [bh, t, 64], or with z > 1 the ranges' acc
                 float* __restrict__ rpart,  // [z, bh, t] the ranges' r (z > 1)
                 int h, int t, int s, int causal, int per, float sm_scale, float qk_scale) {
  constexpr int D = 64;  // this kernel's head dim (jvp_tangent_tf32_128 takes 128)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + TG_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  int* released = reinterpret_cast<int*>(smem + TG_OFF_BAR + TG_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, batch = bh / h, head = bh % h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TG_ROWS;  // the last rows (most tiles) first
  const int kv_hi = causal ? min(s, min(t, q0 + TG_ROWS)) : s;
  const int j0 = blockIdx.z * per;
  const int j1 = min(j0 + per, (kv_hi + TG_KEYS - 1) / TG_KEYS);
  const int n_tiles = max(j1 - j0, 0);

  init_ring(bars, released, TG_STAGES);
  auto load = [&](int i) {  // tile j0 + i into stage i % TG_STAGES; keys past s arrive as zeros
    const int st = i % TG_STAGES, key0 = (j0 + i) * TG_KEYS;
    const uint32_t dst = base + TG_OFF_RING + st * TG_STAGE;
    mbar_expect_tx(full(st), TG_STAGE);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_load_3d(dst + half * TG_KBLK, &kb_map, full(st), 32 * half, key0, bh);
      tma_load_3d(dst + TG_KS + half * TG_KBLK, &ks_map, full(st), 32 * half, key0, bh);
      tma_load_3d(dst + TG_TKB + half * TG_KBLK, &tkb_map, full(st), 32 * half, key0, bh);
      tma_load_3d(dst + TG_TKS + half * TG_KBLK, &tks_map, full(st), 32 * half, key0, bh);
    }
    tma_load_3d(dst + TG_VB, &vb_map, full(st), key0, 0, bh);
    tma_load_3d(dst + TG_VS, &vs_map, full(st), key0, 0, bh);
    tma_load_3d(dst + TG_TVB, &tvb_map, full(st), key0, 0, bh);
    tma_load_3d(dst + TG_TVS, &tvs_map, full(st), key0, 0, bh);
  };
  if (tid == 0)
    for (int i = 0; i < min(TG_STAGES, n_tiles); ++i) load(i);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int c = lane % 4;
  const int ra = 16 * warp + lane / 4;  // this thread's rows ra, ra + 8 of the warpgroup's 64
  int pos[2];
  float lse_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    pos[h2] = q0 + 64 * wg + ra + 8 * h2;
    lse_r[h2] = pos[h2] < t ? lse[batch * l_sb + head * l_sh + pos[h2] * l_st] : 0.f;
  }

  // Q and tQ (f32, read through their strides; rows past t are 0), split:
  // Q big and small and tQ big as the A fragments of the 8 k-steps, tQ small
  // K-major into shared memory (128-byte swizzle: 16-byte chunk ch of row r
  // at ch ^ (r & 7)). Every load is issued before the first split.
  uint32_t qb[8][4], qs[8][4], tqb[8][4];
  const uint32_t tqs_base = base + wg * 2 * TG_QBLK;
  {
    float x[2][16], tx[2][16];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float* row = q + batch * q_sb + head * q_sh + static_cast<long long>(pos[h2]) * q_st;
      const float* trow =
          tq + batch * tq_sb + head * tq_sh + static_cast<long long>(pos[h2]) * tq_st;
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // head dim 8 (i / 2) + c + 4 (i % 2)
        const int d = 8 * (i / 2) + c + 4 * (i % 2);
        x[h2][i] = pos[h2] < t ? row[d] : 0.f;
        tx[h2][i] = pos[h2] < t ? trow[d] : 0.f;
      }
    }
    float* tqs_s = reinterpret_cast<float*>(smem + wg * 2 * TG_QBLK);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = ra + 8 * h2;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int f = h2 + 2 * (i % 2);
        const float big = tf32_big(x[h2][i]), tbig = tf32_big(tx[h2][i]);
        qb[i / 2][f] = __float_as_uint(big);
        qs[i / 2][f] = __float_as_uint(x[h2][i] - big);
        tqb[i / 2][f] = __float_as_uint(tbig);
        const int d = 8 * (i / 2) + c + 4 * (i % 2), w = d % 32;
        tqs_s[(d / 32) * (TG_QBLK / 4) + r * 32 + (((w / 4) ^ (r & 7)) << 2) + w % 4] =
            tx[h2][i] - tbig;
      }
    }
  }
  fence_proxy_async();  // tQ small, for wgmma
  named_barrier(1 + wg, 128);

  float sacc[16], tsacc[16], acc[32], hsum[2] = {0.f, 0.f};
  uint32_t pb[4][4], ps[4][4], hb[4][4], hs[4][4];  // p, h big and small: the A of h V, p tV
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  auto edge = [&](int j) {
    return j * TG_KEYS + TG_KEYS > s || (causal && j * TG_KEYS + TG_KEYS - 1 > q0 + 64 * wg);
  };

  for (int i = 0; i < n_tiles; ++i) {
    const int j = j0 + i;
    const uint32_t st = base + TG_OFF_RING + (i % TG_STAGES) * TG_STAGE;
    mbar_wait(full(i % TG_STAGES), (i / TG_STAGES) & 1);
    // S = Q K^T and tS = tQ K^T + Q tK^T, the small terms first, the big-big
    // terms last: 72 products in one group.
    wgmma_fence();
    wgmma_tf32_m64n32k8_rs_zero(sacc, qb[0], desc_tf32(st + TG_KS, 0, TG_KBLK));
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)  // Q big . K small
      wgmma_tf32_m64n32k8_rs(sacc, qb[kk], desc_tf32(st + TG_KS, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . K big
      wgmma_tf32_m64n32k8_rs(sacc, qs[kk], desc_tf32(st, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . K big
      wgmma_tf32_m64n32k8_rs(sacc, qb[kk], desc_tf32(st, kk, TG_KBLK), 1);
    wgmma_tf32_m64n32k8_rs_zero(tsacc, tqb[0], desc_tf32(st + TG_KS, 0, TG_KBLK));
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)  // tQ big . K small
      wgmma_tf32_m64n32k8_rs(tsacc, tqb[kk], desc_tf32(st + TG_KS, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // tQ small . K big
      wgmma_tf32_m64n32k8_ss(tsacc, desc_tf32(tqs_base, kk, TG_QBLK), desc_tf32(st, kk, TG_KBLK),
                             1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . tK small
      wgmma_tf32_m64n32k8_rs(tsacc, qb[kk], desc_tf32(st + TG_TKS, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . tK big
      wgmma_tf32_m64n32k8_rs(tsacc, qs[kk], desc_tf32(st + TG_TKB, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // tQ big . K big
      wgmma_tf32_m64n32k8_rs(tsacc, tqb[kk], desc_tf32(st, kk, TG_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . tK big
      wgmma_tf32_m64n32k8_rs(tsacc, qb[kk], desc_tf32(st + TG_TKB, kk, TG_KBLK), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(tsacc);
    if (edge(j))
      tangent_terms<true>(sacc, tsacc, pb, ps, hb, hs, hsum, lse_r, pos, j * TG_KEYS, 2 * c, s,
                          causal, sm_scale, qk_scale);
    else
      tangent_terms<false>(sacc, tsacc, pb, ps, hb, hs, hsum, lse_r, pos, j * TG_KEYS, 2 * c, s,
                           causal, sm_scale, qk_scale);
    // The tile's h V + p tV: 24 products in one group into a fresh
    // accumulator, the big-big terms last, then added to acc in f32 (round
    // to nearest). The tensor cores' accumulation truncates: every tile's
    // products summed into acc in place biased it toward 0, 1.3e-4 of
    // max|tO| against float64 at the DiT's shape where this sum gives 3.2e-6
    // and FFMA 7.2e-6 (kernel_probe.py jvp_tangent, on an H100).
    float tacc[32];
    reg_fence(pb);
    reg_fence(ps);
    reg_fence(hb);
    reg_fence(hs);
    wgmma_fence();
    wgmma_tf32_m64n64k8_rs_zero(tacc, hs[0], desc_kmajor_sw128(st + TG_VB));
#pragma unroll
    for (int kk = 1; kk < TG_KEYS / 8; ++kk)  // h small . V big
      wgmma_tf32_m64n64k8_rs(tacc, hs[kk], desc_kmajor_sw128(st + TG_VB) + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < TG_KEYS / 8; ++kk)  // h big . V small
      wgmma_tf32_m64n64k8_rs(tacc, hb[kk], desc_kmajor_sw128(st + TG_VS) + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < TG_KEYS / 8; ++kk)  // p small . tV big
      wgmma_tf32_m64n64k8_rs(tacc, ps[kk], desc_kmajor_sw128(st + TG_TVB) + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < TG_KEYS / 8; ++kk)  // p big . tV small
      wgmma_tf32_m64n64k8_rs(tacc, pb[kk], desc_kmajor_sw128(st + TG_TVS) + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < TG_KEYS / 8; ++kk)  // h big . V big
      wgmma_tf32_m64n64k8_rs(tacc, hb[kk], desc_kmajor_sw128(st + TG_VB) + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < TG_KEYS / 8; ++kk)  // p big . tV big
      wgmma_tf32_m64n64k8_rs(tacc, pb[kk], desc_kmajor_sw128(st + TG_TVB) + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(tacc);
    reg_fence(pb);
    reg_fence(ps);
    reg_fence(hb);
    reg_fence(hs);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += tacc[e];
    release_stage(released, i, TG_STAGES, n_tiles, load);
  }

  // tO = acc - r O, or the range's acc and r (z > 1); rows past t store nothing.
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float r = quad_sum(hsum[h2]);
    if (pos[h2] >= t) continue;
    const size_t row = static_cast<size_t>(bh) * t + pos[h2];
    if (gridDim.z > 1) {
      const size_t at = static_cast<size_t>(blockIdx.z) * gridDim.y * t + row;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(to + at * D + 8 * n + 2 * c) =
            make_float2(acc[4 * n + 2 * h2], acc[4 * n + 2 * h2 + 1]);
      if (c == 0) rpart[at] = r;
      continue;
    }
    const float* orow = o + batch * o_sb + head * o_sh + static_cast<long long>(pos[h2]) * o_st;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 ov = *reinterpret_cast<const float2*>(orow + 8 * n + 2 * c);
      *reinterpret_cast<float2*>(to + row * D + 8 * n + 2 * c) =
          make_float2(acc[4 * n + 2 * h2] - r * ov.x, acc[4 * n + 2 * h2 + 1] - r * ov.y);
    }
  }
}

// The key ranges' sums, added in range order: tO = (acc_0 + acc_1 + ...) -
// (r_0 + r_1 + ...) O, at head dim D. A thread takes 4 columns of one row.
template <int D>
__global__ void __launch_bounds__(256)
tangent_merge_kernel(const float* __restrict__ part, const float* __restrict__ rpart,
                     const float* __restrict__ o, long long o_sb, long long o_sh, long long o_st,
                     float* __restrict__ to, int h, int t, long long rows, int z) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = i / (D / 4);
  if (row >= rows) return;
  const int c4 = 4 * static_cast<int>(i % (D / 4));
  float4 a = *reinterpret_cast<const float4*>(part + row * D + c4);
  float r = rpart[row];
  for (int zz = 1; zz < z; ++zz) {
    const float4 b = *reinterpret_cast<const float4*>(part + (zz * rows + row) * D + c4);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
    r += rpart[zz * rows + row];
  }
  const long long bh = row / t, pos = row % t;
  const float4 ov = *reinterpret_cast<const float4*>(o + (bh / h) * o_sb + (bh % h) * o_sh +
                                                     pos * o_st + c4);
  *reinterpret_cast<float4*>(to + row * D + c4) =
      make_float4(a.x - r * ov.x, a.y - r * ov.y, a.z - r * ov.z, a.w - r * ov.w);
}

// ---------------------------------------------------------------------------
// B10 exact at head dim 128: both warpgroups on one block's 64 rows
// ---------------------------------------------------------------------------
//
// At 128 the layout above doubles past what an SM holds: Q big, Q small and
// tQ big as fragments would take 192 registers beside tO's 64, and a stage
// 128 KB. So a block holds 64 q rows, shared by its two warpgroups, and
// warpgroup w takes keys 32 j + 16 w .. + 15 of every 32-key tile j of the
// range: each product runs once. Q big sits in registers as the A fragments
// of its 16 k-steps (64 registers); Q small, tQ big and tQ small sit in
// shared memory once for both warpgroups (96 KB; their products SS). Each
// warpgroup streams its keys through a ring of its own, refilled by its
// first thread: a K part (K big, K small, tK big, tK small: [16 keys x 128
// dims], 32 KB) and a V part (V^T, tV^T big and small: [128 dims x 16 keys],
// rows of 64 bytes in the 64-byte swizzle, 32 KB). The next K part loads
// under the tile's h V + p tV, the next V part under the next tile's S and
// tS. A tile: S and tS (144 wgmma m64n16k8, one group), p and h split into
// TF32 A fragments, then h V + p tV as four 32-dim quarters, each 12 wgmma
// m64n32k8 into a fresh accumulator added to its quarter of acc (64
// registers) once done (B1 fp32's drain at 128, F32Geom<128>, in quarters:
// halves spilled at 255 registers). At the end warpgroup 1
// hands its acc and r to warpgroup 0 through its own ring, and warpgroup 0
// adds them to its own (a fixed order: bit-repeatable) and writes tO = acc -
// r O, or, with the keys split (z > 1), the range's acc and r for the merge.
constexpr int TW_THREADS = 256;             // two warpgroups
constexpr int TW_ROWS = 64;                 // q rows a block, shared by both warpgroups
constexpr int TW_KEYS = 16;                 // keys a warpgroup takes of each 32-key tile
constexpr int TW_QBLK = 64 * 128;           // a [64 rows x 32 dims] f32 block (128-byte rows)
constexpr int TW_KBLK = TW_KEYS * 128;      // a [16 keys x 32 dims] f32 block
constexpr int TW_KOP = 4 * TW_KBLK;         // an operand of a K part: 128 dims
constexpr int TW_VOP = 128 * TW_KEYS * 4;   // an operand of a V part: [128 dims x 16 keys]
constexpr int TW_PART = 4 * TW_KOP;         // a K part or a V part
constexpr int TW_OFF_TQB = 4 * TW_QBLK;     // Q small at 0, then tQ big and tQ small
constexpr int TW_OFF_TQS = 8 * TW_QBLK;
constexpr int TW_OFF_RING = 12 * TW_QBLK;   // warpgroup w's K part, then its V part
constexpr int TW_OFF_BAR = TW_OFF_RING + 4 * TW_PART;
constexpr int TW_SMEM = TW_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
static_assert(TW_PART == 4 * TW_VOP, "a V part holds as many bytes as a K part");
static_assert(TW_SMEM <= 232448, "a block's shared memory fits an H100 SM");

__global__ void __launch_bounds__(TW_THREADS, 1)
jvp_tangent_tf32_128(const __grid_constant__ CUtensorMap kb_map,    // [bh, s, 128] K big
                     const __grid_constant__ CUtensorMap ks_map,    // K small
                     const __grid_constant__ CUtensorMap tkb_map,   // tK big
                     const __grid_constant__ CUtensorMap tks_map,   // tK small
                     const __grid_constant__ CUtensorMap vb_map,    // [bh, 128, s8] V^T big
                     const __grid_constant__ CUtensorMap vs_map,    // V^T small
                     const __grid_constant__ CUtensorMap tvb_map,   // tV^T big
                     const __grid_constant__ CUtensorMap tvs_map,   // tV^T small
                     const float* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
                     const float* __restrict__ tq, long long tq_sb, long long tq_sh,
                     long long tq_st, const float* __restrict__ o, long long o_sb, long long o_sh,
                     long long o_st, const float* __restrict__ lse, long long l_sb,
                     long long l_sh, long long l_st,
                     float* __restrict__ to,     // [bh, t, 128], or with z > 1 the ranges' acc
                     float* __restrict__ rpart,  // [z, bh, t] the ranges' r (z > 1)
                     int h, int t, int s, int causal, int per, float sm_scale, float qk_scale) {
  constexpr int D = 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + TW_OFF_BAR;

  const int tid = threadIdx.x;
  const int wg = tid / 128, ltid = tid % 128;
  const int bh = blockIdx.y, batch = bh / h, head = bh % h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TW_ROWS;  // the last rows (most tiles) first
  const int kv_hi = causal ? min(s, min(t, q0 + TW_ROWS)) : s;
  const int j0 = blockIdx.z * per;
  const int j1 = min(j0 + per, (kv_hi + 31) / 32);
  const int n_tiles = max(j1 - j0, 0);

  if (tid == 0) {  // each warpgroup's K and V parts: one "full" barrier each
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t kpart = base + TW_OFF_RING + 2 * wg * TW_PART, vpart = kpart + TW_PART;
  const uint32_t kfull = bars + 16 * wg, vfull = kfull + 8;
  // This warpgroup's keys of tile j0 + i; a half wholly past s (masked
  // whole) loads keys 0 .. instead, so that no box lies wholly outside.
  auto key_of = [&](int i) {
    const int key0 = (j0 + i) * 32 + TW_KEYS * wg;
    return key0 < s ? key0 : 0;
  };
  // (the destinations opaque to the compiler a call, as the descriptors below)
  auto load_k = [&](int i) {
    const int key0 = key_of(i);
    uint32_t dst;
    asm volatile("mov.b32 %0, %1;" : "=r"(dst) : "r"(kpart));
    mbar_expect_tx(kfull, TW_PART);
#pragma unroll
    for (int blk = 0; blk < D / 32; ++blk) {
      tma_load_3d(dst + blk * TW_KBLK, &kb_map, kfull, 32 * blk, key0, bh);
      tma_load_3d(dst + TW_KOP + blk * TW_KBLK, &ks_map, kfull, 32 * blk, key0, bh);
      tma_load_3d(dst + 2 * TW_KOP + blk * TW_KBLK, &tkb_map, kfull, 32 * blk, key0, bh);
      tma_load_3d(dst + 3 * TW_KOP + blk * TW_KBLK, &tks_map, kfull, 32 * blk, key0, bh);
    }
  };
  auto load_v = [&](int i) {
    const int key0 = key_of(i);
    uint32_t dst;
    asm volatile("mov.b32 %0, %1;" : "=r"(dst) : "r"(vpart));
    mbar_expect_tx(vfull, TW_PART);
    tma_load_3d(dst, &vb_map, vfull, key0, 0, bh);
    tma_load_3d(dst + TW_VOP, &vs_map, vfull, key0, 0, bh);
    tma_load_3d(dst + 2 * TW_VOP, &tvb_map, vfull, key0, 0, bh);
    tma_load_3d(dst + 3 * TW_VOP, &tvs_map, vfull, key0, 0, bh);
  };
  const bool leader = ltid == 0;
  if (leader && n_tiles > 0) {
    load_k(0);
    load_v(0);
  }

  const int warp = ltid / 32;
  const int lane = tid % 32;
  const int c = lane % 4;
  const int ra = 16 * warp + lane / 4;  // this thread's rows ra, ra + 8 of the block's 64
  int pos[2];
  float lse_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    pos[h2] = q0 + ra + 8 * h2;
    lse_r[h2] = pos[h2] < t ? lse[batch * l_sb + head * l_sh + pos[h2] * l_st] : 0.f;
  }

  // Q big (f32 through Q's strides; rows past t are 0): the A fragments of
  // the 16 k-steps, every load issued before the first split.
  uint32_t qb[D / 8][4];
  {
    float x[2][D / 4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float* row = q + batch * q_sb + head * q_sh + static_cast<long long>(pos[h2]) * q_st;
#pragma unroll
      for (int i = 0; i < D / 4; ++i)  // head dim 8 (i / 2) + c + 4 (i % 2)
        x[h2][i] = pos[h2] < t ? row[8 * (i / 2) + c + 4 * (i % 2)] : 0.f;
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int i = 0; i < D / 4; ++i) qb[i / 2][h2 + 2 * (i % 2)] = __float_as_uint(tf32_big(x[h2][i]));
  }
  // Q small, tQ big and tQ small K-major into shared memory by all 256
  // threads (128-byte swizzle: 16-byte chunk ch of row r at ch ^ (r & 7)),
  // a float4 of each row a thread and pass.
  {
    constexpr int PASSES = TW_ROWS * (D / 4) / TW_THREADS;
    float4 xq[PASSES], xt[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int idx = tid + TW_THREADS * i, r = idx / (D / 4), ch = idx % (D / 4);
      xq[i] = xt[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < t) {
        const long long at = static_cast<long long>(q0 + r);
        xq[i] = *reinterpret_cast<const float4*>(q + batch * q_sb + head * q_sh + at * q_st + 4 * ch);
        xt[i] = *reinterpret_cast<const float4*>(tq + batch * tq_sb + head * tq_sh + at * tq_st +
                                                 4 * ch);
      }
    }
    float* qs_s = reinterpret_cast<float*>(smem);
    float* tqb_s = reinterpret_cast<float*>(smem + TW_OFF_TQB);
    float* tqs_s = reinterpret_cast<float*>(smem + TW_OFF_TQS);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int idx = tid + TW_THREADS * i, r = idx / (D / 4), ch = idx % (D / 4);
      const int at = (ch / 8) * (TW_QBLK / 4) + r * 32 + (((ch % 8) ^ (r & 7)) << 2);
      const float a[4] = {xq[i].x, xq[i].y, xq[i].z, xq[i].w};
      const float b[4] = {xt[i].x, xt[i].y, xt[i].z, xt[i].w};
      float qs4[4], tb4[4], ts4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qs4[e] = a[e] - tf32_big(a[e]);
        tb4[e] = tf32_big(b[e]);
        ts4[e] = b[e] - tb4[e];
      }
      *reinterpret_cast<float4*>(qs_s + at) = make_float4(qs4[0], qs4[1], qs4[2], qs4[3]);
      *reinterpret_cast<float4*>(tqb_s + at) = make_float4(tb4[0], tb4[1], tb4[2], tb4[3]);
      *reinterpret_cast<float4*>(tqs_s + at) = make_float4(ts4[0], ts4[1], ts4[2], ts4[3]);
    }
  }
  fence_proxy_async();  // Q small, tQ big and small, for wgmma
  __syncthreads();

  float acc[2][32], hsum[2] = {0.f, 0.f};  // acc[hf]: head dims 64 hf .. 64 hf + 63
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[hf][e] = 0.f;
  uint32_t pb[2][4], ps[2][4], hb[2][4], hs[2][4];  // p, h big and small: the A of h V, p tV

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (j0 + i) * 32 + TW_KEYS * wg;
    // The shared addresses, opaque to the compiler a tile: the descriptors
    // (loop-invariant here, unlike a ring's) are rebuilt from them, not
    // hoisted out of the loop into registers (spilled at 255 registers).
    uint32_t qs_base, kp, vp;
    asm volatile("mov.b32 %0, %1;" : "=r"(qs_base) : "r"(base));
    asm volatile("mov.b32 %0, %1;" : "=r"(kp) : "r"(kpart));
    asm volatile("mov.b32 %0, %1;" : "=r"(vp) : "r"(vpart));
    const uint32_t tqb_base = qs_base + TW_OFF_TQB, tqs_base = qs_base + TW_OFF_TQS;
    float sacc[8], tsacc[8];
    mbar_wait(kfull, i & 1);
    // S = Q K^T and tS = tQ K^T + Q tK^T, the small terms first, the
    // big-big terms last: 144 products in one group.
    wgmma_fence();
    wgmma_tf32_m64n16k8_rs_zero(sacc, qb[0], desc_tf32(kp + TW_KOP, 0, TW_KBLK));
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)  // Q big . K small
      wgmma_tf32_m64n16k8_rs(sacc, qb[kk], desc_tf32(kp + TW_KOP, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . K big
      wgmma_tf32_m64n16k8_ss(sacc, desc_tf32(qs_base, kk, TW_QBLK), desc_tf32(kp, kk, TW_KBLK),
                             1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . K big
      wgmma_tf32_m64n16k8_rs(sacc, qb[kk], desc_tf32(kp, kk, TW_KBLK), 1);
    wgmma_tf32_m64n16k8_rs_zero(tsacc, qb[0], desc_tf32(kp + 3 * TW_KOP, 0, TW_KBLK));
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)  // Q big . tK small
      wgmma_tf32_m64n16k8_rs(tsacc, qb[kk], desc_tf32(kp + 3 * TW_KOP, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // tQ big . K small
      wgmma_tf32_m64n16k8_ss(tsacc, desc_tf32(tqb_base, kk, TW_QBLK),
                             desc_tf32(kp + TW_KOP, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // tQ small . K big
      wgmma_tf32_m64n16k8_ss(tsacc, desc_tf32(tqs_base, kk, TW_QBLK),
                             desc_tf32(kp, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . tK big
      wgmma_tf32_m64n16k8_ss(tsacc, desc_tf32(qs_base, kk, TW_QBLK),
                             desc_tf32(kp + 2 * TW_KOP, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // tQ big . K big
      wgmma_tf32_m64n16k8_ss(tsacc, desc_tf32(tqb_base, kk, TW_QBLK),
                             desc_tf32(kp, kk, TW_KBLK), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . tK big
      wgmma_tf32_m64n16k8_rs(tsacc, qb[kk], desc_tf32(kp + 2 * TW_KOP, kk, TW_KBLK), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(tsacc);
    named_barrier(1 + wg, 128);  // the warpgroup reads this K part no more
    if (leader && i + 1 < n_tiles) load_k(i + 1);
    if (k0 + TW_KEYS > s || (causal && k0 + TW_KEYS - 1 > q0))
      tangent_terms<true>(sacc, tsacc, pb, ps, hb, hs, hsum, lse_r, pos, k0, 2 * c, s, causal,
                          sm_scale, qk_scale);
    else
      tangent_terms<false>(sacc, tsacc, pb, ps, hb, hs, hsum, lse_r, pos, k0, 2 * c, s, causal,
                           sm_scale, qk_scale);
    mbar_wait(vfull, i & 1);
    // The tile's h V + p tV a 32-dim quarter at a time (a 64-dim half's
    // fresh accumulator spilled at 255 registers): 12 products into a fresh
    // accumulator, the big-big terms last, then added to its quarter of acc
    // in f32 (see the 64-dim kernel). Quarter qq holds acc[qq / 2]'s
    // elements 16 (qq % 2) .. + 15.
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const uint32_t vq = vp + qq * 32 * (TW_KEYS * 4);  // V^T rows (head dims) 32 qq ..
      float hpv[16];
      reg_fence(pb);
      reg_fence(ps);
      reg_fence(hb);
      reg_fence(hs);
      wgmma_fence();
      wgmma_tf32_m64n32k8_rs_zero(hpv, hs[0], desc_kmajor_sw64(vq));
      wgmma_tf32_m64n32k8_rs(hpv, hs[1], desc_kmajor_sw64(vq) + 2, 1);  // h small . V big
#pragma unroll
      for (int kk = 0; kk < TW_KEYS / 8; ++kk)  // h big . V small
        wgmma_tf32_m64n32k8_rs(hpv, hb[kk], desc_kmajor_sw64(vq + TW_VOP) + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < TW_KEYS / 8; ++kk)  // p small . tV big
        wgmma_tf32_m64n32k8_rs(hpv, ps[kk], desc_kmajor_sw64(vq + 2 * TW_VOP) + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < TW_KEYS / 8; ++kk)  // p big . tV small
        wgmma_tf32_m64n32k8_rs(hpv, pb[kk], desc_kmajor_sw64(vq + 3 * TW_VOP) + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < TW_KEYS / 8; ++kk)  // h big . V big
        wgmma_tf32_m64n32k8_rs(hpv, hb[kk], desc_kmajor_sw64(vq) + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < TW_KEYS / 8; ++kk)  // p big . tV big
        wgmma_tf32_m64n32k8_rs(hpv, pb[kk], desc_kmajor_sw64(vq + 2 * TW_VOP) + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(hpv);
      reg_fence(pb);
      reg_fence(ps);
      reg_fence(hb);
      reg_fence(hs);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[qq / 2][16 * (qq % 2) + e] += hpv[e];
    }
    named_barrier(1 + wg, 128);  // the warpgroup reads this V part no more
    if (leader && i + 1 < n_tiles) load_v(i + 1);
  }

  // Warpgroup 1's acc and r (its thread's partial) to warpgroup 0 through
  // warpgroup 1's ring, which no load fills any more; warpgroup 0 adds them
  // to its own.
  float* xbuf = reinterpret_cast<float*>(smem + TW_OFF_RING + 2 * TW_PART);
  if (wg == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) xbuf[(32 * hf + e) * 128 + ltid] = acc[hf][e];
    xbuf[64 * 128 + ltid] = hsum[0];
    xbuf[65 * 128 + ltid] = hsum[1];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[hf][e] += xbuf[(32 * hf + e) * 128 + ltid];
  hsum[0] += xbuf[64 * 128 + ltid];
  hsum[1] += xbuf[65 * 128 + ltid];

  // tO = acc - r O, or the range's acc and r (z > 1); rows past t store nothing.
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float r = quad_sum(hsum[h2]);
    if (pos[h2] >= t) continue;
    const size_t row = static_cast<size_t>(bh) * t + pos[h2];
    if (gridDim.z > 1) {
      const size_t at = static_cast<size_t>(blockIdx.z) * gridDim.y * t + row;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(to + at * D + 64 * hf + 8 * n + 2 * c) =
              make_float2(acc[hf][4 * n + 2 * h2], acc[hf][4 * n + 2 * h2 + 1]);
      if (c == 0) rpart[at] = r;
      continue;
    }
    const float* orow = o + batch * o_sb + head * o_sh + static_cast<long long>(pos[h2]) * o_st;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * hf + 8 * n + 2 * c;
        const float2 ov = *reinterpret_cast<const float2*>(orow + col);
        *reinterpret_cast<float2*>(to + row * D + col) =
            make_float2(acc[hf][4 * n + 2 * h2] - r * ov.x, acc[hf][4 * n + 2 * h2 + 1] - r * ov.y);
      }
  }
}

// B10 fast's shared bytes at head dim d: the block's Q and tQ and the
// streamed K, tK, V and tV, padded bf16 rows.
__host__ __device__ constexpr int mma_smem(int d) {
  return (2 * BM + 4 * BT) * srow(d) * static_cast<int>(sizeof(bf16));
}

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

// Fast mode's launches at head dim HD: the maps, the shared-memory attribute
// (once an instance) and the kernels.
template <int HD>
int fwd_prep(const FwdPrepArgs& args, int b, int h, int s, cudaStream_t stream) {
  const dim3 grid((s + fwd_prep_rows(HD) - 1) / fwd_prep_rows(HD), b * h, 4);
  jvp_fwd_prep_kernel<HD><<<grid, 256, 0, stream>>>(args, h, s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd_fast(const void* q, const long long (&q_st)[3], const void* tq, const long long (&tq_st)[3],
             const void* k, const void* v, const void* tk, const void* tv, void* o, void* to,
             void* lse, void* mu, int b, int h, int t, int s, int causal, float sm_scale,
             float qk_scale, cudaStream_t stream) {
  using G = JfGeom<HD>;
  CUtensorMap k_map, v_map, tk_map, tv_map;
  if (!panel_map(&k_map, k, b * h, s, HD, G::KEYS) || !panel_map(&v_map, v, b * h, s, HD, G::KEYS) ||
      !panel_map(&tk_map, tk, b * h, s, HD, G::KEYS) ||
      !panel_map(&tv_map, tv, b * h, s, HD, G::KEYS))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(jvp_fwd_wgmma<HD>, G::SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (t + JF_ROWS - 1) / JF_ROWS);
  jvp_fwd_wgmma<HD><<<grid, JF_THREADS, G::SMEM, stream>>>(
      k_map, v_map, tk_map, tv_map, static_cast<const float*>(q), q_st[0], q_st[1], q_st[2],
      static_cast<const float*>(tq), tq_st[0], tq_st[1], tq_st[2], static_cast<float*>(o),
      static_cast<float*>(to), static_cast<float*>(lse), static_cast<float*>(mu), h, t, s, causal,
      sm_scale, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_prep(const PrepArgs& args, void* rows_out, int bh, int t, int s, int ld,
             cudaStream_t stream) {
  const dim3 grid(((t > s ? t : s) + prep_rows(HD) - 1) / prep_rows(HD), bh, 9);
  jvp_bwd_prep_kernel<HD><<<grid, 256, 0, stream>>>(args, static_cast<float*>(rows_out), bh, t, s,
                                                    ld);
  return static_cast<int>(cudaGetLastError());
}

// The q-side and key-side maps of B11 (boxes of JD_ROWS and 64 rows) or B12
// (JQ_ROWS and JQ_KEYS rows), 64-dim panels: q, tq, dO, dtO, then k, tk, v, tv.
bool bwd_maps(CUtensorMap (&maps)[8], const void* const (&ops)[8], int bh, int t, int s, int hd,
              int q_rows, int k_rows) {
  for (int i = 0; i < 8; ++i)
    if (!panel_map(&maps[i], ops[i], bh, i < 4 ? t : s, hd, i < 4 ? q_rows : k_rows))
      return false;
  return true;
}

template <int HD, int PART>
int dkv_part(const CUtensorMap (&m)[8], const CUtensorMap& row_map, void* dk, void* dv, void* dtk,
             void* dtv, int bh, int n_kt, int t, int s, int causal, float sm_scale,
             float qk_scale, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err = allow_smem(jvp_dkv_wgmma<HD, PART>, JdGeom<HD>::SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  jvp_dkv_wgmma<HD, PART><<<dim3(bh, n_kt), JD_THREADS, JdGeom<HD>::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], row_map, static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dtk), static_cast<float*>(dtv), t, s, causal,
      sm_scale, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// B11 fast at HD: one launch of all four outputs at 64; at 128 a launch of
// dV and dtV, then one of dK and dtK.
template <int HD>
int dkv_fast(const void* const (&ops)[8], const void* rows, void* dk, void* dv, void* dtk,
             void* dtv, int bh, int t, int s, int ld, int causal, float sm_scale, float qk_scale,
             cudaStream_t stream) {
  CUtensorMap maps[8], row_map;
  const long long rb = 4LL * ld;
  const long long row_stride[3] = {rb, rb, rb * bh};
  if (!bwd_maps(maps, ops, bh, t, s, HD, JD_ROWS, 64) ||
      !tensor_map_4d(&row_map, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh, 1, t, row_stride, 1,
                     JD_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  const int n_kt = (s + JD_KEYS - 1) / JD_KEYS;
  if constexpr (HD == 64) {
    return dkv_part<64, DKV_ALL>(maps, row_map, dk, dv, dtk, dtv, bh, n_kt, t, s, causal,
                                 sm_scale, qk_scale, stream);
  } else {
    const int err = dkv_part<HD, DKV_V>(maps, row_map, dk, dv, dtk, dtv, bh, n_kt, t, s, causal,
                                        sm_scale, qk_scale, stream);
    if (err) return err;
    return dkv_part<HD, DKV_K>(maps, row_map, dk, dv, dtk, dtv, bh, n_kt, t, s, causal,
                               sm_scale, qk_scale, stream);
  }
}

template <int HD>
int dq_fast(const void* const (&ops)[8], const void* rows, void* dq, void* dtq, int bh, int t,
            int s, int ld, int causal, float sm_scale, float qk_scale, cudaStream_t stream) {
  CUtensorMap m[8];
  if (!bwd_maps(m, ops, bh, t, s, HD, JQ_ROWS, JQ_KEYS))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(jvp_dq_wgmma<HD>, JqGeom<HD>::SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  jvp_dq_wgmma<HD><<<dim3(bh, (t + JQ_ROWS - 1) / JQ_ROWS), JQ_THREADS, JqGeom<HD>::SMEM,
                     stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                               static_cast<const float*>(rows), static_cast<float*>(dq),
                               static_cast<float*>(dtq), t, s, ld, causal, sm_scale, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The exact entries: every tensor is f32 and contiguous: q-side [bh, t, d],
// kv-side [bh, s, d], row terms [bh, t]; d 64 or 128, each its own instance.

// Shared bytes one block of the exact FFMA kernels asks for at head dim d
// (ops/jvp_tiling.py's exact_shared_bytes mirrors them): B9 (kernel 0), B11
// (1) or B12 (2); -1 for another kernel or d.
extern "C" int qa_jvp_exact_smem_bytes(int kernel, int d) {
  if (d != 64 && d != 128) return -1;
  const int tiles[3] = {6 * ftile(d) + 2 * PTILE, 8 * ftile(d) + 4 * PTILE + 4 * T,
                        8 * ftile(d) + 2 * PTILE};
  return kernel >= 0 && kernel < 3 ? tiles[kernel] * static_cast<int>(sizeof(float)) : -1;
}

// B9 exact: O, tO [bh, t, d]; lse, mu [bh, t] (fast mode: qa_jvp_fwd_bf16).
extern "C" int qa_jvp_fwd(const void* q, const void* k, const void* v, const void* tq,
                          const void* tk, const void* tv, void* o, void* to, void* lse, void* mu,
                          int bh, int t, int s, int causal, int fast, int d, float sm_scale,
                          float qk_scale, void* stream) {
  if (fast || (d != 64 && d != 128)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(d == 64 ? jvp_fwd_kernel<64> : jvp_fwd_kernel<128>, dim3((t + T - 1) / T, bh),
                THREADS, qa_jvp_exact_smem_bytes(0, d), stream, cf(q), cf(k), cf(v), cf(tq),
                cf(tk), cf(tv), static_cast<float*>(o), static_cast<float*>(to),
                static_cast<float*>(lse), static_cast<float*>(mu), t, s, causal, sm_scale,
                qk_scale);
}

// Shared bytes one B9 fast block asks for at head dim d, 64 or 128
// (ops/jvp_tiling.py mirrors it); -1 for another d.
extern "C" int qa_jvp_fwd_smem_bytes(int d) {
  return d == 64 ? JfGeom<64>::SMEM : d == 128 ? JfGeom<128>::SMEM : -1;
}

// B9 fast's K-side prep: src = k, v, tk, tv [b, h, s, d] f32, d 64 or 128,
// with strides[4][3] (batch, head, token, in elements; rows contiguous;
// pointers and strides 16-byte aligned) -> dst, the same four as contiguous
// bf16 [b * h, s, d], in one launch.
extern "C" int qa_jvp_fwd_prep(const void* const* src, const long long* strides,
                               void* const* dst, int b, int h, int s, int d, void* stream) {
  if (b < 1 || h < 1 || static_cast<long long>(b) * h > 65535 || s < 1 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdPrepArgs args;
  for (int i = 0; i < 4; ++i) {
    if (!aligned16(src[i]) || !aligned16(dst[i])) return static_cast<int>(cudaErrorInvalidValue);
    args.src[i] = static_cast<const float*>(src[i]);
    args.dst[i] = static_cast<__nv_bfloat16*>(dst[i]);
    for (int j = 0; j < 3; ++j) {
      if (strides[3 * i + j] % 4) return static_cast<int>(cudaErrorInvalidValue);
      args.stride[i][j] = strides[3 * i + j];
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? fwd_prep<64>(args, b, h, s, st) : fwd_prep<128>(args, b, h, s, st);
}

// B9 fast: q, tq [b, h, t, d] f32, d 64 or 128 (strides in elements, rows
// contiguous; pointers and strides 16-byte aligned) and the prep's k, v,
// tk, tv (bf16, contiguous [b * h, s, d]) -> O, tO [b * h, t, d] and lse, mu
// [b * h, t] f32.
extern "C" int qa_jvp_fwd_bf16(const void* q, long long q_sb, long long q_sh, long long q_st,
                               const void* tq, long long tq_sb, long long tq_sh, long long tq_st,
                               const void* k, const void* v, const void* tk, const void* tv,
                               void* o, void* to, void* lse, void* mu, int b, int h, int t, int s,
                               int causal, int d, float sm_scale, float qk_scale, void* stream) {
  const int n_qt = (t + JF_ROWS - 1) / JF_ROWS;
  const long long qs[3] = {q_sb, q_sh, q_st}, tqs[3] = {tq_sb, tq_sh, tq_st};
  bool strided16 = aligned16(q) && aligned16(tq);
  for (int i = 0; i < 3; ++i) strided16 = strided16 && qs[i] % 4 == 0 && tqs[i] % 4 == 0;
  if (b < 1 || h < 1 || static_cast<long long>(b) * h > 65535 || t < 1 || s < 1 ||
      n_qt > 65535 || !strided16 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* run = d == 64 ? &fwd_fast<64> : &fwd_fast<128>;
  return run(q, qs, tq, tqs, k, v, tk, tv, o, to, lse, mu, b, h, t, s, causal, sm_scale, qk_scale,
             static_cast<cudaStream_t>(stream));
}

// B10 fast: tO [bh, t, d] from O [bh, t, d] and lse [bh, t], all contiguous
// f32, d 64 or 128 (exact mode: qa_jvp_tangent_tf32).
extern "C" int qa_jvp_tangent(const void* q, const void* k, const void* v, const void* tq,
                              const void* tk, const void* tv, const void* o, const void* lse,
                              void* to, int bh, int t, int s, int causal, int fast, int d,
                              float sm_scale, float qk_scale, void* stream) {
  if (!fast || (d != 64 && d != 128)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(d == 64 ? jvp_tangent_mma<64> : jvp_tangent_mma<128>, dim3((t + BM - 1) / BM, bh),
                MMA_THREADS, mma_smem(d), stream, cf(q), cf(k), cf(v), cf(tq), cf(tk), cf(tv),
                cf(o), cf(lse), static_cast<float*>(to), t, s, causal, sm_scale, qk_scale);
}

// Shared bytes one B10 fast block asks for at head dim d, 64 or 128
// (ops/jvp_tiling.py mirrors it); -1 for another d.
extern "C" int qa_jvp_tangent_fast_smem_bytes(int d) {
  return d == 64 || d == 128 ? mma_smem(d) : -1;
}

// B10 exact's prep, one launch: k, v, tk, tv [b, h, s, d] f32, d 64 or 128
// (strides in elements, rows contiguous; pointers and strides 16-byte
// aligned) -> out[0 .. 3] K big, K small [bh, s, d], V^T big, V^T small
// [bh, d, s8] and out[4 .. 7] the same of tK, tV (s8 = s rounded up to 8;
// 16-byte aligned).
extern "C" int qa_jvp_tangent_prep(const void* const* kv, const long long* strides,
                                   void* const* out, int b, int h, int s, int d, void* stream) {
  if (b < 1 || h < 1 || static_cast<long long>(b) * h > 65535 || s < 1 || s > (1 << 27) ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a;
  for (int z = 0; z < 2; ++z) {
    a.k[z] = static_cast<const float*>(kv[2 * z]);
    a.v[z] = static_cast<const float*>(kv[2 * z + 1]);
    for (int i = 0; i < 3; ++i) {
      a.k_st[z][i] = strides[6 * z + i];
      a.v_st[z][i] = strides[6 * z + 3 + i];
    }
    if (!aligned16(a.k[z]) || !aligned16(a.v[z]) || !strides16(a.k_st[z]) ||
        !strides16(a.v_st[z]))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 4; ++i) {
      a.out[z][i] = static_cast<float*>(out[4 * z + i]);
      if (!aligned16(a.out[z][i])) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int s8 = (s + 7) / 8 * 8;
  const dim3 grid((s + SPLIT_KEYS - 1) / SPLIT_KEYS, b * h, 2);
  auto* kernel = d == 64 ? tangent_prep_kernel<64> : tangent_prep_kernel<128>;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, h, s, s8);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// B10 exact at head dim 128 (jvp_tangent_tf32_128): the maps, the
// shared-memory attribute once, the kernel and, with z > 1, the merge.
int tangent_tf32_128(const void* q, const long long* q_st, const void* tq, const long long* tq_st,
                     const void* o, const long long* o_st, const void* lse, const long long* l_st,
                     const void* const* prep, void* to, void* part, int h, long long bh, int t,
                     int s, int causal, int z, int per, float sm_scale, float qk_scale,
                     cudaStream_t st) {
  constexpr int D = 128;
  bool strided16 = aligned16(q) && aligned16(tq);
  for (int i = 0; i < 3; ++i) strided16 = strided16 && q_st[i] % 4 == 0 && tq_st[i] % 4 == 0;
  if (!strided16) return static_cast<int>(cudaErrorInvalidValue);
  const int s8 = (s + 7) / 8 * 8;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap maps[8];  // K big, K small, tK big, tK small, then V^T big, small, tV^T big, small
  const int order[8] = {0, 1, 4, 5, 2, 3, 6, 7};  // the prep's: K, V pair then tK, tV pair
  for (int i = 0; i < 8; ++i) {
    const bool kside = i < 4;
    if (!(kside ? tensor_map_3d(&maps[i], prep[order[i]], f32, 4, bh, s, D, TW_KEYS, 32,
                                CU_TENSOR_MAP_SWIZZLE_128B)
                : tensor_map_3d(&maps[i], prep[order[i]], f32, 4, bh, D, s8, D, TW_KEYS,
                                CU_TENSOR_MAP_SWIZZLE_64B)))
      return static_cast<int>(cudaErrorNotSupported);
  }
  static bool configured = false;
  cudaError_t err = allow_smem(jvp_tangent_tf32_128, TW_SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sums = z > 1 ? static_cast<float*>(part) : static_cast<float*>(to);
  float* rsums = z > 1 ? sums + static_cast<size_t>(z) * bh * t * D : nullptr;
  const int n_qb = (t + TW_ROWS - 1) / TW_ROWS;
  jvp_tangent_tf32_128<<<dim3(n_qb, bh, z), TW_THREADS, TW_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], cf(q), q_st[0],
      q_st[1], q_st[2], cf(tq), tq_st[0], tq_st[1], tq_st[2], cf(o), o_st[0], o_st[1], o_st[2],
      cf(lse), l_st[0], l_st[1], l_st[2], sums, rsums, h, t, s, causal, per, sm_scale, qk_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return static_cast<int>(err);
  const long long rows = bh * t;
  tangent_merge_kernel<D><<<static_cast<unsigned>((rows * (D / 4) + 255) / 256), 256, 0, st>>>(
      sums, rsums, cf(o), o_st[0], o_st[1], o_st[2], static_cast<float*>(to), h, t, rows, z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B10 exact: tO [bh, t, d] f32 from q, tq, o [b, h, t, d] and lse [b, h, t]
// (f32, strides in elements; q, tq, o rows contiguous and 8-byte aligned; at
// d = 128 q and tq 16-byte aligned with strides of whole 16 bytes) and the
// prep's eight operands, d 64 or 128. The keys are split into z ranges of
// `per` 32-key tiles (z * per covers s); with z > 1 `part` holds z * (bh *
// t * (d + 1)) floats for the ranges' sums, which a second launch adds in
// order.
extern "C" int qa_jvp_tangent_tf32(const void* q, const long long* q_st, const void* tq,
                                   const long long* tq_st, const void* o, const long long* o_st,
                                   const void* lse, const long long* l_st,
                                   const void* const* prep, void* to, void* part, int b, int h,
                                   int t, int s, int causal, int z, int per, int d,
                                   float sm_scale, float qk_scale, void* stream) {
  constexpr int D = 64;  // the instance below; 128 goes to tangent_tf32_128
  const long long bh = static_cast<long long>(b) * h;
  const int n_qb = (t + TG_ROWS - 1) / TG_ROWS;
  if (b < 1 || h < 1 || bh > 65535 || t < 1 || s < 1 || z < 1 || z > 65535 || per < 1 ||
      static_cast<long long>(z) * per * TG_KEYS < s || (z > 1 && !part) || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 8; ++i)
    if (!aligned16(prep[i])) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 128)
    return tangent_tf32_128(q, q_st, tq, tq_st, o, o_st, lse, l_st, prep, to, part, h, bh, t, s,
                            causal, z, per, sm_scale, qk_scale, static_cast<cudaStream_t>(stream));
  const int s8 = (s + 7) / 8 * 8;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap maps[8];  // K big, K small, tK big, tK small, then V^T big, small, tV^T big, small
  const int order[8] = {0, 1, 4, 5, 2, 3, 6, 7};  // the prep's: K, V pair then tK, tV pair
  for (int i = 0; i < 8; ++i) {
    const bool kside = i < 4;
    if (!(kside ? tensor_map_3d(&maps[i], prep[order[i]], f32, 4, bh, s, D, TG_KEYS, 32, sw)
                : tensor_map_3d(&maps[i], prep[order[i]], f32, 4, bh, D, s8, D, TG_KEYS, sw)))
      return static_cast<int>(cudaErrorNotSupported);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        jvp_tangent_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sums = z > 1 ? static_cast<float*>(part) : static_cast<float*>(to);
  float* rsums = z > 1 ? sums + static_cast<size_t>(z) * bh * t * D : nullptr;
  jvp_tangent_tf32<<<dim3(n_qb, bh, z), TG_THREADS, TG_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], cf(q), q_st[0],
      q_st[1], q_st[2], cf(tq), tq_st[0], tq_st[1], tq_st[2], cf(o), o_st[0], o_st[1], o_st[2],
      cf(lse), l_st[0], l_st[1], l_st[2], sums, rsums, h, t, s, causal, per, sm_scale, qk_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return static_cast<int>(err);
  const long long rows = bh * t;
  tangent_merge_kernel<D><<<static_cast<unsigned>((rows * (D / 4) + 255) / 256), 256, 0, st>>>(
      sums, rsums, cf(o), o_st[0], o_st[1], o_st[2], static_cast<float*>(to), h, t, rows, z);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes one B10 exact block asks for at head dim d, 64 or 128
// (ops/jvp_tiling.py mirrors it); -1 for another d.
extern "C" int qa_jvp_tangent_smem_bytes(int d) {
  return d == 64 ? TG_SMEM : d == 128 ? TW_SMEM : -1;
}

// B11 exact: dK, dV, dtK, dtV [bh, s, d] (fast mode: qa_jvp_bwd_dkv_bf16).
extern "C" int qa_jvp_bwd_dkv(const void* q, const void* k, const void* v, const void* tq,
                              const void* tk, const void* tv, const void* dout, const void* dtout,
                              const void* lse, const void* mu, const void* crow,
                              const void* dhat, void* dk, void* dv, void* dtk, void* dtv, int bh,
                              int t, int s, int causal, int fast, int d, float sm_scale,
                              float qk_scale, void* stream) {
  if (fast || (d != 64 && d != 128)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(d == 64 ? jvp_dkv_kernel<64> : jvp_dkv_kernel<128>, dim3((s + T - 1) / T, bh),
                THREADS, qa_jvp_exact_smem_bytes(1, d), stream, cf(q), cf(k), cf(v),
                cf(tq), cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dtk),
                static_cast<float*>(dtv), t, s, causal, sm_scale, qk_scale);
}

// Shared bytes one B11 fast block asks for at head dim d, 64 or 128
// (ops/jvp_tiling.py mirrors it); -1 for another d.
extern "C" int qa_jvp_bwd_dkv_smem_bytes(int d) {
  return d == 64 ? JdGeom<64>::SMEM : d == 128 ? JdGeom<128>::SMEM : -1;
}

// B11 fast's prep: src = q, k, v, tq, tk, tv, dO, dtO (q-side [bh, t, d],
// kv-side [bh, s, d], d 64 or 128) f32, rows = lse, mu, c, dhat [bh, t] f32,
// all contiguous and 16-byte aligned -> dst (the same eight in bf16) and
// rows_out [4, bh, ld] (ld >= t, a multiple of 4), in one launch.
extern "C" int qa_jvp_bwd_prep(const void* const* src, void* const* dst, const void* const* rows,
                               void* rows_out, int bh, int t, int s, int ld, int d,
                               void* stream) {
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || ld < t || ld % 4 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  PrepArgs args;
  for (int i = 0; i < 8; ++i) {
    if (!aligned16(src[i]) || !aligned16(dst[i])) return static_cast<int>(cudaErrorInvalidValue);
    args.src[i] = static_cast<const float*>(src[i]);
    args.dst[i] = static_cast<__nv_bfloat16*>(dst[i]);
  }
  for (int i = 0; i < 4; ++i) args.rows[i] = static_cast<const float*>(rows[i]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? bwd_prep<64>(args, rows_out, bh, t, s, ld, st)
                 : bwd_prep<128>(args, rows_out, bh, t, s, ld, st);
}

// B11 fast: the prep's q, k, v, tq, tk, tv, dO, dtO (bf16, contiguous; d 64
// or 128) and rows [4, bh, ld] -> dK, dV, dtK, dtV [bh, s, d] f32 (at 128 in
// two launches: dV and dtV, then dK and dtK).
extern "C" int qa_jvp_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* tq,
                                   const void* tk, const void* tv, const void* dout,
                                   const void* dtout, const void* rows, void* dk, void* dv,
                                   void* dtk, void* dtv, int bh, int t, int s, int ld, int causal,
                                   int d, float sm_scale, float qk_scale, void* stream) {
  const int n_kt = (s + JD_KEYS - 1) / JD_KEYS;
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || ld < t || ld % 4 || n_kt > 65535 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const ops[8] = {q, tq, dout, dtout, k, tk, v, tv};
  auto* run = d == 64 ? &dkv_fast<64> : &dkv_fast<128>;
  return run(ops, rows, dk, dv, dtk, dtv, bh, t, s, ld, causal, sm_scale, qk_scale,
             static_cast<cudaStream_t>(stream));
}

// B12 exact: dQ, dtQ [bh, t, d] (fast mode: qa_jvp_bwd_dq_bf16).
extern "C" int qa_jvp_bwd_dq(const void* q, const void* k, const void* v, const void* tq,
                             const void* tk, const void* tv, const void* dout, const void* dtout,
                             const void* lse, const void* mu, const void* crow, const void* dhat,
                             void* dq, void* dtq, int bh, int t, int s, int causal, int fast,
                             int d, float sm_scale, float qk_scale, void* stream) {
  if (fast || (d != 64 && d != 128)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(d == 64 ? jvp_dq_kernel<64> : jvp_dq_kernel<128>, dim3((t + T - 1) / T, bh),
                THREADS, qa_jvp_exact_smem_bytes(2, d), stream, cf(q), cf(k), cf(v), cf(tq),
                cf(tk), cf(tv), cf(dout), cf(dtout), cf(lse), cf(mu), cf(crow), cf(dhat),
                static_cast<float*>(dq), static_cast<float*>(dtq), t, s, causal, sm_scale,
                qk_scale);
}

// Shared bytes one B12 fast block asks for at head dim d, 64 or 128
// (ops/jvp_tiling.py mirrors it); -1 for another d.
extern "C" int qa_jvp_bwd_dq_smem_bytes(int d) {
  return d == 64 ? JqGeom<64>::SMEM : d == 128 ? JqGeom<128>::SMEM : -1;
}

// B12 fast: B11's prep's q, k, v, tq, tk, tv, dO, dtO (bf16, contiguous; d
// 64 or 128) and rows [4, bh, ld] -> dQ, dtQ [bh, t, d] f32.
extern "C" int qa_jvp_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* tq,
                                  const void* tk, const void* tv, const void* dout,
                                  const void* dtout, const void* rows, void* dq, void* dtq, int bh,
                                  int t, int s, int ld, int causal, int d, float sm_scale,
                                  float qk_scale, void* stream) {
  const int n_qt = (t + JQ_ROWS - 1) / JQ_ROWS;
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || ld < t || ld % 4 || n_qt > 65535 ||
      !aligned16(rows) || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const ops[8] = {q, tq, dout, dtout, k, tk, v, tv};
  auto* run = d == 64 ? &dq_fast<64> : &dq_fast<128>;
  return run(ops, rows, dq, dtq, bh, t, s, ld, causal, sm_scale, qk_scale,
             static_cast<cudaStream_t>(stream));
}
