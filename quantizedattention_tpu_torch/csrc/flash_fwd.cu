// Corrected-bf16 flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/flash_fwd.py:_fwd_kernel
// (the Pallas online-softmax forward). Same numerics: Q is pre-scaled by
// sm_scale*log2(e) in f32 and rounded to bf16, K and V are bf16, S = Q K^T
// accumulates in f32, masked logits are MASK_VALUE (causal k <= q plus keys
// past s), the row max carries +EPS_BIAS, P = exp2(S - m) is rounded to bf16
// before BOTH the PV product and the row sum l, and rows with l == 0 give O =
// 0. Outputs O f32 and the exp2-domain lse = m + log2(l).
//
// What bounds it on this card: at (4,16,2048,64), causal, the two products
// over 134 M visible (q, k) pairs are 34.4 GFLOP of bf16, 0.035 ms on the
// tensor cores, against ~25 MB of inputs and outputs (f32 in: 0.040 ms of
// HBM). With head dim 64 the products are short and the softmax between them
// is long: 128 x 128 exponentials a tile and block (1,024 cycles of the SM's
// special-function units) and a few more FMA-pipe instructions an element,
// so the softmax has to overlap the products. At the serving prefill (8,16,
// 256,64) a call is 256 blocks of one or two key tiles: latency (the Q load,
// the first tile's copy, the epilogue) more than throughput.
//
// Design (bf16 mode, flash_fwd_kernel):
//   - One block of two warpgroups (256 threads, so each may hold up to 255
//     registers; a ninth warp would cap them at 168) per (batch * kv head, q
//     tile of bq positions). Its 128 rows hold the kv head's whole GQA group
//     (row r -> q head kv_head * rep + r / bq at position q0 + r % bq, bq =
//     128 / rep rounded down), so each K/V tile is fetched once for all rep q
//     heads; each warpgroup owns 64 rows. The blocks with the most key tiles
//     (the last q tiles) start first.
//   - Q prep is in the kernel: each warpgroup reads its Q rows (f32 or bf16,
//     any strides; every load issued before the first conversion), multiplies
//     by qk_scale in f32, rounds to nearest bf16 (the bits of PyTorch's
//     (q.float() * qk_scale).to(bfloat16)) and writes them K-major with the
//     128-byte swizzle.
//   - KV_STAGES tiles of 128 keys are in flight with TMA (4-D maps over [b,
//     h_kv, s, 64] bf16 with the tensors' own strides, so a [b, s, h_kv, 64]
//     view needs no copy, and keys past s arrive as zeros) on "full"
//     mbarriers. Each warpgroup releases a stage once its PV of that tile is
//     done (a shared counter), and the second to release it refills it at
//     once: no thread waits for the other warpgroup to refill.
//   - Both products on wgmma: S = Q K^T on m64n128k16 with Q and K from shared
//     memory (both K-major), PV on m64n64k16 with the rounded P as the A
//     operand in registers (the S accumulator layout is the A fragment layout)
//     and V as an MN-major B straight from the TMA tile (no transposition).
//     The row sums of the rounded P come from the same A fragments times a
//     ones matrix (wgmma m64n8k16, as B5's) and are rescaled with O.
//   - Software pipeline: tile j's S is issued with tile j - 1's PV (B5's
//     form, csrc/int8_fwd.cu), and tile j's softmax runs while that PV is in
//     flight; the P registers alternate between two sets, two tiles an
//     iteration. S is not issued a tile ahead of the softmax: that needs two
//     S accumulators live (255 registers) and ran slower. Nor do the
//     warpgroups take turns issuing their products (named barriers): that
//     helped the serving shape a little and slowed the longer ones.
//   - Causal blocks stop at their last visible key tile; only the tiles that
//     reach past s or past the block's first position take the mask.
//   - The epilogue stages O / l through shared memory and writes it with
//     16-byte stores; rows past t and dead rows store nothing.
// f32 K and V are cast to bf16 by one launch of kv_to_bf16_kernel before
// the kernel (for both tensors), never in the mainloop: each tile is read by
// up to t / bq blocks.
//
// precision="fp32" (flash_fwd_f32_kernel, entry qa_flash_fwd_f32): the same
// TPU kernel's fp32 mode (flash_fwd.py:255-260, Precision.HIGHEST), the
// primal of attention_jvp and the rCM prepass. Q arrives pre-scaled in f32,
// nothing is rounded, masked P is 0, the row max still carries +EPS_BIAS.
// Bound: fp32 products, 2 over every visible (q, k) pair against the 67
// TFLOP/s of the CUDA cores (the TPU's HIGHEST dots have no tensor-core
// counterpart short of 3xTF32). Design: FFMA in 4x4 register tiles, one
// block of 256 threads per (q head, 64-row q tile) over 64-key tiles (see the
// kernel). GQA reads kv head head / rep. No pipelining yet.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;  // head dim
constexpr float MASK_VALUE = -30000.0f;
constexpr float EPS_BIAS = 1.0f / 256.0f;

// --- bf16 mode: TMA ring + wgmma ---

constexpr int BM = 128;             // rows per block: two warpgroups of 64
constexpr int BN = 128;             // keys per K/V tile
constexpr int KV_STAGES = 3;        // K/V tiles in flight
constexpr int THREADS = 256;        // two warpgroups, 8 warps: up to 255 registers a thread
constexpr int ROW = D * 2;          // bytes of a bf16 row: the 128-byte swizzle's span
constexpr int TILE = BN * ROW;      // bytes of a K or a V tile
constexpr int O_LD = D + 8;         // floats of a staged O row (conflict-free float2 stores)
constexpr int OFF_Q = 0;            // Q [BM, D] bf16
constexpr int OFF_KV = OFF_Q + BM * ROW;  // stage st: K at OFF_KV + 2 st TILE, V after it
constexpr int OFF_O = OFF_KV + KV_STAGES * 2 * TILE;
constexpr int OFF_BAR = OFF_O + BM * O_LD * 4;
constexpr int OFF_ONES = OFF_BAR + 128;  // bf16 ones: the B operand of P's row sums
constexpr int ONES_BYTES = 1024;
constexpr int SMEM_BYTES = OFF_ONES + ONES_BYTES + 1024;  // + slack to align the base to 1024
static_assert(KV_STAGES * (8 + 4) <= 128, "the barriers and release counters fit before the ones");

// One tile's S (f32; Q is pre-scaled, so the logits are in the exp2 domain)
// -> P = bf16(exp2(S - m)) as PV's A fragments (key tiles 2kk and 2kk + 1 of
// 8 keys are k-step kk). Masks where MASK (the tile reaches past s or past
// the block's first position), updates the running max m (+EPS_BIAS) and
// gives each row's alpha. s[4 n + e]: row h = e / 2, key k0 + 8 n + cq + (e
// & 1).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&p)[8][4], float (&m)[2],
                                             float (&alpha)[2], int k0, int cq,
                                             const int (&pos)[2], int s_len, int causal) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i % 4) / 2;
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + cq + (i & 1);
      if (!(col < s_len && (!causal || col <= pos[h]))) s[i] = MASK_VALUE;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float next_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    next_m[h] = fmaxf(m[h], quad_max(mx[h]) + EPS_BIAS);
    alpha[h] = exp2_ftz(m[h] - next_m[h]);  // 0 while m is -inf
    m[h] = next_m[h];
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(exp2_ftz(s[4 * n + 2 * h] - next_m[h]),
                                                      exp2_ftz(s[4 * n + 2 * h + 1] - next_m[h]));
      p[n / 2][(n % 2) * 2 + h] = as_u32(pr);
    }
  }
}

// Eight f32 of a Q row -> bf16(q * qk_scale), packed as 16 bytes.
__device__ __forceinline__ uint4 scale_pack8(const float (&x)[8], float qk_scale) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = as_u32(__floats2bfloat162_rn(__fmul_rn(x[2 * i], qk_scale),
                                        __fmul_rn(x[2 * i + 1], qk_scale)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap k_map,  // [b, h_kv, s, D] bf16, 128B swizzle
                 const __grid_constant__ CUtensorMap v_map,  // the same for V
                 const void* __restrict__ q,  // [b, h, t, D] f32 (q_f32) or bf16, strides in elements
                 long long q_sb, long long q_sh, long long q_st, int q_f32,
                 float* __restrict__ o,    // [b, h, t, D]
                 float* __restrict__ lse,  // [b, h, t]
                 int h_kv, int rep, int t, int s, int bq, int causal, float qk_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int batch = bh / h_kv, kvh = bh % h_kv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // the last q tile (most key tiles) first
  // Causal: keys past the block's last query position below t are never visible.
  const int kv_hi = causal ? min(s, min(t, q0 + bq)) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(full(i), 1);
      reinterpret_cast<int*>(smem + OFF_BAR + 8 * KV_STAGES)[i] = 0;  // releases of a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring by TMA: thread 0 loads tiles 0 .. KV_STAGES - 1; then tile j +
  // KV_STAGES is loaded into tile j's stage by whichever warpgroup releases
  // tile j second (a shared counter a stage), so no thread ever waits to
  // refill and each tile is asked for KV_STAGES - 1 tiles ahead.
  int* released = reinterpret_cast<int*>(smem + OFF_BAR + 8 * KV_STAGES);
  auto load_kv = [&](int j) {
    const int st = j % KV_STAGES;
    mbar_expect_tx(full(st), 2 * TILE);
    const uint32_t dst = base + OFF_KV + st * 2 * TILE;
    tma_load_4d(dst, &k_map, full(st), 0, j * BN, kvh, batch);
    tma_load_4d(dst + TILE, &v_map, full(st), 0, j * BN, kvh, batch);
  };
  if (tid == 0)
    for (int j = 0; j < min(KV_STAGES, n_tiles); ++j) load_kv(j);
  // Once this warpgroup's products of tile j are done: the second release
  // refills the stage (its counter goes back to 0 for the stage's next tile).
  auto release = [&](int j) {
    if (tid % 128 == 0 && atomicAdd(&released[j % KV_STAGES], 1) == 1) {
      atomicExch(&released[j % KV_STAGES], 0);
      if (j + KV_STAGES < n_tiles) {
        fence_proxy_async();
        load_kv(j + KV_STAGES);
      }
    }
  };

  // The consumer warpgroups: wg owns block rows wg * 64 .. wg * 64 + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;  // accumulator column pair
  const int rows = rep * bq;      // live rows of the block (<= BM)

  // This warpgroup's Q rows -> shared: bf16(f32(q) * qk_scale), K-major with
  // the 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)); zeros for
  // dead rows and positions past t. A thread's loads are all issued before
  // it converts (the block's start waits for one load latency, not four).
  // Then the ones that sum each row of P.
  constexpr int Q_PASSES = 64 * (D / 8) / 128;  // 16-byte bf16 chunks a thread writes
  uint4 qraw[Q_PASSES][2];
#pragma unroll
  for (int i = 0; i < Q_PASSES; ++i) {
    const int c = tid % 128 + 128 * i;
    const int r = wg * 64 + c / (D / 8), c8 = c % (D / 8);
    const int p = q0 + r % bq;
    qraw[i][0] = qraw[i][1] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && p < t) {
      const long long off =
          batch * q_sb + static_cast<long long>(kvh * rep + r / bq) * q_sh + p * q_st + c8 * 8;
      if (q_f32) {
        const uint4* src = reinterpret_cast<const uint4*>(static_cast<const float*>(q) + off);
        qraw[i][0] = src[0];
        qraw[i][1] = src[1];
      } else {
        qraw[i][0] = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + off);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Q_PASSES; ++i) {
    const int c = tid % 128 + 128 * i;
    const int r = wg * 64 + c / (D / 8), c8 = c % (D / 8);
    float x[8];
    if (q_f32) {
      const uint32_t w[8] = {qraw[i][0].x, qraw[i][0].y, qraw[i][0].z, qraw[i][0].w,
                             qraw[i][1].x, qraw[i][1].y, qraw[i][1].z, qraw[i][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(w[e]);
    } else {  // a bf16's f32 is its bits in the upper half
      const uint32_t w[4] = {qraw[i][0].x, qraw[i][0].y, qraw[i][0].z, qraw[i][0].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[2 * e] = __uint_as_float(w[e] << 16);
        x[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      }
    }
    *reinterpret_cast<uint4*>(smem + OFF_Q + r * ROW + ((c8 ^ (r & 7)) << 4)) =
        scale_pack8(x, qk_scale);
  }
  for (int c = tid; c < ONES_BYTES / 16; c += THREADS)
    reinterpret_cast<uint4*>(smem + OFF_ONES)[c] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);  // bf16 1.0
  fence_proxy_async();
  named_barrier(1, THREADS);

  // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its warp).
  const int ra = wg * 64 + warp * 16 + lane / 4;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = q0 + (ra + 8 * h) % bq;
  auto edge = [&](int j) { return j * BN + BN > s || (causal && j * BN + BN - 1 > q0); };

  const uint64_t desc_q = desc_kmajor_sw128(base + OFF_Q + wg * 64 * ROW);
  const uint64_t desc_ones = desc_interleave(base + OFF_ONES);
  float m[2] = {-INFINITY, -INFINITY};
  float acc[32], ls[4];  // O and the row sums of P, both rescaled by alpha
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ls[i] = 0.f;

  // A group of products is issued as: wait for the tiles it reads, compute
  // its descriptors, fence the register operands (their last writes stay
  // before wgmma.fence: a non-wgmma write of a product's input between the
  // fence and the commit serializes the kernel's wgmma, C7513), one
  // wgmma.fence, the products, one commit.
  auto wait_kv = [&](int j) { mbar_wait(full(j % KV_STAGES), (j / KV_STAGES) & 1); };
  auto desc_k = [&](int j) {
    return desc_kmajor_sw128(base + OFF_KV + (j % KV_STAGES) * 2 * TILE);
  };
  auto desc_v = [&](int j) {
    return desc_mnmajor_sw128(base + OFF_KV + (j % KV_STAGES) * 2 * TILE + TILE);
  };
  auto fence_operands = [&](uint32_t (&pa)[8][4], uint64_t& dk, uint64_t& dv) {
    reg_fence(acc);
    reg_fence(ls);
    reg_fence(pa);
    asm volatile("" : "+l"(dk), "+l"(dv)::"memory");
    wgmma_fence();
  };
  // S = Q K^T into sc: 4 k-steps of 16 head dims (32 bytes of Q's and K's rows).
  auto mma_s = [&](uint64_t dk, float (&sc)[64]) {
    wgmma_bf16_m64n128k16_ss_zero(sc, desc_q, dk);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_bf16_m64n128k16_ss(sc, desc_q + 2 * kk, dk + 2 * kk, 1);
  };
  // acc += P V (and ls += rowsum(P)): 8 k-steps of 16 keys (32 bytes of P's
  // rows, 16 rows = 2048 bytes of V).
  auto mma_pv = [&](uint64_t dv, const uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(acc, pa[kk], dv + kk * (16 * ROW >> 4), 1);
      wgmma_bf16_m64n8k16_rs(ls, pa[kk], desc_ones, 1);
    }
  };

  // The mainloop, with no wgmma under a branch (ptxas would serialize every
  // wgmma of the kernel, C7520). Step j issues tile j's S and tile j - 1's
  // PV, waits for the S and runs tile j's softmax while the PV is in flight.
  // Every step issues the same products: at tile 0 the PV takes P = 0, a
  // tile past the last is clamped to it (its S is not used), and when
  // n_tiles is odd the iteration's second step has no tile (P = 0, alpha =
  // 1) and the PV after the loop adds nothing. The P fragments alternate
  // between two sets, two tiles an iteration: copying them between steps
  // would write a product's input inside its stage (C7513). Then O and l are
  // rescaled by alpha for tile j's PV.
  float sc[64];  // tile j's S
  auto step = [&](int j, bool live, uint32_t (&p_prev)[8][4], uint32_t (&p_cur)[8][4]) {
    uint64_t dv = desc_v(max(j - 1, 0));
    const int jc = min(j, n_tiles - 1);
    wait_kv(jc);
    uint64_t dk = desc_k(jc);
    fence_operands(p_prev, dk, dv);
    mma_s(dk, sc);
    wgmma_commit();
    mma_pv(dv, p_prev);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j is done
    reg_fence(sc);
    float alpha[2] = {1.f, 1.f};
    if (!live) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) p_cur[kk][e] = 0u;
    } else if (edge(j)) {
      softmax_tile<true>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal);
    } else {
      softmax_tile<false>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ls);
    reg_fence(p_prev);
    if (j > 0) release(j - 1);  // this warpgroup reads tile j - 1 no more
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i % 4) / 2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ls[i] *= alpha[i / 2];
  };

  uint32_t p_a[8][4], p_b[8][4] = {};
  for (int j = 0; j < n_tiles; j += 2) {
    step(j, true, p_b, p_a);
    step(j + 1, j + 1 < n_tiles, p_a, p_b);
  }
  {  // tile n_tiles - 1's PV (or, n_tiles odd, P = 0)
    uint64_t dk = 0, dv = desc_v(n_tiles - 1);
    fence_operands(p_b, dk, dv);
    mma_pv(dv, p_b);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(ls);

  // Epilogue: O = acc / l (l == 0 -> 1) staged in shared memory by rows, then
  // 16-byte stores; lse = m + log2(l).
  float* o_s = reinterpret_cast<float*>(smem + OFF_O);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const float l = ls[2 * h];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o_s + r * O_LD + 8 * n + cq) =
          make_float2(acc[4 * n + 2 * h] / l_safe, acc[4 * n + 2 * h + 1] / l_safe);
    if (lane % 4 == 0 && r < rows && pos[h] < t)
      lse[(static_cast<size_t>(bh) * rep + r / bq) * t + pos[h]] = m[h] + log2f(l_safe);
  }
  named_barrier(2 + wg, 128);
  for (int c = tid % 128; c < 64 * (D / 4); c += 128) {
    const int r = wg * 64 + c / (D / 4), c4 = c % (D / 4);
    const int p = q0 + r % bq;
    if (r < rows && p < t) {
      const size_t row = (static_cast<size_t>(bh) * rep + r / bq) * t + p;
      *reinterpret_cast<float4*>(o + row * D + 4 * c4) =
          *reinterpret_cast<const float4*>(o_s + r * O_LD + 4 * c4);
    }
  }
}

// The K/V prep of f32 inputs: K and V ([b, h_kv, s, D] f32, any strides,
// rows contiguous) -> contiguous bf16 (round to nearest), both in one launch:
// grid (CAST_ROWS rows along s, b * h_kv, the tensor). A thread converts 8
// elements of a row in each of CAST_ROWS / 32 rows, all its loads issued
// before its stores (a block per 32 rows spends more time being scheduled
// than copying).
constexpr int CAST_ROWS = 256;
__global__ void __launch_bounds__(256)
kv_to_bf16_kernel(const float* __restrict__ k, const float* __restrict__ v, long long k_sb,
                  long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                  __nv_bfloat16* __restrict__ kb, __nv_bfloat16* __restrict__ vb, int h_kv,
                  int s) {
  const int bh = blockIdx.y, c8 = threadIdx.x % (D / 8);
  const int tok0 = blockIdx.x * CAST_ROWS + threadIdx.x / (D / 8);
  const long long batch = bh / h_kv, head = bh % h_kv;
  const bool is_v = blockIdx.z;
  const float* src = is_v ? v + batch * v_sb + head * v_sh : k + batch * k_sb + head * k_sh;
  const long long st = is_v ? v_st : k_st;
  uint4* dst = reinterpret_cast<uint4*>((is_v ? vb : kb) + static_cast<size_t>(bh) * s * D);
  constexpr int PASSES = CAST_ROWS / (256 / (D / 8));
  float4 x[PASSES][2] = {};
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int tok = tok0 + i * (256 / (D / 8));
    if (tok < s) {
      const float4* row = reinterpret_cast<const float4*>(src + tok * st + c8 * 8);
      x[i][0] = row[0];
      x[i][1] = row[1];
    }
  }
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int tok = tok0 + i * (256 / (D / 8));
    if (tok < s)
      dst[static_cast<size_t>(tok) * (D / 8) + c8] =
          make_uint4(as_u32(__floats2bfloat162_rn(x[i][0].x, x[i][0].y)),
                     as_u32(__floats2bfloat162_rn(x[i][0].z, x[i][0].w)),
                     as_u32(__floats2bfloat162_rn(x[i][1].x, x[i][1].y)),
                     as_u32(__floats2bfloat162_rn(x[i][1].z, x[i][1].w)));
  }
}

// A 4-D map over [b, h_kv, s, D] bf16 with the tensor's strides in elements,
// boxes of BN keys.
bool kv_map(CUtensorMap* map, const void* ptr, int b, int h_kv, int s, long long sb, long long sh,
            long long st) {
  const long long stride[3] = {2 * st, 2 * sh, 2 * sb};
  return tensor_map_4d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, h_kv, s, D, stride, BN, D,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

bool strides16(long long elem_bytes, long long sb, long long sh, long long st) {
  return (sb * elem_bytes) % 16 == 0 && (sh * elem_bytes) % 16 == 0 && (st * elem_bytes) % 16 == 0;
}

// ---------------------------------------------------------------------------
// precision="fp32": FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TF = 64;            // q rows per block and keys per tile
constexpr int LDF = TF + 4;       // padded row of an f32 tile (float4-aligned)
constexpr int THREADS_F = 256;    // thread = (row group tid / 16, column group tid % 16)

// max / sum over the sixteen threads of a row group (one half-warp)
__device__ __forceinline__ float group_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0+TF-1 of a row-major [n, D] f32 matrix into shared
// memory, transposed (dst[d * LDF + row]); rows at or past n are zero.
// Consecutive threads take consecutive rows, so the transposed stores hit
// consecutive banks.
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < TF * (D / 4); c += THREADS_F) {
    const int r = c % TF;
    const int col = (c / TF) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    dst[(col + 0) * LDF + r] = val.x;
    dst[(col + 1) * LDF + r] = val.y;
    dst[(col + 2) * LDF + r] = val.z;
    dst[(col + 3) * LDF + r] = val.w;
  }
}

// Rows row0 .. row0+TF-1 of a row-major [n, D] f32 matrix into a padded
// shared tile as they are; rows at or past n are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n) {
  for (int c = threadIdx.x; c < TF * (D / 4); c += THREADS_F) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<float4*>(&dst[r * LDF + col]) = val;
  }
}

// acc[4][4] += a^T b over TF (or D) steps: a, b [steps][LDF], columns
// a0 .. a0+3 of a and b0 .. b0+3 of b, read as float4.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float* a, const float* b, int a0,
                                       int b0, int steps) {
  for (int d = 0; d < steps; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * LDF + a0]);
    const float4 y = *reinterpret_cast<const float4*>(&b[d * LDF + b0]);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// One block of 256 threads per (q head, 64-row q tile). Thread (g, c) =
// (tid / 16, tid % 16) owns rows 4g .. 4g+3 and, per 64-key tile, keys
// 4c .. 4c+3 of S and columns 4c .. 4c+3 of O: a 4x4 register tile per
// product from two float4 shared loads per step (Q and K stored transposed,
// P transposed, V as it is). A row group's sixteen owners are one
// half-warp: row max and sums reduce by shuffles, and its P rows pass to
// P V behind a __syncwarp.
__global__ void __launch_bounds__(THREADS_F)
flash_fwd_f32_kernel(const float* __restrict__ q,  // [b*h, t, D], pre-scaled by qk_scale
                     const float* __restrict__ k,  // [b*h_kv, s, D]
                     const float* __restrict__ v,  // [b*h_kv, s, D]
                     float* __restrict__ o,        // [b*h, t, D]
                     float* __restrict__ lse,      // [b*h, t]
                     int rep, int t, int s, int causal) {
  extern __shared__ __align__(16) float smem_f[];
  float* qt_s = smem_f;           // [D][LDF]: Q^T
  float* kt_s = qt_s + D * LDF;   // [D][LDF]: K^T
  float* v_s = kt_s + D * LDF;    // [TF][LDF]: V
  float* pt_s = v_s + TF * LDF;   // [TF][LDF]: P^T

  const int tid = threadIdx.x;
  const int g4 = (tid / 16) * 4;
  const int c4 = (tid % 16) * 4;
  const size_t head = blockIdx.y;
  const size_t kvh = head / rep;
  const int q0 = blockIdx.x * TF;

  load_transposed(qt_s, q + head * t * D, q0, t);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int kv_hi = causal ? min(s, q0 + TF) : s;
  const int n_tiles = (kv_hi + TF - 1) / TF;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * TF;
    __syncthreads();  // every thread is done with the previous K/V tile
    load_transposed(kt_s, k + kvh * s * D, k0, s);
    load_rows(v_s, v + kvh * s * D, k0, s);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    outer4(sc, qt_s, kt_s, g4, c4, D);

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + g4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c4 + j;
        if (!(col < s && (!causal || col <= pos))) sc[i][j] = MASK_VALUE;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float next_m = fmaxf(m[i], group_max16(mx) + EPS_BIAS);
      alpha[i] = exp2f(m[i] - next_m);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c4 + j;
        sc[i][j] = (col < s && (!causal || col <= pos)) ? exp2f(sc[i][j] - next_m) : 0.f;
        psum += sc[i][j];
      }
      l[i] = l[i] * alpha[i] + group_sum16(psum);
      m[i] = next_m;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt_s[(c4 + j) * LDF + g4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncwarp();  // a row group's P is written by its sixteen owners, all in this half-warp

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha[i];
    outer4(acc, pt_s, v_s, g4, c4, TF);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + g4 + i;
    if (pos >= t) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const size_t row = head * t + pos;
    *reinterpret_cast<float4*>(o + row * D + c4) =
        make_float4(acc[i][0] / l_safe, acc[i][1] / l_safe, acc[i][2] / l_safe,
                    acc[i][3] / l_safe);
    if (c4 == 0) lse[row] = m[i] + log2f(l_safe);
  }
}

}  // namespace

// Shared bytes one bf16-mode block asks for (ops/flash_tiling.py's
// shared_bytes mirrors it).
extern "C" int qa_flash_fwd_smem_bytes() { return SMEM_BYTES; }

// precision="fp32": q [b*h, t, D] f32 pre-scaled by qk_scale, k/v
// [b*h_kv, s, D] f32 (h = h_kv * rep) -> O [b*h, t, D], lse [b*h, t] f32.
extern "C" int qa_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                int bh, int rep, int t, int s, int causal, void* stream) {
  const int smem = (2 * D + 2 * TF) * LDF * sizeof(float);  // 69,632 bytes
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + TF - 1) / TF, bh);
  flash_fwd_f32_kernel<<<grid, THREADS_F, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), rep, t, s, causal);
  return static_cast<int>(cudaGetLastError());
}

// The K/V prep of f32 inputs: k/v [b, h_kv, s, 64] f32 (strides in elements,
// rows contiguous; pointers and strides 16-byte aligned) -> kb/vb contiguous
// bf16 [b, h_kv, s, 64], in one launch.
extern "C" int qa_flash_kv_to_bf16(const void* k, long long k_sb, long long k_sh, long long k_st,
                                   const void* v, long long v_sb, long long v_sh, long long v_st,
                                   void* kb, void* vb, int b, int h_kv, int s, void* stream) {
  if (b < 1 || h_kv < 1 || static_cast<long long>(b) * h_kv > 65535 || s < 1 ||
      s > (1 << 27) || !aligned16(k) || !aligned16(v) || !aligned16(kb) || !aligned16(vb) ||
      !strides16(4, k_sb, k_sh, k_st) || !strides16(4, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((s + CAST_ROWS - 1) / CAST_ROWS, b * h_kv, 2);
  kv_to_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), k_sb, k_sh, k_st, v_sb, v_sh,
      v_st, static_cast<__nv_bfloat16*>(kb), static_cast<__nv_bfloat16*>(vb), h_kv, s);
  return static_cast<int>(cudaGetLastError());
}

// bf16 mode: q [b, h, t, 64] f32 (q_f32) or bf16, k/v [b, h_kv, s, 64] bf16,
// each with its strides in elements (rows contiguous; pointers and strides
// 16-byte aligned) -> O [b, h, t, 64], lse [b, h, t] f32 (contiguous); h =
// h_kv * rep, bq query positions a block (rep * bq <= 128).
extern "C" int qa_flash_fwd(const void* q, long long q_sb, long long q_sh, long long q_st,
                            int q_f32, const void* k, long long k_sb, long long k_sh,
                            long long k_st, const void* v, long long v_sb, long long v_sh,
                            long long v_st, void* o, void* lse, int b, int h_kv, int rep, int t,
                            int s, int bq, int causal, float qk_scale, void* stream) {
  const int n_qt = bq < 1 ? 0 : (t + bq - 1) / bq;
  if (bq < 1 || rep < 1 || rep * bq > BM || t < 1 || s < 1 || b < 1 || h_kv < 1 ||
      static_cast<long long>(b) * h_kv > 65535 || n_qt > 65535 || !aligned16(q) ||
      !strides16(q_f32 ? 4 : 2, q_sb, q_sh, q_st) || !aligned16(k) || !aligned16(v) ||
      !strides16(2, k_sb, k_sh, k_st) || !strides16(2, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_map, v_map;
  if (!kv_map(&k_map, k, b, h_kv, s, k_sb, k_sh, k_st) ||
      !kv_map(&v_map, v, b, h_kv, s, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(b * h_kv, n_qt);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, q, q_sb, q_sh, q_st, q_f32, static_cast<float*>(o), static_cast<float*>(lse),
      h_kv, rep, t, s, bq, causal, qk_scale);
  return static_cast<int>(cudaGetLastError());
}
