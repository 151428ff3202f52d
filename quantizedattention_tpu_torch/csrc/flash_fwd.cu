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
// primal of attention_jvp and the rCM prepass. Q is scaled by qk_scale in
// f32, nothing is rounded to a narrower type, masked P is exactly 0, the row
// max still carries +EPS_BIAS, and GQA reads kv head head / rep.
// Bound: the TPU's HIGHEST dots are a multi-pass f32 emulation on its matrix
// unit; Hopper's counterpart is 3xTF32 on the tensor cores (hopper.cuh: x =
// big + small, each product as big.big + big.small + small.big), 6 TF32
// products over every visible (q, k) pair at 495 TFLOP/s, against 2 fp32
// products at the CUDA cores' 67 TFLOP/s for FFMA (7.4x more time). Between
// the products each pair takes one exponential and the split of P.
// Design: B1 bf16's shape in TF32. One block of two warpgroups per (q head,
// 128 positions), 64 each; the last positions (most key tiles) first.
//   - One prep launch (kv_split_tf32_kernel), reading K and V through their
//     strides, writes K big and small and V^T big and small: TF32 wgmma reads
//     A and B K-major only, so P V's B is V^T (keys contiguous), its keys in
//     each group of 8 permuted so that P's A fragments come straight from S's
//     accumulator (hopper.cuh's tf32_a_column).
//   - The kernel reads Q through its strides, scales it, keeps Q big as the
//     A fragments of S in registers and writes Q small to shared memory.
//   - Tiles of 64 keys (K big and small, V^T big and small: 64 KB, blocks of
//     32 f32 columns in the 128-byte swizzle, by 3-D TMA maps; keys past s
//     arrive as zeros) through a ring of 3 stages on "full" mbarriers; the
//     second warpgroup to release a stage refills it.
//   - Per tile and warpgroup: S = Q K^T as 24 wgmma m64n64k8 (Q big from
//     registers against K small and K big, Q small from shared memory against
//     K big; the small terms first), the online softmax in registers (row
//     sums in f32 from the unrounded P), P split into big and small A
//     fragments, then O += P V as 24 more (P small . V^T big, P big . V^T
//     small, P big . V^T big). The next tile's S is issued while this tile's
//     P V runs; the two warpgroups' softmaxes overlap each other's products.
//   - Causal blocks stop at their last visible tile; only tiles that reach
//     past s or the warpgroup's first position take the mask.

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
// precision="fp32": 3xTF32 on wgmma
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 128;         // q positions a block (one q head): two warpgroups of 64
constexpr int F_KEYS = 64;          // keys a K/V tile
constexpr int F_STAGES = 3;         // tiles in flight
constexpr int F_BLK = 64 * 128;     // bytes of a [64 x 32] f32 block: rows of 128 bytes (the swizzle)
// A stage: K big, K small (two blocks each: head dims 0-31, 32-63), V^T big,
// V^T small (two blocks each: keys 0-31, 32-63).
constexpr int F_STAGE = 8 * F_BLK;
constexpr int F_OFF_QS = 0;                    // Q small, two blocks a warpgroup
constexpr int F_OFF_RING = 2 * 2 * F_BLK;
constexpr int F_OFF_BAR = F_OFF_RING + F_STAGES * F_STAGE;
constexpr int F_COUNTERS = 64;      // byte offset of the release counters in the barrier area
constexpr int F_SMEM = F_OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
static_assert(F_STAGES * 8 <= F_COUNTERS && F_COUNTERS + F_STAGES * 4 <= 128, "barriers fit");
static_assert(F_SMEM <= 232448, "a block's shared memory fits an H100 SM");

// The K/V prep of the fp32 mode, one launch: K [b, h_kv, s, 64] f32 (any
// strides, rows contiguous) -> K big and K small [b * h_kv, s, 64]; V -> V^T
// big and V^T small [b * h_kv, 64, s8] (s8 = s rounded up to 8), column 8g +
// j holding key 8g + tf32_a_column(j), keys past s 0: the K-major B of P V
// for a P whose fragments come from S's accumulator. Grid (s / 64 rounded
// up, b * h_kv); a block takes 64 keys, V through shared memory, every load
// issued before the first store.
__global__ void __launch_bounds__(256)
kv_split_tf32_kernel(const float* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
                     const float* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
                     float* __restrict__ kb, float* __restrict__ ks, float* __restrict__ vbt,
                     float* __restrict__ vst, int h_kv, int s, int s8) {
  static_assert(SPLIT_KEYS == F_KEYS, "a prep block takes one 64-key tile");
  __shared__ float v_s[F_KEYS][D + 1];
  const int bh = blockIdx.y;
  const long long batch = bh / h_kv, head = bh % h_kv;
  const size_t kv_at = static_cast<size_t>(bh) * s * D, vt_at = static_cast<size_t>(bh) * D * s8;
  kv_split_tf32_tile(k + batch * k_sb + head * k_sh, k_st, v + batch * v_sb + head * v_sh, v_st,
                     kb + kv_at, ks + kv_at, vbt + vt_at, vst + vt_at, blockIdx.x * F_KEYS, s, s8,
                     v_s);
}

// The descriptor of k-step kk (8 columns, 32 bytes of a row) of a K-major
// f32 operand stored as 128-byte blocks of 32 columns, `F_BLK` bytes apart.
__device__ __forceinline__ uint64_t desc_f32(uint32_t addr, int kk) {
  return desc_kmajor_sw128(addr + (kk / 4) * F_BLK) + 2 * (kk % 4);
}

// One tile's S (f32, exp2 domain: Q is pre-scaled) -> P = exp2(S - m), 0
// where masked, split into the TF32 A fragments of P V (k-step n = keys 8n ..
// 8n + 7, in tf32_a_column order). Masks where MASK (the tile reaches past s
// or past the warpgroup's first position), updates the running max m
// (+EPS_BIAS), this thread's partial row sums l and each row's alpha. s[4 n +
// e]: row h = e / 2, key k0 + 8 n + c2 + (e & 1).
template <bool MASK>
__device__ __forceinline__ void softmax_tf32(const float (&s)[32], uint32_t (&pb)[8][4],
                                             uint32_t (&ps)[8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int c2, const int (&pos)[2],
                                             int s_len, int causal) {
  auto visible = [&](int i) {
    const int col = k0 + (i / 4) * 8 + c2 + (i & 1);
    return col < s_len && (!causal || col <= pos[(i % 4) / 2]);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i % 4) / 2;
    mx[h] = fmaxf(mx[h], MASK && !visible(i) ? MASK_VALUE : s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float next = fmaxf(m[h], quad_max(mx[h]) + EPS_BIAS);
    alpha[h] = exp2f(m[h] - next);  // 0 while m is -inf
    m[h] = next;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i % 4) / 2;
    const float p = MASK && !visible(i) ? 0.f : exp2f(s[i] - m[h]);
    sum[h] += p;
    const float big = tf32_big(p);
    // accumulator column 2c + (i & 1) of row h -> fragment column c + 4 (i & 1)
    pb[i / 4][h + 2 * (i & 1)] = __float_as_uint(big);
    ps[i / 4][h + 2 * (i & 1)] = __float_as_uint(p - big);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// One block of two warpgroups (256 threads) per (q head, 128 positions);
// warpgroup wg owns positions q0 + 64 wg .. + 63. See the file's head.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap kb_map,   // [b*h_kv, s, 64] K big
                     const __grid_constant__ CUtensorMap ks_map,   // K small
                     const __grid_constant__ CUtensorMap vbt_map,  // [b*h_kv, 64, s8] V^T big
                     const __grid_constant__ CUtensorMap vst_map,  // V^T small
                     const float* __restrict__ q,  // [b, h, t, D] f32, strides in elements
                     long long q_sb, long long q_sh, long long q_st,
                     float* __restrict__ o,    // [b, h, t, D]
                     float* __restrict__ lse,  // [b, h, t]
                     int h, int rep, int t, int s, int causal, float qk_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + F_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  int* released = reinterpret_cast<int*>(smem + F_OFF_BAR + F_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, batch = bh / h, head = bh % h;
  const int kvh = batch * (h / rep) + head / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS;  // the last positions (most tiles) first
  const int kv_hi = causal ? min(s, min(t, q0 + F_ROWS)) : s;
  const int n_tiles = (kv_hi + F_KEYS - 1) / F_KEYS;

  init_ring(bars, released, F_STAGES);
  auto load_kv = [&](int j) {  // tile j into stage j % F_STAGES; keys past s arrive as zeros
    const int st = j % F_STAGES;
    const uint32_t dst = base + F_OFF_RING + st * F_STAGE;
    mbar_expect_tx(full(st), F_STAGE);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_load_3d(dst + half * F_BLK, &kb_map, full(st), 32 * half, j * F_KEYS, kvh);
      tma_load_3d(dst + (2 + half) * F_BLK, &ks_map, full(st), 32 * half, j * F_KEYS, kvh);
      tma_load_3d(dst + (4 + half) * F_BLK, &vbt_map, full(st), j * F_KEYS + 32 * half, 0, kvh);
      tma_load_3d(dst + (6 + half) * F_BLK, &vst_map, full(st), j * F_KEYS + 32 * half, 0, kvh);
    }
  };
  if (tid == 0)
    for (int j = 0; j < min(F_STAGES, n_tiles); ++j) load_kv(j);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int c = lane % 4;
  const int ra = 16 * warp + lane / 4;  // this thread's rows ra, ra + 8 of the warpgroup's 64
  int pos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) pos[h2] = q0 + 64 * wg + ra + 8 * h2;

  // Q * qk_scale (f32, PyTorch's bits), split: big as the A fragments of the
  // 8 k-steps in registers, small K-major into shared memory (128-byte
  // swizzle: 16-byte chunk ch of row r at ch ^ (r & 7)). Positions past t
  // are 0. Every load is issued before the first conversion.
  uint32_t qa[8][4];
  const uint32_t qs_base = base + F_OFF_QS + wg * 2 * F_BLK;
  {
    float x[2][16];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float* row = q + batch * q_sb + head * q_sh + static_cast<long long>(pos[h2]) * q_st;
#pragma unroll
      for (int i = 0; i < 16; ++i)  // head dim 8 (i / 2) + c + 4 (i % 2)
        x[h2][i] = pos[h2] < t ? row[8 * (i / 2) + c + 4 * (i % 2)] : 0.f;
    }
    float* qs_s = reinterpret_cast<float*>(smem + F_OFF_QS + wg * 2 * F_BLK);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = ra + 8 * h2;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float xs = __fmul_rn(x[h2][i], qk_scale);
        const float big = tf32_big(xs);
        qa[i / 2][h2 + 2 * (i % 2)] = __float_as_uint(big);
        const int d = 8 * (i / 2) + c + 4 * (i % 2), w = d % 32;
        qs_s[(d / 32) * (F_BLK / 4) + r * 32 + (((w / 4) ^ (r & 7)) << 2) + w % 4] = xs - big;
      }
    }
  }
  fence_proxy_async();  // Q small, for wgmma
  named_barrier(1 + wg, 128);

  float sacc[32], oacc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pb[8][4] = {}, ps[8][4] = {};  // P big and small: the A of P V
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = oacc[i] = 0.f;
  auto edge = [&](int j) {
    return j * F_KEYS + F_KEYS > s || (causal && j * F_KEYS + F_KEYS - 1 > q0 + 64 * wg);
  };

  // S = Q K^T of the tile in `stage`: 24 products, the small terms first
  // into the accumulator, the big-big term last.
  auto issue_s = [&](uint32_t stage) {
    wgmma_tf32_m64n64k8_rs_zero(sacc, qa[0], desc_f32(stage + 2 * F_BLK, 0));  // Q big . K small
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk)
      wgmma_tf32_m64n64k8_rs(sacc, qa[kk], desc_f32(stage + 2 * F_BLK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . K big
      wgmma_tf32_m64n64k8_ss(sacc, desc_f32(qs_base, kk), desc_f32(stage, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q big . K big
      wgmma_tf32_m64n64k8_rs(sacc, qa[kk], desc_f32(stage, kk), 1);
    wgmma_commit();
  };
  auto stage_of = [&](int j) { return base + F_OFF_RING + (j % F_STAGES) * F_STAGE; };

  // Tile j: the softmax of its S, then its P V and the next tile's S issued
  // together (the last tile's S again at the end: a wgmma under a branch
  // would serialize them all) and both waited for, so no product is in
  // flight across the loop's back edge (that too serializes them, C7515)
  // or while a ring wait's trap path is live (C7517); then the stage is
  // released.
  mbar_wait(full(0), 0);
  reg_fence(sacc);
  wgmma_fence();
  issue_s(stage_of(0));
  wgmma_wait<0>();
  reg_fence(sacc);
  for (int j = 0; j < n_tiles; ++j) {
    float alpha[2];
    if (edge(j))
      softmax_tf32<true>(sacc, pb, ps, m, l, alpha, j * F_KEYS, 2 * c, pos, s, causal);
    else
      softmax_tf32<false>(sacc, pb, ps, m, l, alpha, j * F_KEYS, 2 * c, pos, s, causal);
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i % 4) / 2];
    const int jn = min(j + 1, n_tiles - 1);
    if (j + 1 < n_tiles) mbar_wait(full(jn % F_STAGES), (jn / F_STAGES) & 1);
    const uint32_t stage = stage_of(j);
    reg_fence(sacc);
    reg_fence(oacc);
    reg_fence(pb);
    reg_fence(ps);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P small . V big
      wgmma_tf32_m64n64k8_rs(oacc, ps[kk], desc_f32(stage + 4 * F_BLK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P big . V small
      wgmma_tf32_m64n64k8_rs(oacc, pb[kk], desc_f32(stage + 6 * F_BLK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < F_KEYS / 8; ++kk)  // P big . V big
      wgmma_tf32_m64n64k8_rs(oacc, pb[kk], desc_f32(stage + 4 * F_BLK, kk), 1);
    wgmma_commit();
    issue_s(stage_of(jn));
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(oacc);
    reg_fence(pb);
    reg_fence(ps);
    release_stage(released, j, F_STAGES, n_tiles, load_kv);
  }

  // O = acc / l (l == 0 -> 1), lse = m + log2(l); rows past t store nothing.
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float lsum = quad_sum(l[h2]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (pos[h2] >= t) continue;
    const size_t row = static_cast<size_t>(bh) * t + pos[h2];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + row * D + 8 * n + 2 * c) =
          make_float2(oacc[4 * n + 2 * h2] / l_safe, oacc[4 * n + 2 * h2 + 1] / l_safe);
    if (c == 0) lse[row] = m[h2] + log2f(l_safe);
  }
}

}  // namespace

// Shared bytes one bf16-mode block asks for (ops/flash_tiling.py's
// shared_bytes mirrors it).
extern "C" int qa_flash_fwd_smem_bytes() { return SMEM_BYTES; }

// Shared bytes one fp32-mode block asks for (ops/flash_tiling.py's
// fp32_shared_bytes mirrors it).
extern "C" int qa_flash_fwd_f32_smem_bytes() { return F_SMEM; }

// The fp32 mode's K/V prep: k/v [b, h_kv, s, 64] f32 (strides in elements,
// rows contiguous; pointers and strides 16-byte aligned) -> kb, ks [b * h_kv,
// s, 64] and vbt, vst [b * h_kv, 64, s8] f32 (s8 = s rounded up to 8), in one
// launch.
extern "C" int qa_flash_kv_split_tf32(const void* k, long long k_sb, long long k_sh,
                                      long long k_st, const void* v, long long v_sb,
                                      long long v_sh, long long v_st, void* kb, void* ks,
                                      void* vbt, void* vst, int b, int h_kv, int s,
                                      void* stream) {
  if (b < 1 || h_kv < 1 || static_cast<long long>(b) * h_kv > 65535 || s < 1 ||
      s > (1 << 27) || !aligned16(k) || !aligned16(v) || !aligned16(kb) || !aligned16(ks) ||
      !aligned16(vbt) || !aligned16(vst) || !strides16(4, k_sb, k_sh, k_st) ||
      !strides16(4, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((s + F_KEYS - 1) / F_KEYS, b * h_kv);
  kv_split_tf32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), k_sb, k_sh, k_st, static_cast<const float*>(v), v_sb, v_sh,
      v_st, static_cast<float*>(kb), static_cast<float*>(ks), static_cast<float*>(vbt),
      static_cast<float*>(vst), h_kv, s, (s + 7) / 8 * 8);
  return static_cast<int>(cudaGetLastError());
}

// precision="fp32": q [b, h, t, 64] f32 (strides in elements, rows
// contiguous), the prep's kb, ks, vbt, vst (h = h_kv * rep) -> O [b, h, t,
// 64], lse [b, h, t] f32 (contiguous); Q is scaled by qk_scale in the kernel.
extern "C" int qa_flash_fwd_f32(const void* q, long long q_sb, long long q_sh, long long q_st,
                                const void* kb, const void* ks, const void* vbt, const void* vst,
                                void* o, void* lse, int b, int h, int h_kv, int t, int s,
                                int causal, float qk_scale, void* stream) {
  const int n_qt = (t + F_ROWS - 1) / F_ROWS;
  if (b < 1 || h_kv < 1 || h < h_kv || h % h_kv || static_cast<long long>(b) * h > 65535 ||
      t < 1 || s < 1 || s > (1 << 27) || n_qt > 65535 || !aligned16(kb) || !aligned16(ks) ||
      !aligned16(vbt) || !aligned16(vst))
    return static_cast<int>(cudaErrorInvalidValue);
  const int s8 = (s + 7) / 8 * 8;
  CUtensorMap kb_map, ks_map, vbt_map, vst_map;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_3d(&kb_map, kb, f32, 4, b * h_kv, s, D, F_KEYS, 32, sw) ||
      !tensor_map_3d(&ks_map, ks, f32, 4, b * h_kv, s, D, F_KEYS, 32, sw) ||
      !tensor_map_3d(&vbt_map, vbt, f32, 4, b * h_kv, D, s8, D, 32, sw) ||
      !tensor_map_3d(&vst_map, vst, f32, 4, b * h_kv, D, s8, D, 32, sw))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(b * h, n_qt);
  flash_fwd_f32_kernel<<<grid, THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      kb_map, ks_map, vbt_map, vst_map, static_cast<const float*>(q), q_sb, q_sh, q_st,
      static_cast<float*>(o), static_cast<float*>(lse), h, h / h_kv, t, s, causal, qk_scale);
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
