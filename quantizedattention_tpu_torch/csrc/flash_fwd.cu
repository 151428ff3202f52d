// Corrected-bf16 flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel quantizedattention_tpu/ops/flash_fwd.py:_fwd_kernel
// (the Pallas online-softmax forward). Same numerics: Q is pre-scaled by
// sm_scale*log2(e) in f32 and rounded to bf16, K and V are bf16, S = Q K^T
// accumulates in f32, masked logits are MASK_VALUE (causal k <= q on global
// positions, k + k_offset <= q + q_offset, plus keys past s), the row max
// carries +EPS_BIAS, P = exp2(S - m) is rounded to bf16 before BOTH the PV
// product and the row sum l, and rows with l == 0 give O = 0. Outputs O f32
// and the exp2-domain lse = m + log2(l). A row that sees no key at all (q_offset
// < k_offset) gives O = 0 and lse = -inf; the TPU kernel gives a row inside a
// live tile MASK_VALUE + log2(s) and the mean of its V (ROADMAP.md §C).
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
//     reach past s or past the block's first position take the mask. The
//     global offsets enter as diag = q_offset - k_offset, which moves the
//     last tile and the masked ones, never the products each step issues.
//   - The epilogue stages O / l through shared memory and writes it with
//     16-byte stores; rows past t and dead rows store nothing.
// f32 K and V are cast to bf16 by one launch of kv_to_bf16_kernel before
// the kernel (for both tensors), never in the mainloop: each tile is read by
// up to t / bq blocks.
//
// Head dim 128 (BASELINE config 2's second head dim; FwdGeom<128>, chosen
// by the entry's d): the same kernel body. A bf16 row is then 256 bytes,
// twice the 128-byte swizzle's span, so Q, K and V tiles are two panels of
// 64 dims (each its own swizzled K-major tile and TMA box); S's k-steps 4-7
// read the second panels, and PV is two m64n64 products a k-step, one a V
// panel read MN-major, into two halves of O's accumulator. K/V tiles hold 64
// keys: S (m64n64, 32 registers) and P's two sets (32) beside O's 64 keep a
// thread at 165 registers with no spill, and three stages (192 KB at 128
// keys would leave no room for O's staging) fit 203 KB. At (4,16,2048,128)
// causal the products are 68.7 GFLOP (0.069 ms on the tensor cores) and f32
// inputs and outputs 269 MB (0.080 ms of HBM): twice d=64's work a key.
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
//     fragments, then the tile's P V as 24 more (P small . V^T big, P big .
//     V^T small, P big . V^T big) into a fresh accumulator, added to O in
//     f32 once done (the tensor cores' accumulation truncates). The next
//     tile's S is issued while this tile's P V runs; the two warpgroups'
//     softmaxes overlap each other's products.
//   - Causal blocks stop at their last visible tile; only tiles that reach
//     past s or the warpgroup's first position take the mask.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float MASK_VALUE = -30000.0f;
constexpr float EPS_BIAS = 1.0f / 256.0f;
// The correction rules (ops/flash_fwd.py RULES), each kernel's template
// argument: "eps" biases the row max by EPS_BIAS, "none" does not, "beta"
// amplifies a tied max once per group of keys (quantize/bf16_correction.py).
constexpr int RULE_EPS = 0, RULE_NONE = 1, RULE_BETA = 2;

// A row's two largest logits t1 >= t2 (a multiset: a tie gives t2 == t1),
// merged over the quad of threads that holds the row.
__device__ __forceinline__ void quad_top2(float& t1, float& t2) {
#pragma unroll
  for (int lane = 1; lane <= 2; lane *= 2) {
    const float o1 = __shfl_xor_sync(0xffffffffu, t1, lane);
    const float o2 = __shfl_xor_sync(0xffffffffu, t2, lane);
    t2 = fmaxf(fmaxf(t2, o2), fminf(t1, o1));
    t1 = fmaxf(t1, o1);
  }
}

// "beta" over one group of keys whose two largest logits are t1 >= t2
// (masked ones MASK_VALUE), against the running max m: next = max(m, t1),
// and where a second logit of the group lies within tol of it (more than
// one logit >= next - tol, JAX amplify_tied_max), beta * next or 0.
__device__ __forceinline__ float tied_max(float m, float t1, float t2, float beta, float tol) {
  const float next = fmaxf(m, t1);
  return t2 >= next - tol ? (next > 0.f ? beta * next : 0.f) : next;
}

// The two largest logits of each of this thread's rows, over one tile's S
// (masked where MASK, as softmax_tile masks). Layout as softmax_tile's.
template <bool MASK, int NS>
__device__ __forceinline__ void top2_tile(const float (&s)[NS], float (&t1)[2], float (&t2)[2],
                                          int k0, int cq, const int (&pos)[2], int s_len,
                                          int causal, int diag) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i % 4) / 2;
    float x = s[i];
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + cq + (i & 1);
      if (!(col < s_len && (!causal || col <= pos[h] + diag))) x = MASK_VALUE;
    }
    t2[h] = fmaxf(t2[h], fminf(t1[h], x));
    t1[h] = fmaxf(t1[h], x);
  }
}

// --- bf16 mode: TMA ring + wgmma ---
//
// One kernel body for head dims 64 and 128 (ops/flash_tiling.py mirrors
// FwdGeom). A bf16 row of 128 dims is 256 bytes, twice the 128-byte
// swizzle's span, so every tile is stored as D / 64 panels of [rows, 64]
// (each its own 128-byte-swizzled K-major tile, TMA-loaded by its own box):
// S's k-steps 4 .. 7 read the second panel of Q and K, and PV's V (an
// MN-major B whose N is the head dim) is two n64 products, one a panel. At
// D = 128 a K/V tile holds 64 keys (S m64n64: 32 registers, P's two sets 32,
// beside O's 64): at 128 keys S and P alone would take 128.
constexpr int ONES_BYTES = 1024;
constexpr int THREADS = 256;    // two warpgroups, 8 warps: up to 255 registers a thread
constexpr int PANEL_ROW = 128;  // bytes of a panel's row: 64 bf16, the 128-byte swizzle's span

template <int D>
struct FwdGeom {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int PANELS = D / 64;          // 64-column panels of a bf16 row
  static constexpr int BM = 128;                 // rows per block: two warpgroups of 64
  static constexpr int BN = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int KV_STAGES = 3;            // K/V tiles in flight
  static constexpr int TILE = BN * D * 2;        // bytes of a K or a V tile (PANELS panels)
  static constexpr int O_LD = D + 8;             // floats of a staged O row (conflict-free stores)
  static constexpr int OFF_Q = 0;                // Q [BM, D] bf16 (PANELS panels of [BM, 64])
  static constexpr int OFF_KV = OFF_Q + BM * D * 2;  // stage st: K at OFF_KV + 2 st TILE, V after
  static constexpr int OFF_O = OFF_KV + KV_STAGES * 2 * TILE;
  static constexpr int OFF_BAR = OFF_O + BM * O_LD * 4;
  static constexpr int OFF_ONES = OFF_BAR + 128;  // bf16 ones: the B operand of P's row sums
  static constexpr int SMEM_BYTES = OFF_ONES + ONES_BYTES + 1024;  // + slack to align the base
  static_assert(KV_STAGES * (8 + 4) <= 128, "the barriers and counters fit before the ones");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory fits an H100 SM");
};

// S = Q K^T's products, by the tile's width: m64n128 (64 floats a thread)
// at 128 keys, m64n64 (32) at 64.
__device__ __forceinline__ void wgmma_s_zero(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_bf16_m64n128k16_ss_zero(d, da, db);
}
__device__ __forceinline__ void wgmma_s_zero(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_bf16_m64n64k16_ss_zero(d, da, db);
}
__device__ __forceinline__ void wgmma_s(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_bf16_m64n128k16_ss(d, da, db, 1);
}
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_bf16_m64n64k16_ss(d, da, db, 1);
}

// One tile's S (f32; Q is pre-scaled, so the logits are in the exp2 domain)
// -> P = bf16(exp2(S - m)) as PV's A fragments (key tiles 2kk and 2kk + 1 of
// 8 keys are k-step kk). Masks where MASK (the tile reaches past s or past
// the block's first position), updates the running max m (+EPS_BIAS under
// "eps") and gives each row's alpha; under "beta" m is the group's, fixed by
// its pre-pass, and alpha is 1. s[4 n + e]: row h = e / 2, key k0 + 8 n + cq +
// (e & 1). NS: the tile's keys / 2.
template <int RULE, bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], uint32_t (&p)[NS / 8][4],
                                             float (&m)[2], float (&alpha)[2], int k0, int cq,
                                             const int (&pos)[2], int s_len, int causal,
                                             int diag) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i % 4) / 2;
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + cq + (i & 1);
      if (!(col < s_len && (!causal || col <= pos[h] + diag))) s[i] = MASK_VALUE;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float next_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (RULE == RULE_BETA) {
      next_m[h] = m[h];
      alpha[h] = 1.f;
    } else {
      float mq = quad_max(mx[h]);
      if constexpr (RULE == RULE_EPS) mq += EPS_BIAS;
      next_m[h] = fmaxf(m[h], mq);
      alpha[h] = exp2_ftz(m[h] - next_m[h]);  // 0 while m is -inf
      m[h] = next_m[h];
    }
  }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
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

template <int D, int RULE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap k_map,  // [b, h_kv, s, D] bf16, 128B swizzle
                 const __grid_constant__ CUtensorMap v_map,  // the same for V
                 const void* __restrict__ q,  // [b, h, t, D] f32 (q_f32) or bf16, strides in elements
                 long long q_sb, long long q_sh, long long q_st, int q_f32,
                 float* __restrict__ o,    // [b, h, t, D]
                 float* __restrict__ lse,  // [b, h, t]
                 int h_kv, int rep, int t, int s, int bq, int causal, int diag,
                 float qk_scale,
                 int gt, float beta, float tol) {  // "beta": gt key tiles a group
  using G = FwdGeom<D>;
  constexpr int BM = G::BM, BN = G::BN, KV_STAGES = G::KV_STAGES, TILE = G::TILE;
  constexpr int PANELS = G::PANELS, O_LD = G::O_LD;
  constexpr int NS = BN / 2;  // S floats a thread
  // descriptor steps (16-byte units) from one panel to the next: Q's, K's and V's
  constexpr uint64_t Q_PANEL = BM * PANEL_ROW >> 4, KV_PANEL = BN * PANEL_ROW >> 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int batch = bh / h_kv, kvh = bh % h_kv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // the last q tile (most key tiles) first
  // Causal: a key is visible where key + k_offset <= position + q_offset, so
  // keys past the block's last query position below t, moved by diag =
  // q_offset - k_offset, are never visible (none at all: no key tile).
  const int kv_hi = causal ? max(0, min(s, min(t, q0 + bq) + diag)) : s;
  const int n_tiles = (kv_hi + BN - 1) / BN;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(full(i), 1);
      reinterpret_cast<int*>(smem + G::OFF_BAR + 8 * KV_STAGES)[i] = 0;  // releases of a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring by TMA: thread 0 loads tiles 0 .. KV_STAGES - 1; then tile j +
  // KV_STAGES is loaded into tile j's stage by whichever warpgroup releases
  // tile j second (a shared counter a stage), so no thread ever waits to
  // refill and each tile is asked for KV_STAGES - 1 tiles ahead. A tile's
  // panel p is the box at head dim 64 p.
  int* released = reinterpret_cast<int*>(smem + G::OFF_BAR + 8 * KV_STAGES);
  auto load_kv = [&](int j) {
    const int st = j % KV_STAGES;
    mbar_expect_tx(full(st), 2 * TILE);
    const uint32_t dst = base + G::OFF_KV + st * 2 * TILE;
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      tma_load_4d(dst + p * BN * PANEL_ROW, &k_map, full(st), 64 * p, j * BN, kvh, batch);
      tma_load_4d(dst + TILE + p * BN * PANEL_ROW, &v_map, full(st), 64 * p, j * BN, kvh, batch);
    }
  };
  // "beta" streams each group of gt key tiles twice, K alone for its
  // pre-pass and then K and V: the ring's u-th load is group g = u / (2 gt)'s
  // (every earlier group is whole), its K-only tiles first.
  auto load_u = [&](int u) {
    const int j0 = u / (2 * gt) * gt, ng = min(gt, n_tiles - j0), r = u - 2 * j0;
    const bool pre = r < ng;
    const int j = j0 + (pre ? r : r - ng), st = u % KV_STAGES;
    mbar_expect_tx(full(st), pre ? TILE : 2 * TILE);
    const uint32_t dst = base + G::OFF_KV + st * 2 * TILE;
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      tma_load_4d(dst + p * BN * PANEL_ROW, &k_map, full(st), 64 * p, j * BN, kvh, batch);
      if (!pre)
        tma_load_4d(dst + TILE + p * BN * PANEL_ROW, &v_map, full(st), 64 * p, j * BN, kvh,
                    batch);
    }
  };
  if constexpr (RULE == RULE_BETA) {
    if (tid == 0)
      for (int u = 0; u < min(KV_STAGES, 2 * n_tiles); ++u) load_u(u);
  } else {
    if (tid == 0)
      for (int j = 0; j < min(KV_STAGES, n_tiles); ++j) load_kv(j);
  }
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
  auto release_u = [&](int u) {  // the same over "beta"'s loads
    if (tid % 128 == 0 && atomicAdd(&released[u % KV_STAGES], 1) == 1) {
      atomicExch(&released[u % KV_STAGES], 0);
      if (u + KV_STAGES < 2 * n_tiles) {
        fence_proxy_async();
        load_u(u + KV_STAGES);
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
  // the 128-byte swizzle (16-byte chunk c of a panel's row r at c ^ (r & 7));
  // zeros for dead rows and positions past t. A thread's loads are all
  // issued before it converts (the block's start waits for one load
  // latency, not four). Then the ones that sum each row of P.
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
    *reinterpret_cast<uint4*>(smem + G::OFF_Q + (c8 / 8) * BM * PANEL_ROW + r * PANEL_ROW +
                              (((c8 % 8) ^ (r & 7)) << 4)) = scale_pack8(x, qk_scale);
  }
  for (int c = tid; c < ONES_BYTES / 16; c += THREADS)
    reinterpret_cast<uint4*>(smem + G::OFF_ONES)[c] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);  // bf16 1.0
  fence_proxy_async();
  named_barrier(1, THREADS);

  // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its warp).
  const int ra = wg * 64 + warp * 16 + lane / 4;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = q0 + (ra + 8 * h) % bq;
  auto edge = [&](int j) {
    return j * BN + BN > s || (causal && j * BN + BN - 1 > q0 + diag);
  };

  const uint64_t desc_q = desc_kmajor_sw128(base + G::OFF_Q + wg * 64 * PANEL_ROW);
  const uint64_t desc_ones = desc_interleave(base + G::OFF_ONES);
  float m[2] = {-INFINITY, -INFINITY};
  float acc[PANELS][32], ls[4];  // O (panel p: head dims 64 p ..) and P's row sums, both rescaled
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ls[i] = 0.f;
  auto fence_acc = [&]() {
#pragma unroll
    for (int p = 0; p < PANELS; ++p) reg_fence(acc[p]);
  };

  // A group of products is issued as: wait for the tiles it reads, compute
  // its descriptors, fence the register operands (their last writes stay
  // before wgmma.fence: a non-wgmma write of a product's input between the
  // fence and the commit serializes the kernel's wgmma, C7513), one
  // wgmma.fence, the products, one commit.
  auto wait_kv = [&](int j) { mbar_wait(full(j % KV_STAGES), (j / KV_STAGES) & 1); };
  auto desc_k = [&](int j) {
    return desc_kmajor_sw128(base + G::OFF_KV + (j % KV_STAGES) * 2 * TILE);
  };
  auto desc_v = [&](int j) {
    return desc_mnmajor_sw128(base + G::OFF_KV + (j % KV_STAGES) * 2 * TILE + TILE);
  };
  auto fence_operands = [&](uint32_t (&pa)[BN / 16][4], uint64_t& dk, uint64_t& dv) {
    fence_acc();
    reg_fence(ls);
    reg_fence(pa);
    asm volatile("" : "+l"(dk), "+l"(dv)::"memory");
    wgmma_fence();
  };
  // S = Q K^T into sc: D / 16 k-steps of 16 head dims (32 bytes of Q's and
  // K's rows; k-step kk in panel kk / 4).
  auto mma_s = [&](uint64_t dk, float (&sc)[NS]) {
    wgmma_s_zero(sc, desc_q, dk);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_s(sc, desc_q + (kk / 4) * Q_PANEL + 2 * (kk % 4),
              dk + (kk / 4) * KV_PANEL + 2 * (kk % 4));
  };
  // acc += P V (and ls += rowsum(P)): BN / 16 k-steps of 16 keys (32 bytes of
  // P's rows, 16 rows = 2048 bytes of each V panel), one n64 product a panel.
  auto mma_pv = [&](uint64_t dv, const uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(acc[p], pa[kk],
                                           dv + p * KV_PANEL + kk * (16 * PANEL_ROW >> 4), 1);
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
  if constexpr (RULE != RULE_BETA) {
    float sc[NS];  // tile j's S
    auto step = [&](int j, bool live, uint32_t (&p_prev)[BN / 16][4],
                    uint32_t (&p_cur)[BN / 16][4]) {
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
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) p_cur[kk][e] = 0u;
      } else if (edge(j)) {
        softmax_tile<RULE, true>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal, diag);
      } else {
        softmax_tile<RULE, false>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal, diag);
      }
      wgmma_wait<0>();
      fence_acc();
      reg_fence(ls);
      reg_fence(p_prev);
      if (j > 0) release(j - 1);  // this warpgroup reads tile j - 1 no more
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i % 4) / 2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ls[i] *= alpha[i / 2];
    };

    uint32_t p_a[BN / 16][4], p_b[BN / 16][4] = {};
    for (int j = 0; j < n_tiles; j += 2) {
      step(j, true, p_b, p_a);
      step(j + 1, j + 1 < n_tiles, p_a, p_b);
    }
    {  // tile n_tiles - 1's PV (or, n_tiles odd or 0, P = 0)
      uint64_t dk = 0, dv = desc_v(max(n_tiles - 1, 0));
      fence_operands(p_b, dk, dv);
      mma_pv(dv, p_b);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc();
    reg_fence(ls);
  } else {
    // "beta", group by group of gt key tiles (JAX's subtile): a pre-pass of
    // S alone gives each row's two largest logits, hence the group's max
    // (amplified where tied); alpha rescales O and l once; then the same
    // pipeline as above with that max fixed, the group's last PV drained
    // before the next group's pre-pass. The ring's u-th load (load_u): tile
    // j of the group [j0, j1) is load j0 + j in the pre-pass, j + j1 after.
    auto wait_u = [&](int u) { mbar_wait(full(u % KV_STAGES), (u / KV_STAGES) & 1); };
    auto desc_k_u = [&](int u) {
      return desc_kmajor_sw128(base + G::OFF_KV + (u % KV_STAGES) * 2 * TILE);
    };
    auto desc_v_u = [&](int u) {
      return desc_mnmajor_sw128(base + G::OFF_KV + (u % KV_STAGES) * 2 * TILE + TILE);
    };
    float sc[NS];
    // Step j of the group: tile j's S with tile j - 1's PV (P = 0 at j0),
    // tile j's softmax against the group's max while the PV runs.
    auto step = [&](int j, int j0, int j1, bool live, uint32_t (&p_prev)[BN / 16][4],
                    uint32_t (&p_cur)[BN / 16][4]) {
      uint64_t dv = desc_v_u(max(j - 1, j0) + j1);
      const int jc = min(j, j1 - 1);
      wait_u(jc + j1);
      uint64_t dk = desc_k_u(jc + j1);
      fence_operands(p_prev, dk, dv);
      mma_s(dk, sc);
      wgmma_commit();
      mma_pv(dv, p_prev);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile j is done
      reg_fence(sc);
      float alpha[2];
      if (!live) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) p_cur[kk][e] = 0u;
      } else if (edge(j)) {
        softmax_tile<RULE, true>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal, diag);
      } else {
        softmax_tile<RULE, false>(sc, p_cur, m, alpha, j * BN, cq, pos, s, causal, diag);
      }
      wgmma_wait<0>();
      fence_acc();
      reg_fence(ls);
      reg_fence(p_prev);
      if (j > j0 && j < j1) release_u(j - 1 + j1);  // the last tile's after the drain
    };

    uint32_t p_a[BN / 16][4], p_b[BN / 16][4];
    for (int j0 = 0; j0 < n_tiles; j0 += gt) {
      const int j1 = min(j0 + gt, n_tiles);
      float t1[2] = {-INFINITY, -INFINITY}, t2[2] = {-INFINITY, -INFINITY};
      for (int j = j0; j < j1; ++j) {  // the pre-pass
        wait_u(j0 + j);
        uint64_t dk = desc_k_u(j0 + j);
        asm volatile("" : "+l"(dk)::"memory");
        wgmma_fence();
        mma_s(dk, sc);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        release_u(j0 + j);
        if (edge(j))
          top2_tile<true>(sc, t1, t2, j * BN, cq, pos, s, causal, diag);
        else
          top2_tile<false>(sc, t1, t2, j * BN, cq, pos, s, causal, diag);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        quad_top2(t1[h], t2[h]);
        const float next = tied_max(m[h], t1[h], t2[h], beta, tol);
        alpha[h] = exp2_ftz(m[h] - next);  // 0 while m is -inf
        m[h] = next;
      }
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i % 4) / 2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ls[i] *= alpha[i / 2];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) p_b[kk][e] = 0u;
      for (int j = j0; j < j1; j += 2) {
        step(j, j0, j1, true, p_b, p_a);
        step(j + 1, j0, j1, j + 1 < j1, p_a, p_b);
      }
      {  // tile j1 - 1's PV (or, the group's tiles odd, P = 0)
        uint64_t dk = 0, dv = desc_v_u(2 * j1 - 1);
        fence_operands(p_b, dk, dv);
        mma_pv(dv, p_b);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc();
      reg_fence(ls);
      release_u(2 * j1 - 1);
    }
  }

  // Epilogue: O = acc / l (l == 0 -> 1) staged in shared memory by rows, then
  // 16-byte stores; lse = m + log2(l). A row that sees no key (causal, its
  // position + diag < 0: every logit was MASK_VALUE, or the block had no key
  // tile) gets O = 0 and lse = -inf, whatever its accumulators hold.
  float* o_s = reinterpret_cast<float*>(smem + G::OFF_O);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const bool empty = causal && pos[h] + diag < 0;
    const float l = ls[2 * h];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o_s + r * O_LD + 8 * n + cq) =
          empty ? make_float2(0.f, 0.f)
                : make_float2(acc[n / 8][4 * (n % 8) + 2 * h] / l_safe,
                              acc[n / 8][4 * (n % 8) + 2 * h + 1] / l_safe);
    if (lane % 4 == 0 && r < rows && pos[h] < t)
      lse[(static_cast<size_t>(bh) * rep + r / bq) * t + pos[h]] =
          empty ? -INFINITY : m[h] + log2f(l_safe);
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
// grid (cast_rows(D) rows along s, b * h_kv, the tensor). A thread converts 8
// elements of a row in each of 8 rows, all its loads issued before its
// stores (a block per 32 rows spends more time being scheduled than
// copying).
__host__ __device__ constexpr int cast_rows(int d) { return 256 * 64 / d; }

template <int D>
__global__ void __launch_bounds__(256)
kv_to_bf16_kernel(const float* __restrict__ k, const float* __restrict__ v, long long k_sb,
                  long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                  __nv_bfloat16* __restrict__ kb, __nv_bfloat16* __restrict__ vb, int h_kv,
                  int s) {
  constexpr int CAST_ROWS = cast_rows(D);
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
// boxes of BN keys x 64 head dims (one panel).
template <int D>
bool kv_map(CUtensorMap* map, const void* ptr, int b, int h_kv, int s, long long sb, long long sh,
            long long st) {
  const long long stride[3] = {2 * st, 2 * sh, 2 * sb};
  return tensor_map_4d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, h_kv, s, D, stride,
                       FwdGeom<D>::BN, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

bool strides16(long long elem_bytes, long long sb, long long sh, long long st) {
  return (sb * elem_bytes) % 16 == 0 && (sh * elem_bytes) % 16 == 0 && (st * elem_bytes) % 16 == 0;
}

// ---------------------------------------------------------------------------
// precision="fp32": 3xTF32 on wgmma
// ---------------------------------------------------------------------------
//
// Head dim 128 (F32Geom<128>): O takes 64 registers, so S walks 32-key
// tiles (16 registers, P's big and small fragments 32), Q big keeps its
// first 64 dims as register fragments (32 registers; with all 128, 255
// registers and a spill) and the rest in shared memory beside Q small, and
// each tile's P V runs as two m64n64 products, one a 64-dim half of O, each
// into the fresh accumulator and added to its half of O once done (the
// second after the first). A stage (K big and small, V^T big and small of 32
// keys) is 64 KB, as at 64; Q small and Q big's second half take 96 KB: a
// ring of 2 stages.

// Geometry of the fp32 mode at head dim D (ops/flash_tiling.py's fp32
// section mirrors it). Every operand is stored as 128-byte rows of 32 f32
// (the swizzle's span): K big and small in D / 32 blocks of [KEYS keys x 32
// dims], V^T big and small in KEYS / 32 blocks of [D dims x 32 keys], Q
// small in D / 32 blocks of [64 rows x 32 dims] a warpgroup.
template <int D>
struct F32Geom {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int KEYS = D == 64 ? 64 : 32;  // keys a K/V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // tiles in flight
  static constexpr int HALVES = D / 64;           // O's 64-dim halves, a P V product each
  static constexpr int QREG = 8;                  // Q big's k-steps in registers: dims 0-63
  static constexpr int QBLK = 64 * 128;           // a [64 x 32] block of Q small or Q big
  static constexpr int KBLK = KEYS * 128;         // a [KEYS x 32] block of K big or small
  static constexpr int VBLK = D * 128;            // a [D x 32] block of V^T big or small
  // a stage: K big, K small, V^T big, V^T small
  static constexpr int OFF_KS = (D / 32) * KBLK;
  static constexpr int OFF_VB = 2 * OFF_KS;
  static constexpr int OFF_VS = OFF_VB + (KEYS / 32) * VBLK;
  static constexpr int STAGE = OFF_VS + (KEYS / 32) * VBLK;
  static constexpr int OFF_QS = 0;                // Q small, D / 32 blocks a warpgroup
  static constexpr int OFF_QB = 2 * (D / 32) * QBLK;  // Q big past QREG, (D - 64) / 32 blocks
  static constexpr int OFF_RING = OFF_QB + 2 * ((D - 64) / 32) * QBLK;
  static constexpr int OFF_BAR = OFF_RING + STAGES * STAGE;
  static constexpr int SMEM = OFF_BAR + 128 + 1024;  // + slack to align the base to 1024
  static_assert(STAGES * 8 <= 64 && 64 + STAGES * 4 <= 128, "barriers fit");
  static_assert(SMEM <= 232448, "a block's shared memory fits an H100 SM");
};
constexpr int F_ROWS = 128;         // q positions a block (one q head): two warpgroups of 64
constexpr int F_COUNTERS = 64;      // byte offset of the release counters in the barrier area

// The K/V prep of the fp32 mode, one launch: K [b, h_kv, s, D] f32 (any
// strides, rows contiguous) -> K big and K small [b * h_kv, s, D]; V -> V^T
// big and V^T small [b * h_kv, D, s8] (s8 = s rounded up to 8), column 8g +
// j holding key 8g + tf32_a_column(j), keys past s 0: the K-major B of P V
// for a P whose fragments come from S's accumulator. Grid (s / 64 rounded
// up, b * h_kv); a block takes 64 keys, V through shared memory, every load
// issued before the first store.
template <int D>
__global__ void __launch_bounds__(256)
kv_split_tf32_kernel(const float* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
                     const float* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
                     float* __restrict__ kb, float* __restrict__ ks, float* __restrict__ vbt,
                     float* __restrict__ vst, int h_kv, int s, int s8) {
  __shared__ float v_s[SPLIT_KEYS][D + 1];
  const int bh = blockIdx.y;
  const long long batch = bh / h_kv, head = bh % h_kv;
  const size_t kv_at = static_cast<size_t>(bh) * s * D;
  const size_t vt_at = static_cast<size_t>(bh) * D * s8;
  kv_split_tf32_tile<D>(k + batch * k_sb + head * k_sh, k_st, v + batch * v_sb + head * v_sh,
                        v_st, kb + kv_at, ks + kv_at, vbt + vt_at, vst + vt_at,
                        blockIdx.x * SPLIT_KEYS, s, s8, v_s);
}

// The descriptor of k-step kk (8 columns, 32 bytes of a row) of a K-major
// f32 operand stored as 128-byte blocks of 32 columns, `blk` bytes apart.
__device__ __forceinline__ uint64_t desc_f32(uint32_t addr, int kk, int blk) {
  return desc_kmajor_sw128(addr + (kk / 4) * blk) + 2 * (kk % 4);
}

// S's TF32 k-steps into an m64 x 64 (N = 32 registers) or m64 x 32 (16)
// accumulator: A from registers (the first one into d, whose old values it
// neither reads nor keeps alive, and the next ones) or from shared memory.
template <int N>
__device__ __forceinline__ void s_rs_first(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32)
    wgmma_tf32_m64n64k8_rs_zero(d, a, db);
  else
    wgmma_tf32_m64n32k8_rs_zero(d, a, db);
}
template <int N>
__device__ __forceinline__ void s_rs(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32)
    wgmma_tf32_m64n64k8_rs(d, a, db, 1);
  else
    wgmma_tf32_m64n32k8_rs(d, a, db, 1);
}
template <int N>
__device__ __forceinline__ void s_ss(float (&d)[N], uint64_t da, uint64_t db) {
  if constexpr (N == 32)
    wgmma_tf32_m64n64k8_ss(d, da, db, 1);
  else
    wgmma_tf32_m64n32k8_ss(d, da, db, 1);
}

// One tile's S (f32, exp2 domain: Q is pre-scaled) -> P = exp2(S - m), 0
// where masked, split into the TF32 A fragments of P V (k-step n = keys 8n ..
// 8n + 7, in tf32_a_column order). Masks where MASK (the tile reaches past s
// or past the warpgroup's first position), updates the running max m
// (+EPS_BIAS), this thread's partial row sums l and each row's alpha. s[4 n +
// e]: row h = e / 2, key k0 + 8 n + c2 + (e & 1). Under "none" m takes no
// EPS_BIAS; under "beta" m is the group's, fixed by its pre-pass (alpha 1).
template <int RULE, bool MASK, int N>
__device__ __forceinline__ void softmax_tf32(const float (&s)[N], uint32_t (&pb)[N / 4][4],
                                             uint32_t (&ps)[N / 4][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int c2, const int (&pos)[2],
                                             int s_len, int causal) {
  auto visible = [&](int i) {
    const int col = k0 + (i / 4) * 8 + c2 + (i & 1);
    return col < s_len && (!causal || col <= pos[(i % 4) / 2]);
  };
  if constexpr (RULE == RULE_BETA) {
    alpha[0] = alpha[1] = 1.f;
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int h = (i % 4) / 2;
      mx[h] = fmaxf(mx[h], MASK && !visible(i) ? MASK_VALUE : s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mq = quad_max(mx[h]);
      if constexpr (RULE == RULE_EPS) mq += EPS_BIAS;
      const float next = fmaxf(m[h], mq);
      alpha[h] = exp2f(m[h] - next);  // 0 while m is -inf
      m[h] = next;
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
template <int D, int RULE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap kb_map,   // [b*h_kv, s, D] K big
                     const __grid_constant__ CUtensorMap ks_map,   // K small
                     const __grid_constant__ CUtensorMap vbt_map,  // [b*h_kv, D, s8] V^T big
                     const __grid_constant__ CUtensorMap vst_map,  // V^T small
                     const float* __restrict__ q,  // [b, h, t, D] f32, strides in elements
                     long long q_sb, long long q_sh, long long q_st,
                     float* __restrict__ o,    // [b, h, t, D]
                     float* __restrict__ lse,  // [b, h, t]
                     int h, int rep, int t, int s, int causal, float qk_scale,
                     int gt, float beta, float tol) {  // "beta": gt key tiles a group
  using G = F32Geom<D>;
  constexpr int KEYS = G::KEYS, STAGES = G::STAGES, HALVES = G::HALVES;
  constexpr int SN = KEYS / 2;  // S's accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  int* released = reinterpret_cast<int*>(smem + G::OFF_BAR + F_COUNTERS);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, batch = bh / h, head = bh % h;
  const int kvh = batch * (h / rep) + head / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS;  // the last positions (most tiles) first
  const int kv_hi = causal ? min(s, min(t, q0 + F_ROWS)) : s;
  const int n_tiles = (kv_hi + KEYS - 1) / KEYS;

  init_ring(bars, released, STAGES);
  // tile j's K big and small (and, unless `k_only`, V^T big and small) into
  // `dst`, block by block (K's loads grouped apart reorder the d=64 SASS);
  // keys past s arrive as zeros
  auto load_tile = [&](uint32_t dst, uint32_t bar, int j, bool k_only) {
#pragma unroll
    for (int blk = 0; blk < D / 32; ++blk) {
      tma_load_3d(dst + blk * G::KBLK, &kb_map, bar, 32 * blk, j * KEYS, kvh);
      tma_load_3d(dst + G::OFF_KS + blk * G::KBLK, &ks_map, bar, 32 * blk, j * KEYS, kvh);
      if (!k_only && blk < KEYS / 32) {
        tma_load_3d(dst + G::OFF_VB + blk * G::VBLK, &vbt_map, bar, j * KEYS + 32 * blk, 0, kvh);
        tma_load_3d(dst + G::OFF_VS + blk * G::VBLK, &vst_map, bar, j * KEYS + 32 * blk, 0, kvh);
      }
    }
  };
  auto load_kv = [&](int j) {  // tile j into stage j % STAGES
    const int st = j % STAGES;
    mbar_expect_tx(full(st), G::STAGE);
    load_tile(base + G::OFF_RING + st * G::STAGE, full(st), j, false);
  };
  // "beta" streams each group of gt key tiles twice, K big and small alone
  // for its pre-pass and then all four: the ring's u-th load is group g = u /
  // (2 gt)'s (every earlier group is whole), its K-only tiles first.
  auto load_u = [&](int u) {
    const int j0 = u / (2 * gt) * gt, ng = min(gt, n_tiles - j0), r = u - 2 * j0;
    const bool pre = r < ng;
    const int st = u % STAGES;
    mbar_expect_tx(full(st), pre ? G::STAGE / 2 : G::STAGE);
    load_tile(base + G::OFF_RING + st * G::STAGE, full(st), j0 + (pre ? r : r - ng), pre);
  };
  if constexpr (RULE == RULE_BETA) {
    if (tid == 0)
      for (int u = 0; u < min(STAGES, 2 * n_tiles); ++u) load_u(u);
  } else {
    if (tid == 0)
      for (int j = 0; j < min(STAGES, n_tiles); ++j) load_kv(j);
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int c = lane % 4;
  const int ra = 16 * warp + lane / 4;  // this thread's rows ra, ra + 8 of the warpgroup's 64
  int pos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) pos[h2] = q0 + 64 * wg + ra + 8 * h2;

  // Q * qk_scale (f32, PyTorch's bits), split: big as the A fragments of the
  // first QREG k-steps in registers (the rest K-major into shared memory),
  // small K-major into shared memory (128-byte swizzle: 16-byte chunk ch of
  // row r at ch ^ (r & 7)). Positions past t are 0. Every load is issued
  // before the first conversion. Each store's address is written out whole:
  // a shared row offset reorders the d=64 SASS, a few % slower.
  constexpr int QREG = G::QREG, QB_BLKS = (D - 64) / 32;
  uint32_t qa[QREG][4];
  const uint32_t qs_base = base + G::OFF_QS + wg * (D / 32) * G::QBLK;
  const uint32_t qb_base = base + G::OFF_QB + wg * QB_BLKS * G::QBLK;
  {
    float x[2][D / 4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float* row = q + batch * q_sb + head * q_sh + static_cast<long long>(pos[h2]) * q_st;
#pragma unroll
      for (int i = 0; i < D / 4; ++i)  // head dim 8 (i / 2) + c + 4 (i % 2)
        x[h2][i] = pos[h2] < t ? row[8 * (i / 2) + c + 4 * (i % 2)] : 0.f;
    }
    float* qs_s = reinterpret_cast<float*>(smem + G::OFF_QS + wg * (D / 32) * G::QBLK);
    float* qb_s = reinterpret_cast<float*>(smem + G::OFF_QB + wg * QB_BLKS * G::QBLK);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = ra + 8 * h2;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float xs = __fmul_rn(x[h2][i], qk_scale);
        const float big = tf32_big(xs);
        const int d = 8 * (i / 2) + c + 4 * (i % 2), w = d % 32;
        if (i / 2 < QREG)
          qa[(i / 2) % QREG][h2 + 2 * (i % 2)] = __float_as_uint(big);
        else
          qb_s[(d / 32 - QREG / 4) * (G::QBLK / 4) + r * 32 + (((w / 4) ^ (r & 7)) << 2) + w % 4] =
              big;
        qs_s[(d / 32) * (G::QBLK / 4) + r * 32 + (((w / 4) ^ (r & 7)) << 2) + w % 4] = xs - big;
      }
    }
  }
  fence_proxy_async();  // Q small, for wgmma
  named_barrier(1 + wg, 128);

  float sacc[SN], oacc[HALVES][32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pb[KEYS / 8][4] = {}, ps[KEYS / 8][4] = {};  // P big and small: the A of P V
#pragma unroll
  for (int i = 0; i < SN; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.f;
  auto edge = [&](int j) {
    return j * KEYS + KEYS > s || (causal && j * KEYS + KEYS - 1 > q0 + 64 * wg);
  };
  auto scale_o = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[hh][i] *= alpha[(i % 4) / 2];
  };

  // S = Q K^T of the tile in `stage`: 3 D / 8 products, the small terms
  // first into the accumulator, the big-big term last.
  auto issue_s = [&](uint32_t stage) {
    s_rs_first(sacc, qa[0], desc_f32(stage + G::OFF_KS, 0, G::KBLK));  // Q big . K small
#pragma unroll
    for (int kk = 1; kk < QREG; ++kk) s_rs(sacc, qa[kk], desc_f32(stage + G::OFF_KS, kk, G::KBLK));
#pragma unroll
    for (int kk = QREG; kk < D / 8; ++kk)
      s_ss(sacc, desc_f32(qb_base, kk - QREG, G::QBLK), desc_f32(stage + G::OFF_KS, kk, G::KBLK));
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)  // Q small . K big
      s_ss(sacc, desc_f32(qs_base, kk, G::QBLK), desc_f32(stage, kk, G::KBLK));
#pragma unroll
    for (int kk = 0; kk < QREG; ++kk)  // Q big . K big
      s_rs(sacc, qa[kk], desc_f32(stage, kk, G::KBLK));
#pragma unroll
    for (int kk = QREG; kk < D / 8; ++kk)
      s_ss(sacc, desc_f32(qb_base, kk - QREG, G::QBLK), desc_f32(stage, kk, G::KBLK));
    wgmma_commit();
  };
  auto stage_of = [&](int j) { return base + G::OFF_RING + (j % STAGES) * G::STAGE; };
  // P V of the tile in `stage` for O's half hh (head dims 64 hh ..: rows 64
  // hh .. of V^T): 3 KEYS / 8 products into the fresh accumulator pacc, the
  // small terms first, the big-big term last; once done it is added to that
  // half of oacc in f32 (round to nearest). The tensor cores' accumulation
  // truncates: every tile's products summed into oacc in place biased O
  // toward 0, 5.214e-5 of max|O| against float64 at the DiT's 4096 keys and
  // 6.200e-6 at 300 (kernel_probe.py fwd_fp32 on an H100; B10 exact's
  // recipe, csrc/jvp.cu).
  float pacc[32];
  auto issue_pv = [&](uint32_t stage, int hh) {
    const uint32_t vb = stage + G::OFF_VB + hh * 64 * 128, vs = stage + G::OFF_VS + hh * 64 * 128;
    wgmma_tf32_m64n64k8_rs_zero(pacc, ps[0], desc_f32(vb, 0, G::VBLK));  // P small . V big
#pragma unroll
    for (int kk = 1; kk < KEYS / 8; ++kk)
      wgmma_tf32_m64n64k8_rs(pacc, ps[kk], desc_f32(vb, kk, G::VBLK), 1);
#pragma unroll
    for (int kk = 0; kk < KEYS / 8; ++kk)  // P big . V small
      wgmma_tf32_m64n64k8_rs(pacc, pb[kk], desc_f32(vs, kk, G::VBLK), 1);
#pragma unroll
    for (int kk = 0; kk < KEYS / 8; ++kk)  // P big . V big
      wgmma_tf32_m64n64k8_rs(pacc, pb[kk], desc_f32(vb, kk, G::VBLK), 1);
    wgmma_commit();
  };
  auto add_pv = [&](int hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] += pacc[i];
  };
  // Half hh of the tile in `stage`, issued alone, drained and added.
  auto drain_pv = [&](uint32_t stage, int hh) {
    reg_fence(pb);
    reg_fence(ps);
    wgmma_fence();
    issue_pv(stage, hh);
    wgmma_wait<0>();
    reg_fence(pacc);
    reg_fence(pb);
    reg_fence(ps);
    add_pv(hh);
  };

  if constexpr (RULE != RULE_BETA) {
    // Tile j: the softmax of its S, then its P V (O's first half) and the
    // next tile's S issued together (the last tile's S again at the end: a
    // wgmma under a branch would serialize them all) and both waited for, so
    // no product is in flight across the loop's back edge (that too
    // serializes them, C7515) or while a ring wait's trap path is live
    // (C7517); then O's other half (head dim 128); then the stage is
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
        softmax_tf32<RULE, true>(sacc, pb, ps, m, l, alpha, j * KEYS, 2 * c, pos, s, causal);
      else
        softmax_tf32<RULE, false>(sacc, pb, ps, m, l, alpha, j * KEYS, 2 * c, pos, s, causal);
      scale_o(alpha);
      const int jn = min(j + 1, n_tiles - 1);
      if (j + 1 < n_tiles) mbar_wait(full(jn % STAGES), (jn / STAGES) & 1);
      reg_fence(sacc);
      reg_fence(pb);
      reg_fence(ps);
      wgmma_fence();
      issue_pv(stage_of(j), 0);
      issue_s(stage_of(jn));
      wgmma_wait<0>();
      reg_fence(sacc);
      reg_fence(pacc);
      reg_fence(pb);
      reg_fence(ps);
      add_pv(0);
#pragma unroll
      for (int hh = 1; hh < HALVES; ++hh) drain_pv(stage_of(j), hh);
      release_stage(released, j, STAGES, n_tiles, load_kv);
    }
  } else {
    // "beta", group by group of gt key tiles (JAX's subtile): a pre-pass of
    // S alone gives each row's two largest logits, hence the group's max
    // (amplified where tied); alpha rescales O and l once; then each tile's
    // S, its softmax against that max and its P V, each drained before the
    // next (no product is in flight at a ring wait or across a back edge).
    // Tile j of the group [j0, j1) is the ring's load j0 + j in the
    // pre-pass and j + j1 after.
    auto s_of = [&](int u) {
      mbar_wait(full(u % STAGES), (u / STAGES) & 1);
      reg_fence(sacc);
      wgmma_fence();
      issue_s(stage_of(u));
      wgmma_wait<0>();
      reg_fence(sacc);
    };
    for (int j0 = 0; j0 < n_tiles; j0 += gt) {
      const int j1 = min(j0 + gt, n_tiles);
      float t1[2] = {-INFINITY, -INFINITY}, t2[2] = {-INFINITY, -INFINITY};
      for (int j = j0; j < j1; ++j) {
        s_of(j0 + j);
        release_stage(released, j0 + j, STAGES, 2 * n_tiles, load_u);
        if (edge(j))
          top2_tile<true>(sacc, t1, t2, j * KEYS, 2 * c, pos, s, causal, 0);
        else
          top2_tile<false>(sacc, t1, t2, j * KEYS, 2 * c, pos, s, causal, 0);
      }
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        quad_top2(t1[h2], t2[h2]);
        const float next = tied_max(m[h2], t1[h2], t2[h2], beta, tol);
        alpha[h2] = exp2f(m[h2] - next);  // 0 while m is -inf
        m[h2] = next;
        l[h2] *= alpha[h2];
      }
      scale_o(alpha);
      for (int j = j0; j < j1; ++j) {
        s_of(j + j1);
        if (edge(j))
          softmax_tf32<RULE, true>(sacc, pb, ps, m, l, alpha, j * KEYS, 2 * c, pos, s, causal);
        else
          softmax_tf32<RULE, false>(sacc, pb, ps, m, l, alpha, j * KEYS, 2 * c, pos, s, causal);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) drain_pv(stage_of(j + j1), hh);
        release_stage(released, j + j1, STAGES, 2 * n_tiles, load_u);
      }
    }
  }

  // O = acc / l (l == 0 -> 1), lse = m + log2(l); rows past t store nothing.
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float lsum = quad_sum(l[h2]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (pos[h2] >= t) continue;
    const size_t row = static_cast<size_t>(bh) * t + pos[h2];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(o + row * D + 64 * hh + 8 * n + 2 * c) = make_float2(
            oacc[hh][4 * n + 2 * h2] / l_safe, oacc[hh][4 * n + 2 * h2 + 1] / l_safe);
    if (c == 0) lse[row] = m[h2] + log2f(l_safe);
  }
}

}  // namespace

// Shared bytes one bf16-mode block asks for at head dim d, 64 or 128
// (ops/flash_tiling.py's shared_bytes mirrors it); -1 for another d.
extern "C" int qa_flash_fwd_smem_bytes(int d) {
  return d == 64 ? FwdGeom<64>::SMEM_BYTES : d == 128 ? FwdGeom<128>::SMEM_BYTES : -1;
}

// Shared bytes one fp32-mode block asks for at head dim d, 64 or 128
// (ops/flash_tiling.py's fp32_shared_bytes mirrors it); -1 for another d.
extern "C" int qa_flash_fwd_f32_smem_bytes(int d) {
  return d == 64 ? F32Geom<64>::SMEM : d == 128 ? F32Geom<128>::SMEM : -1;
}

// The fp32 mode's K/V prep: k/v [b, h_kv, s, d] f32, d 64 or 128 (strides in
// elements, rows contiguous; pointers and strides 16-byte aligned) -> kb, ks
// [b * h_kv, s, d] and vbt, vst [b * h_kv, d, s8] f32 (s8 = s rounded up to
// 8), in one launch.
extern "C" int qa_flash_kv_split_tf32(const void* k, long long k_sb, long long k_sh,
                                      long long k_st, const void* v, long long v_sb,
                                      long long v_sh, long long v_st, void* kb, void* ks,
                                      void* vbt, void* vst, int b, int h_kv, int s, int d,
                                      void* stream) {
  if (b < 1 || h_kv < 1 || static_cast<long long>(b) * h_kv > 65535 || s < 1 ||
      s > (1 << 27) || (d != 64 && d != 128) || !aligned16(k) || !aligned16(v) ||
      !aligned16(kb) || !aligned16(ks) || !aligned16(vbt) || !aligned16(vst) ||
      !strides16(4, k_sb, k_sh, k_st) || !strides16(4, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((s + SPLIT_KEYS - 1) / SPLIT_KEYS, b * h_kv);
  auto* kernel = d == 64 ? &kv_split_tf32_kernel<64> : &kv_split_tf32_kernel<128>;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), k_sb, k_sh, k_st, static_cast<const float*>(v), v_sb, v_sh,
      v_st, static_cast<float*>(kb), static_cast<float*>(ks), static_cast<float*>(vbt),
      static_cast<float*>(vst), h_kv, s, (s + 7) / 8 * 8);
  return static_cast<int>(cudaGetLastError());
}

// precision="fp32" at head dim D under correction RULE: the maps, the
// shared-memory attribute (once an instance) and the launch. The host
// templates are static: their `configured` flags stay this library's even
// where a process loads altered copies of it (kernel_probe.py), which a flag
// of vague linkage would not.
template <int D, int RULE>
static int flash_fwd_f32(const void* q, long long q_sb, long long q_sh, long long q_st,
                         const void* kb, const void* ks, const void* vbt, const void* vst, void* o,
                         void* lse, int b, int h, int h_kv, int t, int s, int causal,
                         float qk_scale, int grain, float beta, float tol, cudaStream_t stream) {
  using G = F32Geom<D>;
  const int n_qt = (t + F_ROWS - 1) / F_ROWS;
  const int s8 = (s + 7) / 8 * 8;
  CUtensorMap kb_map, ks_map, vbt_map, vst_map;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_3d(&kb_map, kb, f32, 4, b * h_kv, s, D, G::KEYS, 32, sw) ||
      !tensor_map_3d(&ks_map, ks, f32, 4, b * h_kv, s, D, G::KEYS, 32, sw) ||
      !tensor_map_3d(&vbt_map, vbt, f32, 4, b * h_kv, D, s8, D, 32, sw) ||
      !tensor_map_3d(&vst_map, vst, f32, 4, b * h_kv, D, s8, D, 32, sw))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D, RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(b * h, n_qt);
  flash_fwd_f32_kernel<D, RULE><<<grid, THREADS, G::SMEM, stream>>>(
      kb_map, ks_map, vbt_map, vst_map, static_cast<const float*>(q), q_sb, q_sh, q_st,
      static_cast<float*>(o), static_cast<float*>(lse), h, h / h_kv, t, s, causal, qk_scale,
      grain / G::KEYS, beta, tol);
  return static_cast<int>(cudaGetLastError());
}

// precision="fp32": q [b, h, t, d] f32, d 64 or 128 (strides in elements,
// rows contiguous), the prep's kb, ks, vbt, vst (h = h_kv * rep) -> O [b, h,
// t, d], lse [b, h, t] f32 (contiguous); Q is scaled by qk_scale in the
// kernel. rule, grain, beta and tol as qa_flash_fwd's.
extern "C" int qa_flash_fwd_f32(const void* q, long long q_sb, long long q_sh, long long q_st,
                                const void* kb, const void* ks, const void* vbt, const void* vst,
                                void* o, void* lse, int b, int h, int h_kv, int t, int s,
                                int causal, float qk_scale, int d, int rule, int grain,
                                float beta, float tol, void* stream) {
  const int n_qt = (t + F_ROWS - 1) / F_ROWS;
  if (b < 1 || h_kv < 1 || h < h_kv || h % h_kv || static_cast<long long>(b) * h > 65535 ||
      t < 1 || s < 1 || s > (1 << 27) || n_qt > 65535 || (d != 64 && d != 128) ||
      !aligned16(kb) || !aligned16(ks) || !aligned16(vbt) || !aligned16(vst) ||
      rule < RULE_EPS || rule > RULE_BETA || (rule == RULE_BETA && (grain < 128 || grain % 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = decltype(&flash_fwd_f32<64, RULE_EPS>);
  constexpr Launch launches[2][3] = {
      {&flash_fwd_f32<64, RULE_EPS>, &flash_fwd_f32<64, RULE_NONE>, &flash_fwd_f32<64, RULE_BETA>},
      {&flash_fwd_f32<128, RULE_EPS>, &flash_fwd_f32<128, RULE_NONE>,
       &flash_fwd_f32<128, RULE_BETA>}};
  return launches[d == 128][rule](q, q_sb, q_sh, q_st, kb, ks, vbt, vst, o, lse, b, h, h_kv, t, s,
                                  causal, qk_scale, grain, beta, tol,
                                  static_cast<cudaStream_t>(stream));
}

// The K/V prep of f32 inputs: k/v [b, h_kv, s, d] f32, d 64 or 128 (strides
// in elements, rows contiguous; pointers and strides 16-byte aligned) ->
// kb/vb contiguous bf16 [b, h_kv, s, d], in one launch.
template <int D>
static int kv_to_bf16(const void* k, long long k_sb, long long k_sh, long long k_st,
                      const void* v, long long v_sb, long long v_sh, long long v_st, void* kb,
                      void* vb, int b, int h_kv, int s, cudaStream_t stream) {
  const dim3 grid((s + cast_rows(D) - 1) / cast_rows(D), b * h_kv, 2);
  kv_to_bf16_kernel<D><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), k_sb, k_sh, k_st, v_sb, v_sh,
      v_st, static_cast<__nv_bfloat16*>(kb), static_cast<__nv_bfloat16*>(vb), h_kv, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qa_flash_kv_to_bf16(const void* k, long long k_sb, long long k_sh, long long k_st,
                                   const void* v, long long v_sb, long long v_sh, long long v_st,
                                   void* kb, void* vb, int b, int h_kv, int s, int d,
                                   void* stream) {
  if (b < 1 || h_kv < 1 || static_cast<long long>(b) * h_kv > 65535 || s < 1 ||
      s > (1 << 27) || (d != 64 && d != 128) || !aligned16(k) || !aligned16(v) ||
      !aligned16(kb) || !aligned16(vb) || !strides16(4, k_sb, k_sh, k_st) ||
      !strides16(4, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = d == 64 ? &kv_to_bf16<64> : &kv_to_bf16<128>;
  return launch(k, k_sb, k_sh, k_st, v, v_sb, v_sh, v_st, kb, vb, b, h_kv, s,
                static_cast<cudaStream_t>(stream));
}

// bf16 mode at head dim D under correction RULE: the maps, the
// shared-memory attribute (once an instance) and the launch.
template <int D, int RULE>
static int flash_fwd(const void* q, long long q_sb, long long q_sh, long long q_st, int q_f32,
                     const void* k, long long k_sb, long long k_sh, long long k_st, const void* v,
                     long long v_sb, long long v_sh, long long v_st, void* o, void* lse, int b,
                     int h_kv, int rep, int t, int s, int bq, int causal, int diag, float qk_scale,
                     int grain, float beta, float tol, cudaStream_t stream) {
  constexpr int SMEM = FwdGeom<D>::SMEM_BYTES;
  CUtensorMap k_map, v_map;
  if (!kv_map<D>(&k_map, k, b, h_kv, s, k_sb, k_sh, k_st) ||
      !kv_map<D>(&v_map, v, b, h_kv, s, v_sb, v_sh, v_st))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(b * h_kv, (t + bq - 1) / bq);
  flash_fwd_kernel<D, RULE><<<grid, THREADS, SMEM, stream>>>(
      k_map, v_map, q, q_sb, q_sh, q_st, q_f32, static_cast<float*>(o), static_cast<float*>(lse),
      h_kv, rep, t, s, bq, causal, diag, qk_scale, grain / FwdGeom<D>::BN, beta, tol);
  return static_cast<int>(cudaGetLastError());
}

// bf16 mode: q [b, h, t, d] f32 (q_f32) or bf16, k/v [b, h_kv, s, d] bf16,
// d 64 or 128, each with its strides in elements (rows contiguous; pointers
// and strides 16-byte aligned) -> O [b, h, t, d], lse [b, h, t] f32
// (contiguous); h = h_kv * rep, bq query positions a block (rep * bq <=
// 128). Causal masking is on global positions: query i sits at q_offset + i,
// key j at k_offset + j (both >= 0; a sequence shard's first token). rule:
// RULE_EPS, RULE_NONE or RULE_BETA, the last with its group of `grain` keys
// (a multiple of 128), beta and tol.
extern "C" int qa_flash_fwd(const void* q, long long q_sb, long long q_sh, long long q_st,
                            int q_f32, const void* k, long long k_sb, long long k_sh,
                            long long k_st, const void* v, long long v_sb, long long v_sh,
                            long long v_st, void* o, void* lse, int b, int h_kv, int rep, int t,
                            int s, int bq, int causal, int q_offset, int k_offset,
                            float qk_scale, int d, int rule, int grain, float beta, float tol,
                            void* stream) {
  const int n_qt = bq < 1 ? 0 : (t + bq - 1) / bq;
  if (bq < 1 || rep < 1 || rep * bq > 128 || t < 1 || s < 1 || b < 1 || h_kv < 1 ||
      q_offset < 0 || k_offset < 0 || (d != 64 && d != 128) ||
      static_cast<long long>(b) * h_kv > 65535 || n_qt > 65535 || !aligned16(q) ||
      !strides16(q_f32 ? 4 : 2, q_sb, q_sh, q_st) || !aligned16(k) || !aligned16(v) ||
      !strides16(2, k_sb, k_sh, k_st) || !strides16(2, v_sb, v_sh, v_st) || rule < RULE_EPS ||
      rule > RULE_BETA || (rule == RULE_BETA && (grain < 128 || grain % 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = decltype(&flash_fwd<64, RULE_EPS>);
  constexpr Launch launches[2][3] = {
      {&flash_fwd<64, RULE_EPS>, &flash_fwd<64, RULE_NONE>, &flash_fwd<64, RULE_BETA>},
      {&flash_fwd<128, RULE_EPS>, &flash_fwd<128, RULE_NONE>, &flash_fwd<128, RULE_BETA>}};
  return launches[d == 128][rule](q, q_sb, q_sh, q_st, q_f32, k, k_sb, k_sh, k_st, v, v_sb, v_sh,
                                  v_st, o, lse, b, h_kv, rep, t, s, bq, causal,
                                  q_offset - k_offset, qk_scale, grain, beta, tol,
                                  static_cast<cudaStream_t>(stream));
}
