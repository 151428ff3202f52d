// Int8 flash-attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels quantizedattention_tpu/ops/int8_bwd.py:
// _int8_dkv_kernel (B7: dK, dV) and :_int8_dq_kernel (B8: dQ). Same
// arithmetic and rounding points, from the forward's residuals (int8 Q/K/V
// payloads, K smoothed, and their f32 scale tables; sq per (q head, q grain),
// sk and sv per (kv head, kv grain)):
//   P  = exp2(Q_i8 K_i8^T * c - lse), c = (sq * sk) * qk_scale, masked to 0,
//        in f32 (the integer logits are exact: s8 x s8 -> s32);
//   dV += bf16(P)^T dO                     (bf16 products, f32 accumulation)
//   dP  = (dO V_i8^T) * sv                 (V widened to bf16, exact)
//   dS  = P (dP - D) * sm_scale            (f32, the unrounded P; D from the wrapper)
//   dK += (bf16(dS)^T Q_i8) * sq           per (q head, q grain)
//   dQ += (bf16(dS) K_i8) * sk + rowsum(dS) * k_mean   per kv grain,
//        the rowsum over the f32 dS (the K-smoothing term).
// dO arrives in bf16 (as the JAX kernels' bf16 dots round it) and is not
// pre-scaled. The TPU kernel applies sq / sk after each grain's product, so
// a product whose scale changes with the grain runs into its own accumulator
// (dK_seg, dQ_seg), folded into the main one with that grain's scale when the
// grain ends; no scale is folded into a bf16 operand before it rounds.
// Masked logits (causal k <= q on global positions, k + k_offset <= q +
// q_offset; keys past s) and positions past t give P = 0, and so does a row
// that saw no key (lse -inf: ops/int8_bwd.py hands it to the kernels as
// +inf). The offsets enter as diag = q_offset - k_offset: they move the first
// q tile (B7), the last key tile (B8) and the masked tiles, never the
// products a tile issues. A block that sees nothing writes zeros.
//
// What bounds it on this card: at (4,16,2048,64), causal, B7 runs one int8
// product (S) and three bf16 products (dV, dP, dK) over 134 M visible pairs,
// B8 one int8 (S) and two bf16 (dP, dQ): 0.0608 and 0.0434 ms on the tensor
// cores, against a few tens of MB of operands. Between the products, each
// pair takes one exponential (the SM's 16 a cycle: about 35 us a kernel at
// that shape across the card) and about 8 FMA-pipe operations, so the
// elementwise work is of the order of the products' and has to overlap them.
//
// Design (as B5's, csrc/int8_fwd.cu): blocks of two consumer warpgroups (256
// threads, up to 255 registers each), thread 0 issuing the TMA, every product
// on wgmma with f32 accumulators in registers, and int8 tiles widened to bf16
// by byte permutes and one f32 subtraction (off the conversion pipe), once a
// tile for both warpgroups.
//   B7: one block per (batch * kv head, 128-key tile), each warpgroup 64 keys
//       (the tile lies inside one kv grain: sk, sv one number a block). K
//       sits in shared memory (int8, K-major, the A of S^T = K Q^T); V is
//       widened once into each warpgroup's bf16 A fragments (registers), the
//       A of dP^T = V dO^T. For each q head of the GQA group and each 64-row q
//       tile that can see the block's keys, TMA streams the int8 Q tile
//       (64-byte swizzle) and the bf16 dO tile (128-byte swizzle, a 3-D map,
//       so rows past t arrive as zeros) through a ring of DKV_STAGES stages;
//       the threads load lse and D a tile ahead and widen Q into a bf16 tile.
//       A warpgroup issues S^T (s8) with dP^T (B = dO read K-major), widens
//       while they run, turns them into P^T and dS^T (bf16 A fragments in
//       registers), and issues dV += P^T dO (B = the same dO tile read
//       MN-major) with dK_seg += dS^T Q (B = the widened Q, MN-major); they
//       run while the next tile's S^T and dP^T are issued. dK itself sums in
//       shared memory (each thread its own slots), folded once per (q head, q
//       grain). Masking runs only on tiles at the causal diagonal or past t
//       or s (a warpgroup whose keys all lie past a causal tile computes it
//       masked: a branch around its products would serialize every wgmma).
//       Key tile 0 (the most q tiles) starts first.
//   B8: one block per (batch * kv head, 128 rows); the rows hold the kv head's
//       whole GQA group (row r -> q head kv_head * rep + r / bq at position q0
//       + r % bq, bq = 128 / rep rounded down), each warpgroup 64 of them. Q
//       sits in shared memory (int8, the A of S); dO is the bf16 A fragments
//       of dP = dO V^T; lse, D and sq are per row in registers. TMA streams
//       int8 K and V tiles of 64 keys through a ring of DQ_STAGES stages; the
//       threads widen each tile a step ahead (V into the K-major B of dP, K
//       into the MN-major B of dQ_seg += dS K). Causal blocks stop at their
//       last visible key tile; the blocks with the most key tiles start
//       first.
// A tile's TMA wait in B7 comes while no product is in flight (tile i + 1's
// before tile i's dV and dK_seg are issued): a wait with a product's
// registers live made ptxas inject a warpgroup.wait (C7517).
//
// Head dim 128 (BwdGeom<128>, chosen by the entries' d): the same bodies.
// An int8 row is 128 bytes (the 128-byte swizzle; S and S^T take four k32
// steps) and a bf16 tile is two 64-dim panels, so dV, dK_seg and dQ_seg are
// two m64n64 products a k-step, one a panel, and dP, dP^T eight k16 steps.
// Registers: V's A fragments (32) beside dV, dK_seg (64 each), S^T, dP^T
// (32 each) and P^T, dS^T (16 each) pass 255, so B7 widens V once into
// shared memory and reads it as the A of dP^T (SS), its ring holds 3
// stages, and it waits for a tile's dV and dK_seg before the next tile's
// S^T and dP^T (245 registers); B8 sums dQ in shared memory as B7 sums dK
// (each thread its own slots) beside dO's A fragments (32) and dQ_seg (64),
// 244 registers. At (4,16,2048,128) causal B7's products are 34.4 G int8
// and 103 G bf16 operations (0.122 ms on the tensor cores), B8's 34.4 G and
// 68.7 G (0.087 ms).
// Each block owns its output rows: no atomics, the same bits every run.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;         // two warpgroups
constexpr int TILE = 64;             // q positions (B7) or keys (B8) a streamed tile
constexpr int ACC = 32;              // f32 accumulator registers a thread (m64n64)
constexpr int PANEL = TILE * 128;    // bytes of a bf16 panel: 64 rows of 64 bf16
constexpr uint64_t PANEL_DESC = PANEL >> 4;  // a descriptor's step from one panel to the next

// One body for head dims 64 and 128 (ops/int8_tiling.py mirrors BwdGeom).
// An int8 row of D bytes takes the 64-byte swizzle at 64 and the 128-byte
// one at 128; a bf16 tile is D / 64 panels of [64, 64] in the 128-byte
// swizzle. At 128, B7 reads V (widened once) as the A of dP^T from shared
// memory and B8 sums dQ in shared memory, as B7 sums dK: V's register
// fragments or dQ beside its segment would pass 255 registers.
template <int D>
struct BwdGeom {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int PANELS = D / 64;
  static constexpr int I8_TILE = TILE * D;    // bytes of an int8 tile
  static constexpr int BF_TILE = 2 * I8_TILE; // bytes of a bf16 tile (PANELS panels)
  static constexpr int SUM_BYTES = PANELS * ACC * THREADS * 4;  // an m64 x D f32 sum a warpgroup
  // B7: dK, dV. Shared layout (from a 1024-byte aligned base): K [128, D]
  // int8; at D = 128 the widened V [128, D] bf16 (warpgroup w's keys at w
  // BF_TILE); the ring of int8 Q and bf16 dO tiles; two widened Q tiles; dK's
  // sums ([PANELS * ACC][THREADS] f32); two row buffers; the mbarriers.
  static constexpr int DKV_KEYS = 128;                 // keys a block: two warpgroups of 64
  static constexpr int DKV_STAGES = D == 64 ? 4 : 3;   // Q / dO tiles in flight
  static constexpr int ROW_FLOATS = 2 * TILE + 4;      // a q tile's lse[64], D[64], sq
  static constexpr int DKV_OFF_VW = DKV_KEYS * D;      // after K
  static constexpr int DKV_OFF_Q = DKV_OFF_VW + (D == 64 ? 0 : 2 * BF_TILE);
  static constexpr int DKV_OFF_DO = DKV_OFF_Q + DKV_STAGES * I8_TILE;
  static constexpr int DKV_OFF_QW = DKV_OFF_DO + DKV_STAGES * BF_TILE;  // two widened Q tiles
  static constexpr int DKV_OFF_DK = DKV_OFF_QW + 2 * BF_TILE;
  static constexpr int DKV_OFF_ROWS = DKV_OFF_DK + SUM_BYTES;  // two row buffers
  static constexpr int DKV_OFF_BAR = DKV_OFF_ROWS + 2 * ROW_FLOATS * 4;
  static constexpr int DKV_SMEM = DKV_OFF_BAR + 64 + 1024;  // + slack to align the base to 1024
  // B8: dQ. Q [128, D] int8; the ring of int8 K and V tiles; the widened K
  // tiles (one a step ahead, one read, one draining) and V tiles; at D = 128
  // dQ's sums; the mbarriers.
  static constexpr int DQ_ROWS = 128;                  // rows a block: two warpgroups of 64
  static constexpr int DQ_STAGES = 3;                  // int8 K / V tiles in flight
  static constexpr int DQ_KW = 3;                      // widened K tiles
  static constexpr int DQ_OFF_K = DQ_ROWS * D;         // after Q
  static constexpr int DQ_OFF_V = DQ_OFF_K + DQ_STAGES * I8_TILE;
  static constexpr int DQ_OFF_KW = DQ_OFF_V + DQ_STAGES * I8_TILE;
  static constexpr int DQ_OFF_VW = DQ_OFF_KW + DQ_KW * BF_TILE;
  static constexpr int DQ_OFF_DQ = DQ_OFF_VW + 2 * BF_TILE;
  static constexpr int DQ_OFF_BAR = DQ_OFF_DQ + (D == 64 ? 0 : SUM_BYTES);
  static constexpr int DQ_SMEM = DQ_OFF_BAR + 64 + 1024;

  static constexpr int I8_ATOM = D == 64 ? 512 : 1024;  // an int8 tile's swizzle atom
  static_assert(DKV_OFF_Q % 1024 == 0 && DKV_OFF_DO % 1024 == 0 && DKV_OFF_QW % 1024 == 0 &&
                    DKV_OFF_VW % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
  static_assert(DQ_OFF_K % I8_ATOM == 0 && DQ_OFF_V % I8_ATOM == 0 && I8_TILE % I8_ATOM == 0 &&
                    DQ_OFF_KW % 1024 == 0 && DQ_OFF_VW % 1024 == 0,
                "swizzled tiles start on their swizzle atom");
  static_assert(DKV_STAGES * 8 <= 64 && DQ_STAGES * 8 <= 64, "the barriers fit");
  static_assert(DKV_OFF_BAR % 8 == 0 && DQ_OFF_BAR % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "a block's shared memory fits an H100 SM");
};

__device__ __forceinline__ void init_barriers(uint32_t bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The swizzle of an int8 row r's 16-byte chunks: the 64-byte one at D = 64
// (chunk c at c ^ ((r >> 1) & 3)), the 128-byte one at 128 (c ^ (r & 7)).
template <int D>
__device__ __forceinline__ int i8_swizzle(int r) {
  return D == 64 ? (r >> 1) & 3 : r & 7;
}

template <int D>
__device__ __forceinline__ uint64_t desc_i8(uint32_t addr) {
  return D == 64 ? desc_kmajor_sw64(addr) : desc_kmajor_sw128(addr);
}

// n rows of a [*, D] int8 payload -> shared, K-major in i8_swizzle's layout;
// `row` maps a tile row to its payload row, or -1 for a zero row.
template <int D, class RowOf>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const int8_t* src, int n, RowOf row) {
  for (int c = threadIdx.x; c < n * (D / 16); c += THREADS) {
    const int r = c / (D / 16), c16 = c % (D / 16);
    const long long at = row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (at >= 0) val = *reinterpret_cast<const uint4*>(src + at * D + c16 * 16);
    *reinterpret_cast<uint4*>(dst + r * D + ((c16 ^ i8_swizzle<D>(r)) << 4)) = val;
  }
}

// 16 int8 of row r (r < 64 of a panel group), head dims 16 c16 .., widened
// into two 16-byte chunks of panel c16 / 4 (the 128-byte swizzle).
__device__ __forceinline__ void widen_chunk(uint8_t* dst, int r, int c16, uint4 x) {
  uint8_t* row = dst + (c16 / 4) * PANEL + r * 128;
  const int c8 = 2 * (c16 % 4);
  *reinterpret_cast<uint4*>(row + ((c8 ^ (r & 7)) << 4)) = widen8(x.x, x.y);
  *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (r & 7)) << 4)) = widen8(x.z, x.w);
}

// One 64-row int8 tile (i8_swizzle's layout) -> bf16 panels in the 128-byte
// swizzle (desc_kmajor_sw128's and desc_mnmajor_sw128's layout).
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* src, uint8_t* dst, int tid) {
  if constexpr (D == 64) {
    widen_tile_64x64(src, dst, tid);
  } else {
#pragma unroll
    for (int i = 0; i < TILE * (D / 16) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (D / 16), c16 = c % (D / 16);
      widen_chunk(dst, r, c16,
                  *reinterpret_cast<const uint4*>(src + r * D + ((c16 ^ (r & 7)) << 4)));
    }
  }
}

// The descriptor of k-step kk (16 head dims, 32 bytes of a row) of a K-major
// bf16 tile of 64-row panels.
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk) {
  return desc + (kk / 4) * PANEL_DESC + 2 * (kk % 4);
}

__device__ __forceinline__ void zero(float (&x)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) x[i] = 0.f;
}

template <int P>
__device__ __forceinline__ void zero(float (&x)[P][ACC]) {
#pragma unroll
  for (int p = 0; p < P; ++p) zero(x[p]);
}

template <int P>
__device__ __forceinline__ void fence_all(float (&x)[P][ACC]) {
#pragma unroll
  for (int p = 0; p < P; ++p) reg_fence(x[p]);
}

// Which tile of the (q head, q tile) walk a B7 block is at, without
// divisions: q tiles j0 .. n_qt - 1 of head g, then of head g + 1.
struct QTileCursor {
  int g, j;
  __device__ __forceinline__ void next(int j0, int n_qt) {
    if (++j == n_qt) {
      j = j0;
      ++g;
    }
  }
};

// B7's P^T and dS^T of one tile, as the bf16 A fragments of dV and dK_seg:
// P^T = exp2(raw * c - lse_q), 0 where masked; dS^T = P^T (dP^T * sv - D_q)
// * sm_scale with the unrounded P. st[4 n + e], dpt[4 n + e]: key key[e / 2],
// q column 8 n + cq + (e & 1), whose lse and D are rw[col], rw[64 + col].
// MASK: the tile reaches past t or s or the causal diagonal.
template <bool MASK>
__device__ __forceinline__ void dkv_p_ds(const int (&st)[ACC], const float (&dpt)[ACC],
                                         const float* rw, float c, float sv, float sm_scale,
                                         int q0, int cq, const int (&key)[2], int s, int t,
                                         int causal, int diag, uint32_t (&pa)[4][4],
                                         uint32_t (&da)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(rw + 8 * n + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(rw + TILE + 8 * n + cq);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(__fmul_rn(small_int_to_float(st[4 * n + e]), c) - ((e & 1) ? l2.y : l2.x));
      if (MASK) {
        const int pos = q0 + 8 * n + cq + (e & 1), k = key[e / 2];
        p[e] = k < s && pos < t && (!causal || k <= pos + diag) ? p[e] : 0.f;
      }
      ds[e] = __fmul_rn(__fmul_rn(p[e], __fmul_rn(dpt[4 * n + e], sv) - ((e & 1) ? d2.y : d2.x)),
                        sm_scale);
    }
    pa[n / 2][(n % 2) * 2 + 0] = as_u32(__floats2bfloat162_rn(p[0], p[1]));
    pa[n / 2][(n % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(p[2], p[3]));
    da[n / 2][(n % 2) * 2 + 0] = as_u32(__floats2bfloat162_rn(ds[0], ds[1]));
    da[n / 2][(n % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(ds[2], ds[3]));
  }
}

// B8's dS of one tile, as the bf16 A fragments of dQ_seg, and its row sums
// added to rs: P = exp2(raw * c - lse), 0 where masked; dS = P (dP * sv - D)
// * sm_scale with the unrounded P. s_acc[4 n + e], dp[4 n + e]: row e / 2,
// key k0 + 8 n + cq + (e & 1). MASK: the tile reaches past s or the causal
// diagonal.
template <bool MASK>
__device__ __forceinline__ void dq_ds(const int (&s_acc)[ACC], const float (&dp)[ACC],
                                      const float (&c)[2], const float (&lse_r)[2],
                                      const float (&di_r)[2], float sv, float sm_scale, int k0,
                                      int cq, const int (&pos)[2], int s, int causal,
                                      int diag, float (&rs)[2], uint32_t (&dsa)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      float p = exp2_ftz(__fmul_rn(small_int_to_float(s_acc[4 * n + e]), c[h]) - lse_r[h]);
      if (MASK) {
        const int col = k0 + 8 * n + cq + (e & 1);
        p = col < s && (!causal || col <= pos[h] + diag) ? p : 0.f;
      }
      ds[e] = __fmul_rn(__fmul_rn(p, __fmul_rn(dp[4 * n + e], sv) - di_r[h]), sm_scale);
      rs[h] += ds[e];
    }
    dsa[n / 2][(n % 2) * 2 + 0] = as_u32(__floats2bfloat162_rn(ds[0], ds[1]));
    dsa[n / 2][(n % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(ds[2], ds[3]));
  }
}

// ---------------------------------------------------------------------------
// B7: dK, dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
int8_dkv_kernel(const __grid_constant__ CUtensorMap q_map,   // [bh_kv * rep * q_pad, D] int8
                const __grid_constant__ CUtensorMap do_map,  // [bh_kv * rep, t, D] bf16
                const int8_t* __restrict__ k,                // [bh_kv, kv_pad, D]
                const int8_t* __restrict__ v,                // [bh_kv, kv_pad, D]
                const float* __restrict__ sq,                // [bh_kv * rep, nq]
                const float* __restrict__ sk,                // [bh_kv, nk]
                const float* __restrict__ sv,                // [bh_kv, nk]
                const float* __restrict__ lse,               // [bh_kv * rep, t]
                const float* __restrict__ di,                // [bh_kv * rep, t]
                float* __restrict__ dk,                      // [bh_kv, s, D]
                float* __restrict__ dv,                      // [bh_kv, s, D]
                int rep, int t, int s, int q_pad, int kv_pad, int nq, int nk, int q_grain,
                int kv_grain, int causal, int diag, float qk_scale, float sm_scale) {
  using G = BwdGeom<D>;
  constexpr int PANELS = G::PANELS, I8_TILE = G::I8_TILE, BF_TILE = G::BF_TILE;
  constexpr int DKV_STAGES = G::DKV_STAGES, ROW_FLOATS = G::ROW_FLOATS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::DKV_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  float* rows_s = reinterpret_cast<float*>(smem + G::DKV_OFF_ROWS);
  float* dk_s = reinterpret_cast<float*>(smem + G::DKV_OFF_DK);

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * G::DKV_KEYS;  // key tile 0, which sees the most q tiles, first
  const int n_qt = (t + TILE - 1) / TILE;
  // Causal: q tiles wholly before the key tile's first key, moved by diag =
  // q_offset - k_offset, see none of its keys (a block that no q tile sees
  // writes dK = dV = 0).
  const int j0 = causal ? min(max(0, k0 - diag) / TILE, n_qt) : 0;
  const int per_head = n_qt - j0;
  const int n_tiles = rep * per_head;  // tile i: q head i / per_head, q tile j0 + i % per_head

  init_barriers(bars, DKV_STAGES);

  // Thread 0 fills the ring: tiles 0 .. DKV_STAGES - 1 now, tile i - 2 +
  // DKV_STAGES at the start of tile i, into the stage of tile i - 2, whose
  // last reader (tile i - 2's dV product) every thread waited for before the
  // barrier that ended tile i - 1. A dO tile is PANELS boxes of 64 head dims.
  QTileCursor at_load = {0, j0};  // the next tile to load
  auto load_tile = [&](int i) {
    if (tid == 0 && i < n_tiles) {
      const int head = static_cast<int>(bh) * rep + at_load.g;
      const int q0 = at_load.j * TILE;
      const int st = i % DKV_STAGES;
      mbar_expect_tx(full(st), I8_TILE + BF_TILE);
      tma_load_2d(base + G::DKV_OFF_Q + st * I8_TILE, &q_map, full(st), 0, head * q_pad + q0);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(base + G::DKV_OFF_DO + st * BF_TILE + p * PANEL, &do_map, full(st), 64 * p,
                    q0, head);
      at_load.next(j0, n_qt);
    }
  };
  for (int i = 0; i < DKV_STAGES; ++i) load_tile(i);

  // The next tile's lse and D (threads 0-63, 64-127; 0 past t) and sq
  // (thread 128), loaded into registers a tile ahead and stored into row
  // buffer i % 2.
  const int q_tiles_per_grain = q_grain / TILE;
  QTileCursor at_rows = {0, j0};
  auto fetch_rows = [&](int i) {
    float x = 0.f;
    if (i < n_tiles && tid <= 2 * TILE) {
      const size_t head = bh * rep + at_rows.g;
      const int q0 = at_rows.j * TILE;
      if (tid == 2 * TILE) {
        x = sq[head * nq + at_rows.j / q_tiles_per_grain];
      } else {
        const int pos = q0 + tid % TILE;
        if (pos < t) x = (tid < TILE ? lse : di)[head * t + pos];
      }
    }
    at_rows.next(j0, n_qt);
    return x;
  };
  auto store_rows = [&](int i, float x) {
    if (tid <= 2 * TILE) rows_s[(i % 2) * ROW_FLOATS + tid] = x;
  };

  // The block's K rows (past s: payload padding, which P masks) and tile 0's
  // rows; dK's sums start at 0 (each thread owns its PANELS * ACC slots). At
  // D = 128 also V, widened once (warpgroup w's 64 keys at w BF_TILE).
  stage_rows<D>(smem, k, G::DKV_KEYS,
                [&](int r) { return static_cast<long long>(bh * kv_pad + k0 + r); });
  store_rows(0, fetch_rows(0));
#pragma unroll
  for (int e = 0; e < PANELS * ACC; ++e) dk_s[e * THREADS + tid] = 0.f;
  if constexpr (D == 128) {
#pragma unroll
    for (int i = 0; i < G::DKV_KEYS * (D / 16) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (D / 16), c16 = c % (D / 16);
      widen_chunk(smem + G::DKV_OFF_VW + (r / 64) * BF_TILE, r % 64, c16,
                  *reinterpret_cast<const uint4*>(v + (bh * kv_pad + k0 + r) * D + c16 * 16));
    }
  }
  fence_proxy_async();
  named_barrier(1, THREADS);

  // The consumer warpgroups: wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;                     // accumulator column pair
  const int kw0 = k0 + 64 * wg;                      // the warpgroup's first key
  const int kr = 64 * wg + 16 * warp + lane / 4;     // this thread's rows kr, kr + 8
  const int key[2] = {k0 + kr, k0 + kr + 8};
  const float sk_b = sk[bh * nk + k0 / kv_grain];
  const float sv_b = sv[bh * nk + k0 / kv_grain];

  // D = 64: V rows kr, kr + 8 as the A fragments of dP^T = V dO^T (k-step
  // kk: head dims 16 kk + cq, + 1 and 16 kk + 8 + cq, + 1), widened once.
  uint32_t va[D == 64 ? 4 : 1][4];
  if constexpr (D == 64) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* row = v + (bh * kv_pad + key[h]) * D + 4 * ((lane % 4) / 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint2 lo = widen4(*reinterpret_cast<const uint32_t*>(row + 16 * kk));
        const uint2 hi = widen4(*reinterpret_cast<const uint32_t*>(row + 16 * kk + 8));
        va[kk][h] = (lane & 1) ? lo.y : lo.x;
        va[kk][2 + h] = (lane & 1) ? hi.y : hi.x;
      }
    }
  }

  const uint64_t desc_k = desc_i8<D>(base + 64 * wg * D);
  const uint64_t desc_vw = desc_kmajor_sw128(base + G::DKV_OFF_VW + wg * BF_TILE);  // D = 128
  float dv_acc[PANELS][ACC], dk_seg[PANELS][ACC], dpt[ACC];
  int st_acc[ACC];
  uint32_t pa[4][4] = {}, da[4][4] = {};  // bf16 P^T and dS^T: the A of dV and dK_seg
  zero(dv_acc);
  zero(dk_seg);
  zero(dpt);
#pragma unroll
  for (int e = 0; e < ACC; ++e) st_acc[e] = 0;
  bool fold = false;  // a segment ended with the last tile: fold dK_seg once it is done
  float sq_fold = 0.f;
  auto fold_dk = [&]() {
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        float& sum = dk_s[(p * ACC + e) * THREADS + tid];
        sum = __fadd_rn(sum, __fmul_rn(dk_seg[p][e], sq_fold));
        dk_seg[p][e] = 0.f;
      }
  };

  // A tile's Q and dO are waited for while no product is in flight (tile 0
  // here, tile i + 1 before tile i's dV and dK_seg): a wait's trap path with
  // a product's registers live makes ptxas inject a warpgroup.wait (C7517).
  if (n_tiles > 0) mbar_wait(full(0), 0);
  int j = j0;  // tile i's q tile
  int seg = j0 % q_tiles_per_grain;  // its place in the q grain
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % DKV_STAGES;
    if (i >= 2) load_tile(i - 2 + DKV_STAGES);
    const float next_rows = fetch_rows(i + 1);
    const int q0 = j * TILE;
    if constexpr (D == 128) {
      // the last tile's dV and dK_seg are done before this tile's S^T and
      // dP^T are issued: with P^T and dS^T dead there, a thread holds 245
      // registers (in flight beside them, it spilled at 255)
      wgmma_wait<0>();
      fence_all(dv_acc);
      fence_all(dk_seg);
    }
    {  // S^T = K Q^T (s8) and dP^T = V dO^T (bf16, B = dO K-major)
      const uint64_t desc_q = desc_i8<D>(base + G::DKV_OFF_Q + st * I8_TILE);
      const uint64_t desc_do = desc_kmajor_sw128(base + G::DKV_OFF_DO + st * BF_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_s8_m64n64k32(st_acc, desc_k + 2 * kk, desc_q + 2 * kk, kk > 0);
      if constexpr (D == 64) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_rs<B_KMAJOR>(dpt, va[kk], desc_do + 2 * kk, kk > 0);
      } else {  // A = the widened V from shared memory
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_bf16_m64n64k16_ss(dpt, kstep(desc_vw, kk), kstep(desc_do, kk), kk > 0);
      }
      wgmma_commit();
    }
    widen_tile<D>(smem + G::DKV_OFF_Q + st * I8_TILE, smem + G::DKV_OFF_QW + (i % 2) * BF_TILE,
                  tid);
    store_rows(i + 1, next_rows);
    wgmma_wait<0>();  // this tile's S^T, dP^T and the last tile's dV, dK_seg are done
    reg_fence(st_acc);
    reg_fence(dpt);
    reg_fence(pa);
    reg_fence(da);
    fence_all(dv_acc);
    fence_all(dk_seg);
    if (fold) {
      fold_dk();
      fold = false;
    }
    const float* rw = rows_s + (i % 2) * ROW_FLOATS;
    const float sq_t = rw[2 * TILE];
    // the tile lies in one q grain: c = (sq * sk) * qk_scale is one number
    const float c = __fmul_rn(__fmul_rn(sq_t, sk_b), qk_scale);
    // masking only where the tile reaches past t or s or the diagonal (a
    // warpgroup whose keys all lie past a causal tile gets P = 0)
    if (q0 + TILE > t || kw0 + 64 > s || (causal && q0 + diag < kw0 + 63))
      dkv_p_ds<true>(st_acc, dpt, rw, c, sv_b, sm_scale, q0, cq, key, s, t, causal, diag, pa,
                     da);
    else
      dkv_p_ds<false>(st_acc, dpt, rw, c, sv_b, sm_scale, q0, cq, key, s, t, causal, diag, pa,
                      da);
    if (i + 1 < n_tiles) mbar_wait(full((i + 1) % DKV_STAGES), ((i + 1) / DKV_STAGES) & 1);
    fence_proxy_async();  // the widened Q tile, for wgmma
    named_barrier(1, THREADS);
    {  // dV += P^T dO, dK_seg += dS^T Q (both B MN-major, one n64 product a panel)
      const uint64_t desc_dot = desc_mnmajor_sw128(base + G::DKV_OFF_DO + st * BF_TILE);
      const uint64_t desc_qw = desc_mnmajor_sw128(base + G::DKV_OFF_QW + (i % 2) * BF_TILE);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dv_acc[p], pa[kk],
                                             desc_dot + p * PANEL_DESC + 128 * kk, 1);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dk_seg[p], da[kk],
                                             desc_qw + p * PANEL_DESC + 128 * kk, 1);
      wgmma_commit();
    }
    // the (q head, q grain) segment ends with this tile: dK += dK_seg * sq
    ++seg;
    if (j + 1 == n_qt || seg == q_tiles_per_grain) {
      fold = true;
      sq_fold = sq_t;
    }
    if (seg == q_tiles_per_grain) seg = 0;
    if (++j == n_qt) {
      j = j0;
      seg = j0 % q_tiles_per_grain;
    }
  }
  wgmma_wait<0>();
  fence_all(dv_acc);
  fence_all(dk_seg);
  reg_fence(pa);
  reg_fence(da);
  if (fold) fold_dk();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s) continue;
    const size_t off = (bh * s + key[h]) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int e = (n / 8) * ACC + 4 * (n % 8) + 2 * h;  // panel n / 8's slot of head dim 8 n
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_s[e * THREADS + tid], dk_s[(e + 1) * THREADS + tid]);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[n / 8][4 * (n % 8) + 2 * h], dv_acc[n / 8][4 * (n % 8) + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B8: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
int8_dq_kernel(const __grid_constant__ CUtensorMap k_map,  // [bh_kv * kv_pad, D] int8
               const __grid_constant__ CUtensorMap v_map,  // [bh_kv * kv_pad, D] int8
               const int8_t* __restrict__ q,               // [bh_kv * rep, q_pad, D]
               const float* __restrict__ sq,               // [bh_kv * rep, nq]
               const float* __restrict__ sk,               // [bh_kv, nk]
               const float* __restrict__ sv,               // [bh_kv, nk]
               const __nv_bfloat16* __restrict__ dout,     // [bh_kv * rep, t, D]
               const float* __restrict__ lse,              // [bh_kv * rep, t]
               const float* __restrict__ di,               // [bh_kv * rep, t]
               const float* __restrict__ k_mean,           // [bh_kv, D]
               float* __restrict__ dq,                     // [bh_kv * rep, t, D]
               int rep, int t, int s, int q_pad, int kv_pad, int nq, int nk, int q_grain,
               int kv_grain, int bq, int causal, int diag, float qk_scale, float sm_scale) {
  using G = BwdGeom<D>;
  constexpr int PANELS = G::PANELS, I8_TILE = G::I8_TILE, BF_TILE = G::BF_TILE;
  constexpr int DQ_STAGES = G::DQ_STAGES, DQ_KW = G::DQ_KW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + G::DQ_OFF_BAR;
  auto full = [&](int st) { return bars + 8 * st; };

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // the last rows (the most key tiles) first
  // Causal: keys past the block's last query position (below t), moved by
  // diag = q_offset - k_offset, are never visible (none at all: no key tile,
  // dQ = 0).
  const int kv_hi = causal ? max(0, min(s, min(t, q0 + bq) + diag)) : s;
  const int n_tiles = (kv_hi + TILE - 1) / TILE;

  init_barriers(bars, DQ_STAGES);

  // Thread 0 fills the K/V ring: tiles 0 .. DQ_STAGES - 1 now, tile j - 1 +
  // DQ_STAGES at the start of tile j, into the stage of tile j - 1, whose
  // readers (its widening and S) every thread finished before the barrier
  // that ended tile j - 1.
  auto load_kv = [&](int j) {
    if (tid == 0 && j < n_tiles) {
      const int st = j % DQ_STAGES;
      mbar_expect_tx(full(st), 2 * I8_TILE);
      const int row = static_cast<int>(bh) * kv_pad + j * TILE;
      tma_load_2d(base + G::DQ_OFF_K + st * I8_TILE, &k_map, full(st), 0, row);
      tma_load_2d(base + G::DQ_OFF_V + st * I8_TILE, &v_map, full(st), 0, row);
    }
  };
  for (int j = 0; j < DQ_STAGES; ++j) load_kv(j);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int rows = rep * bq;  // live rows of the block (<= DQ_ROWS)

  // Q rows of the whole GQA group -> shared (zeros for dead rows and
  // positions past t).
  stage_rows<D>(smem, q, G::DQ_ROWS, [&](int r) {
    const int p = q0 + r % bq;
    return r < rows && p < t ? static_cast<long long>((bh * rep + r / bq) * q_pad + p) : -1ll;
  });

  // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its
  // warp). A dead row has Q = dO = 0, lse = D = 0: its P is 1 and its dS 0.
  const int ra = wg * 64 + warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
  float lse_r[2], di_r[2], sq_r[2];
  uint32_t doa[D / 16][4];  // dO rows as the A fragments of dP = dO V^T
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    pos[h] = q0 + r % bq;
    live[h] = r < rows && pos[h] < t;
    const size_t row = (bh * rep + r / bq) * t + pos[h];
    lse_r[h] = live[h] ? lse[row] : 0.f;
    di_r[h] = live[h] ? di[row] : 0.f;
    sq_r[h] = live[h] ? sq[(bh * rep + r / bq) * nq + pos[h] / q_grain] : 1.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(dout + row * D + 16 * kk + cq);
      doa[kk][h] = live[h] ? src[0] : 0u;
      doa[kk][2 + h] = live[h] ? src[4] : 0u;  // head dims + 8
    }
  }

  // Tile 0's K and V, widened before the loop (a block with no key tile has
  // none).
  if (n_tiles > 0) {
    mbar_wait(full(0), 0);
    widen_tile<D>(smem + G::DQ_OFF_K, smem + G::DQ_OFF_KW, tid);
    widen_tile<D>(smem + G::DQ_OFF_V, smem + G::DQ_OFF_VW, tid);
  }
  fence_proxy_async();
  named_barrier(1, THREADS);

  const uint64_t desc_q = desc_i8<D>(base + wg * 64 * D);
  // dQ: in registers at D = 64; at 128 in shared memory, each thread its own
  // PANELS * ACC slots (dq_s)
  float dq_acc[D == 64 ? ACC : 1], dq_seg[PANELS][ACC], dp[ACC];
  float* dq_s = reinterpret_cast<float*>(smem + G::DQ_OFF_DQ);
  int s_acc[ACC];
  uint32_t dsa[4][4] = {};  // bf16 dS: the A of dQ_seg
  if constexpr (D == 64) {
    zero(dq_acc);
  } else {
#pragma unroll
    for (int e = 0; e < PANELS * ACC; ++e) dq_s[e * THREADS + tid] = 0.f;
  }
  zero(dq_seg);
  float rs[2] = {0.f, 0.f};  // this thread's part of rowsum(dS) over the grain
  bool fold = false;
  float sk_fold = 0.f;
  // the kv grain ended: dQ += dQ_seg * sk + rowsum(dS) * k_mean
  auto fold_dq = [&]() {
    const float rsum[2] = {quad_sum(rs[0]), quad_sum(rs[1])};
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 km = *reinterpret_cast<const float2*>(k_mean + bh * D + 64 * p + 8 * n + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float term = __fadd_rn(__fmul_rn(dq_seg[p][4 * n + e], sk_fold),
                                       __fmul_rn(rsum[e / 2], (e & 1) ? km.y : km.x));
          if constexpr (D == 64) {
            dq_acc[4 * n + e] = __fadd_rn(dq_acc[4 * n + e], term);
          } else {
            float& sum = dq_s[(p * ACC + 4 * n + e) * THREADS + tid];
            sum = __fadd_rn(sum, term);
          }
          dq_seg[p][4 * n + e] = 0.f;
        }
      }
    rs[0] = rs[1] = 0.f;
  };

  const int kv_tiles_per_grain = kv_grain / TILE;
  int grain = 0, seg = 0;  // tile j's kv grain and its place in it
  float sk_t = sk[bh * nk], sv_t = sv[bh * nk];
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % DQ_STAGES;
    if (j >= 1) load_kv(j - 1 + DQ_STAGES);
    const int k0 = j * TILE;
    {  // S = Q K^T (s8) and dP = dO V^T (bf16, B = the widened V, K-major)
      const uint64_t desc_k = desc_i8<D>(base + G::DQ_OFF_K + st * I8_TILE);
      const uint64_t desc_v = desc_kmajor_sw128(base + G::DQ_OFF_VW + (j % 2) * BF_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_s8_m64n64k32(s_acc, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_m64n64k16_rs<B_KMAJOR>(dp, doa[kk], kstep(desc_v, kk), kk > 0);
      wgmma_commit();
    }
    if (j + 1 < n_tiles) {  // the next tile's K and V, widened while these run
      const int sn = (j + 1) % DQ_STAGES;
      mbar_wait(full(sn), ((j + 1) / DQ_STAGES) & 1);
      widen_tile<D>(smem + G::DQ_OFF_K + sn * I8_TILE,
                    smem + G::DQ_OFF_KW + ((j + 1) % DQ_KW) * BF_TILE, tid);
      widen_tile<D>(smem + G::DQ_OFF_V + sn * I8_TILE,
                    smem + G::DQ_OFF_VW + ((j + 1) % 2) * BF_TILE, tid);
    }
    wgmma_wait<0>();  // this tile's S, dP and the last tile's dQ_seg are done
    reg_fence(s_acc);
    reg_fence(dp);
    fence_all(dq_seg);
    reg_fence(dsa);
    if (fold) {
      fold_dq();
      fold = false;
    }
    float c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) c[h] = __fmul_rn(__fmul_rn(sq_r[h], sk_t), qk_scale);
    // the next tile's scales, loaded while no product is in flight
    const int next_grain = grain + (seg + 1 == kv_tiles_per_grain);
    const float sk_next = sk[bh * nk + min(next_grain, nk - 1)];
    const float sv_next = sv[bh * nk + min(next_grain, nk - 1)];
    // masking only where the tile reaches past s or the diagonal
    if (k0 + TILE > s || (causal && k0 + TILE - 1 > q0 + diag))
      dq_ds<true>(s_acc, dp, c, lse_r, di_r, sv_t, sm_scale, k0, cq, pos, s, causal, diag, rs,
                  dsa);
    else
      dq_ds<false>(s_acc, dp, c, lse_r, di_r, sv_t, sm_scale, k0, cq, pos, s, causal, diag, rs,
                   dsa);
    fence_proxy_async();  // the next tile's widened K and V, for wgmma
    named_barrier(1, THREADS);
    {  // dQ_seg += dS K (B = the widened K, MN-major, one n64 product a panel)
      const uint64_t desc_kw = desc_mnmajor_sw128(base + G::DQ_OFF_KW + (j % DQ_KW) * BF_TILE);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_rs<B_MNMAJOR>(dq_seg[p], dsa[kk],
                                             desc_kw + p * PANEL_DESC + 128 * kk, 1);
      wgmma_commit();
    }
    if (++seg == kv_tiles_per_grain || j + 1 == n_tiles) {
      fold = true;
      sk_fold = sk_t;
    }
    if (seg == kv_tiles_per_grain) {
      seg = 0;
      ++grain;
    }
    sk_t = sk_next;
    sv_t = sv_next;
  }
  wgmma_wait<0>();
  fence_all(dq_seg);
  reg_fence(dsa);
  if (fold) fold_dq();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = ra + 8 * h;
    const size_t off = ((bh * rep + r / bq) * t + pos[h]) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 val;
      if constexpr (D == 64) {
        val = make_float2(dq_acc[4 * n + 2 * h], dq_acc[4 * n + 2 * h + 1]);
      } else {
        const int e = (n / 8) * ACC + 4 * (n % 8) + 2 * h;  // panel n / 8's slot of head dim 8 n
        val = make_float2(dq_s[e * THREADS + tid], dq_s[(e + 1) * THREADS + tid]);
      }
      *reinterpret_cast<float2*>(dq + off + 8 * n) = val;
    }
  }
}

// What both kernels take (ops/int8_tiling.py checks the same before a launch).
bool bad_shape(int bh_kv, int rep, int t, int s, int q_pad, int kv_pad, int q_grain,
               int kv_grain, int q_offset, int k_offset, int d) {
  return bh_kv < 1 || rep < 1 || t < 1 || s < 1 || t > q_pad || s > kv_pad || q_offset < 0 ||
         k_offset < 0 || (d != 64 && d != 128) || q_grain % TILE ||
         kv_grain % BwdGeom<64>::DKV_KEYS || q_pad % q_grain || kv_pad % kv_grain ||
         static_cast<long long>(bh_kv) * rep * q_pad > 0x7fffffffLL ||  // TMA row coordinates
         static_cast<long long>(bh_kv) * kv_pad > 0x7fffffffLL;
}

// An int8 payload's map: rows of D bytes, boxes of TILE rows, in i8_swizzle's
// layout.
template <int D>
bool i8_map(CUtensorMap* map, const void* ptr, int rows) {
  return tensor_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, D, TILE, D,
                       D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* sq, const void* sk,
        const void* sv, const void* dout, const void* lse, const void* di, void* dk, void* dv,
        int bh_kv, int rep, int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
        int causal, int diag, float qk_scale, float sm_scale, cudaStream_t stream) {
  constexpr int SMEM = BwdGeom<D>::DKV_SMEM;
  CUtensorMap q_map, do_map;  // dO: boxes of 64 head dims, one a panel
  if (!i8_map<D>(&q_map, q, bh_kv * rep * q_pad) ||
      !tensor_map_3d(&do_map, dout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bh_kv * rep, t, D, TILE,
                     64, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(int8_dkv_kernel<D>, SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh_kv, (s + BwdGeom<D>::DKV_KEYS - 1) / BwdGeom<D>::DKV_KEYS);
  int8_dkv_kernel<D><<<grid, THREADS, SMEM, stream>>>(
      q_map, do_map, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(sq), static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dk),
      static_cast<float*>(dv), rep, t, s, q_pad, kv_pad, q_pad / q_grain, kv_pad / kv_grain,
      q_grain, kv_grain, causal, diag, qk_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* sq, const void* sk,
       const void* sv, const void* dout, const void* lse, const void* di, const void* k_mean,
       void* dq_out, int bh_kv, int rep, int t, int s, int q_pad, int kv_pad, int q_grain,
       int kv_grain, int bq, int causal, int diag, float qk_scale, float sm_scale,
       cudaStream_t stream) {
  constexpr int SMEM = BwdGeom<D>::DQ_SMEM;
  CUtensorMap k_map, v_map;
  if (!i8_map<D>(&k_map, k, bh_kv * kv_pad) || !i8_map<D>(&v_map, v, bh_kv * kv_pad))
    return static_cast<int>(cudaErrorNotSupported);
  static bool configured = false;
  const cudaError_t err = allow_smem(int8_dq_kernel<D>, SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh_kv, (t + bq - 1) / bq);
  int8_dq_kernel<D><<<grid, THREADS, SMEM, stream>>>(
      k_map, v_map, static_cast<const int8_t*>(q), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const float*>(k_mean), static_cast<float*>(dq_out),
      rep, t, s, q_pad, kv_pad, q_pad / q_grain, kv_pad / kv_grain, q_grain, kv_grain, bq, causal,
      diag, qk_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes one block asks for at head dim d, 64 or 128 (ops/int8_tiling.py
// mirrors them); -1 for another d.
extern "C" int qa_int8_bwd_dkv_smem_bytes(int d) {
  return d == 64 ? BwdGeom<64>::DKV_SMEM : d == 128 ? BwdGeom<128>::DKV_SMEM : -1;
}
extern "C" int qa_int8_bwd_dq_smem_bytes(int d) {
  return d == 64 ? BwdGeom<64>::DQ_SMEM : d == 128 ? BwdGeom<128>::DQ_SMEM : -1;
}

// B7: dK, dV [bh_kv, s, d] f32, d 64 or 128. q/k/v int8 payloads, sq/sk/sv
// f32 scale tables, dout [bh_kv * rep, t, d] bf16, lse/di [bh_kv * rep, t]
// f32. Causal masking on global positions q_offset + i, k_offset + j (both
// >= 0).
extern "C" int qa_int8_bwd_dkv(const void* q, const void* k, const void* v, const void* sq,
                               const void* sk, const void* sv, const void* dout, const void* lse,
                               const void* di, void* dk, void* dv, int bh_kv, int rep, int t,
                               int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                               int causal, int q_offset, int k_offset, float qk_scale,
                               float sm_scale, int d, void* stream) {
  const int n_kt = (s + BwdGeom<64>::DKV_KEYS - 1) / BwdGeom<64>::DKV_KEYS;
  if (bad_shape(bh_kv, rep, t, s, q_pad, kv_pad, q_grain, kv_grain, q_offset, k_offset, d) ||
      n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = d == 64 ? &dkv<64> : &dkv<128>;
  return launch(q, k, v, sq, sk, sv, dout, lse, di, dk, dv, bh_kv, rep, t, s, q_pad, kv_pad,
                q_grain, kv_grain, causal, q_offset - k_offset, qk_scale, sm_scale,
                static_cast<cudaStream_t>(stream));
}

// B8: dQ [bh_kv * rep, t, d] f32, same inputs as B7 plus k_mean [bh_kv, d];
// bq query positions a block (rep * bq <= 128), offsets as B7's.
extern "C" int qa_int8_bwd_dq(const void* q, const void* k, const void* v, const void* sq,
                              const void* sk, const void* sv, const void* dout, const void* lse,
                              const void* di, const void* k_mean, void* dq_out, int bh_kv, int rep,
                              int t, int s, int q_pad, int kv_pad, int q_grain, int kv_grain,
                              int bq, int causal, int q_offset, int k_offset, float qk_scale,
                              float sm_scale, int d, void* stream) {
  const int n_qb = bq < 1 ? 0 : (t + bq - 1) / bq;
  if (bad_shape(bh_kv, rep, t, s, q_pad, kv_pad, q_grain, kv_grain, q_offset, k_offset, d) ||
      bq < 1 || rep * bq > BwdGeom<64>::DQ_ROWS || n_qb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = d == 64 ? &dq<64> : &dq<128>;
  return launch(q, k, v, sq, sk, sv, dout, lse, di, k_mean, dq_out, bh_kv, rep, t, s, q_pad,
                kv_pad, q_grain, kv_grain, bq, causal, q_offset - k_offset, qk_scale, sm_scale,
                static_cast<cudaStream_t>(stream));
}
