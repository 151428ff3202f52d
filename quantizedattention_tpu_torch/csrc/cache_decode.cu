// Decode attention over the paged int8 cache (B14), the slotted int4 cache
// (B15) and the paged int4 cache (B16), for Hopper (sm_90a), plain C ABI:
// one query per sequence (spec == 1) or the speculative-verify staircase of
// `spec` consecutive queries. One kernel body, three entries:
//
//   qa_paged_decode  replaces quantizedattention_tpu/parallel/paged_cache.py:
//                    _paged_decode_kernel;
//   qa_decode4       replaces quantizedattention_tpu/parallel/kv4_cache.py:
//                    _decode4_kernel;
//   qa_paged4_decode replaces quantizedattention_tpu/parallel/paged4_cache.py:
//                    _paged4_decode_kernel.
//
// Numerics are those of the slotted int8 kernel (decode.cu, B13): q and the
// integer K/V are taken as bf16 (int8 and int4 values are exact in bf16),
// s = (q . k) * (sk * qk_scale) in f32, masked tokens get -inf, p =
// exp2(s - m) with the online running max, l sums the UNROUNDED p, and the
// PV operand is bf16(p * sv) against the integer V. The q rows of a kv head
// fold (GQA group, spec) as r = g * spec + j; row r attends tokens
// t < length - (spec - 1) + r % spec, the JAX kernels' staircase, and a row
// with no live token gives O = 0 and lse = -inf.
//
// Layouts (the JAX package's). A sequence's tokens live in "pages" of ps
// tokens; page j of sequence s is table[s, j] (paged) or j itself (slotted
// int4, whose pages are its 256-token pack blocks). A page holds ps payload
// rows of int8 values, or ps/2 byte rows of int4 pairs: byte row r holds the
// page's token r in its low nibble and token r + ps/2 in its high nibble.
// Scales are per token, f32.
//
// What bounds it on this card: each step streams every live token's K and V
// payload (2 * 64 bytes for int8, 2 * 32 for int4) and two f32 scales once
// per (sequence, kv head), plus the row's page-table entries, and does about
// 4 * group FLOP per byte: far below the FLOP/byte ridge, so it is HBM-bound
// on the K/V stream (and at short lengths, latency-bound).
//
// Design (simple first, decode.cu's): one block of 128 threads per (kv head,
// sequence) holds the kv head's whole GQA group, so the group shares every
// K/V fetch. The block walks the row's tokens in order, in tiles of 128
// consecutive tokens, exactly as decode.cu does: slot s of a tile is token
// t0 + s, so B14 computes what B13 computes on the same K/V bit for bit,
// and B15 and B16 (whose pages split their tokens differently) do too. Each
// slot looks up its own page in the table (an ordinary global read; this
// card has no scalar prefetch) and stages its payload row in shared memory
// with 16-byte loads; an int4 slot unpacks the one nibble that is its
// token. Two tokens share an int4 byte row, so a byte row is fetched once
// per token: the second fetch is served by L1 (a 128-token page holds both
// tokens of a row in one tile) or L2 (a 256-token pack block holds them in
// two consecutive tiles). Only tokens below the length are read, so no page
// at or past ceil(length / ps) is touched; a slot past the length (the tail
// of a tile, the other half of a half-live int4 row) is zero-filled, gets
// p = 0 by select and a zero scale, never a stale scale times 0 (stale
// scales may be non-finite). Scores use one thread per slot, the softmax
// one warp per group row, PV one thread per (group row, channel). The
// staircase is decode.cu's: a per-row limit where the scores are masked and
// p is taken, p = 0 and alpha = 1 by select for a row with no live token in
// a tile, so verify row j equals the spec == 1 launch at its own length bit
// for bit. Reading each int4 byte row once for both its tokens, splitting
// the kv axis across blocks, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int TILE = 128;     // token slots per tile = threads per block
constexpr int KROW = D + 16;  // padded shared K row (bytes): conflict-free 16-byte reads
constexpr int THREADS = 128;

struct Pool {
  const int8_t* k;
  const float* sk;
  const int8_t* v;
  const float* sv;
  const int* table;   // [n_seqs, max_pages], or nullptr: page j is j
  const int* length;  // [n_seqs]
  int ps;             // tokens per page
  int max_pages;      // pages a sequence can hold
  // element offsets: payload row r of page p of (seq, kv head) sits at
  // pay_seq * seq + pay_head * kvh + pay_page * p + r * D; the scale of
  // in-page token t at sc_seq * seq + sc_head * kvh + sc_page * p + t
  long long pay_seq, pay_head, pay_page;
  long long sc_seq, sc_head, sc_page;
};

__host__ __device__ constexpr int float_words(int group) {
  // q [G][D], scores/weights [G][TILE], acc [G][D], m/l/alpha [G], sk/sv [TILE]
  return ((group * (2 * D + TILE + 3) + 2 * TILE) + 3) & ~3;
}

__host__ __device__ constexpr size_t smem_bytes(int group) {
  // + K [TILE][KROW] and V [TILE][D] int8 slots
  return static_cast<size_t>(float_words(group)) * 4 + TILE * KROW + TILE * D;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

union Bytes16 {
  int4 v;
  int8_t b[16];
};

// 16 packed bytes -> the sign-extended low (hi = false) or high nibbles
// (ops/int4_linear.py:unpack_int4: lo = ((b & 15) ^ 8) - 8, hi = b >> 4)
__device__ __forceinline__ int4 nibbles16(int4 packed, bool hi) {
  Bytes16 in, out;
  in.v = packed;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int b = in.b[e];
    out.b[e] = static_cast<int8_t>(hi ? b >> 4 : ((b & 15) ^ 8) - 8);
  }
  return out.v;
}

template <bool INT4>
__global__ void __launch_bounds__(THREADS)
cache_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [n_seqs, n_kv * G, D]
                    Pool c,
                    float* __restrict__ o,                 // [n_seqs, n_kv * G, D]
                    float* __restrict__ lse,               // [n_seqs, n_kv * G]
                    int n_kv, int G, int spec, float qk_scale) {
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
  const int seq = blockIdx.y;
  const size_t head0 = static_cast<size_t>(seq) * n_kv * G + static_cast<size_t>(kvh) * G;
  const int len = min(max(c.length[seq], 0), c.max_pages * c.ps);
  const int rpp = INT4 ? c.ps / 2 : c.ps;  // payload rows per page
  const int* trow = c.table ? c.table + static_cast<size_t>(seq) * c.max_pages : nullptr;
  const int8_t* k_seq = c.k + c.pay_seq * seq + c.pay_head * kvh;
  const int8_t* v_seq = c.v + c.pay_seq * seq + c.pay_head * kvh;
  const float* sk_seq = c.sk + c.sc_seq * seq + c.sc_head * kvh;
  const float* sv_seq = c.sv + c.sc_seq * seq + c.sc_head * kvh;

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
    // Slot s holds token t0 + s: its page, in-page offset and payload row.
    for (int ci = tid; ci < TILE * (D / 16); ci += THREADS) {
      const int s = ci / (D / 16);
      const int col = (ci % (D / 16)) * 16;
      int4 kk = make_int4(0, 0, 0, 0);
      int4 vv = kk;
      if (s < n) {
        const int t = t0 + s;
        const int blk = t / c.ps;
        const int in_page = t % c.ps;
        const int page = trow ? trow[blk] : blk;
        const long long off =
            c.pay_page * page + static_cast<long long>(in_page % rpp) * D + col;
        kk = *reinterpret_cast<const int4*>(k_seq + off);
        vv = *reinterpret_cast<const int4*>(v_seq + off);
        if (INT4) {  // the nibble of this token: low in the page's first half
          const bool hi = in_page >= rpp;
          kk = nibbles16(kk, hi);
          vv = nibbles16(vv, hi);
        }
      }
      *reinterpret_cast<int4*>(k_s + s * KROW + col) = kk;
      *reinterpret_cast<int4*>(v_s + s * D + col) = vv;
    }
    if (tid < n) {
      const int t = t0 + tid;
      const int page = trow ? trow[t / c.ps] : t / c.ps;
      const long long off = c.sc_page * page + t % c.ps;
      sk_s[tid] = sk_seq[off];
      sv_s[tid] = sv_seq[off];
    } else {
      sk_s[tid] = 0.f;
      sv_s[tid] = 0.f;
    }
    __syncthreads();

    // Scores: thread tid owns slot tid for every group row.
    {
      const int8_t* krow = k_s + tid * KROW;
      const float scale = sk_s[tid] * qk_scale;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_f + g * D;
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < D; cc += 16) {
          Bytes16 chunk;
          chunk.v = *reinterpret_cast<const int4*>(krow + cc);
#pragma unroll
          for (int e = 0; e < 16; ++e) dot = fmaf(qg[cc + e], static_cast<float>(chunk.b[e]), dot);
        }
        // spec == 1: the limit is the length, and t0 + tid < len is tid < n
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

    // acc = acc * alpha + bf16(p * sv) . v: thread -> (group row, channel).
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

template <bool INT4>
int launch(const void* q, const Pool& pool, void* o, void* lse, int n_seqs, int n_kv,
           int group, int spec, float qk_scale, void* stream) {
  if (spec < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = group * spec;
  const size_t bytes = smem_bytes(rows);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_decode_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cache_decode_kernel<INT4><<<dim3(n_kv, n_seqs), THREADS, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), pool, static_cast<float*>(o),
      static_cast<float*>(lse), n_kv, rows, spec, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// Pool of pages [n_kv, n_pages, rpp, D] payload rows, scales [n_pages, n_kv, ps].
Pool paged_pool(const void* k, const void* sk, const void* v, const void* sv,
                const void* table, const void* lengths, int n_kv, int n_pages, int ps,
                int max_pages, int rpp) {
  Pool p;
  p.k = static_cast<const int8_t*>(k);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const int8_t*>(v);
  p.sv = static_cast<const float*>(sv);
  p.table = static_cast<const int*>(table);
  p.length = static_cast<const int*>(lengths);
  p.ps = ps;
  p.max_pages = max_pages;
  p.pay_seq = 0;
  p.pay_head = static_cast<long long>(n_pages) * rpp * D;
  p.pay_page = static_cast<long long>(rpp) * D;
  p.sc_seq = 0;
  p.sc_head = ps;
  p.sc_page = static_cast<long long>(n_kv) * ps;
  return p;
}

}  // namespace

// Every entry takes q [n_seqs, n_kv * group * spec, D], row (kv head, g, j).
extern "C" int qa_paged_decode(const void* q, const void* k_pages, const void* sk,
                               const void* v_pages, const void* sv, const void* table,
                               const void* lengths, void* o, void* lse, int n_seqs, int n_kv,
                               int group, int spec, int n_pages, int page_size, int max_pages,
                               float qk_scale, void* stream) {
  if (page_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool = paged_pool(k_pages, sk, v_pages, sv, table, lengths, n_kv, n_pages,
                               page_size, max_pages, page_size);
  return launch<false>(q, pool, o, lse, n_seqs, n_kv, group, spec, qk_scale, stream);
}

extern "C" int qa_paged4_decode(const void* q, const void* k_p, const void* sk, const void* v_p,
                                const void* sv, const void* table, const void* lengths, void* o,
                                void* lse, int n_seqs, int n_kv, int group, int spec,
                                int n_pages, int page_size, int max_pages, float qk_scale,
                                void* stream) {
  if (page_size <= 0 || page_size % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool = paged_pool(k_p, sk, v_p, sv, table, lengths, n_kv, n_pages, page_size,
                               max_pages, page_size / 2);
  return launch<true>(q, pool, o, lse, n_seqs, n_kv, group, spec, qk_scale, stream);
}

// Slotted int4: payload [b, n_kv, max_len/2, D], scales [b, n_kv, max_len];
// the pages are the row's 256-token pack blocks, in order.
extern "C" int qa_decode4(const void* q, const void* k_p, const void* sk, const void* v_p,
                          const void* sv, const void* length, void* o, void* lse, int batch,
                          int n_kv, int group, int spec, int max_len, float qk_scale,
                          void* stream) {
  constexpr int PACK = 256;
  if (max_len <= 0 || max_len % PACK != 0) return static_cast<int>(cudaErrorInvalidValue);
  Pool p;
  p.k = static_cast<const int8_t*>(k_p);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const int8_t*>(v_p);
  p.sv = static_cast<const float*>(sv);
  p.table = nullptr;
  p.length = static_cast<const int*>(length);
  p.ps = PACK;
  p.max_pages = max_len / PACK;
  p.pay_head = static_cast<long long>(max_len / 2) * D;
  p.pay_seq = p.pay_head * n_kv;
  p.pay_page = static_cast<long long>(PACK / 2) * D;
  p.sc_head = max_len;
  p.sc_seq = static_cast<long long>(max_len) * n_kv;
  p.sc_page = PACK;
  return launch<true>(q, p, o, lse, batch, n_kv, group, spec, qk_scale, stream);
}
