// Per-grain symmetric int8 quantization for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels quantizedattention_tpu/quantize/int8.py:
// _quant_block_kernel, _quant_block_sub_kernel and _quant_qkv_kernel (B4).
// Same numerics, byte for byte: for each (row, grain) block of a
// [rows, tokens, D] tensor, x' = x - sub (K-smoothing, when a sub row is
// given), s = max(absmax(x'), 1e-12) * fl(1/127) in f32 (the JAX package
// writes absmax / 127, which XLA compiles to a product with the f32
// reciprocal), payload = clamp(round_half_even(x' / s), -128, 127) with an
// IEEE division (rintf of __fdiv_rn), one f32 scale per block. Tokens past
// the tensor's length up to its padded length read as 0, so a padded K row
// becomes -sub: it joins the absmax of its grain exactly as the JAX
// package's zero-padded, then smoothed, K does.
//
// One launch covers up to three tensors (Q, K and V of one attention call),
// each with its own rows, length, padded length, grain and optional sub row,
// all at one head dim D, 64 or 128 (one instance each, chosen by the
// entry's d). A tensor is read through its strides: row r is (batch r /
// heads, head r % heads) of a [batch, heads, t, D] view whose token rows are
// contiguous and start on 16 bytes (the model's [b, h, t, D] views of [b, t,
// h, D] activations need no copy). The input is f32 or bf16 (widened
// exactly).
//
// What bounds it on this card: bytes. It reads each input once and writes a
// quarter-width (f32) or half-width (bf16) payload; the whole work is a max
// and a division per element. Design: each (tensor, row, grain) is one
// thread-block cluster of CLUSTER blocks of 128 threads; block `rank` takes
// the grain's tokens rank * grain / CLUSTER .. (16 to 128 tokens, 4 to 32
// KB of f32 at D = 64, twice that at 128). It copies its share into shared
// memory with 16-byte cp.async copies, all in flight at once (up to 16 a
// thread, 32 at D = 128; tokens past t arrive as zeros), so an SM holds 6
// blocks' shares (192 KB; 3 of 64 KB at D = 128) and keeps them in flight
// together. It reduces its absmax (warp shuffles, then shared memory),
// publishes it in its shared memory behind a cluster barrier and reads the
// other blocks' seven through distributed shared memory. Each block then
// takes the grain's max and writes its payload share from shared memory (a
// thread reads back only the chunks it copied; the grain is read from HBM
// once; the bytes packed with no float-to-int conversion), and rank 0
// writes the scale. A second cluster barrier, after the stores, keeps every
// block resident until the cluster's reads of its shared memory are done. The scale goes out once per grain as [rows,
// n_grains] f32. At the training shape the share held in registers (256
// threads, 64 registers, 4 blocks an SM) and persistent clusters streaming
// items through two buffers both measured slower on f32 (PERF.md).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CLUSTER = 8;      // blocks a grain (the portable cluster size)
constexpr int MAX_GRAIN = 1024;  // a block's share at most MAX_GRAIN / CLUSTER tokens
constexpr int MAX_JOBS = 3;
constexpr float INV_INT8_MAX = 1.0f / 127.0f;  // fl(1/127), folded at compile time

enum InType { IN_F32 = 0, IN_BF16 = 1 };

struct Job {
  const void* x;               // [rows, t, D] of the input type, through its strides
  long long sb, sh, st;        // strides in elements of batch, head and token
  const float* sub;            // [rows, D] or null
  int8_t* out;                 // [rows, pad, D]
  float* scale;                // [rows, pad / grain]
  int heads, rows, t, pad, grain;
};

struct Jobs {
  Job job[MAX_JOBS];
  int start[MAX_JOBS + 1];  // first cluster of each job; start[n] = clusters in all
  int n;
};

// The 16 bytes at p (shared memory) as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const void* p, float (&v)[N]) {
    const float4 u = *static_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const void* p, float (&v)[N]) {
    const uint4 u = *static_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// A block's largest share in f32 at head dim D.
template <int D>
constexpr int smem_bytes() {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  return MAX_GRAIN / CLUSTER * D * 4;
}

// The payload byte of v (the low byte of the result): clamp(rint(v / s),
// -128, 127) with an IEEE division. q + 1.5 * 2^23 holds the integer q in
// its low bits, two's complement: no float-to-int conversion instruction.
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// Four payload bytes (the low bytes of a, b, c, d) as one word, a's first.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) quant_int8_kernel(Jobs jobs) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks a token row
  static_assert(THREADS % CPR == 0, "a thread's chunks share their columns");
  extern __shared__ __align__(16) uint8_t share_s[];  // the block's share, chunk i at 16 i
  __shared__ float warp_max[THREADS / 32];
  __shared__ float block_max;

  int c = blockIdx.x / CLUSTER;
  int j = 0;
  while (j + 1 < jobs.n && c >= jobs.start[j + 1]) ++j;
  const Job& jb = jobs.job[j];
  c -= jobs.start[j];
  const int n_grains = jb.pad / jb.grain;
  const int row = c / n_grains;
  const int grain = c % n_grains;
  const int rank = cluster_ctarank();
  const int share = jb.grain / CLUSTER;
  const int tok0 = grain * jb.grain + rank * share;

  // Chunk i of the share (token i / CPR, columns VEC (i % CPR) ..) by thread
  // i % THREADS: every copy in flight before the first wait.
  const T* xrow =
      static_cast<const T*>(jb.x) + (row / jb.heads) * jb.sb + (row % jb.heads) * jb.sh;
  for (int i = threadIdx.x; i < share * CPR; i += THREADS) {
    const int tok = tok0 + i / CPR;
    const T* src = tok < jb.t ? xrow + tok * jb.st + (i % CPR) * VEC : xrow;
    cp_async16(share_s + i * 16, src, tok < jb.t);
  }
  cp_async_commit();
  const int col = (threadIdx.x % CPR) * VEC;  // the columns of every chunk of this thread
  float sub[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    sub[e] = jb.sub ? jb.sub[static_cast<size_t>(row) * D + col + e] : 0.f;
  cp_async_wait<0>();

  float amax = 0.f;
  for (int i = threadIdx.x; i < share * CPR; i += THREADS) {
    float x[VEC];
    Vec<T>::load(share_s + i * 16, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(x[e] - sub[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    block_max = m;
  }
  cluster_arrive();  // every block's max is published
  cluster_wait();
  const uint32_t at = smem_addr(&block_max);
  amax = 0.f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) amax = fmaxf(amax, ld_cluster_f32(at, q));
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), INV_INT8_MAX);
  if (rank == 0 && threadIdx.x == 0) jb.scale[static_cast<size_t>(row) * n_grains + grain] = s;

  int8_t* orow = jb.out + (static_cast<size_t>(row) * jb.pad + tok0) * D + col;
  for (int i = threadIdx.x; i < share * CPR; i += THREADS) {
    float x[VEC];
    Vec<T>::load(share_s + i * 16, x);
    uint32_t b[VEC], w[VEC / 4];
#pragma unroll
    for (int e = 0; e < VEC; ++e) b[e] = quant_byte(x[e] - sub[e], s);
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      w[k] = pack4(b[4 * k], b[4 * k + 1], b[4 * k + 2], b[4 * k + 3]);
    int8_t* o = orow + static_cast<size_t>(i / CPR) * D;
    if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(o) = w[0];
    else
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  }
  // No block leaves before the cluster's reads of its max are done. (An
  // arrival right after those reads, before the stores, measured slower.)
  cluster_arrive();
  cluster_wait();
}

template <typename T, int D>
cudaError_t launch(const Jobs& jobs, cudaStream_t stream) {
  if (smem_bytes<D>() > 48 * 1024) {  // above the default limit: raised once an instance
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          quant_int8_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
      if (err != cudaSuccess) return err;
      configured = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(jobs.start[jobs.n] * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<D>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quant_int8_kernel<T, D>, jobs);
}

}  // namespace

// Quantize n_jobs (1..3) tensors of head dim d (64 or 128) in one launch.
// Job i: x of in_type (0 f32, 1 bf16), row r at x + (r / heads) * sb + (r %
// heads) * sh, token tok of it tok * st further (strides in elements; the d
// elements of a token contiguous; pointer and strides 16-byte aligned), sub
// [rows, d] f32 or null, out [rows, pad, d] int8, scale [rows, pad / grain]
// f32; pad is a multiple of grain, grain a multiple of 16 up to 1024, pad >=
// t.
extern "C" int qa_quant_int8(const void* const* x, const long long* strides, const int* heads,
                             const void* const* sub, void* const* out, void* const* scale,
                             const int* rows, const int* t, const int* pad, const int* grain,
                             int n_jobs, int in_type, int d, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || in_type < IN_F32 || in_type > IN_BF16 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elem = in_type == IN_F32 ? 4 : 2;
  Jobs jobs;
  jobs.n = n_jobs;
  jobs.start[0] = 0;
  for (int i = 0; i < n_jobs; ++i) {
    const long long* st = strides + 3 * i;
    if (grain[i] < 16 || grain[i] > MAX_GRAIN || grain[i] % 16 || pad[i] % grain[i] ||
        pad[i] < t[i] || heads[i] < 1 || rows[i] % heads[i] || !aligned16(x[i]) ||
        (st[0] * elem) % 16 || (st[1] * elem) % 16 || (st[2] * elem) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    jobs.job[i] = Job{x[i], st[0], st[1], st[2], static_cast<const float*>(sub[i]),
                      static_cast<int8_t*>(out[i]), static_cast<float*>(scale[i]), heads[i],
                      rows[i], t[i], pad[i], grain[i]};
    const long long clusters = static_cast<long long>(jobs.start[i]) +
                               static_cast<long long>(rows[i]) * (pad[i] / grain[i]);
    if (clusters * CLUSTER > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    jobs.start[i + 1] = static_cast<int>(clusters);
  }
  for (int i = n_jobs; i < MAX_JOBS; ++i) jobs.job[i] = jobs.job[0];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* run = in_type == IN_F32 ? (d == 64 ? &launch<float, 64> : &launch<float, 128>)
                                 : (d == 64 ? &launch<__nv_bfloat16, 64>
                                            : &launch<__nv_bfloat16, 128>);
  const cudaError_t err = run(jobs, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks a grain's cluster holds and threads a block (ops/int8_tiling.py's
// quant geometry mirrors them).
extern "C" int qa_quant_int8_geometry(int* cluster, int* threads, int* max_grain) {
  *cluster = CLUSTER;
  *threads = THREADS;
  *max_grain = MAX_GRAIN;
  return 0;
}

// Dynamic shared bytes a block asks for at head dim d, 64 or 128
// (ops/int8_tiling.py's quant_shared_bytes mirrors it); -1 for another d.
extern "C" int qa_quant_int8_smem_bytes(int d) {
  return d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : -1;
}
