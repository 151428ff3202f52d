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
// each with its own rows, length, padded length, grain and optional sub row:
// the grid is the concatenation of their (row, grain) blocks. The input is
// f32 or bf16 (widened exactly). A job with no payload output writes its
// scale table only: the fused inference forward (B6, csrc/int8_fwd.cu)
// takes its scales from that pass and quantizes its tiles itself.
//
// What bounds it on this card: it reads each input once and writes a
// quarter-width payload, so it is bytes-bound (the whole work is a max and a
// division per element). Design (simple first): one block of 256 threads per
// (tensor, row, grain); pass 1 reads the grain with 4-element loads (a warp
// covers two token rows) and reduces the absmax through warp
// shuffles and shared memory; pass 2 reads the grain again, which at 256 KB
// a grain comes back from L2, and writes 4 int8 per thread per token row.
// The scale goes out once per block as [rows, n_grains] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;  // head dim
constexpr int THREADS = 256;
constexpr int COLS4 = D / 4;                // float4 columns of a token row
constexpr int ROWS_PER_STEP = THREADS / COLS4;
constexpr int MAX_JOBS = 3;
constexpr float INV_INT8_MAX = 1.0f / 127.0f;  // fl(1/127), folded at compile time

enum InType { IN_F32 = 0, IN_BF16 = 1 };

struct Job {
  const void* x;       // [rows, t, D] of the input type
  const float* sub;    // [rows, D] or null
  int8_t* out;         // [rows, pad, D], or null: the scale table only
  float* scale;        // [rows, pad / grain]
  int rows, t, pad, grain;
};

struct Jobs {
  Job job[MAX_JOBS];
  int start[MAX_JOBS + 1];  // first block of each job; start[n] = grid size
  int n;
};

// 4 consecutive elements as floats; p is aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 load_shifted(const Job& jb, const T* xrow, int tok, float4 sub) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tok < jb.t) v = load4(xrow + (size_t)tok * D);
  if (jb.sub) {
    v.x -= sub.x;
    v.y -= sub.y;
    v.z -= sub.z;
    v.w -= sub.w;
  }
  return v;
}

__device__ __forceinline__ int quant1(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) quant_int8_kernel(Jobs jobs) {
  __shared__ float warp_max[THREADS / 32];

  int blk = blockIdx.x;
  int j = 0;
  while (j + 1 < jobs.n && blk >= jobs.start[j + 1]) ++j;
  const Job& jb = jobs.job[j];
  blk -= jobs.start[j];
  const int n_grains = jb.pad / jb.grain;
  const int row = blk / n_grains;
  const int tok0 = (blk % n_grains) * jb.grain;

  const int c4 = threadIdx.x % COLS4;
  const int r0 = threadIdx.x / COLS4;
  const T* xrow = static_cast<const T*>(jb.x) + (size_t)row * jb.t * D + c4 * 4;
  float4 sub = make_float4(0.f, 0.f, 0.f, 0.f);
  if (jb.sub) sub = *reinterpret_cast<const float4*>(jb.sub + (size_t)row * D + c4 * 4);

  float amax = 0.f;
  for (int tok = tok0 + r0; tok < tok0 + jb.grain; tok += ROWS_PER_STEP) {
    const float4 v = load_shifted(jb, xrow, tok, sub);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), INV_INT8_MAX);
  if (threadIdx.x == 0) jb.scale[(size_t)row * n_grains + blk % n_grains] = s;
  if (!jb.out) return;

  int8_t* orow = jb.out + (size_t)row * jb.pad * D + c4 * 4;
  for (int tok = tok0 + r0; tok < tok0 + jb.grain; tok += ROWS_PER_STEP) {
    const float4 v = load_shifted(jb, xrow, tok, sub);
    char4 qv;
    qv.x = static_cast<signed char>(quant1(v.x, s));
    qv.y = static_cast<signed char>(quant1(v.y, s));
    qv.z = static_cast<signed char>(quant1(v.z, s));
    qv.w = static_cast<signed char>(quant1(v.w, s));
    *reinterpret_cast<char4*>(orow + (size_t)tok * D) = qv;
  }
}

}  // namespace

// Quantize n_jobs (1..3) tensors in one launch. Job i: x [rows, t, D] of
// in_type (0 f32, 1 bf16), sub [rows, D] f32 or null, out [rows, pad, D]
// int8 or null (then only the scales are written), scale [rows, pad/grain]
// f32; pad is a multiple of grain, pad >= t.
extern "C" int qa_quant_int8(const void* const* x, const void* const* sub, void* const* out,
                             void* const* scale, const int* rows, const int* t, const int* pad,
                             const int* grain, int n_jobs, int in_type, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || in_type < IN_F32 || in_type > IN_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs;
  jobs.n = n_jobs;
  jobs.start[0] = 0;
  for (int i = 0; i < n_jobs; ++i) {
    jobs.job[i] = Job{x[i], static_cast<const float*>(sub[i]), static_cast<int8_t*>(out[i]),
                      static_cast<float*>(scale[i]), rows[i], t[i], pad[i], grain[i]};
    jobs.start[i + 1] = jobs.start[i] + rows[i] * (pad[i] / grain[i]);
  }
  for (int i = n_jobs; i < MAX_JOBS; ++i) jobs.job[i] = jobs.job[0];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_type == IN_F32)
    quant_int8_kernel<float><<<jobs.start[n_jobs], THREADS, 0, st>>>(jobs);
  else
    quant_int8_kernel<__nv_bfloat16><<<jobs.start[n_jobs], THREADS, 0, st>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}
