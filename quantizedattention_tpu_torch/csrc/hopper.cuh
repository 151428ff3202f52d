// Hopper (sm_90a) building blocks shared by the port's kernels: shared-memory
// addresses, mbarriers, TMA (2-, 3- and 4-D maps), cp.async, rings of TMA stages shared
// by two warpgroups, thread-block clusters and the k split's sum, mma.sync,
// wgmma (descriptors, the int8, bf16 and tf32 forms, the 3xTF32 split),
// the exact int8 / int4 -> bf16 widening, and the element helpers of the
// attention kernels (exp2, quad reductions, exact small integers as f32).
// Each .cu that includes it is its own library, so everything here has
// internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum OutType { OUT_F32 = 0, OUT_BF16 = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ---

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of TMA traffic on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive once (release: this thread's earlier shared-memory writes are seen
// by the threads that wait on the phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of the given parity has completed (a stage's n-th
// fill completes phase n - 1). A wait that never completes is a bug of the
// pipeline: after ~2^30 tries the kernel traps (the launch fails) instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory writes of these threads become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- cp.async ---

// 16 bytes global -> shared, asynchronously; zero-filled and nothing read
// when !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- rings of TMA stages shared by two warpgroups ---

// Initialise n "full" barriers (one arrival each: the expect_tx) and zero the
// release counters.
__device__ __forceinline__ void init_ring(uint32_t bars, int* released, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      mbar_init(bars + 8 * i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The warpgroup of this thread reads tile i's stage no more: the second of
// the two warpgroups to say so refills the stage with tile i + stages (if
// any) through `load`, so no thread ever waits to refill.
template <class Load>
__device__ __forceinline__ void release_stage(int* released, int i, int stages, int n_tiles,
                                              Load load) {
  if (threadIdx.x % 128 == 0 && atomicAdd(&released[i % stages], 1) == 1) {
    atomicExch(&released[i % stages], 0);
    if (i + stages < n_tiles) {
      fence_proxy_async();
      load(i + stages);
    }
  }
}

// --- thread-block clusters ---

__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster arrives; shared-memory writes
// before it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of cluster_sync, for work between them: an arrival
// releases this thread's earlier shared-memory writes to the cluster; the
// wait returns once every thread of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The f32 at this block's shared address `addr` in the cluster's block `rank`.
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Store an f32 at this block's shared address `addr` in the block of the
// cluster with rank `rank`.
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// Floats a block's receive buffer of cluster_reduce needs for partials of
// `elems` floats, at most `max_split` blocks of T threads.
__host__ __device__ constexpr int cluster_recv_floats(int elems, int max_split, int T) {
  return elems + max_split * T;
}

// The k split's sum across a cluster of `split` blocks of T threads, one
// cluster barrier: element e < elems of each block's partial red[] goes to
// the block that owns it (rank (e / T) % split), which adds the split
// partials in rank order and calls emit(e, sum). recv is this block's
// receive buffer (cluster_recv_floats(elems, split, T) floats at least),
// apart from anything a block still reads when the first block arrives.
template <int T, class Emit>
__device__ __forceinline__ void cluster_reduce(const float* red, float* recv, int elems, int split,
                                               int rank, Emit emit) {
  const int tid = threadIdx.x;
  const int per = (elems + T * split - 1) / (T * split) * T;  // slots of one sender
  for (int e = tid; e < elems; e += T)
    st_cluster_f32(smem_addr(recv + rank * per + (e / (T * split)) * T + e % T), (e / T) % split,
                   red[e]);
  cluster_sync();
  for (int li = tid; li < per; li += T) {
    const int e = (li / T) * (T * split) + rank * T + li % T;
    if (e >= elems) break;
    float sum = recv[li];
    for (int z = 1; z < split; ++z) sum = __fadd_rn(sum, recv[z * per + li]);
    emit(e, sum);
  }
}

// --- mma.sync ---

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- wgmma ---

// Shared-memory matrix descriptors (start address, LBO, SBO in 16-byte
// units; layout type in bits 62-63). The tiles they describe are the ones TMA
// writes with the same swizzle (or threads write by the same rule), based at
// a multiple of 1024 bytes.
//
// K-major, 128-byte swizzle: rows of 64 bf16 = 128 bytes (16-byte chunk c of
// row r at c ^ (r & 7)), 8-row groups 1024 bytes apart. A k16 step further
// is 32 bytes on (+2 in the address field).
__device__ __forceinline__ uint64_t desc_kmajor_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major, 64-byte swizzle: rows of 64 int8 bytes (16-byte chunk c of row r
// at c ^ ((r >> 1) & 3)), 8-row groups 512 bytes apart. A k32 step further
// is 32 bytes on (+2).
__device__ __forceinline__ uint64_t desc_kmajor_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// MN-major, 128-byte swizzle: the same tile as desc_kmajor_sw128's, read
// with its rows along K (64 bf16 of N a row), 8-row groups 1024 bytes apart
// along K. A k16 step further is 16 rows = 2048 bytes on (+128).
__device__ __forceinline__ uint64_t desc_mnmajor_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// No swizzle, K-major (core matrices of 8 rows x 16 bytes, 128 bytes apart
// along K and 256 along N): the all-ones B of P's row sums (wgmma m64n8k16),
// which reads 256 bytes from the start.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A register A operand's fragments, which a wgmma in flight still reads.
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d[64 x 64] (+)= A[64 x 32] B[64 x 32]^T, s8 x s8 -> s32, both K-major from
// shared memory; accumulate = 0 zeroes d first. d[4 n + e]: row 16 * warp +
// lane / 4 + 8 * (e / 2), column 8 n + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The layout of a wgmma's B operand in shared memory: K-major (K contiguous)
// or MN-major (N contiguous). The transpose flag is an immediate of the
// instruction, so each is its own form.
enum BMajor { B_KMAJOR = 0, B_MNMAJOR = 1 };

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 -> f32; A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory, K-major
// or MN-major. d's layout as wgmma_s8_m64n64k32's.
template <int MAJOR>
__device__ __forceinline__ void wgmma_bf16_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(MAJOR));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 -> f32; A and B both K-major
// from shared memory (descriptors). d's layout as wgmma_s8_m64n64k32's.
__device__ __forceinline__ void wgmma_bf16_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32; A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B K-major from shared memory.
// d[4 n + e]: row 16 * warp + lane / 4 + 8 * (e / 2) of the warpgroup's 64,
// column 8 n + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_bf16_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32; A and B both K-major
// from shared memory (descriptors). d's layout as wgmma_bf16_m64n128k16_rs's.
__device__ __forceinline__ void wgmma_bf16_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] = A[64 x 16] B[16 x 128]: the first k-step of a product into
// d, whose old values it neither reads nor keeps alive ("=f"), so the
// registers a new product overwrites carry no false dependence.
__device__ __forceinline__ void wgmma_bf16_m64n128k16_ss_zero(float (&d)[64], uint64_t da,
                                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
        "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]),
        "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], bf16 -> f32; A and B both K-major
// from shared memory (descriptors). d[4 n + e]: row 16 * warp + lane / 4 + 8
// * (e / 2), column 8 n + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_bf16_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] = A[64 x 16] B[16 x 32]: the first k-step of a product into d,
// whose old values it neither reads nor keeps alive ("=f"), as
// wgmma_bf16_m64n128k16_ss_zero.
__device__ __forceinline__ void wgmma_bf16_m64n32k16_ss_zero(float (&d)[16], uint64_t da,
                                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 64] = A[64 x 16] B[16 x 64]: the same first k-step at n64.
__device__ __forceinline__ void wgmma_bf16_m64n64k16_ss_zero(float (&d)[32], uint64_t da,
                                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 8] (+)= A[64 x 16] B[16 x 8], bf16 -> f32; A from registers, B
// K-major from shared memory (P's row sums against a ones matrix).
__device__ __forceinline__ void wgmma_bf16_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// --- TF32 (the exact modes' products as 3xTF32) ---
//
// An f32 x splits into big = x rounded to nearest TF32 (ties away from zero,
// as cvt.rna.tf32.f32: the low 13 bits cleared after adding half of their
// range) and small = x - big, exact in f32. The tensor cores ignore the low 13
// bits of what they read, so a product of two f32 operands is taken as
// a_big b_big + a_big b_small + a_small b_big (the small-small term, below
// 2^-22 of the product, is dropped). TF32 wgmma reads A and B K-major only
// (the transpose bits are for 16-bit types), each k8 step 32 bytes of a row:
// the bf16 k16 steps' descriptors serve unchanged. The A fragment in
// registers of a k-step (8 columns) is, per thread, a[0] = (row, c), a[1] =
// (row + 8, c), a[2] = (row, c + 4), a[3] = (row + 8, c + 4), with row = 16
// warp + lane / 4 and c = lane % 4: an accumulator's pair (row, 2c), (row,
// 2c + 1) lands on columns c and c + 4, so a product whose A comes from an
// accumulator reads its B with each group of 8 k indices permuted (column j
// of the fragment is accumulator column tf32_a_column(j)).

__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// The accumulator column (0..7 within a group of 8) that a TF32 A fragment
// built from accumulator pairs holds in its column j.
__host__ __device__ constexpr int tf32_a_column(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 -> f32; A and B K-major from
// shared memory. d's layout as wgmma_s8_m64n64k32's.
__device__ __forceinline__ void wgmma_tf32_m64n64k8_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] = A[64 x 8] B[8 x 64], tf32 -> f32, A from registers: the
// first k-step of a product into d, whose old values it neither reads nor
// keeps alive ("=f"): with "+f", the moves that carry d's dead values across
// a loop's back edge land inside the pipeline stage of a product still in
// flight there, and ptxas serializes the kernel's wgmma (C7515).
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs_zero(float (&d)[32],
                                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 -> f32; A from registers (the
// fragment above), B K-major from shared memory.
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32 -> f32, A from registers (the
// fragment above), B K-major from shared memory. d[4 n + e]: row 16 * warp +
// lane / 4 + 8 * (e / 2), column 8 n + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_tf32_m64n32k8_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 32] = A[64 x 8] B[8 x 32]: the first k-step of a product into d,
// whose old values it neither reads nor keeps alive ("=f"), as
// wgmma_tf32_m64n64k8_rs_zero.
__device__ __forceinline__ void wgmma_tf32_m64n32k8_rs_zero(float (&d)[16],
                                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32 -> f32; A and B K-major from
// shared memory. d's layout as wgmma_tf32_m64n32k8_rs's.
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The 3xTF32 prep of one pair of key-side operands, 64 keys of one (batch,
// head) by a block of 256 threads: K [s, 64] f32 (rows `k_st` floats apart,
// contiguous, 16-byte aligned) -> K big and K small at kb, ks [s, 64]; V ->
// V^T big and V^T small at vbt, vst [64, s8] (s8 = s rounded up to 8),
// column 8g + j holding key 8g + tf32_a_column(j), keys past s 0: the
// K-major B of a product whose A fragments come from an accumulator whose
// columns are keys. Keys k0 .. k0 + 63; V passes through v_s. Every load is
// issued before the first store.
constexpr int SPLIT_KEYS = 64;

__device__ __forceinline__ void kv_split_tf32_tile(const float* __restrict__ kp, long long k_st,
                                                   const float* __restrict__ vp, long long v_st,
                                                   float* __restrict__ kb, float* __restrict__ ks,
                                                   float* __restrict__ vbt,
                                                   float* __restrict__ vst, int k0, int s, int s8,
                                                   float (&v_s)[SPLIT_KEYS][65]) {
  constexpr int HD = 64;
  const int tid = threadIdx.x;
  constexpr int PASSES = SPLIT_KEYS * (HD / 4) / 256;
  float4 kx[PASSES], vx[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {  // chunk c: key c / 16, head dims 4 (c % 16) ..
    const int c = tid + 256 * i, key = k0 + c / (HD / 4);
    kx[i] = vx[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < s) {
      kx[i] = *reinterpret_cast<const float4*>(kp + key * k_st + 4 * (c % (HD / 4)));
      vx[i] = *reinterpret_cast<const float4*>(vp + key * v_st + 4 * (c % (HD / 4)));
    }
  }
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int c = tid + 256 * i, r = c / (HD / 4), c4 = 4 * (c % (HD / 4));
    const float x[4] = {kx[i].x, kx[i].y, kx[i].z, kx[i].w};
    float big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      big[e] = tf32_big(x[e]);
      small[e] = x[e] - big[e];
    }
    if (k0 + r < s) {
      const size_t at = static_cast<size_t>(k0 + r) * HD + c4;
      *reinterpret_cast<float4*>(kb + at) = make_float4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<float4*>(ks + at) = make_float4(small[0], small[1], small[2], small[3]);
    }
    v_s[r][c4] = vx[i].x;
    v_s[r][c4 + 1] = vx[i].y;
    v_s[r][c4 + 2] = vx[i].z;
    v_s[r][c4 + 3] = vx[i].w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {  // chunk c: head dim c / 16, columns 4 (c % 16) ..
    const int c = tid + 256 * i, d = c / (SPLIT_KEYS / 4), j4 = 4 * (c % (SPLIT_KEYS / 4));
    if (k0 + j4 >= s8) continue;
    float big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = v_s[(j4 / 8) * 8 + tf32_a_column(j4 % 8 + e)][d];
      big[e] = tf32_big(x);
      small[e] = x - big[e];
    }
    const size_t at = static_cast<size_t>(d) * s8 + k0 + j4;
    *reinterpret_cast<float4*>(vbt + at) = make_float4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<float4*>(vst + at) = make_float4(small[0], small[1], small[2], small[3]);
  }
}

// --- exact widening to bf16, off the conversion pipe ---

// Int8 -> bf16 (exact) on the integer and FMA pipes only (conversion
// instructions run at a quarter of their rate): each byte, biased to unsigned
// (x ^ 0x80), is spliced into the mantissa of 2^23 and 2^23 + 128 is
// subtracted, which gives the integer exactly in f32; |b| <= 128 has at most
// 8 significant bits, so its bf16 is the f32's upper half.
__device__ __forceinline__ float biased_byte_f32(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + j)) - 8388736.f;
}

// Byte j of two int8 words -> one word of two bf16, wa's in the low half.
__device__ __forceinline__ uint32_t widen_pair(uint32_t wa, uint32_t wb, int j) {
  return __byte_perm(__float_as_uint(biased_byte_f32(wa ^ 0x80808080u, j)),
                     __float_as_uint(biased_byte_f32(wb ^ 0x80808080u, j)), 0x7632u);
}

// 4 int8 (one word) -> 4 bf16 in byte order, as two words.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __float_as_uint(biased_byte_f32(u, i));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632u), __byte_perm(f[2], f[3], 0x7632u));
}

// 8 int8 (two words) -> 8 bf16, as 16 bytes.
__device__ __forceinline__ uint4 widen8(uint32_t w0, uint32_t w1) {
  const uint2 a = widen4(w0), b = widen4(w1);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// One 64 x 64 int8 tile in the 64-byte swizzle (desc_kmajor_sw64's layout)
// -> bf16 rows of 128 bytes in the 128-byte swizzle (desc_kmajor_sw128's and
// desc_mnmajor_sw128's layout). 256 threads, one 16-byte chunk each.
__device__ __forceinline__ void widen_tile_64x64(const uint8_t* src, uint8_t* dst, int tid) {
  const int r = tid / 4, c = tid % 4;
  const uint4 x = *reinterpret_cast<const uint4*>(src + r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
  *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * c) ^ (r & 7)) << 4)) = widen8(x.x, x.y);
  *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * c + 1) ^ (r & 7)) << 4)) = widen8(x.z, x.w);
}

// Two biased nibbles u0, u1 (0..15, one in bits 0-7 and one in bits 16-23 of
// t; the other bits are ignored) -> two bf16 u - 8 (exact): 0x4300 | u is the
// bf16 128 + u, and one bf16x2 fma subtracts 136.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t t) {
  const uint32_t biased = (t & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// The same from two int4 values in two's complement (bits 0-3 and 16-19 of
// t): the sign bit flipped is the value biased by 8, folded into the same
// logic op.
__device__ __forceinline__ uint32_t signed_nibbles_to_bf16x2(uint32_t t) {
  const uint32_t biased = (t & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Byte j of two words of biased nibbles -> one word of two bf16 (exact): nb0's
// in the low half, nb1's in the high half.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t nb0, uint32_t nb1, int j) {
  return nibbles_to_bf16x2(__byte_perm(nb0, nb1, j | ((4 + j) << 8)));
}

// The same from two words of int4 values in two's complement.
__device__ __forceinline__ uint32_t signed_nibble_pair(uint32_t n0, uint32_t n1, int j) {
  return signed_nibbles_to_bf16x2(__byte_perm(n0, n1, j | ((4 + j) << 8)));
}

// The int4 nibbles of a packed word (low nibbles: the lower half's rows; high
// nibbles: the upper half's), biased by 8, one per byte.
__device__ __forceinline__ uint32_t low_nibbles(uint32_t p) {
  return (p ^ 0x88888888u) & 0x0F0F0F0Fu;
}
__device__ __forceinline__ uint32_t high_nibbles(uint32_t p) {
  return ((p ^ 0x88888888u) >> 4) & 0x0F0F0F0Fu;
}

// --- element helpers of the int8 attention kernels ---

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// An int32 of magnitude below 2^22 as f32, exactly, without a conversion
// instruction: added to the bits of 1.5 * 2^23, then 1.5 * 2^23 subtracted.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// 2^x, one MUFU.EX2 (flushes results below 2^-126 to 0: what it feeds is
// rounded to bf16, whose normal range is f32's, or scales such a value).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_type) {
  if (out_type == OUT_F32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// Two neighbouring outputs i, i + 1 (i even, the row length even).
__device__ __forceinline__ void store_out2(void* out, size_t i, float v0, float v1, int out_type) {
  if (out_type == OUT_F32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(v0, v1);
}

// --- host side ---

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over a row-major [rows, cols] array of `elem_bytes`-byte elements
// (row stride cols * elem_bytes, a multiple of 16), boxes of box_rows x
// box_cols; reads outside the array fill with zeros.
bool tensor_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes,
                   int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over a row-major [n, rows, cols] array (rows of cols *
// elem_bytes bytes, a multiple of 16), boxes of 1 x box_rows x box_cols: a box
// stays inside one of the n matrices, and its rows past `rows` fill with
// zeros.
bool tensor_map_3d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes,
                   int n, int rows, int cols, int box_rows, int box_cols,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * elem_bytes;
  const cuuint64_t strides[2] = {row_bytes, row_bytes * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map over a [n3, n2, rows, cols] array with the given strides in
// bytes (stride[0] the row's, stride[1] and stride[2] those of the outer
// dimensions; each a multiple of 16, in any order), boxes of 1 x 1 x box_rows x box_cols: a box stays inside one
// [rows, cols] matrix, and its rows past `rows` fill with zeros. The rows of
// a strided view ([b, s, h, d] read as [b, h, s, d]) need no copy.
bool tensor_map_4d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int n3, int n2,
                   int rows, int cols, const long long (&stride)[3], int box_rows, int box_cols,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n2), static_cast<cuuint64_t>(n3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride[0]),
                                 static_cast<cuuint64_t>(stride[1]),
                                 static_cast<cuuint64_t>(stride[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
