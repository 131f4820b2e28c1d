// Synchronisation and copy helpers that several kernels share: the
// shared-memory address of a pointer, counters in device memory taken with
// acquire and given with release (GPU and system scope), thread block
// clusters (rank, size, the full cluster barrier, another block's shared
// memory by `mapa`, stores into it and a counter it releases), and 16-byte
// cp.async copies into shared memory.  Every access is volatile asm with a
// memory clobber, so the compiler keeps it in program order with the
// ordinary loads and stores around it.

#pragma once

#include <cuda_runtime.h>

namespace hsync {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ------------------------------------------ counters in device memory
__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  return static_cast<int>(ld_acquire_gpu(reinterpret_cast<const unsigned*>(p)));
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  st_release_gpu(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(v));
}

// The same at system scope: a counter another card reads or writes.
__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// ------------------------------------------------ thread block clusters
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (release, then acquire):
// what each wrote before (its shared memory, another block's) is seen by
// all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of the cluster with rank `rank`.
__device__ __forceinline__ unsigned remote_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_remote(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void st_remote(unsigned a, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}

__device__ __forceinline__ void st_release_remote(unsigned a, int v) {
  asm volatile("st.release.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// A counter of this block's shared memory that another block of the
// cluster stores into.
__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p))
               : "memory");
  return v;
}

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hsync
