// Common header of the zkvm_torch CUDA kernels.
//
// Built by nvcc for sm_90a (zkvm_torch/kernels.py), every kernel launches on
// the caller's stream and each C entry point returns cudaGetLastError().
//
// The same sources also compile as plain C++ (g++ -std=c++20 -pthread)
// against host_emu.h, which runs every CUDA thread of a block as a host
// thread with a barrier for __syncthreads().  That is how the CPU tests
// check the kernels' index and carry logic where there is no card
// (tests/test_torch_csrc_emu.py); the card's own run is chip_smoke.py.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define ZK_HD __host__ __device__ __forceinline__
#define ZK_DYN_SMEM(T, name)                                   \
  extern __shared__ __align__(16) unsigned char zk_smem_raw[]; \
  T* name = reinterpret_cast<T*>(zk_smem_raw)
#define ZK_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define ZK_SET_SMEM(kernel, bytes) \
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (bytes))
#define ZK_LAST_ERROR() ((int)cudaGetLastError())
#else
#include "host_emu.h"
#define ZK_HD inline
#define ZK_DYN_SMEM(T, name) T* name = reinterpret_cast<T*>(zk_emu::block_smem)
#define ZK_LAUNCH(kernel, grid, block, smem, stream, ...) \
  zk_emu::launch((grid), (block), (smem), kernel, __VA_ARGS__)
#define ZK_SET_SMEM(kernel, bytes) ((void)0)
#define ZK_LAST_ERROR() 0
#endif

#define ZK_EXPORT extern "C" __attribute__((visibility("default")))

// The warp-wide tensor-core product and the asynchronous copies of the
// multi-eval (csrc/multi_eval.cu), as PTX on the card and through
// host_emu.h on the host.
namespace zk {
#if defined(__CUDACC__)
// d[m][n] += a[m] b[n], a grid of M x N m16n8k32 tiles of unsigned bytes
// with s32 sums (the PTX ISA's fragment layout; host_emu.h spells it out)
template <int M, int N>
__device__ __forceinline__ void mma_u8(int32_t (&d)[M][N][4], const uint32_t (&a)[M][4], const uint32_t (&b)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(d[m][n][0]), "+r"(d[m][n][1]), "+r"(d[m][n][2]), "+r"(d[m][n][3])
          : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]), "r"(b[n][0]), "r"(b[n][1]));
}
// copy 16 (or 4) bytes to shared memory without waiting: the first
// src_bytes from src, zeros after them
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#else
template <int M, int N>
inline void mma_u8(int32_t (&d)[M][N][4], const uint32_t (&a)[M][4], const uint32_t (&b)[N][2]) {
  zk_emu::mma_m16n8k32_u8(d, a, b);
}
inline void cp_async16(void* dst, const void* src, int src_bytes) { zk_emu::cp_async(dst, src, 16, src_bytes); }
inline void cp_async4(void* dst, const void* src, int src_bytes) { zk_emu::cp_async(dst, src, 4, src_bytes); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
#endif
}  // namespace zk
