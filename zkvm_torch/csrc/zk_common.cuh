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
