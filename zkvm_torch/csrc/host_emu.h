// Host emulation of the few CUDA features the zkvm_torch kernels use.
//
// Only for testing the kernels' logic on a machine without a card: each
// block runs its threads as std::threads sharing one dynamic shared-memory
// buffer, and __syncthreads() is a std::barrier.  Blocks run one after
// another.  Never compiled by nvcc.
#pragma once

#include <barrier>
#include <cstddef>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__

namespace zk_emu {
inline thread_local dim3 tl_thread_idx;
inline thread_local dim3 tl_block_idx;
inline dim3 g_block_dim;
inline dim3 g_grid_dim;
inline unsigned char* block_smem = nullptr;
inline std::barrier<>* block_barrier = nullptr;

template <class K, class... A>
void launch(dim3 grid, dim3 block, size_t smem_bytes, K kernel, A... args) {
  g_block_dim = block;
  g_grid_dim = grid;
  std::vector<unsigned char> smem(smem_bytes + 16);
  unsigned nthreads = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nthreads);
        block_barrier = &bar;
        block_smem = smem.data();
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nthreads; ++t) {
          threads.emplace_back([=] {
            tl_block_idx = dim3(bx, by, bz);
            tl_thread_idx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            kernel(args...);
          });
        }
        for (auto& th : threads) th.join();
      }
}
}  // namespace zk_emu

#define threadIdx (zk_emu::tl_thread_idx)
#define blockIdx (zk_emu::tl_block_idx)
#define blockDim (zk_emu::g_block_dim)
#define gridDim (zk_emu::g_grid_dim)
#define __syncthreads() (zk_emu::block_barrier->arrive_and_wait())
