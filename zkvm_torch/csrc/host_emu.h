// Host emulation of the few CUDA features the zkvm_torch kernels use.
//
// Only for testing the kernels' logic on a machine without a card: each
// block runs its threads as std::threads sharing one dynamic shared-memory
// buffer, and __syncthreads() is a std::barrier.  A __shared__ variable is
// a static one, which all threads see; blocks run one after another, so
// each block has it to itself.  The byte permute and the funnel shift are
// their plain shift forms.  Never compiled by nvcc.
#pragma once

#include <barrier>
#include <cstddef>
#include <cstdint>
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
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

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

// byte i of the result is byte s[4i+2 .. 4i] of the 8 bytes y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

// the low word of hi:lo shifted right by (shift mod 32)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned n = shift & 31;
  return n ? (lo >> n) | (hi << (32 - n)) : lo;
}
