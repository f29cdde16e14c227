// Host emulation of the few CUDA features the zkvm_torch kernels use.
//
// Only for testing the kernels' logic on a machine without a card: a
// launch runs a block's threads as std::threads sharing one dynamic
// shared-memory buffer, and __syncthreads() is a std::barrier.  A
// __shared__ variable is a static one, which all threads see; blocks run
// one after another (the same threads take each block in turn, a barrier
// between blocks), so each block has it to itself.  The byte permute and
// the funnel shift are their plain shift forms; cp.async is a plain copy
// with its zero fill; a grid of the warp-wide mma.sync of u8 bytes (M A
// fragments by N B fragments) exchanges its lanes' fragments through a
// buffer of the warp's, between two barriers of the warp's 32 threads,
// and __syncwarp() is that barrier.  atomicAdd is a std::atomic_ref add,
// and __threadfence() a sequentially consistent fence.  With ZK_EMU_REVERSE_BLOCKS=1 the blocks of a grid run in
// reverse order (the last block first), so a kernel whose blocks meet at
// a counter sees its last arrival at the lowest block.
// Never compiled by nvcc.
#pragma once

#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
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
#define __grid_constant__

#ifndef ZK_EMU_REVERSE_BLOCKS
#define ZK_EMU_REVERSE_BLOCKS 0
#endif

namespace zk_emu {
inline thread_local dim3 tl_thread_idx;
inline thread_local dim3 tl_block_idx;
inline dim3 g_block_dim;
inline dim3 g_grid_dim;
inline unsigned char* block_smem = nullptr;
inline std::barrier<>* block_barrier = nullptr;

// each warp's mma fragments (A: 4 words a lane, B: 2; up to kMmaM and
// kMmaN of them) and its barrier
constexpr int kMmaM = 8, kMmaN = 16;
struct WarpFrags {
  uint32_t a[32][kMmaM][4], b[32][kMmaN][2];
};
inline std::vector<WarpFrags> warp_frags;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;

template <class K, class... A>
void launch(dim3 grid, dim3 block, size_t smem_bytes, K kernel, A... args) {
  g_block_dim = block;
  g_grid_dim = grid;
  std::vector<unsigned char> smem(smem_bytes + 16);
  const unsigned nthreads = block.x * block.y * block.z, nwarps = (nthreads + 31) / 32;
  std::barrier<> bar(nthreads);
  block_barrier = &bar;
  block_smem = smem.data();
  warp_frags.assign(nwarps, WarpFrags{});
  warp_barriers.clear();
  for (unsigned w = 0; w < nwarps; ++w)
    warp_barriers.emplace_back(std::make_unique<std::barrier<>>(nthreads - 32 * w < 32 ? nthreads - 32 * w : 32));
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nthreads; ++t) {
    threads.emplace_back([=, &bar] {
      tl_thread_idx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            tl_block_idx = ZK_EMU_REVERSE_BLOCKS ? dim3(grid.x - 1 - bx, grid.y - 1 - by, grid.z - 1 - bz)
                                                 : dim3(bx, by, bz);
            kernel(args...);
            bar.arrive_and_wait();  // the block's end: every thread done before the next block
          }
    });
  }
  for (auto& th : threads) th.join();
}

inline unsigned linear_thread() {
  return tl_thread_idx.x + g_block_dim.x * (tl_thread_idx.y + g_block_dim.y * tl_thread_idx.z);
}

// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32, d[m][n] += a[m] b[n] for
// M A and N B fragments, in the PTX ISA's fragment layout: lane = 4 g + t
// (groupID g, threadID_in_group t); A (16 x 32, row-major): a[0] holds
// row g, k 4t..4t+3 (byte e is k 4t + e), a[1] row g + 8, a[2] row g,
// k 16 + 4t.., a[3] row g + 8, k 16 + 4t..; B (32 x 8, column n): b[0]
// holds k 4t..4t+3 of column g, b[1] k 16 + 4t..; D: d[0], d[1] row g,
// columns 2t and 2t + 1, d[2], d[3] row g + 8.
template <int M, int N>
void mma_m16n8k32_u8(int32_t (&d)[M][N][4], const uint32_t (&a)[M][4], const uint32_t (&b)[N][2]) {
  static_assert(M <= kMmaM && N <= kMmaN, "a warp's fragment buffer");
  const unsigned tid = linear_thread(), lane = tid % 32;
  WarpFrags& f = warp_frags[tid / 32];
  std::barrier<>& bar = *warp_barriers[tid / 32];
  std::memcpy(f.a[lane], a, sizeof a);
  std::memcpy(f.b[lane], b, sizeof b);
  bar.arrive_and_wait();
  const unsigned g = lane / 4, t = lane % 4;
  for (int m = 0; m < M; ++m)
    for (int n = 0; n < N; ++n)
      for (int i = 0; i < 4; ++i) {
        const unsigned r = g + 8 * (i / 2), col = 2 * t + i % 2;
        uint32_t acc = (uint32_t)d[m][n][i];
        for (unsigned k = 0; k < 32; ++k) {
          const uint32_t x = f.a[4 * (r % 8) + (k % 16) / 4][m][2 * (k / 16) + r / 8] >> (8 * (k % 4));
          const uint32_t y = f.b[4 * col + (k % 16) / 4][n][k / 16] >> (8 * (k % 4));
          acc += (x & 0xFF) * (y & 0xFF);
        }
        d[m][n][i] = (int32_t)acc;
      }
  bar.arrive_and_wait();  // every lane has read the fragments before they change
}

// cp.async of `bytes` bytes: the first src_bytes from src, the rest zeros
inline void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  if (src_bytes) std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<unsigned char*>(dst) + src_bytes, 0, bytes - src_bytes);
}
}  // namespace zk_emu

#define threadIdx (zk_emu::tl_thread_idx)
#define blockIdx (zk_emu::tl_block_idx)
#define blockDim (zk_emu::g_block_dim)
#define gridDim (zk_emu::g_grid_dim)
#define __syncthreads() (zk_emu::block_barrier->arrive_and_wait())

// the barrier of the calling thread's warp (all its threads, whatever the mask)
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { zk_emu::warp_barriers[zk_emu::linear_thread() / 32]->arrive_and_wait(); }

inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

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
