// The Merkle heap over BLAKE3 digests: (8, N) leaf digest words -> the
// (2N, 8) heap of zkvm/hash/blake3_jax.py::merkle_flat (:178; the parent of
// i is i / 2, row 0 zero, the root at row 1, leaf j at row N + j), N a
// power of two.  The reference builds it with XLA (blake3_jax.merge :148),
// not Pallas: this is device work it left to the compiler.
//
// What bounds it on an H100: the N - 1 compresses (32-bit integer ALU
// work, as K2), then the 96 bytes a leaf of memory (32 read, 64 written).
// Launches, at most ceil(log2 N / k) of them (k = ZK_MERKLE_K): (i) a block
// takes 2^k consecutive leaves, loaded coalesced into shared memory, and
// builds its subtree's levels there, one compress a thread a parent, one
// barrier a level, writing each node to the heap as one 32-byte row; then
// (ii), while more than one root is left, the same over the R roots of
// the last launch, read back from the heap: a block takes 2^k of them, or
// all R when R <= 2^ZK_MERKLE_TOP (the top launch, one block).  Shared
// memory holds 48 bytes a node, so no launch needs more than a block has
// (a single top launch over the 8192 roots of 2^23 leaves would need
// 393,216 bytes).  When N <= 2^k, (i) alone builds the whole tree.  The
// compress is K2's (blake3.cuh).  Nothing is copied from the host: the IV
// and flags are constants.
#include "blake3.cuh"

#ifndef ZK_MERKLE_K
#define ZK_MERKLE_K 10  // log2 of the nodes a block of launch (i) or (ii) takes
#endif
#ifndef ZK_MERKLE_TOP
#define ZK_MERKLE_TOP ZK_MERKLE_K  // log2 of the most roots the top launch takes
#endif

namespace {

constexpr int kLeaves = 1 << ZK_MERKLE_K;
constexpr long kTop = 1L << ZK_MERKLE_TOP;
constexpr int kThreads = kLeaves / 2 < 32 ? 32 : kLeaves / 2 > 1024 ? 1024 : kLeaves / 2;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use (sm_90)
static_assert(48L * kLeaves <= kMaxSmem && 48L * kTop <= kMaxSmem, "a block's nodes must fit shared memory");

// the nodes a block of launch (ii) takes over a level of R > 1 nodes
long level_block(long R) { return R <= kTop ? R : R < kLeaves ? R : kLeaves; }

// heap row r <- the 8 words v
__device__ __forceinline__ void store_row(uint32_t* __restrict__ heap, long r, const uint32_t (&v)[8]) {
#if defined(__CUDACC__)
  uint4* dst = reinterpret_cast<uint4*>(heap + 8 * r);
  dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
  dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
#else
  for (int j = 0; j < 8; ++j) heap[8 * r + j] = v[j];
#endif
}

// Build the levels above the block's `count` nodes (a power of two), held
// word-major in s (word j of node p at s[j * count + p]); globally their
// level has `level` nodes and the block's first is node `first`.  s holds
// 1.5 count nodes: each level reads one half and writes the other.
__device__ void build_levels(uint32_t* s, int count, long level, long first, uint32_t* __restrict__ heap) {
  uint32_t* in = s;
  uint32_t* outb = s + 8 * count;
  while (count > 1) {
    const int half = count / 2;
    level /= 2;
    first /= 2;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      uint32_t m[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = in[j * count + 2 * p];
        m[8 + j] = in[j * count + 2 * p + 1];
      }
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = zk::b3::iv(j);
      zk::b3::compress(v, m, 64, zk::b3::kChunkStart | zk::b3::kChunkEnd | zk::b3::kRoot);
#pragma unroll
      for (int j = 0; j < 8; ++j) outb[j * half + p] = v[j];
      store_row(heap, level + first + p, v);
    }
    __syncthreads();
    uint32_t* t = in;
    in = outb;
    outb = t;
    count = half;
  }
}

}  // namespace

// (i): block b takes leaves b L .. b L + L - 1 (L = min(N, 2^k))
__global__ void __launch_bounds__(kThreads)
    merkle_subtrees_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ heap, long N, int L) {
  ZK_DYN_SMEM(uint32_t, s);
  const long first = (long)blockIdx.x * L;
  for (int i = threadIdx.x; i < 8 * L; i += blockDim.x) {
    const int j = i / L, l = i % L;
    s[i] = leaves[j * N + first + l];
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = s[j * L + l];
    store_row(heap, N + first + l, v);
  }
  build_levels(s, L, N, first, heap);
  if (N == L && threadIdx.x == 0) {
    const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    store_row(heap, 0, zero);
  }
}

// (ii): block b takes nodes b L .. b L + L - 1 of the level of R nodes at
// heap rows R .. 2R - 1 and builds the log2 L levels above them; with L = R
// (one block) it builds the top of the tree
__global__ void __launch_bounds__(kThreads) merkle_levels_kernel(uint32_t* __restrict__ heap, long R, int L) {
  ZK_DYN_SMEM(uint32_t, s);
  const long first = (long)blockIdx.x * L;
  const uint32_t* nodes = heap + 8 * (R + first);
  for (int i = threadIdx.x; i < 8 * L; i += blockDim.x) s[(i % 8) * L + i / 8] = nodes[i];
  __syncthreads();
  build_levels(s, L, R, first, heap);
  if (R == L && threadIdx.x == 0) {
    const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    store_row(heap, 0, zero);
  }
}

// leaves: (8, N) digest words -> heap: (2N, 8); N a power of two.
// *launches is set to the kernel launches this call made.
ZK_EXPORT int zk_merkle_heap(const uint32_t* leaves, uint32_t* heap, long N, int* launches, void* stream) {
  *launches = 0;
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const long L = N < kLeaves ? N : kLeaves;
  // 8 words of 1.5 nodes a node of the block
  const long smem_i = 48 * L;
  if (smem_i > 48 * 1024) ZK_SET_SMEM(merkle_subtrees_kernel, (int)smem_i);
  const int threads_i = L / 2 < 1 ? 1 : L / 2 > kThreads ? kThreads : (int)(L / 2);
  ZK_LAUNCH(merkle_subtrees_kernel, dim3((unsigned)(N / L)), dim3(threads_i), (size_t)smem_i, stream, leaves,
            heap, N, (int)L);
  ++*launches;
  int rc = ZK_LAST_ERROR();
  for (long R = N / L; rc == 0 && R > 1; R /= level_block(R)) {
    const long Lr = level_block(R), smem = 48 * Lr;
    if (smem > 48 * 1024) ZK_SET_SMEM(merkle_levels_kernel, (int)smem);
    const int threads = Lr / 2 > kThreads ? kThreads : (int)(Lr / 2);
    ZK_LAUNCH(merkle_levels_kernel, dim3((unsigned)(R / Lr)), dim3(threads), (size_t)smem, stream, heap, R,
              (int)Lr);
    ++*launches;
    rc = ZK_LAST_ERROR();
  }
  return rc;
}
