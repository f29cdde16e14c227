// The Merkle heap over BLAKE3 digests: (8, N) leaf digest words -> the
// (2N, 8) heap of zkvm/hash/blake3_jax.py::merkle_flat (:178; the parent of
// i is i / 2, row 0 zero, the root at row 1, leaf j at row N + j), N a
// power of two.  The reference builds it with XLA (blake3_jax.merge :148),
// not Pallas: this is device work it left to the compiler.
//
// What bounds it on an H100: the N - 1 compresses (32-bit integer ALU
// work, as K2), then the 96 bytes a leaf of memory (32 read, 64 written).
//
// One launch a tree, at every N.  A block takes a unit of C = 2^k consecutive
// nodes of a level (k = ZK_MERKLE_K; all N leaves when N <= 2^k), held
// word-major in shared memory, and builds the unit's levels there down to W =
// 2^k / G roots (G = ZK_MERKLE_GROUP; 32 roots at the shipped k = 10, G = 32):
// one compress a thread a parent, one barrier a level, every node written to
// the heap as one 32-byte row.  So every level with at least W parents in a
// unit runs on full warps.  The first stage takes its leaves four a thread,
// straight from the (8, N) words in 8-byte loads, and builds the two levels
// above them in registers with no barrier; only the grandparents go through
// shared memory (the one-leaf-a-thread form stays for units of fewer than 4 W
// leaves and for leaves not 8-byte aligned).  Then the block fences its writes
// and adds one to its group's counter: the units of G siblings (all of them,
// where fewer are left) make one unit of the next stage, and the block that
// arrives last carries on with it: it reads the group's G W roots back from the
// heap (from L2 in 16-byte loads, several in flight a thread: other blocks
// wrote them in this launch, so never through the non-coherent path), resets
// the counter to 0 and builds that unit the same way.  No block waits for
// another. When one unit of W roots is left, the tree's top log2 W <= 5 levels
// (<= 16 parents) run in the last block's first warp, on __syncwarp(), and row
// 0 is written.  The counters are an int32 scratch the caller keeps
// (zk_merkle_counters ints, zero before the launch, zero after it), so a tree
// needs no memset, no second launch and no copy from the host: the IV and flags
// are constants.  The compress is K2's (blake3.cuh).
#include "blake3.cuh"

#ifndef ZK_MERKLE_K
#define ZK_MERKLE_K 10  // log2 of the nodes a block's unit takes
#endif
#ifndef ZK_MERKLE_GROUP
#define ZK_MERKLE_GROUP 0  // sibling units a carry gathers (0: 2^k / 32, or 2^k below 64 nodes a unit)
#endif
#ifndef ZK_MERKLE_THREADS
#define ZK_MERKLE_THREADS 256  // threads of a full block
#endif
#ifndef ZK_MERKLE_MIN_BLOCKS
#define ZK_MERKLE_MIN_BLOCKS 3  // blocks an SM must hold (the register budget: 85 a thread)
#endif

namespace {

constexpr int kWarp = 32;
constexpr long kLeaves = 1L << ZK_MERKLE_K;
constexpr long kGroup = ZK_MERKLE_GROUP ? ZK_MERKLE_GROUP : kLeaves >= 2 * kWarp ? kLeaves / kWarp : kLeaves;
constexpr long kRoots = kLeaves / kGroup;  // W: the roots a unit keeps, the top's width
constexpr int kThreads = ZK_MERKLE_THREADS;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use (sm_90)
static_assert(kGroup >= 2 && (kGroup & (kGroup - 1)) == 0 && kLeaves % kGroup == 0, "G: a power of two below 2^k");
static_assert(kRoots <= kWarp, "the top fits one warp");
static_assert(kThreads >= kWarp && kThreads % kWarp == 0, "whole warps a block");
static_assert(48L * kLeaves <= kMaxSmem, "a block's nodes must fit shared memory");

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

// the parent v of the nodes l and r
__device__ __forceinline__ void parent(const uint32_t (&l)[8], const uint32_t (&r)[8], uint32_t (&v)[8]) {
  uint32_t m[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = l[j];
    m[8 + j] = r[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = zk::b3::iv(j);
  zk::b3::compress(v, m, 64, zk::b3::kChunkStart | zk::b3::kChunkEnd | zk::b3::kRoot);
}

// the parent of nodes 2p and 2p + 1 of the `count` nodes at in (word j of
// node i at in[j * count + i]), to v
__device__ __forceinline__ void merge(const uint32_t* in, int count, int p, uint32_t (&v)[8]) {
  uint32_t l[8], r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    l[j] = in[j * count + 2 * p];
    r[j] = in[j * count + 2 * p + 1];
  }
  parent(l, r, v);
}

// leaves l and l + 1 (l even) of the (8, N) words: their heap rows, and
// their parent's, which is v; word j of both in one 8-byte load
__device__ __forceinline__ void leaf_pair(const uint32_t* __restrict__ leaves, long N, long l,
                                          uint32_t* __restrict__ heap, uint32_t (&v)[8]) {
  uint32_t x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#if defined(__CUDACC__)
    const uint2 w = *reinterpret_cast<const uint2*>(leaves + j * N + l);
    x[j] = w.x, y[j] = w.y;
#else
    x[j] = leaves[j * N + l], y[j] = leaves[j * N + l + 1];
#endif
  }
  store_row(heap, N + l, x);
  store_row(heap, N + l + 1, y);
  parent(x, y, v);
  store_row(heap, (N + l) / 2, v);
}

// the C nodes of heap rows from `row` on, word-major into s (word j of
// node i at s[j C + i]): 16-byte loads from L2 (another block of this
// launch may have written them: never the non-coherent path), 4 of them
// in flight a thread
__device__ __forceinline__ void load_nodes(const uint32_t* heap, long row, int C, uint32_t* s) {
  constexpr int kBatch = 4;
  for (int base = threadIdx.x; base < 2 * C; base += kBatch * blockDim.x) {
    uint32_t w[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;  // words 4 (i % 2) .. + 3 of node i / 2
      if (i < 2 * C) {
#if defined(__CUDACC__)
        const uint4 x = __ldcg(reinterpret_cast<const uint4*>(heap + 8 * row) + i);
        w[u][0] = x.x, w[u][1] = x.y, w[u][2] = x.z, w[u][3] = x.w;
#else
        for (int e = 0; e < 4; ++e) w[u][e] = heap[8 * row + 4 * i + e];
#endif
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      if (i < 2 * C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[(4 * (i & 1) + e) * C + (i >> 1)] = w[u][e];
      }
    }
  }
}

// Build the levels above the block's `count` nodes (a power of two) down
// to `stop` nodes, every thread of the block: the nodes are word-major at
// s; globally their level has `level` nodes and the block's first is node
// `first`.  s holds 1.5 count nodes: each level reads one half and writes
// the other.  Returns where the last level's nodes are.
__device__ uint32_t* build_levels(uint32_t* s, int count, int stop, long level, long first,
                                  uint32_t* __restrict__ heap) {
  uint32_t* in = s;
  uint32_t* outb = s + 8 * count;
  while (count > stop) {
    const int half = count / 2;
    level /= 2;
    first /= 2;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      uint32_t v[8];
      merge(in, count, p, v);
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
  return in;
}

// The tree's top: its level of `count` <= W nodes at in, built up to the
// root by the block's first warp alone (out: room for count / 2 nodes
// apart from in), then row 0.  The other warps leave.
__device__ void build_top(uint32_t* in, uint32_t* out, int count, uint32_t* __restrict__ heap) {
  if (threadIdx.x >= kWarp) return;
  const int lanes = blockDim.x < kWarp ? (int)blockDim.x : kWarp;
  const unsigned mask = lanes == kWarp ? 0xFFFFFFFFu : (1u << lanes) - 1;
  for (; count > 1; count /= 2) {
    const int half = count / 2;  // the parents' level: heap rows half .. count - 1
    for (int p = threadIdx.x; p < half; p += lanes) {
      uint32_t v[8];
      merge(in, count, p, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j * half + p] = v[j];
      store_row(heap, half + p, v);
    }
    __syncwarp(mask);
    uint32_t* t = in;
    in = out;
    out = t;
  }
  if (threadIdx.x == 0) {
    const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    store_row(heap, 0, zero);
  }
}

}  // namespace

// A stage reads a level of R nodes in units of C = min(R, 2^k); each unit
// keeps W roots.  Block b starts with unit b of the leaves.
__global__ void __launch_bounds__(kThreads, ZK_MERKLE_MIN_BLOCKS)
    merkle_heap_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ heap, int* __restrict__ counters,
                       long N, bool quads) {
  ZK_DYN_SMEM(uint32_t, s);
  __shared__ int carry;
  long R = N, C = N < kLeaves ? N : kLeaves, unit = blockIdx.x;
  long next = 0;  // the first counter of the next stage's units
  const long first = unit * C;
  if (quads) {
    // four leaves a thread, straight from (8, N): their rows and the two
    // levels above them in registers, with no barrier; the unit's C / 4
    // grandparents go to shared memory
    const int count = (int)(C / 4);
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
      const long l0 = first + 4 * q;
      uint32_t a[8], b[8], g[8];
      leaf_pair(leaves, N, l0, heap, a);
      leaf_pair(leaves, N, l0 + 2, heap, b);
      parent(a, b, g);
      store_row(heap, N / 4 + l0 / 4, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j * count + q] = g[j];
    }
    __syncthreads();
    R = N / 4;
    C = count;
  } else {
    // word j of leaf l at s[j C + l]: C a power of two, so a shift and a
    // mask (no 64-bit division in the loop)
    int log_c = 0;
    while ((1L << log_c) < C) ++log_c;
    for (int i = threadIdx.x; i < 8 * C; i += blockDim.x) s[i] = leaves[(i >> log_c) * N + first + (i & (C - 1))];
    __syncthreads();
    for (int l = threadIdx.x; l < C; l += blockDim.x) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s[j * C + l];
      store_row(heap, N + first + l, v);
    }
  }
  uint32_t* nodes = s;
  while (R > kRoots) {
    nodes = build_levels(s, (int)C, (int)kRoots, R, unit * C, heap);
    const long units = R / C;
    R = units * kRoots;
    if (units == 1) break;  // this unit's W roots are the tree's top level
    const long Cn = R < kLeaves ? R : kLeaves, group = unit / (Cn / kRoots);
    __threadfence();  // this thread's rows, before the group's counter moves
    __syncthreads();
    if (threadIdx.x == 0) {
      int* counter = counters + next + group;
      carry = atomicAdd(counter, 1) == Cn / kRoots - 1;
      if (carry) {
        *counter = 0;  // every sibling has arrived: ready for the next tree
        __threadfence();
      }
    }
    __syncthreads();
    if (!carry) return;
    next += R / Cn;
    C = Cn;
    unit = group;
    load_nodes(heap, R + unit * C, (int)C, s);  // the group's roots
    __syncthreads();
    nodes = s;
  }
  build_top(nodes, nodes == s ? s + 8 * C : s, (int)R, heap);
}

namespace {

// the counters a tree of N leaves uses: one a unit of every stage that a
// group carries
long counters_for(long N) {
  long need = 0;
  for (long R = N; R > kRoots;) {
    const long units = R / (R < kLeaves ? R : kLeaves);
    R = units * kRoots;
    if (units == 1) break;
    need += R / (R < kLeaves ? R : kLeaves);
  }
  return need;
}

}  // namespace

// the int32 counters zk_merkle_heap needs for N leaves (a power of two)
ZK_EXPORT int zk_merkle_counters(long N) { return N < 1 || (N & (N - 1)) ? -1 : (int)counters_for(N); }

// leaves: (8, N) digest words -> heap: (2N, 8); N a power of two.
// counters: n_counters int32 of device memory, all 0, which the launch
// leaves all 0 (see zk_merkle_counters).  *launches is set to the kernel
// launches this call made: one, or none where it refuses (1, the
// cudaErrorInvalidValue, for N not a power of two or too few counters).
ZK_EXPORT int zk_merkle_heap(const uint32_t* leaves, uint32_t* heap, long N, int* counters, long n_counters,
                             int* launches, void* stream) {
  *launches = 0;
  if (N < 1 || (N & (N - 1)) || counters_for(N) > n_counters) return 1;
  const long C = N < kLeaves ? N : kLeaves;
  // leaves four a thread where a unit keeps W roots of its grandparents
  // and the 8-byte loads are aligned
  const bool quads = C >= 4 * kRoots && ((uintptr_t)leaves & 7) == 0;
  // 8 words of 1.5 nodes a node of the unit; above 48 KB with the static
  // `carry` only after the attribute is raised
  const long smem = 48 * C;
  if (smem + 16 > 48 * 1024) ZK_SET_SMEM(merkle_heap_kernel, (int)smem);
  const long work = quads ? C / 4 : C / 2;  // threads with a first task
  const int threads = work < 1 ? 1 : work > kThreads ? kThreads : (int)work;
  ZK_LAUNCH(merkle_heap_kernel, dim3((unsigned)(N / C)), dim3(threads), (size_t)smem, stream, leaves, heap, counters,
            N, quads);
  *launches = 1;
  return ZK_LAST_ERROR();
}
