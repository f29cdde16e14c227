// K1: the constant-geometry (Pease) NTT stage network along axis M.
//
// Replaces the TPU kernel zkvm/ntt/ntt_t.py::_pallas_stages (:320; kernels
// _stages_kernel, _stages_kernel_full, _stages_kernel_r1, body
// _stages_in_kernel) together with the two layout gathers around it
// (ntt_t.py::_axis_ntt): y and out are (B, M, 8, NL) 16-bit limbs in
// natural row order.  Shared-memory row m is loaded from input row
// bitrev(rotl(m, 1)); all log2 M radix-2 stages run, each pairing rows p
// and p + M/2 (twiddle tw[s][p]) and writing the sum and difference to
// rows rotr(p, 1) and rotr(p + M/2, 1); shared row j is stored to output
// row rotl(j, 1).  Variant 1 first multiplies by a full (M, NL) tensor (the
// four-step mid twiddles), variant 2 by the rank-1 tensor rs(8, M) x
// ls(8, NL) (the coset shift of class_ntt_t); both are indexed by the
// shared (permuted) row.
//
// What bounds it on an H100: by the count, 32-bit integer operations, most
// of them in the 128-bit modular multiplies (zk::mul32: 16 32 x 32-bit
// products and two folds by eps, as PTX carry chains); as measured, also
// the device-memory accesses, which come as runs of LT lanes (4 LT bytes)
// of one limb row.  The design keeps one block's M x LT tile (16 bytes an
// element) in shared memory, updated in place, so device memory is read
// and written once per call whatever M is; the premultiply is applied
// while loading.  A tile holds max(2048, 8 M) elements, so LT >= 8 where
// NL allows and each run fills a 32-byte sector, moved as 16-byte accesses
// of 4 lanes.  Each thread runs 4 butterflies per stage, whose multiplies
// are independent chains.  The kernel is a template on S = log2 M, and LT
// is a power of two, so every index is a shift or a mask.  The stage twiddles and the full
// premultiplier come packed (16 bytes an element, built once per size and
// cached by the wrapper) and are read with one 16-byte load; rs and ls are
// packed into shared memory once per block.
#include "f128.cuh"

using zk::cell;
using zk::fe;
using zk::pack;
using zk::unpack;

namespace {

constexpr int kMaxThreads = 512;
// The launch shape: a tile of max(ZK_K1_TILE, ZK_K1_LANES x M) elements
// and ZK_K1_PER_THREAD butterflies per thread and stage.  Other values are
// for timing the shapes only (kernel_bench.py --sweep builds them).
#ifndef ZK_K1_TILE
#define ZK_K1_TILE 2048
#endif
#ifndef ZK_K1_LANES
#define ZK_K1_LANES 8
#endif
#ifndef ZK_K1_PER_THREAD
#define ZK_K1_PER_THREAD 4
#endif
constexpr int kTile = ZK_K1_TILE, kLanes = ZK_K1_LANES, kPerThread = ZK_K1_PER_THREAD;

// V consecutive limbs of one limb row, moved as one 4V-byte access
template <int V>
struct alignas(4 * V) run {
  uint32_t w[V];
};

// the low S bits of m reversed
template <int S>
ZK_HD int bitrev(int m) {
#if defined(__CUDA_ARCH__)
  return (int)(__brev((unsigned)m) >> (32 - S));
#else
  int r = 0;
  for (int i = 0; i < S; ++i) r |= ((m >> i) & 1) << (S - 1 - i);
  return r;
#endif
}

template <int S>
ZK_HD int rotl1(int m) {
  return ((m << 1) | (m >> (S - 1))) & ((1 << S) - 1);
}

template <int S>
ZK_HD int rotr1(int m) {
  return (m >> 1) | ((m & 1) << (S - 1));
}

// Load phase for V lanes at a time: tile element e = m * LT + l (shared
// row m, lane l) holds input row bitrev(rotl(m, 1)), premultiplied.
template <int S, int V>
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ y,
                                          cell* __restrict__ dst,
                                          const cell* __restrict__ pre,
                                          const cell* __restrict__ rl, long b, long l0, int NL,
                                          int lt_log, int variant) {
  constexpr int M = 1 << S;
  const int LT = 1 << lt_log;
  const int groups = (M << lt_log) / V;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int e = g * V;
    const int m = e >> lt_log, l = e & (LT - 1);
    const int row = bitrev<S>(rotl1<S>(m));
    const uint32_t* p = y + ((b * M + row) * 8) * NL + l0 + l;
    run<V> limb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) limb[k] = *reinterpret_cast<const run<V>*>(p + (long)k * NL);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      fe v{(uint64_t)limb[0].w[i] | ((uint64_t)limb[1].w[i] << 16) |
               ((uint64_t)limb[2].w[i] << 32) | ((uint64_t)limb[3].w[i] << 48),
           (uint64_t)limb[4].w[i] | ((uint64_t)limb[5].w[i] << 16) |
               ((uint64_t)limb[6].w[i] << 32) | ((uint64_t)limb[7].w[i] << 48)};
      if (variant == 1) {
        v = zk::mul32(v, unpack(pre[(long)m * NL + l0 + l + i]));
      } else if (variant == 2) {
        v = zk::mul32(zk::mul32(v, unpack(rl[m])), unpack(rl[M + l + i]));
      }
      dst[e + i] = pack(v);
    }
  }
}

// Store phase: shared row j goes to output row rotl(j, 1).
template <int S, int V>
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ out,
                                           const cell* __restrict__ src, long b, long l0, int NL,
                                           int lt_log) {
  constexpr int M = 1 << S;
  const int LT = 1 << lt_log;
  const int groups = (M << lt_log) / V;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int e = g * V;
    const int j = e >> lt_log, l = e & (LT - 1);
    uint32_t* p = out + ((b * M + rotl1<S>(j)) * 8) * NL + l0 + l;
    run<V> limb[8];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const cell c = src[e + i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        limb[k].w[i] = (uint32_t)(c.lo >> (16 * k)) & 0xFFFF;
        limb[4 + k].w[i] = (uint32_t)(c.hi >> (16 * k)) & 0xFFFF;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) *reinterpret_cast<run<V>*>(p + (long)k * NL) = limb[k];
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_stages_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                      const cell* __restrict__ tw, const cell* __restrict__ pre,
                      const uint32_t* __restrict__ rs, const uint32_t* __restrict__ ls, int NL,
                      int lt_log, int variant) {
  constexpr int M = 1 << S;
  constexpr int H = M / 2;
  ZK_DYN_SMEM(cell, buf);
  const int tile = M << lt_log;
  cell* rl = buf + tile;  // variant 2: rs over M rows, then ls over LT lanes
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long b = blockIdx.y;
  const long l0 = (long)blockIdx.x << lt_log;

  if (variant == 2) {
    for (int i = tid; i < M + (1 << lt_log); i += nt) {
      rl[i] = pack(i < M ? zk::load(rs + i, M) : zk::load(ls + l0 + (i - M), NL));
    }
    __syncthreads();
  }
  if (lt_log >= 2) {
    load_tile<S, 4>(y, buf, pre, rl, b, l0, NL, lt_log, variant);
  } else if (lt_log == 1) {
    load_tile<S, 2>(y, buf, pre, rl, b, l0, NL, lt_log, variant);
  } else {
    load_tile<S, 1>(y, buf, pre, rl, b, l0, NL, lt_log, variant);
  }
  __syncthreads();

  // Each thread runs butterflies tid + k * nt (k < kPerThread) of every
  // stage: it reads all its pairs and multiplies (independent carry chains
  // that the scheduler interleaves), waits for the block, and writes the
  // sums and differences in place.
  const int LT = 1 << lt_log;
  const int half = H << lt_log;  // butterflies per stage
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const cell* tws = tw + s * H;
    fe a[kPerThread], bw[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int idx = tid + k * nt;
      if (idx < half) {
        a[k] = unpack(buf[idx]);
        bw[k] = zk::mul32(unpack(buf[idx + half]), unpack(tws[idx >> lt_log]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int idx = tid + k * nt;
      if (idx < half) {
        const int p = idx >> lt_log, l = idx & (LT - 1);
        buf[(rotr1<S>(p) << lt_log) + l] = pack(zk::add32(a[k], bw[k]));
        buf[(rotr1<S>(p + H) << lt_log) + l] = pack(zk::sub32(a[k], bw[k]));
      }
    }
    __syncthreads();
  }

  if (lt_log >= 2) {
    store_tile<S, 4>(out, buf, b, l0, NL, lt_log);
  } else if (lt_log == 1) {
    store_tile<S, 2>(out, buf, b, l0, NL, lt_log);
  } else {
    store_tile<S, 1>(out, buf, b, l0, NL, lt_log);
  }
}

template <int S>
int launch(const uint32_t* y, uint32_t* out, const cell* tw, const cell* pre, const uint32_t* rs,
           const uint32_t* ls, int B, int NL, int variant, void* stream) {
  constexpr int M = 1 << S;
  constexpr int tile = kTile > kLanes * M ? kTile : kLanes * M;
  int lt_log = 0;  // LT = min(tile / M, NL), a power of two
  while ((M << (lt_log + 1)) <= tile && (2 << lt_log) <= NL) ++lt_log;
  const int pairs = (M / 2) << lt_log;
  const int nt = (pairs + kPerThread - 1) / kPerThread;
  if (nt > kMaxThreads) return -1;
  const int cells = (M << lt_log) + (variant == 2 ? M + (1 << lt_log) : 0);
  const size_t smem = (size_t)cells * sizeof(cell);
  auto kernel = ntt_stages_kernel<S>;
  ZK_SET_SMEM(kernel, (int)smem);
  dim3 grid(NL >> lt_log, B);
  ZK_LAUNCH(kernel, grid, dim3(nt), smem, stream, y, out, tw, pre, rs, ls, NL, lt_log, variant);
  return ZK_LAST_ERROR();
}

}  // namespace

// y, out: (B, M, 8, NL) limbs, natural row order; tw: (S, M/2) packed
// elements with S = log2 M (1 <= S <= 9); pre: (M, NL) packed, variant 1;
// rs: (8, M) and ls: (8, NL) limbs, variant 2.  M and NL are powers of two.
// A packed element is the four little-endian 32-bit words of its value.
ZK_EXPORT int zk_ntt_stages(const uint32_t* y, uint32_t* out, const uint32_t* tw,
                            const uint32_t* pre, const uint32_t* rs, const uint32_t* ls,
                            int B, int M, int NL, int S, int variant, void* stream) {
  if (S < 1 || S > 9 || M != (1 << S)) return -1;
  const cell* twc = reinterpret_cast<const cell*>(tw);
  const cell* prec = reinterpret_cast<const cell*>(pre);
#define ZK_K1_CASE(s) \
  case s:             \
    return launch<s>(y, out, twc, prec, rs, ls, B, NL, variant, stream);
  switch (S) {
    ZK_K1_CASE(1)
    ZK_K1_CASE(2)
    ZK_K1_CASE(3)
    ZK_K1_CASE(4)
    ZK_K1_CASE(5)
    ZK_K1_CASE(6)
    ZK_K1_CASE(7)
    ZK_K1_CASE(8)
    ZK_K1_CASE(9)
  }
#undef ZK_K1_CASE
  return -1;
}

// zk::mul32 alone, one element per thread: out[i] = a[i] * b[i] for n
// packed elements.  Not on any path: it checks the multiply on the card
// (and, through the host emulation, on the CPU), and its SASS is the count
// of the multiply's instructions.
extern "C" __global__ void zk_mul32_probe(const cell* __restrict__ a, const cell* __restrict__ b,
                                          cell* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pack(zk::mul32(unpack(a[i]), unpack(b[i])));
}

ZK_EXPORT int zk_mul32(const uint32_t* a, const uint32_t* b, uint32_t* out, int n, void* stream) {
  constexpr int kThreads = 128;
  ZK_LAUNCH(zk_mul32_probe, dim3((n + kThreads - 1) / kThreads), dim3(kThreads), 0, stream,
            reinterpret_cast<const cell*>(a), reinterpret_cast<const cell*>(b),
            reinterpret_cast<cell*>(out), n);
  return ZK_LAST_ERROR();
}
