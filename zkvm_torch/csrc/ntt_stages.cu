// K1: the constant-geometry (Pease) NTT stage network along axis M.
//
// Replaces the TPU kernel zkvm/ntt/ntt_t.py::_pallas_stages (:320; kernels
// _stages_kernel, _stages_kernel_full, _stages_kernel_r1, body
// _stages_in_kernel) together with the two layout gathers around it
// (ntt_t.py::_axis_ntt): y and out are (B1, B2, M, 8, NL) 16-bit limbs in
// natural row order, each read and written through its own element
// strides, so every pass of the four-step transform is a strided view of
// one buffer and nothing copies between passes.  Shared-memory row m is
// loaded from input row bitrev(rotl(m, 1)); all log2 M radix-2 stages run,
// each pairing rows p and p + M/2 (twiddle tw[s][p]) and writing the sum and
// difference to rows rotr(p, 1) and rotr(p + M/2, 1); shared row j is
// stored to output row rotl(j, 1).  Variant 1 first multiplies by a full
// tensor read through its own cell strides (by row and lane: the
// four-step's mid twiddles; by row and batch: a recursing pass's), variant
// 2 by the rank-1 tensor rs(8, M) x ls(8, NL) (a coset shift); both are
// indexed by the shared (permuted) row.
//
// What bounds it on an H100: by the count, 32-bit integer operations, most
// of them in the 128-bit modular multiplies (zk::mul32: 16 32 x 32-bit
// products and two folds by eps, as PTX carry chains); as measured, also
// the device-memory accesses.  The design keeps one block's M x LT tile
// (16 bytes an element) in shared memory, updated in place, so device
// memory is read and written once per call whatever M is; the premultiply
// is applied while loading.  A tile holds max(2048, 8 M) elements, so LT >=
// 8 where NL allows.  Each side walks its tile along whichever of its axes
// is unit-stride in device memory: along lanes, runs of V consecutive lanes
// of one (row, limb); along rows, runs of V consecutive rows of one (lane,
// limb), the low bits of the thread index walking 8 lanes and then the
// runs of one 32-byte sector, so a warp reads or writes every sector whole
// and the 8 threads of a quarter-warp touch 8 lanes of one shared row set
// (distinct banks).  A walk along rows is a transpose through shared
// memory.  V is 4 (16-byte accesses) where the pointer and strides allow,
// else 2 or 1.  An address is a 64-bit base a block (its batch and first
// lane) plus a 32-bit offset inside the tile: with 64-bit strided offsets
// K1 took 1.5 times as long at M = 256 and 512 (H100, 700 W), and the entry
// refuses a block that spans 2^31 elements.  Each thread runs 4
// butterflies per stage, whose multiplies are independent chains.  The
// kernel is a template on S = log2 M, and LT is a power of two, so every
// tile index is a shift or a mask.  The stage
// twiddles and the full premultiplier come packed (16 bytes an element,
// built once per size and cached by the wrapper) and are read with one
// 16-byte load; rs and ls are packed into shared memory once per block.
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

// the axes of an operand's strides
enum { kB1 = 0, kB2 = 1, kRow = 2, kLimb = 3, kLane = 4, kPreLane = 3 };

// One call's geometry: the element strides of y and out over (b1, b2, row,
// limb, lane), the premultiplier's cell strides over (b1, b2, row, lane),
// each side's walk (1: along rows, whose stride is 1; 0: along lanes,
// whose stride is 1) and access run V, the lanes and the tile's lanes.
struct Geo {
  long ys[5], os[5], ps[4];
  int in_rows, out_rows, vin, vout;
  int NL, lt_log, variant;
};

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

template <int V>
ZK_HD constexpr int log2v() {
  return V == 4 ? 2 : V == 2 ? 1 : 0;
}

// Thread group t of a walk along rows -> (lane l, run r of V rows): the
// low bits of t take the low 3 bits of the lane (all of LT where LT < 8),
// the next bits the runs of one 32-byte sector, then the rest of the lanes
// and of the runs.
template <int S, int V>
ZK_HD void row_run(int t, int lt_log, int& l, int& r) {
  constexpr int runs_log = S - log2v<V>();
  constexpr int sector_log = 3 - log2v<V>();  // runs of V limbs in 8
  constexpr int rb = sector_log < runs_log ? sector_log : runs_log;
  const int lb = lt_log < 3 ? lt_log : 3;
  l = t & ((1 << lb) - 1);
  t >>= lb;
  r = t & ((1 << rb) - 1);
  t >>= rb;
  l |= (t & ((1 << (lt_log - lb)) - 1)) << lb;
  r |= (t >> (lt_log - lb)) << rb;
}

// limb k of V elements -> element i
template <int V>
ZK_HD fe join_limbs(const run<V> (&limb)[8], int i) {
  return fe{(uint64_t)limb[0].w[i] | ((uint64_t)limb[1].w[i] << 16) | ((uint64_t)limb[2].w[i] << 32) |
                ((uint64_t)limb[3].w[i] << 48),
            (uint64_t)limb[4].w[i] | ((uint64_t)limb[5].w[i] << 16) | ((uint64_t)limb[6].w[i] << 32) |
                ((uint64_t)limb[7].w[i] << 48)};
}

template <int V>
ZK_HD void split_limbs(run<V> (&limb)[8], int i, cell c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    limb[k].w[i] = (uint32_t)(c.lo >> (16 * k)) & 0xFFFF;
    limb[4 + k].w[i] = (uint32_t)(c.hi >> (16 * k)) & 0xFFFF;
  }
}

// Load phase, V elements a thread group: tile element m * LT + l (shared
// row m, lane l) holds input row bitrev(rotl(m, 1)), premultiplied.
template <int S, int V, bool ROWS>
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ y, const Geo& g,
                                          cell* __restrict__ dst, const cell* __restrict__ pre,
                                          const cell* __restrict__ rl, long b1, long b2, long l0) {
  constexpr int M = 1 << S;
  if constexpr (!ROWS || V <= M) {
    const int lt_log = g.lt_log, LT = 1 << lt_log;
    // 64-bit bases at the block's batch and first lane; offsets inside the
    // tile fit 32 bits (the entry checks it)
    const uint32_t* base = y + b1 * g.ys[kB1] + b2 * g.ys[kB2] + l0 * g.ys[kLane];
    const cell* pb = pre + b1 * g.ps[kB1] + b2 * g.ps[kB2] + l0 * g.ps[kPreLane];
    const int s_row = (int)g.ys[kRow], s_limb = (int)g.ys[kLimb], s_lane = (int)g.ys[kLane];
    const int p_row = (int)g.ps[kRow], p_lane = (int)g.ps[kPreLane];
    const int groups = (M << lt_log) / V;
    for (int t = threadIdx.x; t < groups; t += blockDim.x) {
      // ROWS: input rows r0 + i of lane `lane`; else input row of shared
      // row r0, lanes lane + i
      int r0, lane, off;
      if constexpr (ROWS) {
        int r;
        row_run<S, V>(t, lt_log, lane, r);
        r0 = r * V;
        off = r0 + lane * s_lane;
      } else {
        const int e = t * V;
        r0 = e >> lt_log;
        lane = e & (LT - 1);
        off = bitrev<S>(rotl1<S>(r0)) * s_row + lane;
      }
      const uint32_t* p = base + off;
      run<V> limb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) limb[k] = *reinterpret_cast<const run<V>*>(p + k * s_limb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int m = ROWS ? rotr1<S>(bitrev<S>(r0 + i)) : r0;
        const int l = ROWS ? lane : lane + i;
        fe v = join_limbs<V>(limb, i);
        if (g.variant == 1) {
          v = zk::mul32(v, unpack(pb[m * p_row + l * p_lane]));
        } else if (g.variant == 2) {
          v = zk::mul32(zk::mul32(v, unpack(rl[m])), unpack(rl[M + l]));
        }
        dst[(m << lt_log) + l] = pack(v);
      }
    }
  }
}

// Store phase: shared row j goes to output row rotl(j, 1).
template <int S, int V, bool ROWS>
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ out, const Geo& g,
                                           const cell* __restrict__ src, long b1, long b2, long l0) {
  constexpr int M = 1 << S;
  if constexpr (!ROWS || V <= M) {
    const int lt_log = g.lt_log, LT = 1 << lt_log;
    uint32_t* base = out + b1 * g.os[kB1] + b2 * g.os[kB2] + l0 * g.os[kLane];
    const int s_row = (int)g.os[kRow], s_limb = (int)g.os[kLimb], s_lane = (int)g.os[kLane];
    const int groups = (M << lt_log) / V;
    for (int t = threadIdx.x; t < groups; t += blockDim.x) {
      run<V> limb[8];
      int off;
      if constexpr (ROWS) {
        int lane, r;
        row_run<S, V>(t, lt_log, lane, r);
        off = r * V + lane * s_lane;
#pragma unroll
        for (int i = 0; i < V; ++i) split_limbs<V>(limb, i, src[(rotr1<S>(r * V + i) << lt_log) + lane]);
      } else {
        const int e = t * V;
        const int j = e >> lt_log, lane = e & (LT - 1);
        off = rotl1<S>(j) * s_row + lane;
#pragma unroll
        for (int i = 0; i < V; ++i) split_limbs<V>(limb, i, src[e + i]);
      }
      uint32_t* p = base + off;
#pragma unroll
      for (int k = 0; k < 8; ++k) *reinterpret_cast<run<V>*>(p + k * s_limb) = limb[k];
    }
  }
}

template <int S, bool ROWS>
__device__ __forceinline__ void load_any(const uint32_t* y, const Geo& g, cell* dst, const cell* pre,
                                         const cell* rl, long b1, long b2, long l0) {
  if (g.vin == 4) {
    load_tile<S, 4, ROWS>(y, g, dst, pre, rl, b1, b2, l0);
  } else if (g.vin == 2) {
    load_tile<S, 2, ROWS>(y, g, dst, pre, rl, b1, b2, l0);
  } else {
    load_tile<S, 1, ROWS>(y, g, dst, pre, rl, b1, b2, l0);
  }
}

template <int S, bool ROWS>
__device__ __forceinline__ void store_any(uint32_t* out, const Geo& g, const cell* src, long b1, long b2,
                                          long l0) {
  if (g.vout == 4) {
    store_tile<S, 4, ROWS>(out, g, src, b1, b2, l0);
  } else if (g.vout == 2) {
    store_tile<S, 2, ROWS>(out, g, src, b1, b2, l0);
  } else {
    store_tile<S, 1, ROWS>(out, g, src, b1, b2, l0);
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_stages_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                      const cell* __restrict__ tw, const cell* __restrict__ pre,
                      const uint32_t* __restrict__ rs, const uint32_t* __restrict__ ls, const Geo g) {
  constexpr int M = 1 << S;
  constexpr int H = M / 2;
  ZK_DYN_SMEM(cell, buf);
  const int lt_log = g.lt_log;
  const int tile = M << lt_log;
  cell* rl = buf + tile;  // variant 2: rs over M rows, then ls over LT lanes
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long b1 = blockIdx.y, b2 = blockIdx.z;
  const long l0 = (long)blockIdx.x << lt_log;

  if (g.variant == 2) {
    for (int i = tid; i < M + (1 << lt_log); i += nt) {
      rl[i] = pack(i < M ? zk::load(rs + i, M) : zk::load(ls + l0 + (i - M), g.NL));
    }
    __syncthreads();
  }
  if (g.in_rows) {
    load_any<S, true>(y, g, buf, pre, rl, b1, b2, l0);
  } else {
    load_any<S, false>(y, g, buf, pre, rl, b1, b2, l0);
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

  if (g.out_rows) {
    store_any<S, true>(out, g, buf, b1, b2, l0);
  } else {
    store_any<S, false>(out, g, buf, b1, b2, l0);
  }
}

// The widest access run, 4, 2 or 1 elements, that keeps a side's accesses
// aligned: its pointer on a 4V-byte boundary, every stride but the walked
// one a multiple of V, and V no longer than the walked extent (M along
// rows, the tile's LT lanes along lanes).
int run_width(const void* p, const long* s, int rows, int M, int LT) {
  const int walked = rows ? M : LT;
  for (int v = 4; v > 1; v /= 2) {
    bool ok = v <= walked && (reinterpret_cast<uintptr_t>(p) % (4 * v)) == 0;
    for (int i = 0; i < 5; ++i) ok = ok && (i == (rows ? kRow : kLane) || s[i] % v == 0);
    if (ok) return v;
  }
  return 1;
}

template <int S>
int launch(const uint32_t* y, uint32_t* out, const cell* tw, const cell* pre, const uint32_t* rs,
           const uint32_t* ls, Geo g, int B1, int B2, void* stream) {
  constexpr int M = 1 << S;
  constexpr int tile = kTile > kLanes * M ? kTile : kLanes * M;
  int lt_log = 0;  // LT = min(tile / M, NL), a power of two
  while ((M << (lt_log + 1)) <= tile && (2 << lt_log) <= g.NL) ++lt_log;
  g.lt_log = lt_log;
  g.vin = run_width(y, g.ys, g.in_rows, M, 1 << lt_log);
  g.vout = run_width(out, g.os, g.out_rows, M, 1 << lt_log);
  const int pairs = (M / 2) << lt_log;
  const int nt = (pairs + kPerThread - 1) / kPerThread;
  if (nt > kMaxThreads) return -1;
  const int cells = (M << lt_log) + (g.variant == 2 ? M + (1 << lt_log) : 0);
  const size_t smem = (size_t)cells * sizeof(cell);
  auto kernel = ntt_stages_kernel<S>;
  ZK_SET_SMEM(kernel, (int)smem);
  dim3 grid(g.NL >> lt_log, B1, B2);
  ZK_LAUNCH(kernel, grid, dim3(nt), smem, stream, y, out, tw, pre, rs, ls, g);
  return ZK_LAST_ERROR();
}

}  // namespace

// y, out: (B1, B2, M, 8, NL) limbs, natural row order, read and written
// through ys and os, their element strides over (b1, b2, row, limb, lane);
// walks: bit 0 set where the load walks rows (ys's row stride 1), else it
// walks lanes (lane stride 1), bit 1 the same for the store.  tw: (S, M/2)
// packed elements with S = log2 M (1 <= S <= 9); pre: variant 1's packed
// elements at the cell strides ps over (b1, b2, row, lane); rs: (8, M) and
// ls: (8, NL) limbs, variant 2.  M and NL are powers of two, B1 and B2 at
// most 65535, and one batch's (M, 8, NL) block of y or out, or its (M, NL)
// block of pre, spans fewer than 2^31 elements.  A packed element is the four little-endian 32-bit words of
// its value.
ZK_EXPORT int zk_ntt_stages(const uint32_t* y, const long* ys, uint32_t* out, const long* os, const uint32_t* tw,
                            const uint32_t* pre, const long* ps, const uint32_t* rs, const uint32_t* ls, int B1,
                            int B2, int M, int NL, int S, int variant, int walks, void* stream) {
  if (S < 1 || S > 9 || M != (1 << S) || NL < 1 || (NL & (NL - 1)) || B1 < 1 || B2 < 1 || B1 > 65535 ||
      B2 > 65535 || variant < 0 || variant > 2) {
    return -1;
  }
  Geo g{};
  for (int i = 0; i < 5; ++i) {
    g.ys[i] = ys[i];
    g.os[i] = os[i];
  }
  for (int i = 0; i < 4; ++i) g.ps[i] = variant == 1 ? ps[i] : 0;
  g.in_rows = walks & 1;
  g.out_rows = (walks >> 1) & 1;
  if (g.ys[g.in_rows ? kRow : kLane] != 1 || g.os[g.out_rows ? kRow : kLane] != 1) return -1;
  // the kernel's offsets inside a tile are 32-bit: the farthest element of
  // a batch's (M, 8, NL) block, and of the premultiplier's, from its start
  const long span_y = (M - 1) * ys[kRow] + 7 * ys[kLimb] + (long)(NL - 1) * ys[kLane];
  const long span_o = (M - 1) * os[kRow] + 7 * os[kLimb] + (long)(NL - 1) * os[kLane];
  const long span_p = (M - 1) * g.ps[kRow] + (long)(NL - 1) * g.ps[kPreLane];
  if (span_y >= (1L << 31) || span_o >= (1L << 31) || span_p >= (1L << 31)) return -1;
  g.NL = NL;
  g.variant = variant;
  const cell* twc = reinterpret_cast<const cell*>(tw);
  const cell* prec = reinterpret_cast<const cell*>(pre);
#define ZK_K1_CASE(s) \
  case s:             \
    return launch<s>(y, out, twc, prec, rs, ls, g, B1, B2, stream);
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

// zk::sqr32 alone, as zk_mul32 checks zk::mul32: out[i] = a[i]^2.
extern "C" __global__ void zk_sqr32_probe(const cell* __restrict__ a, cell* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pack(zk::sqr32(unpack(a[i])));
}

ZK_EXPORT int zk_sqr32(const uint32_t* a, uint32_t* out, int n, void* stream) {
  constexpr int kThreads = 128;
  ZK_LAUNCH(zk_sqr32_probe, dim3((n + kThreads - 1) / kThreads), dim3(kThreads), 0, stream,
            reinterpret_cast<const cell*>(a), reinterpret_cast<cell*>(out), n);
  return ZK_LAST_ERROR();
}
