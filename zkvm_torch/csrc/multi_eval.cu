// Multi-point evaluation: rows[q][c] = sum_t coeffs[c][t] * pt_q^t mod p,
// the C committed column polynomials at Q points
// (zkvm_torch/prover/multi_eval.py).  The points come as the two factors
// of their power ladders, pt_q^t = l1[q][t mod S] * l2[q][t div S]
// (ntt_t.ladders_split: S and T / S about sqrt T).
//
// Replaces zkvm/prover/eval_mxu.py::_contract (:45) and multi_eval_rows
// (:80), device work the reference left to XLA (no Pallas): it builds the
// (Q, 8, T) ladders, splits every element into 32 nibbles, runs the
// (C 32, T) x (T, Q 32) product as one int8 dot_general, sums the 63
// anti-diagonal buckets on the device, and recombines
// sum_k bucket_k 16^k mod p on the host.  The provers call it four times a
// proof: the OOD frame (28 trace columns at z and z g, the 8 composition
// columns at z^8) and the query rows (28 and 8 columns at up to 32 points).
//
// Here it is a direct field dot product on zk::mul32 / zk::add32
// (csrc/f128.cuh, the arithmetic of K1-K4 and the field ops), so the
// output is already a canonical element: no nibbles, no buckets, no host
// recombination, and no (Q, 8, T) ladder in device memory (1 GiB at
// Q = 32, T = 2^20, and as much again for the copy that joins it).
// Launch 1 splits the work three ways to fill the card at the OOD's 56 or
// 8 (c, q) pairs as well as the queries' 896: a block takes a tile of kCT
// columns x QT points (QT = 1, 2 or 4, by Q) and one slice of t; each
// thread keeps the tile's kCT QT sums in registers, walking its slice's t
// by the block's width (neighbouring threads on neighbouring t, so every
// limb load is coalesced).  A thread makes each point's pt^t from the two
// factors, one multiply (their O(sqrt T) rows stay in L1 and L2), loads
// each column's element once, and adds the tile's kCT QT products.  The
// block adds its threads' sums by a tree in shared memory (no warp
// shuffles or atomics, so the host emulation runs it as it is) and writes
// one partial sum a pair of its tile and slice.  Launch 2, a warp a pair,
// adds the slices' partials by the same tree and writes the canonical
// limbs (Q, C, 8).  The tiles of one slice are neighbours in the grid, so
// they run together and read the slice's columns from L2.  Index
// arithmetic is 64-bit; T is any length >= 1 up to S x (T / S) (16 in the
// CPU tests, 2^20 on the 2^20-row path).
//
// What bounds it on an H100: operations.  The same work done as the
// reference does it, a nibble product on the int8 tensor cores, is
// 2 (32 C)(32 Q) T operations at 1,979 T/s, against (C + Q) T 32 bytes at
// 3.35 TB/s: 0.97 ms against 0.60 at C = 28, Q = 32, T = 2^20.  This
// direct dot does C Q T (96 + 8) 32-bit operations by the bound's count
// (16.73 T/s: 5.84 ms there), and a multiply more a point and t for each
// column tile (C / kCT of them: 25% more at kCT = 4); each tile re-reads
// its kCT columns from L2.  The tensor-core nibble contraction is the
// later redesign.
#include "f128.cuh"

// threads a block (a power of two) and the blocks (tiles x slices) a
// launch aims at; other values are for the tests' emulation and for
// timing other shapes
#ifndef ZK_MEVAL_THREADS
#define ZK_MEVAL_THREADS 128
#endif
#ifndef ZK_MEVAL_BLOCKS
#define ZK_MEVAL_BLOCKS 4096
#endif

namespace {

constexpr int kThreads = ZK_MEVAL_THREADS;
constexpr long kBlocks = ZK_MEVAL_BLOCKS;
constexpr int kSumThreads = kThreads < 32 ? kThreads : 32;  // launch 2's block: a warp
constexpr int kCT = 4;    // columns a tile
constexpr int kQMax = 4;  // points a tile, at most
static_assert(kThreads >= 1 && (kThreads & (kThreads - 1)) == 0, "the block's tree needs a power of two");
static_assert(kBlocks >= 1 && kBlocks <= 65535, "slices go on the grid's y axis");

// the launch's shape for C columns, Q points and T coefficients
struct Plan {
  int qt;             // points a tile: 1, 2 or 4
  long tiles_c;       // tiles along the columns
  long tiles;         // tiles in all
  long slices, span;  // slices of t, and the t of each (the last fewer)
};

Plan plan(int c, int q, long t) {
  Plan p{};
  p.qt = q >= 3 ? kQMax : q;
  p.tiles_c = (c + kCT - 1) / kCT;
  p.tiles = p.tiles_c * ((q + p.qt - 1) / p.qt);
  long s = kBlocks / p.tiles;
  const long most = (t + kThreads - 1) / kThreads;  // each slice at least a block's width
  s = s < 1 ? 1 : (s > most ? most : s);
  p.span = ((t + s - 1) / s + kThreads - 1) / kThreads * kThreads;
  p.slices = (t + p.span - 1) / p.span;
  return p;
}

// the N sums of each of a block's W threads, red[k][thread], added by a
// tree into red[k][0]
template <int N, int W>
__device__ __forceinline__ void block_sum(zk::cell (*red)[W], int tid) {
  __syncthreads();
  for (int half = W / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        red[k][tid] = zk::pack(zk::add32(zk::unpack(red[k][tid]), zk::unpack(red[k][tid + half])));
    }
    __syncthreads();
  }
}

// launch 1: block (tile, slice) -> work[slice][q][c], the partial sums of
// the tile's pairs over the slice's t
template <int QT>
__global__ void __launch_bounds__(kThreads)
meval_partial_kernel(const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ l1,
                     const uint32_t* __restrict__ l2, zk::cell* __restrict__ work, int C, int Q, long T, long S,
                     int log_s, long N2, long span, long tiles_c) {
  __shared__ zk::cell red[kCT * QT][kThreads];
  const int tid = threadIdx.x;
  const int c0 = (int)(blockIdx.x % tiles_c) * kCT, q0 = (int)(blockIdx.x / tiles_c) * QT;
  const long slice = blockIdx.y;
  const long t0 = slice * span, t1 = t0 + span < T ? t0 + span : T;
  // a tile's columns and points past C or Q read the last one's (their
  // sums are never written)
  const uint32_t* cp[kCT];
  const uint32_t* f1[QT];
  const uint32_t* f2[QT];
#pragma unroll
  for (int i = 0; i < kCT; ++i) cp[i] = coeffs + (long)(c0 + i < C ? c0 + i : C - 1) * 8 * T;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const long q = q0 + j < Q ? q0 + j : Q - 1;
    f1[j] = l1 + q * 8 * S;
    f2[j] = l2 + q * 8 * N2;
  }
  zk::fe acc[kCT][QT];
#pragma unroll
  for (int i = 0; i < kCT; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[i][j] = zk::fe{0, 0};
  for (long t = t0 + tid; t < t1; t += kThreads) {
    const long lo = t & (S - 1), hi = t >> log_s;
    zk::fe y[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) y[j] = zk::mul32(zk::load(f1[j] + lo, S), zk::load(f2[j] + hi, N2));
#pragma unroll
    for (int i = 0; i < kCT; ++i) {
      const zk::fe x = zk::load(cp[i] + t, T);
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[i][j] = zk::add32(acc[i][j], zk::mul32(x, y[j]));
    }
  }
#pragma unroll
  for (int i = 0; i < kCT; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) red[i * QT + j][tid] = zk::pack(acc[i][j]);
  block_sum<kCT * QT, kThreads>(red, tid);
  for (int k = tid; k < kCT * QT; k += kThreads) {
    const int c = c0 + k / QT, q = q0 + k % QT;
    if (c < C && q < Q) work[(slice * Q + q) * C + c] = red[k][0];
  }
}

// launch 2: block p (pair q C + c) -> out[p] (8 limbs), the sum of the
// pair's partials over the slices
__global__ void __launch_bounds__(kSumThreads)
meval_sum_kernel(const zk::cell* __restrict__ work, uint32_t* __restrict__ out, long pairs, long slices) {
  __shared__ zk::cell red[1][kSumThreads];
  const int tid = threadIdx.x;
  const long p = blockIdx.x;
  zk::fe acc{0, 0};
  for (long s = tid; s < slices; s += kSumThreads) acc = zk::add32(acc, zk::unpack(work[s * pairs + p]));
  red[0][tid] = zk::pack(acc);
  block_sum<1, kSumThreads>(red, tid);
  if (tid == 0) zk::store(out + 8 * p, 1, zk::unpack(red[0][0]));
}

}  // namespace

// The slices of t that zk_multi_eval splits C columns and Q points over:
// its work buffer holds slices x Q x C packed elements (16 bytes each).
// 0 for sizes below 1.
ZK_EXPORT int zk_multi_eval_slices(int C, int Q, long T) {
  if (C < 1 || Q < 1 || T < 1) return 0;
  return (int)plan(C, Q, T).slices;
}

// coeffs (C, 8, T) limbs; the ladder factors l1 (Q, 8, S), S a power of
// two, and l2 (Q, 8, N2), S N2 >= T; all contiguous; work of work_slices x
// Q x C packed elements, work_slices at least what zk_multi_eval_slices
// says; out (Q, C, 8) canonical limbs.  Anything else returns -1 with no
// launch.  Two launches on the stream, no allocation, no synchronisation.
ZK_EXPORT int zk_multi_eval(const uint32_t* coeffs, const uint32_t* l1, const uint32_t* l2, zk::cell* work,
                            long work_slices, uint32_t* out, int C, int Q, long T, long S, long N2,
                            void* stream) {
  if (C < 1 || Q < 1 || T < 1 || S < 1 || (S & (S - 1)) || N2 < 1 || S * N2 < T) return -1;
  const Plan p = plan(C, Q, T);
  if (work_slices < p.slices) return -1;
  const int log_s = __builtin_ctzl(S);
  const dim3 grid((unsigned)p.tiles, (unsigned)p.slices), block(kThreads);
  if (p.qt == 1) {
    ZK_LAUNCH(meval_partial_kernel<1>, grid, block, 0, stream, coeffs, l1, l2, work, C, Q, T, S, log_s, N2,
              p.span, p.tiles_c);
  } else if (p.qt == 2) {
    ZK_LAUNCH(meval_partial_kernel<2>, grid, block, 0, stream, coeffs, l1, l2, work, C, Q, T, S, log_s, N2,
              p.span, p.tiles_c);
  } else {
    ZK_LAUNCH(meval_partial_kernel<kQMax>, grid, block, 0, stream, coeffs, l1, l2, work, C, Q, T, S, log_s, N2,
              p.span, p.tiles_c);
  }
  const int rc = ZK_LAST_ERROR();
  if (rc != 0) return rc;
  const long pairs = (long)C * Q;
  ZK_LAUNCH(meval_sum_kernel, dim3((unsigned)pairs), dim3(kSumThreads), 0, stream, work, out, pairs, p.slices);
  return ZK_LAST_ERROR();
}
