// The DEEP combination: the weighted column sums and the class quotient,
// each one launch.
//
// Replaces the DEEP's pointwise chains of zkvm/prover/pipeline.py::
// _stage_deep_cls (:616) and _stage_deep, device work that the reference
// leaves to XLA inside one jit (no Pallas).  The port ran them as field-op
// launches: a multiply and a pairwise tree of adds over the columns a
// weight set (a multiply and an add a column from limits.CHUNK_T on), and
// a subtract, a multiply and two adds a quotient; ~7 launches a class and
// 16-56 a DEEP more.
//
// zk_weighted_sum: out[k] = sum_c w[k][c] cols[c] for K weight sets (K
// <= 4) over C columns (C, 8, N).  One thread a lane reads each column's
// element once for all K sets and keeps the K sums in registers; the K C
// weights (at most kMaxWeights) travel by value and are staged once a
// block into shared memory as packed cells.
//
// zk_deep_quotient: y = sum_k (vals[k] - at[k]) inv[k] for K <= 4 rows of
// (K, 8, N) values and inverses and K host values at[k] (by value).  One
// thread a lane.
//
// Both read their inputs through a row (column) stride and a limb stride,
// lanes contiguous, so a block of a resident LDE (mono's row blocks) or a
// row of a stacked tensor is read in place; both write contiguous
// canonical limbs and copy nothing to the card.
//
// What bounds them on an H100: the sum reads C elements and writes K a
// lane (32 bytes each) against K C multiplies and adds (104 32-bit
// operations a pair by the bound's count): at (28, 8, 2^20) and K = 2,
// 0.30 ms of bytes against 0.37 ms of operations.  The quotient reads 2K
// elements and writes one against K (subtract, multiply, add): bytes
// (0.0044 ms against 0.0020 at K = 3 over 2^16 lanes).  Nothing is re-read
// and no partial sum leaves the registers.
#include "f128.cuh"

#ifndef ZK_DEEP_THREADS
#define ZK_DEEP_THREADS 256
#endif

namespace {

using zk::cell;
using zk::fe;

constexpr int kThreads = ZK_DEEP_THREADS;
constexpr int kMaxK = 4;
constexpr int kMaxWeights = 128;  // K C: T-mode's and mono's 2 x 28

struct SumArgs {
  const uint32_t* cols;
  long col_stride, limb_stride;
  uint32_t* out;  // (K, 8, N)
  int K, C;
  long N;
  cell w[kMaxWeights];  // w[k C + c]
};

__global__ void __launch_bounds__(kThreads) weighted_sum_kernel(const SumArgs a) {
  __shared__ cell w[kMaxWeights];
  for (int i = threadIdx.x; i < a.K * a.C; i += kThreads) w[i] = a.w[i];
  __syncthreads();
  const long j = (long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.N) return;
  fe acc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) acc[k] = fe{0, 0};
  for (int c = 0; c < a.C; ++c) {
    const fe x = zk::load(a.cols + c * a.col_stride + j, a.limb_stride);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) acc[k] = zk::add32(acc[k], zk::mul32(x, zk::unpack(w[k * a.C + c])));
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < a.K) zk::store(a.out + k * 8 * a.N + j, a.N, acc[k]);
}

struct QuotientArgs {
  const uint32_t* vals;
  long vals_row, vals_limb;
  const uint32_t* inv;
  long inv_row, inv_limb;
  uint32_t* out;  // (8, N)
  int K;
  long N;
  cell at[kMaxK];
};

__global__ void __launch_bounds__(kThreads) deep_quotient_kernel(const QuotientArgs a) {
  const long j = (long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.N) return;
  fe y{0, 0};
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= a.K) break;
    const fe v = zk::load(a.vals + k * a.vals_row + j, a.vals_limb);
    const fe i = zk::load(a.inv + k * a.inv_row + j, a.inv_limb);
    y = zk::add32(y, zk::mul32(zk::sub32(v, zk::unpack(a.at[k])), i));
  }
  zk::store(a.out + j, a.N, y);
}

long blocks(long n) { return (n + kThreads - 1) / kThreads; }

cell cell_of(const uint32_t* w) { return cell{(uint64_t)w[1] << 32 | w[0], (uint64_t)w[3] << 32 | w[2]}; }

}  // namespace

// out (K, 8, N) contiguous = sum_c w[k][c] cols[c]; cols: C columns at
// col_stride apart, limbs limb_stride apart, lanes contiguous; weights: a
// host array of K C elements (k major), each its four 32-bit words least
// significant first.  -1 with no launch for K outside 1..4, C < 1, K C above
// 128 or N < 1.  One launch on the stream.
ZK_EXPORT int zk_weighted_sum(const uint32_t* cols, long col_stride, long limb_stride, const uint32_t* weights,
                              uint32_t* out, int K, int C, long N, void* stream) {
  if (K < 1 || K > kMaxK || C < 1 || K * C > kMaxWeights || N < 1 || blocks(N) > 0x7fffffffL) return -1;
  SumArgs a{cols, col_stride, limb_stride, out, K, C, N, {}};
  for (int i = 0; i < K * C; ++i) a.w[i] = cell_of(weights + 4 * i);
  ZK_LAUNCH(weighted_sum_kernel, dim3((unsigned)blocks(N)), dim3(kThreads), 0, stream, a);
  return ZK_LAST_ERROR();
}

// out (8, N) contiguous = sum_k (vals[k] - at[k]) inv[k]; vals and inv: K
// rows at their row strides, limbs at their limb strides, lanes
// contiguous; at: a host array of K elements as four 32-bit words each.
// -1 with no launch for K outside 1..4 or N < 1.  One launch on the
// stream.
ZK_EXPORT int zk_deep_quotient(const uint32_t* vals, long vals_row, long vals_limb, const uint32_t* inv,
                               long inv_row, long inv_limb, const uint32_t* at, uint32_t* out, int K, long N,
                               void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || blocks(N) > 0x7fffffffL) return -1;
  QuotientArgs a{vals, vals_row, vals_limb, inv, inv_row, inv_limb, out, K, N, {}};
  for (int k = 0; k < K; ++k) a.at[k] = cell_of(at + 4 * k);
  ZK_LAUNCH(deep_quotient_kernel, dim3((unsigned)blocks(N)), dim3(kThreads), 0, stream, a);
  return ZK_LAST_ERROR();
}
