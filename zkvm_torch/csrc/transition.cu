// K4: the merged transition value over a domain, two threads per row.
//
// Replaces the TPU kernel zkvm/air/constraints_pallas.py::
// merged_transition_pallas (:378; kernel _kernel :369, body
// merged_transition_t :74), reached through merged_transition_via_pallas
// (:456, the full-LDE prover) and merged_transition_pallas_pair (:418, one
// blowup class).  For row n of N rows:
//
//   out[n] = sum_k alpha_k * gate_k * C_k at row n, next row (n + step) mod N,
//            periodic columns at phase n mod P
//
// The TPU kernel takes a materialised next-row array and (8, D) / (8, 8, D)
// periodic arrays.  Here the next row is read in place at (n + step) mod N
// (step = blowup over the full domain, 1 within a class), and the periodic
// values come from tables of length P (16 * blowup over the full domain,
// 16 for a class): at D = 2^19 that saves reading a rolled copy of the
// LDE (470 MB) and a tiled round-constant array (134 MB).
//
// What bounds it on an H100: the ~106 128-bit modular multiplies a row
// (transition.cuh, shared with K3) and the registers their carry chains
// hold, against ~1 KB of limbs read per row.  Each block stages the
// alphas, the two matrices and the periodic table (9 P elements, 18 KB at
// P = 128) into shared memory, packed 16 bytes an element, so every read
// of a constant is one 16-byte shared load; delta comes by value.
//
// As in K3, a block's first 4 warps run part A of the body for its 128
// rows and its last 4 part B, meeting in shared memory, so each thread
// holds half the live state; at a cap of 80 registers (3 blocks of 256 per
// SM, 24 warps) ptxas spills ~30 words, and kernel_bench.py --sweep found
// that shape ~20% faster at D = 2^19 than the best one with one thread a
// row (128 registers, 16 warps).
#include "transition.cuh"

using zk::cell;

constexpr int kMaxPeriod = 1024;  // 9 * 1024 packed elements: 144 KB of shared memory
// The launch shape: threads per block, the blocks per SM that
// __launch_bounds__ asks ptxas to fit (so its register cap), and threads
// per row (1, or 2: part A in the block's first half of warps, part B in
// the second).  Other values are for timing the shapes only
// (kernel_bench.py --sweep builds them).
#ifndef ZK_AIR_THREADS
#define ZK_AIR_THREADS 256
#endif
#ifndef ZK_AIR_MIN_BLOCKS
#define ZK_AIR_MIN_BLOCKS 3
#endif
#ifndef ZK_AIR_SPLIT
#define ZK_AIR_SPLIT 2
#endif
constexpr int kThreads = ZK_AIR_THREADS, kSplit = ZK_AIR_SPLIT;
constexpr int kRows = kThreads / kSplit;  // rows per block
static_assert(kSplit == 1 || (kSplit == 2 && kRows % 32 == 0), "the halves are whole warps");

struct TransArgs {
  const uint32_t* lde;    // (28, 8, N)
  const uint32_t* mask;   // (8, P) table
  const uint32_t* ark;    // (8, 8, P) tables
  const uint32_t* mds;    // (32, 8): MDS then inverse MDS, limbs last
  const uint32_t* alphas; // (20, 8)
  zk::fe delta;
  uint32_t* out;          // (8, N)
  long N;
  int P;
  long step;              // 0 < step < N
};

__global__ void __launch_bounds__(kThreads, ZK_AIR_MIN_BLOCKS) transition_kernel(TransArgs a) {
  __shared__ zk::AirConsts k;
  ZK_DYN_SMEM(cell, tab);  // (9, P)
  const int tid = threadIdx.x;
  zk::stage_consts(&k, a.alphas, a.mds, tid, kThreads);
  zk::stage_table(tab, a.mask, a.ark, a.P, tid, kThreads);
  __syncthreads();

  const long N = a.N;
  const int r = tid % kRows;
  const long n = (long)blockIdx.x * kRows + r;
  const long nn = (n + a.step < N) ? n + a.step : n + a.step - N;
  auto cur = [&](int c) { return zk::load(a.lde + (long)c * 8 * N + n, N); };
  auto nxt = [&](int c) { return zk::load(a.lde + (long)c * 8 * N + nn, N); };
  const cell* per = tab + n % a.P;
  zk::fe q, b[5], f_push;
  if (kSplit == 1) {
    if (n >= N) return;
    zk::decoder_bits(cur, b);
    const zk::fe op = zk::opcode(b);
    q = zk::transition_a(cur, nxt, b, k, a.delta, f_push);
    zk::phase();
    q = zk::add32(q, zk::transition_b(cur, nxt, op, f_push, k, per, a.P));
  } else {
    // part B's warps leave their value for part A's
    __shared__ cell part[kSplit == 2 ? kRows : 1];
    if (n < N) zk::decoder_bits(cur, b);
    if (tid >= kRows && n < N)
      part[r] = zk::pack(zk::transition_b(cur, nxt, zk::opcode(b), zk::push_selector(b), k, per, a.P));
    else if (n < N)
      q = zk::transition_a(cur, nxt, b, k, a.delta, f_push);
    __syncthreads();
    if (tid >= kRows || n >= N) return;
    q = zk::add32(q, zk::unpack(part[r]));
  }
  zk::store(a.out + n, N, q);
}

// delta = delta_hi * 2^64 + delta_lo; P divides N, P <= kMaxPeriod.
ZK_EXPORT int zk_transition(const uint32_t* lde, const uint32_t* mask, const uint32_t* ark,
                            const uint32_t* mds, const uint32_t* alphas, uint64_t delta_lo,
                            uint64_t delta_hi, uint32_t* out, long N, long P, long step,
                            void* stream) {
  if (P < 1 || P > kMaxPeriod || N % P != 0 || step <= 0 || step >= N) return -1;
  TransArgs a{lde, mask, ark, mds, alphas, zk::fe{delta_lo, delta_hi}, out, N, (int)P, step};
  const size_t smem = (size_t)9 * P * sizeof(cell);
  ZK_SET_SMEM(transition_kernel, (int)smem);
  const long blocks = (N + kRows - 1) / kRows;
  ZK_LAUNCH(transition_kernel, dim3((unsigned)blocks), dim3(kThreads), smem, stream, a);
  return ZK_LAST_ERROR();
}
