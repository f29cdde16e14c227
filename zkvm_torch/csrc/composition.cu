// K3: the per-class composition value, two threads per row.
//
// Replaces the TPU kernel zkvm/air/constraints_pallas.py::
// _composition_pallas_call (:230; kernel _composition_kernel :210, body
// composition_body_t :174 -> merged_transition_t :74).  For row n of one
// blowup class (T rows; the next row is (n + 1) mod T, cyclic within the
// class):
//
//   q = (sum_k alpha_k * gate_k * C_k) * ee
//       + sum_j (cur[bcols0_j] - bvals0_j) * bbetas0_j * i0
//       + sum_j (cur[bcols1_j] - bvals1_j) * bbetas1_j * i1
//
// over the 20 transition constraints C_k of the AIR, computed by the device
// functions of transition.cuh (shared with K4).  The periodic mask and
// round constants are read from their 16-step patterns at n % 16.
//
// What bounds it on an H100: 128-bit modular multiplies (~130 a row) and
// the registers their carry chains hold, not bytes (~1 KB read per row).
// So each block first stages what all its rows share into shared memory,
// packed 16 bytes an element: the alphas and the two matrices, the 16-step
// periodic patterns, and the boundary groups rearranged as
//
//   sum_j (cur[c_j] - v_j) * b_j = sum_c cur[c] * B[c] - K,
//   B[c] = sum of the b_j with c_j = c,  K = sum_j v_j * b_j,
//
// so that each trace column of the row is read once: the body's accessor
// adds cur[c] * B[c] to the group's sum where column c is in a group, and
// a row costs one multiply per distinct boundary column.  The columns and
// delta come by value in the arguments.
//
// The multiplies wait on their carry chains, so the card needs many warps
// in flight, and one thread's body needs more registers than that leaves
// (218 uncapped).  A block's first 4 warps run part A of the body (and the
// boundary sums and the domain factor) for its 128 rows, its last 4 run
// part B for the same rows and leave their value in shared memory; the
// register cap of 128 (2 blocks of 256 per SM) costs ptxas a few spilled
// words.  kernel_bench.py --sweep chose that shape: at T = 2^16 it beat
// one thread a row at 128 registers (one wave of blocks) by ~9%.
#include "transition.cuh"

using zk::cell;
using zk::fe;

// boundary columns per group that the argument struct holds (the AIR has
// 12 and 10)
constexpr int kMaxBoundary = 16;
constexpr int kColumns = 28;
// The launch shape: threads per block, the blocks per SM that
// __launch_bounds__ asks ptxas to fit (so its register cap), and threads
// per row (1, or 2: part A in the block's first half of warps, part B in
// the second).  Other values are for timing the shapes only
// (kernel_bench.py --sweep builds them).
#ifndef ZK_AIR_THREADS
#define ZK_AIR_THREADS 256
#endif
#ifndef ZK_AIR_MIN_BLOCKS
#define ZK_AIR_MIN_BLOCKS 2
#endif
#ifndef ZK_AIR_SPLIT
#define ZK_AIR_SPLIT 2
#endif
constexpr int kThreads = ZK_AIR_THREADS, kSplit = ZK_AIR_SPLIT;
constexpr int kRows = kThreads / kSplit;  // rows per block
static_assert(kThreads >= 2 * kColumns + 2, "a block stages the boundary sums with 58 threads");
static_assert(kSplit == 1 || (kSplit == 2 && kRows % 32 == 0), "the halves are whole warps");

struct CompArgs {
  const uint32_t* cur;    // (28, 8, T)
  const uint32_t* mask;   // (8, 16) pattern
  const uint32_t* ark;    // (8, 8, 16) patterns
  const uint32_t* ee;     // (8, T)
  const uint32_t* i0;     // (8, T)
  const uint32_t* i1;     // (8, T)
  const uint32_t* mds;    // (32, 8): MDS then inverse MDS, limbs last
  const uint32_t* alphas; // (20, 8)
  fe delta;
  const uint32_t* bv[2];  // (k_g, 8) boundary values of group g
  const uint32_t* bb[2];  // (k_g, 8) their coefficients
  int bc[2][kMaxBoundary];  // their columns
  int k[2];
  uint32_t in_group[2];   // bit c: column c is in group g
  uint32_t* out;          // (8, T)
  long T;
};

__global__ void __launch_bounds__(kThreads, ZK_AIR_MIN_BLOCKS) composition_kernel(CompArgs a) {
  __shared__ zk::AirConsts k;
  __shared__ cell tab[9 * 16];
  __shared__ cell bcoef[2][kColumns];  // B[c] of each group
  __shared__ cell bprod[2][kMaxBoundary];  // v_j * b_j
  __shared__ cell bconst[2];           // K of each group
  const int tid = threadIdx.x;
  zk::stage_consts(&k, a.alphas, a.mds, tid, kThreads);
  zk::stage_table(tab, a.mask, a.ark, 16, tid, kThreads);
  if (tid < 2 * kMaxBoundary) {
    const int g = tid / kMaxBoundary, j = tid % kMaxBoundary;
    if (j < a.k[g])
      bprod[g][j] = zk::pack(zk::mul32(zk::load(a.bv[g] + j * 8, 1), zk::load(a.bb[g] + j * 8, 1)));
  }
  __syncthreads();
  if (tid < 2 * kColumns) {
    const int g = tid / kColumns, c = tid % kColumns;
    fe s{0, 0};
#pragma unroll
    for (int j = 0; j < kMaxBoundary; ++j)
      if (j < a.k[g] && a.bc[g][j] == c) s = zk::add32(s, zk::load(a.bb[g] + j * 8, 1));
    bcoef[g][c] = zk::pack(s);
  } else if (tid < 2 * kColumns + 2) {
    const int g = tid - 2 * kColumns;
    fe s{0, 0};
    for (int j = 0; j < a.k[g]; ++j) s = zk::add32(s, zk::unpack(bprod[g][j]));
    bconst[g] = zk::pack(s);
  }
  __syncthreads();

  const long T = a.T;
  const int r = tid % kRows;
  const long n = (long)blockIdx.x * kRows + r;
  const long nn = (n + 1 == T) ? 0 : n + 1;
  fe g0{0, 0}, g1{0, 0};
  auto load = [&](int c) { return zk::load(a.cur + (long)c * 8 * T + n, T); };
  auto cur = [&](int c) {
    const fe v = load(c);
    if ((a.in_group[0] >> c) & 1) g0 = zk::add32(g0, zk::mul32(v, zk::unpack(bcoef[0][c])));
    if ((a.in_group[1] >> c) & 1) g1 = zk::add32(g1, zk::mul32(v, zk::unpack(bcoef[1][c])));
    return v;
  };
  auto nxt = [&](int c) { return zk::load(a.cur + (long)c * 8 * T + nn, T); };
  const cell* per = tab + (n & 15);
  fe acc, b[5], f_push;
  if (kSplit == 1) {
    if (n >= T) return;
    zk::decoder_bits(cur, b);
    const fe op = zk::opcode(b);
    acc = zk::transition_a(cur, nxt, b, k, a.delta, f_push);
    zk::phase();
    acc = zk::add32(acc, zk::transition_b(cur, nxt, op, f_push, k, per, 16));
  } else {
    // part B's warps leave their value and boundary sums for part A's
    __shared__ cell part[kSplit == 2 ? 3 * kRows : 1];
    if (tid >= kRows && n < T) {
      zk::decoder_bits(load, b);  // part A's thread folds these columns in
      acc = zk::transition_b(cur, nxt, zk::opcode(b), zk::push_selector(b), k, per, 16);
      part[3 * r] = zk::pack(acc), part[3 * r + 1] = zk::pack(g0), part[3 * r + 2] = zk::pack(g1);
    } else if (n < T) {
      zk::decoder_bits(cur, b);
      acc = zk::transition_a(cur, nxt, b, k, a.delta, f_push);
    }
    __syncthreads();
    if (tid >= kRows || n >= T) return;
    acc = zk::add32(acc, zk::unpack(part[3 * r]));
    g0 = zk::add32(g0, zk::unpack(part[3 * r + 1]));
    g1 = zk::add32(g1, zk::unpack(part[3 * r + 2]));
  }
  // the boundary columns that the body does not read (the upper stack)
#pragma unroll
  for (int c = 22; c < kColumns; ++c)
    if (((a.in_group[0] | a.in_group[1]) >> c) & 1) cur(c);

  // the domain factor and the two boundary groups
  fe q = zk::mul32(acc, zk::load(a.ee + n, T));
  g0 = zk::sub32(g0, zk::unpack(bconst[0]));
  g1 = zk::sub32(g1, zk::unpack(bconst[1]));
  q = zk::add32(q, zk::mul32(g0, zk::load(a.i0 + n, T)));
  q = zk::add32(q, zk::mul32(g1, zk::load(a.i1 + n, T)));
  zk::store(a.out + n, T, q);
}

// delta = delta_hi * 2^64 + delta_lo; bc0 and bc1 are host arrays of k0 and
// k1 column indices (k0, k1 <= kMaxBoundary, each column < 28), copied
// into the arguments.
ZK_EXPORT int zk_composition(const uint32_t* cur, const uint32_t* mask, const uint32_t* ark,
                             const uint32_t* ee, const uint32_t* i0, const uint32_t* i1,
                             const uint32_t* mds, const uint32_t* alphas, uint64_t delta_lo,
                             uint64_t delta_hi, const uint32_t* bv0, const uint32_t* bb0,
                             const int* bc0, int k0, const uint32_t* bv1, const uint32_t* bb1,
                             const int* bc1, int k1, uint32_t* out, long T, void* stream) {
  if (k0 < 0 || k0 > kMaxBoundary || k1 < 0 || k1 > kMaxBoundary) return -1;
  CompArgs a{cur, mask, ark, ee, i0, i1, mds, alphas, fe{delta_lo, delta_hi}, {bv0, bv1},
             {bb0, bb1}, {}, {k0, k1}, {0, 0}, out, T};
  const int* bc[2] = {bc0, bc1};
  for (int g = 0; g < 2; ++g) {
    for (int j = 0; j < a.k[g]; ++j) {
      if (bc[g][j] < 0 || bc[g][j] >= kColumns) return -1;
      a.bc[g][j] = bc[g][j];
      a.in_group[g] |= 1u << bc[g][j];
    }
  }
  const long blocks = (T + kRows - 1) / kRows;
  ZK_LAUNCH(composition_kernel, dim3((unsigned)blocks), dim3(kThreads), 0, stream, a);
  return ZK_LAST_ERROR();
}
