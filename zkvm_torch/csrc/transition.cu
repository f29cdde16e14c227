// K4: the merged transition value over a domain, one thread per row.
//
// Replaces the TPU kernel zkvm/air/constraints_pallas.py::
// merged_transition_pallas (:378; kernel _kernel :369, body
// merged_transition_t :74), reached through merged_transition_via_pallas
// (:456, the full-LDE prover) and merged_transition_pallas_pair (:418, one
// blowup class).  For row n of N rows:
//
//   out[n] = zk::merged_transition(row n, row (n + step) mod N,
//                                  periodic tables at n mod P)
//
// The TPU kernel takes a materialised next-row array and (8, D) / (8, 8, D)
// periodic arrays.  Here the next row is read in place at (n + step) mod N
// (step = blowup over the full domain, 1 within a class), and the periodic
// values come from tables of length P (16 * blowup over the full domain,
// 16 for a class): at D = 2^19 that saves reading a rolled copy of the
// LDE (470 MB) and a tiled round-constant array (134 MB).
//
// What bounds it on an H100: the 28 columns of two rows read per output
// row (about 1 KB of 16-bit limbs in 32-bit words), against about 140
// 128-bit modular multiplies a row; the algebra is the same as K3's, whose
// register pressure it shares.
#include "transition.cuh"

struct TransArgs {
  const uint32_t* lde;    // (28, 8, N)
  const uint32_t* mask;   // (8, P) table
  const uint32_t* ark;    // (8, 8, P) tables
  const uint32_t* mds;    // (4, 4, 8) limbs last
  const uint32_t* imds;   // (4, 4, 8) limbs last
  const uint32_t* alphas; // (20, 8)
  const uint32_t* delta;  // (8,)
  uint32_t* out;          // (8, N)
  long N;
  long P;
  long step;              // 0 < step < N
};

__global__ void transition_kernel(TransArgs a) {
  const long n = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const long nn = (n + a.step < a.N) ? n + a.step : n + a.step - a.N;
  const zk::fe q = zk::merged_transition(a.lde, a.N, n, nn, a.mask, a.ark, a.P, n % a.P,
                                         a.mds, a.imds, a.alphas, a.delta);
  zk::store(a.out + n, a.N, q);
}

ZK_EXPORT int zk_transition(const uint32_t* lde, const uint32_t* mask, const uint32_t* ark,
                            const uint32_t* mds, const uint32_t* imds, const uint32_t* alphas,
                            const uint32_t* delta, uint32_t* out, long N, long P, long step,
                            void* stream) {
  TransArgs a{lde, mask, ark, mds, imds, alphas, delta, out, N, P, step};
  const int threads = 128;
  const long blocks = (N + threads - 1) / threads;
  ZK_LAUNCH(transition_kernel, dim3((unsigned)blocks), dim3(threads), 0, stream, a);
  return ZK_LAST_ERROR();
}
