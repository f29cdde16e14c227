// K3: the per-class composition value, one thread per row.
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
// function zk::merged_transition (transition.cuh, shared with K4).  The
// periodic mask and round constants are read from their 16-step patterns
// at n % 16.
//
// What bounds it on an H100: 128-bit modular multiplies (about 110 per
// row) and register pressure, not bytes (about 2 KB read per row).
#include "transition.cuh"

using zk::fe;

struct CompArgs {
  const uint32_t* cur;    // (28, 8, T)
  const uint32_t* mask;   // (8, 16) pattern
  const uint32_t* ark;    // (8, 8, 16) patterns
  const uint32_t* ee;     // (8, T)
  const uint32_t* i0;     // (8, T)
  const uint32_t* i1;     // (8, T)
  const uint32_t* mds;    // (4, 4, 8) limbs last
  const uint32_t* imds;   // (4, 4, 8) limbs last
  const uint32_t* alphas; // (20, 8)
  const uint32_t* delta;  // (8,)
  const uint32_t* bv0;    // (k0, 8)
  const uint32_t* bb0;    // (k0, 8)
  const int* bc0;         // (k0,)
  int k0;
  const uint32_t* bv1;
  const uint32_t* bb1;
  const int* bc1;
  int k1;
  uint32_t* out;          // (8, T)
  long T;
};

__global__ void composition_kernel(CompArgs a) {
  const long n = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long T = a.T;
  if (n >= T) return;
  const long nn = (n + 1 == T) ? 0 : n + 1;
  auto cur = [&](int c) { return zk::load(a.cur + (long)c * 8 * T + n, T); };
  auto vec = [](const uint32_t* p, int i) { return zk::load(p + (long)i * 8, 1); };
  const fe zero{0, 0};

  const fe acc = zk::merged_transition(a.cur, T, n, nn, a.mask, a.ark, 16, n % 16,
                                       a.mds, a.imds, a.alphas, a.delta);

  // domain factor and the two boundary groups
  fe q = zk::mul(acc, zk::load(a.ee + n, T));
  fe g0 = zero, g1 = zero;
  for (int j = 0; j < a.k0; ++j)
    g0 = zk::add(g0, zk::mul(zk::sub(cur(a.bc0[j]), vec(a.bv0, j)), vec(a.bb0, j)));
  for (int j = 0; j < a.k1; ++j)
    g1 = zk::add(g1, zk::mul(zk::sub(cur(a.bc1[j]), vec(a.bv1, j)), vec(a.bb1, j)));
  q = zk::add(q, zk::mul(g0, zk::load(a.i0 + n, T)));
  q = zk::add(q, zk::mul(g1, zk::load(a.i1 + n, T)));
  zk::store(a.out + n, T, q);
}

ZK_EXPORT int zk_composition(const uint32_t* cur, const uint32_t* mask, const uint32_t* ark,
                             const uint32_t* ee, const uint32_t* i0, const uint32_t* i1,
                             const uint32_t* mds, const uint32_t* imds, const uint32_t* alphas,
                             const uint32_t* delta, const uint32_t* bv0, const uint32_t* bb0,
                             const int* bc0, int k0, const uint32_t* bv1, const uint32_t* bb1,
                             const int* bc1, int k1, uint32_t* out, long T, void* stream) {
  CompArgs a{cur, mask, ark, ee, i0, i1, mds, imds, alphas, delta,
             bv0, bb0, bc0, k0, bv1, bb1, bc1, k1, out, T};
  const int threads = 128;
  const long blocks = (T + threads - 1) / threads;
  ZK_LAUNCH(composition_kernel, dim3((unsigned)blocks), dim3(threads), 0, stream, a);
  return ZK_LAST_ERROR();
}
