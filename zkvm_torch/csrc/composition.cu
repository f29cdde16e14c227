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
// over the 20 transition constraints C_k of the AIR (clock, depth, shift,
// add/mul, FHE sadd/add2/smul, push/read/read2/noop, the Rescue half-round
// meet in the middle, hash copy).  The periodic mask and round constants
// are read from their 16-step patterns at n % 16.
//
// What bounds it on an H100: 128-bit modular multiplies (about 110 per
// row) and register pressure, not bytes (about 2 KB read per row).  The
// design loads each trace column where it is used and folds every
// constraint into the running sum at once, so only the Rescue states (12
// elements) are live together.
#include "f128.cuh"

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
  const int k16 = (int)(n % 16);
  auto cur = [&](int c) { return zk::load(a.cur + (long)c * 8 * T + n, T); };
  auto nxt = [&](int c) { return zk::load(a.cur + (long)c * 8 * T + nn, T); };
  auto vec = [](const uint32_t* p, int i) { return zk::load(p + (long)i * 8, 1); };
  const fe zero{0, 0}, one{1, 0};

  // decoder bits b0..b4 (b0 = MSB = column 5) and the selectors
  const fe b[5] = {cur(5), cur(4), cur(3), cur(2), cur(1)};
  fe nb[5];
  for (int i = 0; i < 5; ++i) nb[i] = zk::sub(one, b[i]);
  auto sel = [&](int p0, int p1, int p2, int p3, int p4) {
    const fe o0 = p0 ? b[0] : nb[0], o1 = p1 ? b[1] : nb[1], o2 = p2 ? b[2] : nb[2];
    const fe o3 = p3 ? b[3] : nb[3], o4 = p4 ? b[4] : nb[4];
    return zk::mul(zk::mul(zk::mul(o0, o1), zk::mul(o2, o3)), o4);
  };
  const fe f_add = sel(0, 1, 0, 0, 0), f_sadd = sel(0, 1, 0, 1, 0), f_add2 = sel(0, 1, 0, 1, 1);
  const fe f_mul = sel(0, 1, 0, 0, 1), f_smul = sel(0, 1, 1, 0, 0), f_push = sel(1, 0, 0, 0, 0);
  const fe f_read = sel(1, 0, 0, 0, 1), f_read2 = sel(1, 0, 0, 1, 0), f_noop = sel(0, 0, 0, 0, 0);
  const fe shr = b[0], shl = b[1];

  fe acc = zero;
  auto term = [&](int k, fe e, fe g) { acc = zk::add(acc, zk::mul(zk::mul(e, g), vec(a.alphas, k))); };

  // 0: clk' - (clk + 1)
  term(0, zk::sub(nxt(0), zk::add(cur(0), one)), one);
  // 1: d' - d - shr + shl - 4*read2 + 4*add2
  const fe four{4, 0};
  fe dep = zk::add(zk::sub(zk::sub(nxt(11), cur(11)), shr), shl);
  dep = zk::sub(dep, zk::mul(f_read2, four));
  term(1, zk::add(dep, zk::mul(f_add2, four)), one);
  // 2: shr * shl
  term(2, zk::mul(shr, shl), one);
  // 3: add
  const fe s0 = cur(12), s1 = cur(13), sn0 = nxt(12);
  term(3, zk::sub(sn0, zk::add(s0, s1)), f_add);
  // 4: sadd (LWE size 5): sum sn[0..4] - sum s[1..5] - delta * s0
  fe sn04 = zero, s15 = zero, s04 = zero, s59 = zero;
  for (int i = 0; i < 5; ++i) {
    sn04 = zk::add(sn04, nxt(12 + i));
    s15 = zk::add(s15, cur(13 + i));
    s04 = zk::add(s04, cur(12 + i));
    s59 = zk::add(s59, cur(17 + i));
  }
  term(4, zk::sub(zk::sub(sn04, s15), zk::mul(zk::load(a.delta, 1), s0)), f_sadd);
  // 5: add2
  term(5, zk::sub(zk::sub(sn04, s04), s59), f_add2);
  // 6: mul
  term(6, zk::sub(sn0, zk::mul(s0, s1)), f_mul);
  // 7: smul
  term(7, zk::sub(sn04, zk::mul(s0, s15)), f_smul);
  // 8-11: push / read / read2 / noop shifts
  const fe sn1 = nxt(13);
  term(8, zk::sub(sn1, s0), f_push);
  term(9, zk::sub(sn1, s0), f_read);
  term(10, zk::sub(nxt(17), s0), f_read2);
  term(11, zk::sub(sn0, s0), f_noop);

  // 12-15: Rescue half rounds, meeting in the middle
  const fe mask = zk::load(a.mask + k16, 16);
  const fe h0 = cur(6);
  auto ark = [&](int j) { return zk::load(a.ark + (long)j * 8 * 16 + k16, 16); };
  fe x3[4], st[4], y[4];
  for (int i = 0; i < 4; ++i) {
    const fe x = cur(7 + i);
    x3[i] = zk::mul(zk::mul(x, x), x);
    y[i] = zk::sub(nxt(7 + i), ark(4 + i));
  }
  for (int i = 0; i < 4; ++i) {
    fe s = zero;
    for (int j = 0; j < 4; ++j) s = zk::add(s, zk::mul(vec(a.mds, i * 4 + j), x3[j]));
    st[i] = zk::add(s, ark(i));
  }
  fe opcode = zero;
  const uint64_t weights[5] = {16, 8, 4, 2, 1};
  for (int i = 0; i < 5; ++i) opcode = zk::add(opcode, zk::mul(fe{weights[i], 0}, b[i]));
  st[0] = zk::add(st[0], opcode);
  st[1] = zk::add(st[1], zk::mul(sn0, f_push));
  const fe gate = zk::mul(mask, h0);
  for (int i = 0; i < 4; ++i) {
    fe s = zero;
    for (int j = 0; j < 4; ++j) s = zk::add(s, zk::mul(vec(a.imds, i * 4 + j), y[j]));
    term(12 + i, zk::sub(zk::mul(zk::mul(s, s), s), st[i]), gate);
  }
  // 16-19: hash copy / capacity reset
  const fe ngate = zk::mul(zk::sub(one, mask), h0);
  term(16, zk::sub(nxt(7), cur(7)), ngate);
  term(17, zk::sub(nxt(8), cur(8)), ngate);
  term(18, nxt(9), ngate);
  term(19, nxt(10), ngate);

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
