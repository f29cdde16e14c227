// The merged transition value of the AIR at one row: the device function
// shared by K3 (composition.cu) and K4 (transition.cu).
//
// Counterpart of zkvm/air/constraints_pallas.py::merged_transition_t (:74),
// the body of both TPU kernels.  It returns
//
//   sum_k alpha_k * gate_k * C_k
//
// over the 20 transition constraints C_k (clock, depth, shift, add/mul,
// FHE sadd/add2/smul, push/read/read2/noop, the Rescue half-round meet in
// the middle, hash copy).  Trace column c of row r is read from
// lde + c*8*N + r with limb stride N; the current row is n, the next row nn.
// The periodic mask and round constants are read from tables of length P
// at kp (mask (8, P), ark (8, 8, P)): K3 passes its 16-step class patterns,
// K4 the period-P tables of the full domain, so neither needs a tiled
// copy.
//
// Register pressure, not bytes, bounds it: each trace column is loaded
// where it is used and every constraint folds into the running sum at once,
// so only the Rescue states (12 elements) are live together.
#pragma once

#include "f128.cuh"

namespace zk {

ZK_HD fe merged_transition(const uint32_t* lde, long N, long n, long nn,
                           const uint32_t* mask_tab, const uint32_t* ark_tab, long P, long kp,
                           const uint32_t* mds, const uint32_t* imds,
                           const uint32_t* alphas, const uint32_t* delta) {
  auto cur = [&](int c) { return load(lde + (long)c * 8 * N + n, N); };
  auto nxt = [&](int c) { return load(lde + (long)c * 8 * N + nn, N); };
  auto vec = [](const uint32_t* p, int i) { return load(p + (long)i * 8, 1); };
  const fe zero{0, 0}, one{1, 0};

  // decoder bits b0..b4 (b0 = MSB = column 5) and the selectors
  const fe b[5] = {cur(5), cur(4), cur(3), cur(2), cur(1)};
  fe nb[5];
  for (int i = 0; i < 5; ++i) nb[i] = sub(one, b[i]);
  auto sel = [&](int p0, int p1, int p2, int p3, int p4) {
    const fe o0 = p0 ? b[0] : nb[0], o1 = p1 ? b[1] : nb[1], o2 = p2 ? b[2] : nb[2];
    const fe o3 = p3 ? b[3] : nb[3], o4 = p4 ? b[4] : nb[4];
    return mul(mul(mul(o0, o1), mul(o2, o3)), o4);
  };
  const fe f_add = sel(0, 1, 0, 0, 0), f_sadd = sel(0, 1, 0, 1, 0), f_add2 = sel(0, 1, 0, 1, 1);
  const fe f_mul = sel(0, 1, 0, 0, 1), f_smul = sel(0, 1, 1, 0, 0), f_push = sel(1, 0, 0, 0, 0);
  const fe f_read = sel(1, 0, 0, 0, 1), f_read2 = sel(1, 0, 0, 1, 0), f_noop = sel(0, 0, 0, 0, 0);
  const fe shr = b[0], shl = b[1];

  fe acc = zero;
  auto term = [&](int k, fe e, fe g) { acc = add(acc, mul(mul(e, g), vec(alphas, k))); };

  // 0: clk' - (clk + 1)
  term(0, sub(nxt(0), add(cur(0), one)), one);
  // 1: d' - d - shr + shl - 4*read2 + 4*add2
  const fe four{4, 0};
  fe dep = add(sub(sub(nxt(11), cur(11)), shr), shl);
  dep = sub(dep, mul(f_read2, four));
  term(1, add(dep, mul(f_add2, four)), one);
  // 2: shr * shl
  term(2, mul(shr, shl), one);
  // 3: add
  const fe s0 = cur(12), s1 = cur(13), sn0 = nxt(12);
  term(3, sub(sn0, add(s0, s1)), f_add);
  // 4: sadd (LWE size 5): sum sn[0..4] - sum s[1..5] - delta * s0
  fe sn04 = zero, s15 = zero, s04 = zero, s59 = zero;
  for (int i = 0; i < 5; ++i) {
    sn04 = add(sn04, nxt(12 + i));
    s15 = add(s15, cur(13 + i));
    s04 = add(s04, cur(12 + i));
    s59 = add(s59, cur(17 + i));
  }
  term(4, sub(sub(sn04, s15), mul(load(delta, 1), s0)), f_sadd);
  // 5: add2
  term(5, sub(sub(sn04, s04), s59), f_add2);
  // 6: mul
  term(6, sub(sn0, mul(s0, s1)), f_mul);
  // 7: smul
  term(7, sub(sn04, mul(s0, s15)), f_smul);
  // 8-11: push / read / read2 / noop shifts
  const fe sn1 = nxt(13);
  term(8, sub(sn1, s0), f_push);
  term(9, sub(sn1, s0), f_read);
  term(10, sub(nxt(17), s0), f_read2);
  term(11, sub(sn0, s0), f_noop);

  // 12-15: Rescue half rounds, meeting in the middle
  const fe mask = load(mask_tab + kp, P);
  const fe h0 = cur(6);
  auto ark = [&](int j) { return load(ark_tab + (long)j * 8 * P + kp, P); };
  fe x3[4], st[4], y[4];
  for (int i = 0; i < 4; ++i) {
    const fe x = cur(7 + i);
    x3[i] = mul(mul(x, x), x);
    y[i] = sub(nxt(7 + i), ark(4 + i));
  }
  for (int i = 0; i < 4; ++i) {
    fe s = zero;
    for (int j = 0; j < 4; ++j) s = add(s, mul(vec(mds, i * 4 + j), x3[j]));
    st[i] = add(s, ark(i));
  }
  fe opcode = zero;
  const uint64_t weights[5] = {16, 8, 4, 2, 1};
  for (int i = 0; i < 5; ++i) opcode = add(opcode, mul(fe{weights[i], 0}, b[i]));
  st[0] = add(st[0], opcode);
  st[1] = add(st[1], mul(sn0, f_push));
  const fe gate = mul(mask, h0);
  for (int i = 0; i < 4; ++i) {
    fe s = zero;
    for (int j = 0; j < 4; ++j) s = add(s, mul(vec(imds, i * 4 + j), y[j]));
    term(12 + i, sub(mul(mul(s, s), s), st[i]), gate);
  }
  // 16-19: hash copy / capacity reset
  const fe ngate = mul(sub(one, mask), h0);
  term(16, sub(nxt(7), cur(7)), ngate);
  term(17, sub(nxt(8), cur(8)), ngate);
  term(18, nxt(9), ngate);
  term(19, nxt(10), ngate);
  return acc;
}

}  // namespace zk
