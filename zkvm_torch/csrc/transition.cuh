// The merged transition value of the AIR at one row: the device functions
// shared by K3 (composition.cu) and K4 (transition.cu).
//
// Counterpart of zkvm/air/constraints_pallas.py::merged_transition_t (:74),
// the body of both TPU kernels.  It returns
//
//   sum_k alpha_k * gate_k * C_k
//
// over the 20 transition constraints C_k (clock, depth, shift, add/mul,
// FHE sadd/add2/smul, push/read/read2/noop, the Rescue half-round meet in
// the middle, hash copy), as two parts:
//
//   part A (terms 0-11): the clock, depth and decoder terms and the stack
//     and LWE operations; current-row columns 0-5 and 11-21;
//   part B (terms 12-19): the Rescue half rounds and the hash copy;
//     columns 6-10, the opcode and the push selector.
//
// A kernel runs both in one thread, or part A in some warps and part B in
// others for the same rows (two threads a row, fewer registers each; the
// halves are whole warps, so no warp runs both paths).
//
// A kernel reads the rows through its accessors cur(c) and nxt(c), and
// each part asks for a column of the current row once (K3's accessor also
// folds the column into its boundary sums).  Constants come packed from
// shared memory, staged once per block: the alphas and the two matrices
// (AirConsts), and the periodic mask and round constants (a table of 9
// columns of P phases, read at the row's phase).
//
// The algebra is the reference's, rearranged where the field allows it,
// so the values are the same canonical elements: the nine selectors share
// their partial products (21 multiplies, not 36); a gate of one is not
// multiplied; 4 x and the opcode's weights are doublings; terms 8 and 9
// share their constraint, terms 12-15 and 16-19 their gate.  That is 106
// multiplies and 105 adds a row where the reference's order takes 138
// and 118.
//
// What bounds it on an H100: the multiplies (zk::mul32, ~107 instructions
// each) and the registers that their carry chains and the live Rescue
// state (8 elements) hold; not bytes (~1 KB of limbs read per row).
#pragma once

#include "f128.cuh"

namespace zk {

// The per-block constants in shared memory, packed: the 20 alphas, then
// the MDS and inverse-MDS matrices (row-major, mat[0..15] and mat[16..31]).
struct AirConsts {
  cell alpha[20];
  cell mat[32];
};

// Stage (n, 8) limbs-last elements into packed cells, threads tid, tid + nt, ...
ZK_HD void stage_rows(cell* dst, const uint32_t* src, int n, int tid, int nt) {
  for (int i = tid; i < n; i += nt) dst[i] = pack(load(src + (long)i * 8, 1));
}

ZK_HD void stage_consts(AirConsts* k, const uint32_t* alphas, const uint32_t* mat, int tid, int nt) {
  stage_rows(k->alpha, alphas, 20, tid, nt);
  stage_rows(k->mat, mat, 32, tid, nt);
}

// The periodic table: dst[j * P + i] = column j (0 the mask (8, P), 1-8 the
// round constants (8, 8, P)) at phase i.
ZK_HD void stage_table(cell* dst, const uint32_t* mask, const uint32_t* ark, int P, int tid,
                       int nt) {
  for (int e = tid; e < 9 * P; e += nt) {
    const int j = e / P, i = e - j * P;
    dst[e] = pack(load(j == 0 ? mask + i : ark + (long)(j - 1) * 8 * P + i, P));
  }
}

ZK_HD fe dbl(fe a) { return add32(a, a); }

// An ordering point between phases of the body, a warp barrier with memory
// ordering: ptxas does not hoist a later phase's loads above it into the
// registers of the phase before (the two-thread shapes ran 4-7% faster
// with these points than without).
ZK_HD void phase() {
#if defined(__CUDA_ARCH__)
  __syncwarp(__activemask());
#endif
}

// decoder bits b0..b4 (b0 = MSB = column 5)
template <class Cur>
ZK_HD void decoder_bits(Cur& cur, fe b[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) b[i] = cur(5 - i);
}

// the opcode 16 b0 + 8 b1 + 4 b2 + 2 b3 + b4, by doublings
ZK_HD fe opcode(const fe b[5]) {
  fe op = b[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) op = add32(dbl(op), b[i]);
  return op;
}

// the push selector b0 (1 - b1)(1 - b2)(1 - b3)(1 - b4), alone (part B's
// thread when the parts run in two)
ZK_HD fe push_selector(const fe b[5]) {
  const fe one{1, 0};
  const fe r0 = mul32(mul32(b[0], sub32(one, b[1])), sub32(one, b[2]));
  return mul32(r0, mul32(sub32(one, b[3]), sub32(one, b[4])));
}

// Part A: terms 0-11.  Sets f_push for part B.
template <class Cur, class Nxt>
ZK_HD fe transition_a(Cur& cur, Nxt& nxt, const fe b[5], const AirConsts& k, fe delta,
                      fe& f_push) {
  const fe one{1, 0};
  auto al = [&](int i) { return unpack(k.alpha[i]); };
  fe nb[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) nb[i] = sub32(one, b[i]);
  // selectors, bit patterns b0..b4 (1: the bit, 0: one minus it)
  const fe p01 = mul32(nb[0], b[1]), p010 = mul32(p01, nb[2]);
  const fe p0100 = mul32(p010, nb[3]), p0101 = mul32(p010, b[3]);
  const fe q34 = mul32(nb[3], nb[4]);
  const fe r0 = mul32(mul32(b[0], nb[1]), nb[2]);
  const fe f_add = mul32(p0100, nb[4]), f_mul = mul32(p0100, b[4]);     // 01000, 01001
  const fe f_sadd = mul32(p0101, nb[4]), f_add2 = mul32(p0101, b[4]);   // 01010, 01011
  const fe f_smul = mul32(mul32(p01, b[2]), q34);                        // 01100
  f_push = mul32(r0, q34);                                               // 10000
  const fe f_read = mul32(mul32(r0, nb[3]), b[4]);                       // 10001
  const fe f_read2 = mul32(mul32(r0, b[3]), nb[4]);                      // 10010
  const fe f_noop = mul32(mul32(mul32(nb[0], nb[1]), nb[2]), q34);       // 00000
  const fe shr = b[0], shl = b[1];
  phase();

  // 0: clk' - (clk + 1)
  fe acc = mul32(sub32(nxt(0), add32(cur(0), one)), al(0));
  // 1: d' - d - shr + shl - 4*read2 + 4*add2
  const fe dep = add32(sub32(sub32(nxt(11), cur(11)), shr), shl);
  acc = add32(acc, mul32(add32(dep, dbl(dbl(sub32(f_add2, f_read2)))), al(1)));
  // 2: shr * shl
  acc = add32(acc, mul32(mul32(shr, shl), al(2)));
  // the stack s0..s9 (columns 12-21) and the next row's s0..s4
  const fe s0 = cur(12), s1 = cur(13);
  const fe s14 = add32(add32(s1, cur(14)), add32(cur(15), cur(16)));
  const fe s5 = cur(17);
  const fe s04 = add32(s0, s14), s15 = add32(s14, s5);
  const fe s59 = add32(add32(add32(s5, cur(18)), add32(cur(19), cur(20))), cur(21));
  const fe sn0 = nxt(12), sn1 = nxt(13);
  const fe sn04 = add32(add32(add32(sn0, sn1), add32(nxt(14), nxt(15))), nxt(16));
  phase();
  auto term = [&](int i, fe e, fe g) { acc = add32(acc, mul32(mul32(e, g), al(i))); };
  // 3: add
  term(3, sub32(sn0, add32(s0, s1)), f_add);
  // 4: sadd (LWE size 5): sum sn[0..4] - sum s[1..5] - delta * s0
  term(4, sub32(sub32(sn04, s15), mul32(delta, s0)), f_sadd);
  // 5: add2
  term(5, sub32(sub32(sn04, s04), s59), f_add2);
  // 6: mul
  term(6, sub32(sn0, mul32(s0, s1)), f_mul);
  // 7: smul
  term(7, sub32(sn04, mul32(s0, s15)), f_smul);
  // 8-11: push / read / read2 / noop shifts
  acc = add32(acc, mul32(sub32(sn1, s0), add32(mul32(f_push, al(8)), mul32(f_read, al(9)))));
  term(10, sub32(nxt(17), s0), f_read2);
  term(11, sub32(sn0, s0), f_noop);
  return acc;
}

// Part B: terms 12-19.  per points at the periodic table's phase of this
// row (column j at per[j * P]).
template <class Cur, class Nxt>
ZK_HD fe transition_b(Cur& cur, Nxt& nxt, fe op, fe f_push, const AirConsts& k,
                      const cell* per, int P) {
  const fe one{1, 0};
  auto al = [&](int i) { return unpack(k.alpha[i]); };
  auto ark = [&](int j) { return unpack(per[(1 + j) * P]); };
  const fe mask = unpack(per[0]);
  const fe h0 = cur(6);
  // the state x (columns 7-10) cubed, the next state less the second
  // half-round's constants, and the hash copy (16-19) from both
  fe x3[4], y[4], copy;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const fe x = cur(7 + i), xn = nxt(7 + i);
    x3[i] = mul32(mul32(x, x), x);
    y[i] = sub32(xn, ark(4 + i));
    const fe c = mul32(i < 2 ? sub32(xn, x) : xn, al(16 + i));
    copy = i == 0 ? c : add32(copy, c);
  }
  phase();
  // 12-15: MDS(x^3) + ark[0..3] (+ the opcode, + s0' * push) against the
  // cube of MDS^-1(y)
  fe rescue;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fe st = ark(i), s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st = add32(st, mul32(unpack(k.mat[i * 4 + j]), x3[j]));
      const fe m = mul32(unpack(k.mat[16 + i * 4 + j]), y[j]);
      s = j == 0 ? m : add32(s, m);
    }
    if (i == 0) st = add32(st, op);
    if (i == 1) st = add32(st, mul32(nxt(12), f_push));
    const fe c = mul32(sub32(mul32(mul32(s, s), s), st), al(12 + i));
    rescue = i == 0 ? c : add32(rescue, c);
  }
  const fe r = mul32(rescue, mul32(mask, h0));
  return add32(r, mul32(copy, mul32(sub32(one, mask), h0)));
}

}  // namespace zk
