// f128 field arithmetic for the zkvm_torch kernels.
//
// p = 2^128 - eps with eps = 2^128 mod p = 45*2^40 - 1 (< 2^46).  A field
// element (zk::fe) holds its value as two 64-bit halves, but all
// arithmetic runs on its four 32-bit words: mul32 is a 4 x 4 schoolbook of
// 32-bit limbs with two folds by eps (sqr32 the square from 10 of its 16
// products), add32 / sub32 are 32-bit carry
// chains (PTX on the card, the same steps in C on the host, where the
// kernels are emulated).  In device memory an element is the reference's
// 8 little-endian 16-bit limbs, one per uint32 (the transposed (..., 8, N)
// layout: limb i at offset i*stride), or, for constants read many times,
// a packed cell of its four words (16 bytes, one load).  Every function
// takes and returns canonical values (< p), so results are the same bits
// as zkvm_torch/field/f128t.py and the JAX reference.
#pragma once

#include "zk_common.cuh"

namespace zk {

struct fe {
  uint64_t lo, hi;
};

constexpr uint64_t EPS = 45ull * (1ull << 40) - 1;

// one element packed in 16 bytes (its four 32-bit words), for constants
// that a kernel reads many times: one 16-byte load
struct alignas(16) cell {
  uint64_t lo, hi;
};

ZK_HD fe unpack(cell c) { return fe{c.lo, c.hi}; }
ZK_HD cell pack(fe v) { return cell{v.lo, v.hi}; }

// Any 256-bit value r7..r0 (words, least significant first) mod p, as a
// canonical element: the folds by eps = 0x2D00 * 2^32 - 1 as a multiply by
// the 14-bit 0x2D00, a shift by one word and a subtraction.  The second half
// of mul32_c, and the multi-eval's reduction of its digit sums.
ZK_HD fe fold256(const uint32_t r[8]) {
  constexpr uint32_t E1 = 0x2D00;  // eps = E1 * 2^32 - 1
  // fold 1: H * 2^128 == H * eps = (H * E1) << 32 - H for H = r7..r4;
  // g4..g0 = H * E1, and L + (g << 32) - H >= 0 is t5..t0 (t5:t4 < 2^47)
  uint32_t g[5];
  uint64_t t = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t = (uint64_t)r[4 + j] * E1 + (t >> 32);
    g[j] = (uint32_t)t;
  }
  g[4] = (uint32_t)(t >> 32);
  int64_t s = (int64_t)r[0] - r[4];
  const uint32_t t0 = (uint32_t)s;
  s = (s >> 32) + r[1] + g[0] - r[5];
  const uint32_t t1 = (uint32_t)s;
  s = (s >> 32) + r[2] + g[1] - r[6];
  const uint32_t t2 = (uint32_t)s;
  s = (s >> 32) + r[3] + g[2] - r[7];
  const uint32_t t3 = (uint32_t)s;
  s = (s >> 32) + g[3];
  const uint32_t t4 = (uint32_t)s;
  const uint32_t t5 = (uint32_t)((s >> 32) + g[4]);
  // fold 2: the same with H = t5:t4; the sum is below 2^128 + 2^93
  uint64_t u = (uint64_t)t4 * E1;
  const uint32_t h0 = (uint32_t)u;
  u = (u >> 32) + (uint64_t)t5 * E1;
  s = (int64_t)t0 - t4;
  const uint32_t v0 = (uint32_t)s;
  s = (s >> 32) + t1 + h0 - t5;
  const uint32_t v1 = (uint32_t)s;
  s = (s >> 32) + t2 + (uint32_t)u;
  const uint32_t v2 = (uint32_t)s;
  s = (s >> 32) + t3 + (uint32_t)(u >> 32);
  const uint32_t v3 = (uint32_t)s;
  // fold 3 and the canonical value: v + eps where bit 128 was set (then
  // v < 2^93, and v + 2^128 == v + eps) or where v + eps carries (v >= p)
  const uint64_t lo = (uint64_t)v1 << 32 | v0, hi = (uint64_t)v3 << 32 | v2;
  const uint64_t tlo = lo + EPS, thi = hi + (tlo < lo);
  const bool carry = (tlo < lo) && thi == 0;
  return ((s >> 32) != 0 || carry) ? fe{tlo, thi} : fe{lo, hi};
}

// The product from 32-bit limbs (the card has no 64 x 64-bit multiplier):
// a 4 x 4 schoolbook of 32 x 32 -> 64-bit products, then fold256.  mul32_c
// is the algorithm in C (the host's mul32, so the emulated kernels check
// it); on the card mul32 runs the same steps as one PTX carry chain (nvcc's
// SASS for the C kept its carries in extra 64-bit adds and moves: ~130
// instructions against ~80).
ZK_HD fe mul32_c(fe a, fe b) {
  const uint32_t x[4] = {(uint32_t)a.lo, (uint32_t)(a.lo >> 32), (uint32_t)a.hi,
                         (uint32_t)(a.hi >> 32)};
  const uint32_t y[4] = {(uint32_t)b.lo, (uint32_t)(b.lo >> 32), (uint32_t)b.hi,
                         (uint32_t)(b.hi >> 32)};
  // 256-bit product r7..r0; each step is x*y + r + carry < 2^64
  uint32_t r[8];
  uint64_t t = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t = (uint64_t)x[0] * y[j] + (t >> 32);
    r[j] = (uint32_t)t;
  }
  r[4] = (uint32_t)(t >> 32);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    t = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t = (uint64_t)x[i] * y[j] + r[i + j] + (t >> 32);
      r[i + j] = (uint32_t)t;
    }
    r[i + 4] = (uint32_t)(t >> 32);
  }
  return fold256(r);
}

// The square from 10 limb products, not mul32's 16: the six x_i x_j (i <
// j) once, their sum doubled, then the four x_i^2 added at word 2i, and
// fold256.  sqr32_c is the algorithm in C (the host's sqr32); on the card
// sqr32 runs the same steps as one PTX carry chain.  The squaring chains
// of the ladders (csrc/multi_eval.cu) are their kernels' floor.
ZK_HD fe sqr32_c(fe a) {
  const uint32_t x[4] = {(uint32_t)a.lo, (uint32_t)(a.lo >> 32), (uint32_t)a.hi,
                         (uint32_t)(a.hi >> 32)};
  // R = sum_{i<j} x_i x_j 2^(32 (i + j)) < 2^224 in r6..r1
  uint32_t r[8];
  uint64_t t = (uint64_t)x[0] * x[1];
  r[0] = 0;
  r[1] = (uint32_t)t;
  t = (uint64_t)x[0] * x[2] + (t >> 32);
  r[2] = (uint32_t)t;
  t = (uint64_t)x[0] * x[3] + (t >> 32);
  r[3] = (uint32_t)t;
  r[4] = (uint32_t)(t >> 32);
  t = (uint64_t)x[1] * x[2] + r[3];
  r[3] = (uint32_t)t;
  t = (uint64_t)x[1] * x[3] + r[4] + (t >> 32);
  r[4] = (uint32_t)t;
  t = (uint64_t)x[2] * x[3] + (t >> 32);
  r[5] = (uint32_t)t;
  r[6] = (uint32_t)(t >> 32);
  r[7] = 0;
  // 2 R + sum_i x_i^2 2^(64 i), a word at a time
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t s = (uint64_t)x[i] * x[i];
    c += ((uint64_t)r[2 * i] << 1) + (uint32_t)s;
    r[2 * i] = (uint32_t)c;
    c >>= 32;
    c += ((uint64_t)r[2 * i + 1] << 1) + (s >> 32);
    r[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return fold256(r);
}

#if defined(__CUDA_ARCH__)
#define ZK_WORDS(v)                                                                 \
  "r"((uint32_t)(v).lo), "r"((uint32_t)((v).lo >> 32)), "r"((uint32_t)(v).hi), \
      "r"((uint32_t)((v).hi >> 32))
#define ZK_JOIN(w) fe{(uint64_t)(w)[1] << 32 | (w)[0], (uint64_t)(w)[3] << 32 | (w)[2]}

// the folds of mul32 and sqr32's 256-bit r7..r0 to a canonical value in
// %0..%3 (fold 1 by H = r7..r4, fold 2 by the two words above 128 bits,
// fold 3 and canon in one test), in their asm blocks' registers
#define ZK_FOLD_PTX \
  /* fold 1: g4..g0 = H * 0x2D00; r + (g << 32) - H into g4 g3 r3..r0 */ \
  "mul.lo.u32 g0, r4, 0x2D00;\n\t" \
  "mul.lo.u32 g1, r5, 0x2D00;\n\t" \
  "mul.lo.u32 g2, r6, 0x2D00;\n\t" \
  "mul.lo.u32 g3, r7, 0x2D00;\n\t" \
  "mad.hi.cc.u32 g1, r4, 0x2D00, g1;\n\t" \
  "madc.hi.cc.u32 g2, r5, 0x2D00, g2;\n\t" \
  "madc.hi.cc.u32 g3, r6, 0x2D00, g3;\n\t" \
  "madc.hi.u32 g4, r7, 0x2D00, 0;\n\t" \
  "add.cc.u32 r1, r1, g0;\n\t" \
  "addc.cc.u32 r2, r2, g1;\n\t" \
  "addc.cc.u32 r3, r3, g2;\n\t" \
  "addc.cc.u32 g3, g3, 0;\n\t" \
  "addc.u32 g4, g4, 0;\n\t" \
  "sub.cc.u32 r0, r0, r4;\n\t" \
  "subc.cc.u32 r1, r1, r5;\n\t" \
  "subc.cc.u32 r2, r2, r6;\n\t" \
  "subc.cc.u32 r3, r3, r7;\n\t" \
  "subc.cc.u32 g3, g3, 0;\n\t" \
  "subc.u32 g4, g4, 0;\n\t" \
  /* fold 2: H = g4:g3 (< 2^47); H * 0x2D00 = r5:r4; the carry in c */ \
  "mul.lo.u32 r4, g3, 0x2D00;\n\t" \
  "mul.hi.u32 r5, g3, 0x2D00;\n\t" \
  "mad.lo.u32 r5, g4, 0x2D00, r5;\n\t" \
  "add.cc.u32 r1, r1, r4;\n\t" \
  "addc.cc.u32 r2, r2, r5;\n\t" \
  "addc.cc.u32 r3, r3, 0;\n\t" \
  "addc.u32 c, 0, 0;\n\t" \
  "sub.cc.u32 r0, r0, g3;\n\t" \
  "subc.cc.u32 r1, r1, g4;\n\t" \
  "subc.cc.u32 r2, r2, 0;\n\t" \
  "subc.cc.u32 r3, r3, 0;\n\t" \
  "subc.u32 c, c, 0;\n\t" \
  /* fold 3 and canon */ \
  "add.cc.u32 r4, r0, 0xFFFFFFFF;\n\t" \
  "addc.cc.u32 r5, r1, 0x2CFF;\n\t" \
  "addc.cc.u32 r6, r2, 0;\n\t" \
  "addc.cc.u32 r7, r3, 0;\n\t" \
  "addc.u32 c, c, 0;\n\t" \
  "setp.ne.u32 q, c, 0;\n\t" \
  "selp.b32 %0, r4, r0, q;\n\t" \
  "selp.b32 %1, r5, r1, q;\n\t" \
  "selp.b32 %2, r6, r2, q;\n\t" \
  "selp.b32 %3, r7, r3, q;\n\t"

// mul32_c's steps in one asm block: the carry flag does not survive
// between asm statements.  Row i of the schoolbook adds a_i * b at word i
// as two chains, the low halves of the four products and their high
// halves one word up; the last fold and canon share one test: the result
// is v + eps when bit 128 was set or v + eps carries.
ZK_HD fe mul32(fe a, fe b) {
  uint32_t o[4];
  asm("{\n\t"
      ".reg .u32 r0, r1, r2, r3, r4, r5, r6, r7, g0, g1, g2, g3, g4, c;\n\t"
      ".reg .pred q;\n\t"
      "mul.lo.u32 r0, %4, %8;\n\t"
      "mul.lo.u32 r1, %4, %9;\n\t"
      "mul.lo.u32 r2, %4, %10;\n\t"
      "mul.lo.u32 r3, %4, %11;\n\t"
      "mad.hi.cc.u32 r1, %4, %8, r1;\n\t"
      "madc.hi.cc.u32 r2, %4, %9, r2;\n\t"
      "madc.hi.cc.u32 r3, %4, %10, r3;\n\t"
      "madc.hi.u32 r4, %4, %11, 0;\n\t"
      "mad.lo.cc.u32 r1, %5, %8, r1;\n\t"
      "madc.lo.cc.u32 r2, %5, %9, r2;\n\t"
      "madc.lo.cc.u32 r3, %5, %10, r3;\n\t"
      "madc.lo.cc.u32 r4, %5, %11, r4;\n\t"
      "addc.u32 r5, 0, 0;\n\t"
      "mad.hi.cc.u32 r2, %5, %8, r2;\n\t"
      "madc.hi.cc.u32 r3, %5, %9, r3;\n\t"
      "madc.hi.cc.u32 r4, %5, %10, r4;\n\t"
      "madc.hi.u32 r5, %5, %11, r5;\n\t"
      "mad.lo.cc.u32 r2, %6, %8, r2;\n\t"
      "madc.lo.cc.u32 r3, %6, %9, r3;\n\t"
      "madc.lo.cc.u32 r4, %6, %10, r4;\n\t"
      "madc.lo.cc.u32 r5, %6, %11, r5;\n\t"
      "addc.u32 r6, 0, 0;\n\t"
      "mad.hi.cc.u32 r3, %6, %8, r3;\n\t"
      "madc.hi.cc.u32 r4, %6, %9, r4;\n\t"
      "madc.hi.cc.u32 r5, %6, %10, r5;\n\t"
      "madc.hi.u32 r6, %6, %11, r6;\n\t"
      "mad.lo.cc.u32 r3, %7, %8, r3;\n\t"
      "madc.lo.cc.u32 r4, %7, %9, r4;\n\t"
      "madc.lo.cc.u32 r5, %7, %10, r5;\n\t"
      "madc.lo.cc.u32 r6, %7, %11, r6;\n\t"
      "addc.u32 r7, 0, 0;\n\t"
      "mad.hi.cc.u32 r4, %7, %8, r4;\n\t"
      "madc.hi.cc.u32 r5, %7, %9, r5;\n\t"
      "madc.hi.cc.u32 r6, %7, %10, r6;\n\t"
      "madc.hi.u32 r7, %7, %11, r7;\n\t"
      ZK_FOLD_PTX
      "}"
      : "=&r"(o[0]), "=&r"(o[1]), "=&r"(o[2]), "=&r"(o[3])
      : ZK_WORDS(a), ZK_WORDS(b));
  return ZK_JOIN(o);
}

// sqr32_c's steps in one asm block: the off-diagonal rows x0 (x1, x2, x3)
// at words 1-4, x1 (x2, x3) at 3-5 and x2 x3 at 5-6 (R < 2^224, so no
// carry leaves word 6), R doubled into r7..r1, the squares x_i^2 added at
// word 2i, then mul32's folds.
ZK_HD fe sqr32(fe a) {
  uint32_t o[4];
  asm("{\n\t"
      ".reg .u32 r0, r1, r2, r3, r4, r5, r6, r7, g0, g1, g2, g3, g4, c;\n\t"
      ".reg .pred q;\n\t"
      "mul.lo.u32 r1, %4, %5;\n\t"
      "mul.lo.u32 r2, %4, %6;\n\t"
      "mul.lo.u32 r3, %4, %7;\n\t"
      "mad.hi.cc.u32 r2, %4, %5, r2;\n\t"
      "madc.hi.cc.u32 r3, %4, %6, r3;\n\t"
      "madc.hi.u32 r4, %4, %7, 0;\n\t"
      "mad.lo.cc.u32 r3, %5, %6, r3;\n\t"
      "madc.lo.cc.u32 r4, %5, %7, r4;\n\t"
      "addc.u32 r5, 0, 0;\n\t"
      "mad.hi.cc.u32 r4, %5, %6, r4;\n\t"
      "madc.hi.u32 r5, %5, %7, r5;\n\t"
      "mad.lo.cc.u32 r5, %6, %7, r5;\n\t"
      "madc.hi.u32 r6, %6, %7, 0;\n\t"
      "add.cc.u32 r1, r1, r1;\n\t"
      "addc.cc.u32 r2, r2, r2;\n\t"
      "addc.cc.u32 r3, r3, r3;\n\t"
      "addc.cc.u32 r4, r4, r4;\n\t"
      "addc.cc.u32 r5, r5, r5;\n\t"
      "addc.cc.u32 r6, r6, r6;\n\t"
      "addc.u32 r7, 0, 0;\n\t"
      "mul.lo.u32 r0, %4, %4;\n\t"
      "mad.hi.cc.u32 r1, %4, %4, r1;\n\t"
      "madc.lo.cc.u32 r2, %5, %5, r2;\n\t"
      "madc.hi.cc.u32 r3, %5, %5, r3;\n\t"
      "madc.lo.cc.u32 r4, %6, %6, r4;\n\t"
      "madc.hi.cc.u32 r5, %6, %6, r5;\n\t"
      "madc.lo.cc.u32 r6, %7, %7, r6;\n\t"
      "madc.hi.u32 r7, %7, %7, r7;\n\t"
      ZK_FOLD_PTX
      "}"
      : "=&r"(o[0]), "=&r"(o[1]), "=&r"(o[2]), "=&r"(o[3])
      : ZK_WORDS(a));
  return ZK_JOIN(o);
}

// add and sub as 32-bit carry chains: a + b, then the sum + eps (= sum - p
// mod 2^128) where that is the value below p; a - b, then - eps (= + p)
// where it borrowed
ZK_HD fe add32(fe a, fe b) {
  uint32_t o[4];
  asm("{\n\t"
      ".reg .u32 s0, s1, s2, s3, c;\n\t"
      ".reg .pred q;\n\t"
      "add.cc.u32 s0, %4, %8;\n\t"
      "addc.cc.u32 s1, %5, %9;\n\t"
      "addc.cc.u32 s2, %6, %10;\n\t"
      "addc.cc.u32 s3, %7, %11;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "add.cc.u32 %0, s0, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %1, s1, 0x2CFF;\n\t"
      "addc.cc.u32 %2, s2, 0;\n\t"
      "addc.cc.u32 %3, s3, 0;\n\t"
      "addc.u32 c, c, 0;\n\t"
      "setp.eq.u32 q, c, 0;\n\t"
      "@q mov.b32 %0, s0;\n\t"
      "@q mov.b32 %1, s1;\n\t"
      "@q mov.b32 %2, s2;\n\t"
      "@q mov.b32 %3, s3;\n\t"
      "}"
      : "=&r"(o[0]), "=&r"(o[1]), "=&r"(o[2]), "=&r"(o[3])
      : ZK_WORDS(a), ZK_WORDS(b));
  return ZK_JOIN(o);
}

ZK_HD fe sub32(fe a, fe b) {
  uint32_t o[4];
  asm("{\n\t"
      ".reg .u32 m, e;\n\t"
      "sub.cc.u32 %0, %4, %8;\n\t"
      "subc.cc.u32 %1, %5, %9;\n\t"
      "subc.cc.u32 %2, %6, %10;\n\t"
      "subc.cc.u32 %3, %7, %11;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 e, m, 0x2CFF;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, e;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.u32 %3, %3, 0;\n\t"
      "}"
      : "=&r"(o[0]), "=&r"(o[1]), "=&r"(o[2]), "=&r"(o[3])
      : ZK_WORDS(a), ZK_WORDS(b));
  return ZK_JOIN(o);
}
#undef ZK_WORDS
#undef ZK_JOIN
#undef ZK_FOLD_PTX
#else
ZK_HD fe mul32(fe a, fe b) { return mul32_c(a, b); }
ZK_HD fe sqr32(fe a) { return sqr32_c(a); }

// add32 / sub32 on the host: the PTX chains' steps on 32-bit words
ZK_HD void words(fe v, uint32_t w[4]) {
  w[0] = (uint32_t)v.lo, w[1] = (uint32_t)(v.lo >> 32), w[2] = (uint32_t)v.hi,
  w[3] = (uint32_t)(v.hi >> 32);
}
ZK_HD fe join(const uint32_t w[4]) {
  return fe{(uint64_t)w[1] << 32 | w[0], (uint64_t)w[3] << 32 | w[2]};
}
constexpr uint32_t EPS_WORDS[4] = {0xFFFFFFFFu, 0x2CFFu, 0, 0};

ZK_HD fe add32(fe a, fe b) {
  uint32_t x[4], y[4], s[4], r[4];
  words(a, x), words(b, y);
  uint64_t t = 0;
  for (int i = 0; i < 4; ++i) s[i] = (uint32_t)(t = (uint64_t)x[i] + y[i] + (t >> 32));
  uint32_t c = (uint32_t)(t >> 32);
  t = 0;
  for (int i = 0; i < 4; ++i) r[i] = (uint32_t)(t = (uint64_t)s[i] + EPS_WORDS[i] + (t >> 32));
  c += (uint32_t)(t >> 32);
  return c ? join(r) : join(s);
}

ZK_HD fe sub32(fe a, fe b) {
  uint32_t x[4], y[4], d[4];
  words(a, x), words(b, y);
  int64_t t = 0;
  for (int i = 0; i < 4; ++i) d[i] = (uint32_t)(t = (int64_t)x[i] - y[i] + (t >> 32));
  const uint32_t m = (uint32_t)(t >> 32);  // 0, or all ones where it borrowed
  t = 0;
  for (int i = 0; i < 4; ++i) d[i] = (uint32_t)(t = (int64_t)d[i] - (EPS_WORDS[i] & m) + (t >> 32));
  return join(d);
}
#endif

// limb i of the element at p[i * stride] (16-bit values in uint32 words)
ZK_HD fe load(const uint32_t* p, long stride) {
  uint64_t lo = (uint64_t)p[0] | ((uint64_t)p[stride] << 16) |
                ((uint64_t)p[2 * stride] << 32) | ((uint64_t)p[3 * stride] << 48);
  uint64_t hi = (uint64_t)p[4 * stride] | ((uint64_t)p[5 * stride] << 16) |
                ((uint64_t)p[6 * stride] << 32) | ((uint64_t)p[7 * stride] << 48);
  return fe{lo, hi};
}

ZK_HD void store(uint32_t* p, long stride, fe v) {
  for (int i = 0; i < 4; ++i) {
    p[i * stride] = (uint32_t)((v.lo >> (16 * i)) & 0xFFFF);
    p[(4 + i) * stride] = (uint32_t)((v.hi >> (16 * i)) & 0xFFFF);
  }
}

}  // namespace zk
