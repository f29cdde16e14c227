// f128 field arithmetic for the zkvm_torch kernels.
//
// p = 2^128 - eps with eps = 2^128 mod p = 45*2^40 - 1 (< 2^46).  A field
// element lives in registers as two 64-bit words; in memory it is the
// reference's 8 little-endian 16-bit limbs, one per uint32 (the
// transposed (..., 8, N) layout: limb i at offset i*stride).  Every
// function takes and returns canonical values (< p), so results are the
// same bits as zkvm_torch/field/f128t.py and the JAX reference.
#pragma once

#include "zk_common.cuh"

namespace zk {

struct fe {
  uint64_t lo, hi;
};

constexpr uint64_t EPS = 45ull * (1ull << 40) - 1;

ZK_HD uint64_t mulhi(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// value < 2^128 -> canonical (subtract p once if value >= p; x - p equals
// x + eps - 2^128, so add eps and keep the sum where it overflows)
ZK_HD fe canon(uint64_t lo, uint64_t hi) {
  uint64_t tlo = lo + EPS;
  uint64_t c = tlo < lo;
  uint64_t thi = hi + c;
  bool ge = c & (thi == 0);
  return ge ? fe{tlo, thi} : fe{lo, hi};
}

ZK_HD fe add(fe a, fe b) {
  uint64_t lo = a.lo + b.lo;
  uint64_t c = lo < a.lo;
  uint64_t hi = a.hi + b.hi;
  uint64_t c1 = hi < a.hi;
  hi += c;
  c1 |= hi < c;  // carry out of bit 128
  uint64_t tlo = lo + EPS;
  uint64_t d = tlo < lo;
  uint64_t thi = hi + d;
  uint64_t c2 = d & (thi == 0);
  return (c1 | c2) ? fe{tlo, thi} : fe{lo, hi};
}

ZK_HD fe sub(fe a, fe b) {
  uint64_t lo = a.lo - b.lo;
  uint64_t bw = a.lo < b.lo;
  uint64_t hi = a.hi - b.hi - bw;
  bool neg = (a.hi < b.hi) | ((a.hi == b.hi) & bw);
  if (neg) {  // + p == - eps (mod 2^128)
    uint64_t b3 = lo < EPS;
    lo -= EPS;
    hi -= b3;
  }
  return fe{lo, hi};
}

ZK_HD fe mul(fe a, fe b) {
  // 256-bit product r3 r2 r1 r0
  uint64_t r0 = a.lo * b.lo;
  uint64_t r1 = mulhi(a.lo, b.lo);
  uint64_t p01l = a.lo * b.hi, p01h = mulhi(a.lo, b.hi);
  uint64_t p10l = a.hi * b.lo, p10h = mulhi(a.hi, b.lo);
  uint64_t p11l = a.hi * b.hi, p11h = mulhi(a.hi, b.hi);
  uint64_t k = 0;
  r1 += p01l;
  k += r1 < p01l;
  r1 += p10l;
  k += r1 < p10l;
  uint64_t r2 = p01h + k;
  uint64_t k2 = r2 < k;
  r2 += p10h;
  k2 += r2 < p10h;
  r2 += p11l;
  k2 += r2 < p11l;
  uint64_t r3 = p11h + k2;
  // fold 1: (r3 r2) * 2^128 == (r3 r2) * eps; result w2:w1:w0 < 2^175
  uint64_t m0l = r2 * EPS, m0h = mulhi(r2, EPS);
  uint64_t m1l = r3 * EPS, m1h = mulhi(r3, EPS);
  uint64_t w0 = r0 + m0l;
  uint64_t c = w0 < m0l;
  uint64_t w1 = r1 + c;
  uint64_t cc = w1 < c;
  w1 += m0h;
  cc += w1 < m0h;
  w1 += m1l;
  cc += w1 < m1l;
  uint64_t w2 = m1h + cc;  // < 2^47
  // fold 2: w2 * 2^128 == w2 * eps (< 2^93); leaves a carry bit
  uint64_t ql = w2 * EPS, qh = mulhi(w2, EPS);
  uint64_t v0 = w0 + ql;
  c = v0 < ql;
  uint64_t v1 = w1 + qh;
  uint64_t top = v1 < qh;
  v1 += c;
  top += v1 < c;
  // folds 3 and 4: the carry bit is one more eps
  for (int i = 0; i < 2; ++i) {
    uint64_t e = EPS & (0 - top);
    v0 += e;
    c = v0 < e;
    v1 += c;
    top = v1 < c;
  }
  return canon(v0, v1);
}

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
