// BLAKE3's compression function on the card, shared by K2 (blake3_rows.cu)
// and the Merkle heap (merkle.cu).
//
// Only what the prover hashes: one chunk, counter 0, so a compress is
// cv <- first 8 words of compress(cv, m, 0, block_len, flags).  Each
// rotation is one instruction on the card: by 16 and 8 a byte permute
// (PRMT), by 12 and 7 a funnel shift (SHF); host_emu.h gives both
// intrinsics as plain shifts, so the host emulation runs this same code.
#pragma once

#include "zk_common.cuh"

namespace zk {
namespace b3 {

constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kRoot = 8;

// word i of BLAKE3's IV (a select chain: device code cannot index a
// namespace-scope table, and i is a constant wherever this is unrolled)
ZK_HD uint32_t iv(int i) {
  return i == 0 ? 0x6A09E667u : i == 1 ? 0xBB67AE85u : i == 2 ? 0x3C6EF372u : i == 3 ? 0xA54FF53Au
       : i == 4 ? 0x510E527Fu : i == 5 ? 0x9B05688Cu : i == 6 ? 0x1F83D9ABu : 0x5BE0CD19u;
}

// The intrinsics exist in device code and in the host emulation; nvcc's
// host pass, which never runs these, gets the plain shifts.
#if defined(__CUDA_ARCH__) || !defined(__CUDACC__)
#define ZK_B3_INTRINSICS 1
#endif

ZK_HD uint32_t rotr16(uint32_t x) {
#ifdef ZK_B3_INTRINSICS
  return __byte_perm(x, 0, 0x1032);
#else
  return (x >> 16) | (x << 16);
#endif
}
ZK_HD uint32_t rotr8(uint32_t x) {
#ifdef ZK_B3_INTRINSICS
  return __byte_perm(x, 0, 0x0321);
#else
  return (x >> 8) | (x << 24);
#endif
}
ZK_HD uint32_t rotr12(uint32_t x) {
#ifdef ZK_B3_INTRINSICS
  return __funnelshift_r(x, x, 12);
#else
  return (x >> 12) | (x << 20);
#endif
}
ZK_HD uint32_t rotr7(uint32_t x) {
#ifdef ZK_B3_INTRINSICS
  return __funnelshift_r(x, x, 7);
#else
  return (x >> 7) | (x << 25);
#endif
}

// the 32-bit word lo | hi << 16 of two 16-bit limbs held in 32-bit words
ZK_HD uint32_t pack_limbs(uint32_t lo, uint32_t hi) {
#ifdef ZK_B3_INTRINSICS
  return __byte_perm(lo, hi, 0x5410);
#else
  return lo | hi << 16;
#endif
}

ZK_HD void g(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, uint32_t mx, uint32_t my) {
  a = a + b + mx;
  d = rotr16(d ^ a);
  c = c + d;
  b = rotr12(b ^ c);
  a = a + b + my;
  d = rotr8(d ^ a);
  c = c + d;
  b = rotr7(b ^ c);
}

// cv <- the first 8 words of compress(cv, m, counter 0, block_len, flags)
ZK_HD void compress(uint32_t (&cv)[8], const uint32_t (&m_in)[16], uint32_t block_len, uint32_t flags) {
  const int perm[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
  // rows c and d: the IV's first half, the counter (0, 0), the length, the flags
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    iv(0), iv(1), iv(2), iv(3), 0u,    0u,    block_len, flags};
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = m_in[i];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(v[0], v[4], v[8], v[12], m[0], m[1]);
    g(v[1], v[5], v[9], v[13], m[2], m[3]);
    g(v[2], v[6], v[10], v[14], m[4], m[5]);
    g(v[3], v[7], v[11], v[15], m[6], m[7]);
    g(v[0], v[5], v[10], v[15], m[8], m[9]);
    g(v[1], v[6], v[11], v[12], m[10], m[11]);
    g(v[2], v[7], v[8], v[13], m[12], m[13]);
    g(v[3], v[4], v[9], v[14], m[14], m[15]);
    if (r < 6) {
      uint32_t tmp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) tmp[i] = m[perm[i]];
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = tmp[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[8 + i];
}

}  // namespace b3
}  // namespace zk
