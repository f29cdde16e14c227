// K2: BLAKE3-256 of every lane's row of C field elements.
//
// Replaces the TPU kernel zkvm/hash/blake3_t.py::_pallas_rows (:115;
// kernel _rows_kernel :93).  Input x is (C, 8, N) 16-bit limbs; lane n's
// message is its C elements as 16-byte little-endian encodings (word
// 4c + j = limb[2j] | limb[2j+1] << 16), hashed as one BLAKE3 chunk
// (winterfell hash_elements): ceil(C/4) compress blocks, CHUNK_START on the
// first, CHUNK_END | ROOT on the last, the last block's length C*16 mod 64
// (64 when that is 0).  Output (8, N) digest words.
//
// What bounds it on an H100: 32-bit integer ALU work (7 rounds x 8 G steps
// x 14 ops per 64-byte block); it reads 32 bytes per element and writes
// 32 per lane.  The design gives one thread one lane with the whole
// 16-word state and the message block in registers; with N minor, a
// warp's loads of one limb are 32 neighbouring words.
#include "zk_common.cuh"

namespace {

// (tables are function-local: device code cannot index namespace-scope arrays)
#define ZK_BLAKE3_IV                                                            \
  {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu, \
   0x1F83D9ABu, 0x5BE0CD19u}
constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kRoot = 8;

ZK_HD uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

ZK_HD void g(uint32_t* v, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  v[a] = v[a] + v[b] + mx;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + my;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

// cv <- first 8 words of compress(cv, m, counter 0, block_len, flags)
ZK_HD void compress(uint32_t* cv, const uint32_t* m_in, uint32_t block_len, uint32_t flags) {
  const uint32_t iv[8] = ZK_BLAKE3_IV;
  const int perm[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6],     cv[7],
                    iv[0], iv[1], iv[2], iv[3], 0u,    0u,    block_len, flags};
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = m_in[i];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {
      uint32_t t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = m[perm[i]];
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

}  // namespace

__global__ void blake3_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                   int C, long N) {
  const long n = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  uint32_t cv[8] = ZK_BLAKE3_IV;
  const int nblocks = C > 0 ? (C + 3) / 4 : 1;
  const long nbytes = 16L * C;
  for (int bi = 0; bi < nblocks; ++bi) {
    uint32_t m[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * bi + k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w = 0;
        if (c < C) {
          const uint32_t* p = x + ((long)c * 8 + 2 * j) * N + n;
          w = p[0] | (p[N] << 16);
        }
        m[4 * k + j] = w;
      }
    }
    const uint32_t flags = (bi == 0 ? kChunkStart : 0u) | (bi == nblocks - 1 ? (kChunkEnd | kRoot) : 0u);
    uint32_t blen = 64;
    if (bi == nblocks - 1 && nbytes % 64) blen = (uint32_t)(nbytes % 64);
    compress(cv, m, blen, flags);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * N + n] = cv[i];
}

// x: (C, 8, N) limbs -> out: (8, N) digest words
ZK_EXPORT int zk_blake3_rows(const uint32_t* x, uint32_t* out, int C, long N, void* stream) {
  const int threads = 128;
  const long blocks = (N + threads - 1) / threads;
  ZK_LAUNCH(blake3_rows_kernel, dim3((unsigned)blocks), dim3(threads), 0, stream, x, out, C, N);
  return ZK_LAST_ERROR();
}
