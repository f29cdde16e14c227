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
// x 12 ops, and 8 output xors, per 64-byte block; 4 byte permutes per
// element to pack its limbs); it reads 32 bytes per element and writes 32
// per lane.  A lane's blocks are a chain of compresses, so the design
// keeps the ALU fed while the next block's words travel: a thread issues
// the loads of block bi + 1 (into registers) before it compresses block
// bi.  With N minor, a warp's loads of one limb are neighbouring words,
// and two limbs become a message word in one byte permute.  One thread
// hashes one lane: splitting a lane's compress over 2 or 4 threads of a
// warp (a column of the state a thread, the diagonal step's rows by warp
// shuffles) gave more warps at N = 2^16 but was 10-26% (2 threads) and
// 56-74% (4) slower at N = 2^16 and 2^19 on an H100, the message selects
// and shuffles costing more than the warps gained.  The shipped shape is
// 256 threads a block, 2 blocks an SM (kernel_bench.py --sweep K2).
#include "blake3.cuh"

#ifndef ZK_K2_THREADS
#define ZK_K2_THREADS 256  // threads a block
#endif
#ifndef ZK_K2_MIN_BLOCKS
#define ZK_K2_MIN_BLOCKS 2  // blocks an SM, for __launch_bounds__ (104 registers, no spill)
#endif

namespace {

// message block bi of lane n: elements 4 bi .. 4 bi + 3 (zero past C, and
// for an idle thread)
ZK_HD void load_block(uint32_t (&m)[16], const uint32_t* __restrict__ x, int bi, int C, long N, long n,
                      bool live) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * bi + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t w = 0;
      if (live && c < C) {
        const uint32_t* p = x + ((long)c * 8 + 2 * j) * N + n;
        w = zk::b3::pack_limbs(p[0], p[N]);
      }
      m[4 * k + j] = w;
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(ZK_K2_THREADS, ZK_K2_MIN_BLOCKS)
    blake3_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int C, long N) {
  const long n = (long)blockIdx.x * ZK_K2_THREADS + threadIdx.x;
  // an idle thread (past N) hashes zeros and stores nothing: with an early
  // return instead, ptxas holds the kernel to 64 registers and it runs
  // 1.4-1.8x slower (256 threads a block, H100; kernel_bench.py --sweep K2)
  const bool live = n < N;
  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = zk::b3::iv(i);
  const int nblocks = C > 0 ? (C + 3) / 4 : 1;
  const long nbytes = 16L * C;
  uint32_t cur[16], nxt[16];
  load_block(cur, x, 0, C, N, n, live);
  for (int bi = 0; bi < nblocks; ++bi) {
    load_block(nxt, x, bi + 1, C, N, n, live);  // all zero past the last block
    const uint32_t flags = (bi == 0 ? zk::b3::kChunkStart : 0u) |
                           (bi == nblocks - 1 ? (zk::b3::kChunkEnd | zk::b3::kRoot) : 0u);
    uint32_t blen = 64;
    if (bi == nblocks - 1 && nbytes % 64) blen = (uint32_t)(nbytes % 64);
    zk::b3::compress(cv, cur, blen, flags);
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i * N + n] = cv[i];
  }
}

// x: (C, 8, N) limbs -> out: (8, N) digest words
ZK_EXPORT int zk_blake3_rows(const uint32_t* x, uint32_t* out, int C, long N, void* stream) {
  const long blocks = (N + ZK_K2_THREADS - 1) / ZK_K2_THREADS;
  ZK_LAUNCH(blake3_rows_kernel, dim3((unsigned)blocks), dim3(ZK_K2_THREADS), 0, stream, x, out, C, N);
  return ZK_LAST_ERROR();
}
