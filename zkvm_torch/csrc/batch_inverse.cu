// The batch inverse: every element of an (R, 8, N) limb tensor inverted,
// 0 -> 0.
//
// Replaces zkvm/field/jax_f128.py::batch_inverse (:310), Montgomery's
// trick in XLA (no Pallas): device work the reference left to the
// compiler.  The provers invert the composition's boundary denominators
// and the DEEP's x - z per class (the class prover, 16 calls a proof), the
// DEEP's three (8, D) denominators (mono) and the domain constants.
//
// Montgomery's trick, one thread a chunk: thread t of row r takes the K
// elements t, t + W, ..., t + (K-1) W of the row (W = ceil(N / K) threads
// a row; the last of them may take fewer), so for a fixed step the threads
// of a warp read neighbouring lanes, and each limb load is coalesced.  It
// packs each element to its four 32-bit words, replaces a zero by one
// (remembering it), forms the prefix products in registers, inverts the
// chunk's product by one exponentiation to p - 2 (127 squarings and 123
// multiplies: p - 2 = 2^128 - 45 * 2^40 - 1 has 124 one bits), and sweeps
// back with two multiplies an element.  It writes canonical 16-bit limbs,
// 0 where the input was 0: the unique inverse, the same bits as the
// reference and as the plain Fermat version (zkvm_torch/field/f128t.py).
//
// What bounds it on an H100: the multiplies.  The bound counts 3 an
// element (Montgomery's trick over the whole row); this kernel does
// 3 + 250 / K, ~19 at K = 16, against 64 bytes an element moved (32 read,
// 32 written).  A product tree over a block (one exponentiation a block)
// would bring it near 3; it is not done here.
#include "f128.cuh"

// elements a thread (K) and threads a block; other values are for the
// tests' emulation and for timing other shapes
#ifndef ZK_BINV_K
#define ZK_BINV_K 16
#endif
#ifndef ZK_BINV_THREADS
#define ZK_BINV_THREADS 256
#endif

namespace {

constexpr int kChunk = ZK_BINV_K, kThreads = ZK_BINV_THREADS;
static_assert(kChunk >= 1 && kChunk <= 32, "the zero flags of a chunk are one 32-bit word");
// p - 2 = 2^128 - 45 * 2^40 - 1, as its two 64-bit words
constexpr uint64_t kExpLo = 0xFFFFD2FFFFFFFFFFull, kExpHi = ~0ull;

// a^(p-2), square and multiply from the top bit (bit 127, set) down
ZK_HD zk::fe power_p_minus_2(zk::fe a) {
  zk::fe r = a;
  for (int b = 126; b >= 0; --b) {
    r = zk::mul32(r, r);
    const uint64_t w = b >= 64 ? kExpHi >> (b - 64) : kExpLo >> b;
    if (w & 1) r = zk::mul32(r, a);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
batch_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long R, long N, long W) {
  const long g = (long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= R * W) return;
  const long row = g / W, t = g % W;  // t < W <= N: element 0 is always there
  const uint32_t* src = in + row * 8 * N;
  uint32_t* dst = out + row * 8 * N;
  zk::fe pre[kChunk];  // pre[i] = the product of the chunk's elements 0..i
  uint32_t zeros = 0;
  zk::fe acc{1, 0};
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const long j = t + i * W;
    if (j < N) {
      zk::fe v = zk::load(src + j, N);
      if ((v.lo | v.hi) == 0) {
        zeros |= 1u << i;
        v = zk::fe{1, 0};
      }
      acc = i ? zk::mul32(acc, v) : v;
    }
    pre[i] = acc;
  }
  zk::fe inv = power_p_minus_2(acc);  // 1 / (the product of the chunk)
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    const long j = t + i * W;
    if (j < N) {
      const bool zero = (zeros >> i) & 1;
      // inv = 1 / pre[i] here: 1 / a_i = inv * pre[i-1], then inv *= a_i
      const zk::fe r = i ? zk::mul32(inv, pre[i - 1]) : inv;
      zk::store(dst + j, N, zero ? zk::fe{0, 0} : r);
      if (i && !zero) inv = zk::mul32(inv, zk::load(src + j, N));
    }
  }
}

}  // namespace

// in, out: (R, 8, N) limbs, contiguous; R, N >= 1.
ZK_EXPORT int zk_batch_inverse(const uint32_t* in, uint32_t* out, long R, long N, void* stream) {
  if (R < 1 || N < 1) return -1;
  const long W = (N + kChunk - 1) / kChunk;
  const long blocks = (R * W + kThreads - 1) / kThreads;
  ZK_LAUNCH(batch_inverse_kernel, dim3((unsigned)blocks), dim3(kThreads), 0, stream, in, out, R, N, W);
  return ZK_LAST_ERROR();
}
