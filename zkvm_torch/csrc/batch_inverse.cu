// The batch inverse: every element of an (R, 8, N) limb tensor inverted,
// 0 -> 0.
//
// Replaces zkvm/field/jax_f128.py::batch_inverse (:310), Montgomery's
// trick in XLA (no Pallas): device work the reference left to the
// compiler.  The provers invert the DEEP's x - (z, z g, z^8) per class
// (T-mode and the class prover, 8 calls a proof), the class prover's
// boundary denominators per class (8 more), the DEEP's three (8, D)
// denominators (mono) and the domain constants.
//
// Montgomery's trick over a block, with a product tree.  Block b of a row
// takes the row's S = K * kThreads elements from b S on (the last block of
// the row fewer; no block spans two rows), its thread t the K elements
// b S + t + i kThreads, so for a fixed i the threads of a warp read
// neighbouring lanes and each limb load is coalesced.  A thread packs each
// element to its four 32-bit words, replaces a zero by one (remembering
// it), keeps the K values in registers and their prefix products in shared
// memory, and puts its chunk's product at a leaf of a tree there.  The
// up-sweep multiplies the tree level by level (one barrier a level); one
// thread inverts the root, the block's product, by an addition chain for
// p - 2 (127 squarings, 11 multiplies); the down-sweep gives every node its
// inverse, 1/left = 1/parent * right and 1/right = 1/parent * left.  Each
// thread then sweeps back over its chunk from 1 / (its chunk's product),
// two multiplies an element.  It writes canonical 16-bit limbs, 0 where the
// input was 0: the unique inverse, the same bits as the reference and as
// the plain Fermat version (zkvm_torch/field/f128t.py).
//
// What bounds it on an H100: 64 bytes an element moved (32 read once, 32
// written) against 3 multiplies an element by the bound's count; the two
// bounds are within 10% of each other.  This kernel does 3 + 138/S
// multiplies an element (3 - 3/K in the chunks, about 3/K in the tree; 3.13
// at K = 8 and 128 threads).  What holds it back is latency: one thread's
// 138 dependent multiplies of the exponentiation, while the rest of its
// block waits, are ~80% of a block's dependent chain (K prefix products,
// two sweeps of log2 kThreads levels, 2K back).  At a class's shapes (a few
// rows of 2^16) that chain is the time, so S = 1024 gives (3, 8, 2^16) 192
// blocks for the 132 SMs.  At the large shapes the blocks of a wave reach
// their exponentiations together, so the SM idles through them once a
// wave; more blocks an SM make fewer waves: the prefixes in shared memory
// (16 KB a block) leave 64 registers a thread, 8 blocks an SM.
#include "f128.cuh"

// elements a thread (K) and threads a block (a power of two); other values
// are for the tests' emulation and for timing other shapes
#ifndef ZK_BINV_K
#define ZK_BINV_K 8
#endif
#ifndef ZK_BINV_THREADS
#define ZK_BINV_THREADS 128
#endif

namespace {

constexpr int kChunk = ZK_BINV_K, kThreads = ZK_BINV_THREADS;
constexpr long kSpan = (long)kChunk * kThreads;  // elements a block
static_assert(kChunk >= 1 && kChunk <= 32, "the zero flags of a chunk are one 32-bit word");
static_assert(kThreads >= 1 && (kThreads & (kThreads - 1)) == 0, "the tree needs a power of two");

// x^(2^n), n squarings
ZK_HD zk::fe square_n(zk::fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = zk::mul32(x, x);
  return x;
}

// a^(p-2) = 1/a for a != 0.  p - 2 = 2^128 - 45 * 2^40 - 1 is, from the
// top, 82 one bits, the six bits 010010 (45..40) and 40 one bits.  With
// x_k = a^(2^k - 1) and x_(j+k) = x_j^(2^k) x_k: x_2, x_4, x_8, x_16, x_32,
// x_40 = x_32^(2^8) x_8, x_80 = x_40^(2^40) x_40 and x_82; then bits 45..40
// (two multiplies by a), and x_40 for the last 40 bits.  127 squarings and
// 11 multiplies, where square and multiply takes 127 and 123.
ZK_HD zk::fe power_p_minus_2(zk::fe a) {
  const zk::fe x2 = zk::mul32(square_n(a, 1), a);
  const zk::fe x4 = zk::mul32(square_n(x2, 2), x2);
  const zk::fe x8 = zk::mul32(square_n(x4, 4), x4);
  const zk::fe x16 = zk::mul32(square_n(x8, 8), x8);
  const zk::fe x32 = zk::mul32(square_n(x16, 16), x16);
  const zk::fe x40 = zk::mul32(square_n(x32, 8), x8);
  const zk::fe x80 = zk::mul32(square_n(x40, 40), x40);
  zk::fe r = zk::mul32(square_n(x80, 2), x2);  // bits 127..46
  r = zk::mul32(square_n(r, 2), a);            // bits 45, 44: 0 1
  r = zk::mul32(square_n(r, 3), a);            // bits 43..41: 0 0 1
  r = square_n(r, 1);                          // bit 40: 0
  return zk::mul32(square_n(r, 40), x40);      // bits 39..0
}

__global__ void __launch_bounds__(kThreads)
batch_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long N, long per_row) {
  // tree[1] is the root, tree[kThreads + t] thread t's leaf;
  // prefix[i * kThreads + t] the product of thread t's values 0..i
  __shared__ zk::fe tree[2 * kThreads], prefix[kChunk * kThreads];
  const int t = threadIdx.x;
  const long row = blockIdx.x / per_row;
  const long first = blockIdx.x % per_row * kSpan + t;
  const uint32_t* src = in + row * 8 * N;
  uint32_t* dst = out + row * 8 * N;
  zk::fe* const pre = prefix + t;
  zk::fe val[kChunk];  // the chunk's values, a zero as one
  uint32_t zeros = 0;
  zk::fe acc{1, 0};
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const long j = first + (long)i * kThreads;
    zk::fe v{1, 0};
    if (j < N) {
      v = zk::load(src + j, N);
      if ((v.lo | v.hi) == 0) {
        zeros |= 1u << i;
        v = zk::fe{1, 0};
      }
      acc = i ? zk::mul32(acc, v) : v;
    }
    val[i] = v;
    pre[i * kThreads] = acc;
  }
  tree[kThreads + t] = acc;
  __syncthreads();
  for (int n = kThreads / 2; n >= 1; n /= 2) {  // up: node v = n + t
    if (t < n) tree[n + t] = zk::mul32(tree[2 * (n + t)], tree[2 * (n + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = power_p_minus_2(tree[1]);
  __syncthreads();
  for (int n = 1; n < kThreads; n *= 2) {  // down: node v = n + t holds 1 / its product
    if (t < n) {
      const int v = n + t;
      const zk::fe inv = tree[v], left = tree[2 * v], right = tree[2 * v + 1];
      tree[2 * v] = zk::mul32(inv, right);
      tree[2 * v + 1] = zk::mul32(inv, left);
    }
    __syncthreads();
  }
  zk::fe inv = tree[kThreads + t];  // 1 / (the product of the chunk)
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    const long j = first + (long)i * kThreads;
    if (j < N) {
      // inv = 1 / pre[i] here: 1 / a_i = inv * pre[i-1], then inv *= a_i
      const zk::fe r = i ? zk::mul32(inv, pre[(i - 1) * kThreads]) : inv;
      zk::store(dst + j, N, (zeros >> i) & 1 ? zk::fe{0, 0} : r);
      if (i) inv = zk::mul32(inv, val[i]);
    }
  }
}

// The addition chain alone, one packed element a thread: out[i] =
// a[i]^(p-2).  Not on any path: it checks power_p_minus_2 (on the card and
// through the host emulation).
__global__ void power_probe(const zk::cell* __restrict__ a, zk::cell* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = zk::pack(power_p_minus_2(zk::unpack(a[i])));
}

}  // namespace

// in, out: (R, 8, N) limbs, contiguous; R, N >= 1.
ZK_EXPORT int zk_batch_inverse(const uint32_t* in, uint32_t* out, long R, long N, void* stream) {
  if (R < 1 || N < 1) return -1;
  const long per_row = (N + kSpan - 1) / kSpan;
  if (R > 0x7FFFFFFFL / per_row) return -1;  // one grid dimension
  ZK_LAUNCH(batch_inverse_kernel, dim3((unsigned)(R * per_row)), dim3(kThreads), 0, stream, in, out, N,
            per_row);
  return ZK_LAST_ERROR();
}

// a, out: n packed elements (16 bytes each)
ZK_EXPORT int zk_binv_power(const uint32_t* a, uint32_t* out, int n, void* stream) {
  constexpr int kProbeThreads = 128;
  if (n < 1) return -1;
  ZK_LAUNCH(power_probe, dim3((n + kProbeThreads - 1) / kProbeThreads), dim3(kProbeThreads), 0, stream,
            reinterpret_cast<const zk::cell*>(a), reinterpret_cast<zk::cell*>(out), n);
  return ZK_LAST_ERROR();
}
