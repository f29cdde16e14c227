// Elementwise f128 add, sub and mul over broadcast (..., 8, N) limb
// tensors: the port's field arithmetic (zkvm_torch/field/f128t.py fadd,
// fsub, fmul) on the card.
//
// Replaces zkvm/field/jax_f128t.py::fadd (:142), fsub (:148) and fmul
// (:192), which the reference never runs eagerly: XLA fuses them into the
// few kernels of each jit (the ladders, the DEEP sums, the FRI fold, the
// stage functions).  No Pallas kernel computes them.  In plain torch one
// fmul is ~150 kernel launches with ~50 bytes of int64 transients an input
// byte; here it is one launch and no transient.
//
// One thread an output element (a batch index and a lane): it reads the
// element's 8 limbs of each operand through that operand's strides (a
// broadcast axis has stride 0, so no operand is copied to the output's
// shape), packs them into a zk::fe, applies zk::add32 / sub32 / mul32
// (csrc/f128.cuh, the arithmetic of K1-K4) and writes the 8 canonical
// limbs.  The element axes arrive coalesced by the wrapper, innermost last,
// so neighbouring threads take neighbouring lanes and every limb row is
// read and written coalesced (or, for a stride-0 operand, as one
// broadcast word).  Index arithmetic is 64-bit throughout: the largest
// operand on a path is (28, 8, 2^23), 1.9e9 limbs.  An axis whose length
// is a power of two is split by shift and mask, any other by division.
//
// What bounds it on an H100: bytes.  An element moves 32 bytes for each
// operand read and 32 written (less for a broadcast operand), 96 bytes
// against 8 (add, sub) or 96 (mul) 32-bit operations by the bound's count:
// at 3.35 TB/s and 16.7 T int32 operations/s that is ~28.7 ps against
// 5.7 ps for a multiply, so even mul32's ~80 instructions fit under the
// memory time.  The design does the least for it: each limb is one 4-byte
// load (8 a limb row of an operand, a warp reading 128 contiguous bytes a
// row), with no staging in shared memory.
#include "f128.cuh"

// threads a block and the most blocks a launch (the threads then stride
// over the rest); other values are for the tests' emulation
#ifndef ZK_FOP_THREADS
#define ZK_FOP_THREADS 256
#endif
#ifndef ZK_FOP_MAX_BLOCKS
#define ZK_FOP_MAX_BLOCKS (1L << 30)
#endif

namespace {

constexpr int kThreads = ZK_FOP_THREADS;
constexpr long kMaxBlocks = ZK_FOP_MAX_BLOCKS;
constexpr int kMaxDims = 8;  // element axes after the wrapper coalesced them

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

// the launch's geometry, by value in the kernel's parameters: the element
// axes (outermost first), each with its length and the stride of a, b and
// the output along it; each operand's stride along the limb axis
struct Geometry {
  long size[kMaxDims];
  int shift[kMaxDims];  // log2 size where size is a power of two, else -1
  long stride[3][kMaxDims];
  long limb[3];
  long total;
  int nd;
};

template <int OP>
__global__ void __launch_bounds__(kThreads)
field_op_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                const Geometry g) {
  for (long e = (long)blockIdx.x * kThreads + threadIdx.x; e < g.total; e += (long)gridDim.x * kThreads) {
    long rest = e, oa = 0, ob = 0, oo = 0;
#pragma unroll
    for (int k = kMaxDims - 1; k >= 0; --k) {
      if (k >= g.nd) continue;
      long i;
      if (g.shift[k] >= 0) {
        i = rest & (g.size[k] - 1);
        rest >>= g.shift[k];
      } else {
        i = rest % g.size[k];
        rest /= g.size[k];
      }
      oa += i * g.stride[0][k];
      ob += i * g.stride[1][k];
      oo += i * g.stride[2][k];
    }
    const zk::fe x = zk::load(a + oa, g.limb[0]), y = zk::load(b + ob, g.limb[1]);
    const zk::fe r = OP == kAdd ? zk::add32(x, y) : OP == kSub ? zk::sub32(x, y) : zk::mul32(x, y);
    zk::store(out + oo, g.limb[2], r);
  }
}

}  // namespace

// op: 0 add, 1 sub, 2 mul.  nd element axes (1..8, outermost first) of
// lengths sizes[0..nd); strides: a host array of 3 (nd + 1) longs, for a,
// b and out in turn the limb axis's stride then each element axis's, in
// elements (0 along a broadcast axis).  Every length >= 1.
ZK_EXPORT int zk_field_op(int op, int nd, const long* sizes, const long* strides, const uint32_t* a,
                          const uint32_t* b, uint32_t* out, void* stream) {
  if (op < kAdd || op > kMul || nd < 1 || nd > kMaxDims) return -1;
  Geometry g{};
  g.nd = nd;
  g.total = 1;
  for (int k = 0; k < nd; ++k) {
    const long n = sizes[k];
    if (n < 1) return -1;
    g.size[k] = n;
    g.shift[k] = (n & (n - 1)) ? -1 : __builtin_ctzl(n);
    g.total *= n;
    for (int j = 0; j < 3; ++j) g.stride[j][k] = strides[j * (nd + 1) + 1 + k];
  }
  for (int j = 0; j < 3; ++j) g.limb[j] = strides[j * (nd + 1)];
  long blocks = (g.total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (op == kAdd) {
    ZK_LAUNCH(field_op_kernel<kAdd>, grid, block, 0, stream, a, b, out, g);
  } else if (op == kSub) {
    ZK_LAUNCH(field_op_kernel<kSub>, grid, block, 0, stream, a, b, out, g);
  } else {
    ZK_LAUNCH(field_op_kernel<kMul>, grid, block, 0, stream, a, b, out, g);
  }
  return ZK_LAST_ERROR();
}
