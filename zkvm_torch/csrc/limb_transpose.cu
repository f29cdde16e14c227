// The trace's limb transpose: (C, N, 8) limbs -> (C, 8, N), one launch.
//
// Replaces no TPU kernel.  The reference turns its trace into the
// transposed layout on the host (zkvm/prover/pipeline.py:1199,
// np.swapaxes of the (28, T, 8) limbs before the device put), and the port
// did the same: a strided copy of 940 MB on one host thread at T = 2^20
// (about 1.1 s a proof with the card idle).  The prover now uploads the
// generator's (C, N, 8) limbs as they are and turns them here, on the
// card's stream, so the host copies nothing before the upload.
//
// A thread takes one element of one column (a block kThreads consecutive
// elements): it reads the element's 32 contiguous bytes as two 16-byte
// loads, so a warp's loads cover 1 KB of whole elements, and writes limb k
// to row k, so a warp's store to a row is 128 contiguous bytes.  No shared
// memory, nothing re-read.  (Two or four elements a thread, with their
// limbs stored together, measured no faster on an H100.)
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once, 2 x 32 bytes: 0.56 ms at (28, 2^20) and 0.035 ms at (28, 2^16) at
// 3.35 TB/s.  It does no arithmetic.
#include "zk_common.cuh"

#ifndef ZK_LT_THREADS
#define ZK_LT_THREADS 256
#endif

namespace {

constexpr int kThreads = ZK_LT_THREADS;
static_assert(kThreads >= 32 && kThreads % 32 == 0 && kThreads <= 1024, "whole warps a block");

struct alignas(16) u32x4 {
  uint32_t x, y, z, w;
};

__global__ void __launch_bounds__(kThreads)
    limb_transpose_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long N) {
  const long c = blockIdx.y;
  const long j = (long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  const u32x4* src = reinterpret_cast<const u32x4*>(in + 8 * (c * N + j));
  const u32x4 lo = src[0], hi = src[1];
  uint32_t* dst = out + 8 * c * N + j;
  dst[0] = lo.x, dst[N] = lo.y, dst[2 * N] = lo.z, dst[3 * N] = lo.w;
  dst[4 * N] = hi.x, dst[5 * N] = hi.y, dst[6 * N] = hi.z, dst[7 * N] = hi.w;
}

long blocks(long n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// out (C, 8, N) contiguous <- in (C, N, 8) contiguous: out[c][k][j] =
// in[c][j][k].  The input must start on a 16-byte boundary.  -1 with no
// launch for C outside 1..65535, N < 1 or a misaligned input.  One launch
// on the stream.
ZK_EXPORT int zk_limb_transpose(const uint32_t* in, uint32_t* out, int C, long N, void* stream) {
  if (C < 1 || C > 65535 || N < 1 || blocks(N) > 0x7fffffffL || reinterpret_cast<uintptr_t>(in) % 16) return -1;
  ZK_LAUNCH(limb_transpose_kernel, dim3((unsigned)blocks(N), (unsigned)C), dim3(kThreads), 0, stream, in, out, N);
  return ZK_LAST_ERROR();
}
