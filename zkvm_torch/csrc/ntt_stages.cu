// K1: the constant-geometry (Pease) NTT stage network along axis M.
//
// Replaces the TPU kernel zkvm/ntt/ntt_t.py::_pallas_stages (:320; kernels
// _stages_kernel, _stages_kernel_full, _stages_kernel_r1, body
// _stages_in_kernel).  Input y is (B, M, 8, NL) 16-bit limbs, already
// permuted by the initial layout indices; all log2 M radix-2 stages run,
// each stage pairing rows p and p + M/2 (twiddle tw[s][p]) and writing the
// sum and difference to rows rotr(p, 1) and rotr(p + M/2, 1).  Variant 1
// first multiplies by a full (M, 8, NL) tensor (the four-step mid
// twiddles), variant 2 by the rank-1 tensor rs(8, M) x ls(8, NL) (the coset
// shift of class_ntt_t).
//
// What bounds it on an H100: 128-bit modular multiplies (each a dozen
// 64-bit multiplies) and the log2 M round trips of the whole block.  The
// design keeps one block's M x LT tile (2048 elements, packed to 16 bytes
// each) in shared memory, double-buffered, so device memory is read and
// written once per call whatever M is; the premultiply is applied while
// loading.  One block per (batch, lane tile).
#include "f128.cuh"

using zk::fe;

static constexpr int kTileElems = 2048;  // M * LT elements per block
static constexpr int kMaxThreads = 256;

__global__ void ntt_stages_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ tw,
                                  const uint32_t* __restrict__ pre,
                                  const uint32_t* __restrict__ rs,
                                  const uint32_t* __restrict__ ls, int M, int NL, int S,
                                  int LT, int variant) {
  ZK_DYN_SMEM(fe, buf);
  fe* src = buf;
  fe* dst = buf + M * LT;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long b = blockIdx.y;
  const long l0 = (long)blockIdx.x * LT;
  const int h = M / 2;

  for (int idx = tid; idx < M * LT; idx += nt) {
    const int m = idx / LT, l = idx % LT;
    fe v = zk::load(y + (b * M + m) * 8 * (long)NL + l0 + l, NL);
    if (variant == 1) {
      v = zk::mul(v, zk::load(pre + (long)m * 8 * NL + l0 + l, NL));
    } else if (variant == 2) {
      v = zk::mul(zk::mul(v, zk::load(rs + m, M)), zk::load(ls + l0 + l, NL));
    }
    src[idx] = v;
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    for (int idx = tid; idx < h * LT; idx += nt) {
      const int p = idx / LT, l = idx % LT;
      const fe a = src[p * LT + l];
      const fe bw = zk::mul(src[(p + h) * LT + l], zk::load(tw + ((long)s * h + p) * 8, 1));
      const int q = p + h;
      const int d0 = (p >> 1) | ((p & 1) << (S - 1));
      const int d1 = (q >> 1) | ((q & 1) << (S - 1));
      dst[d0 * LT + l] = zk::add(a, bw);
      dst[d1 * LT + l] = zk::sub(a, bw);
    }
    __syncthreads();
    fe* t = src;
    src = dst;
    dst = t;
  }

  for (int idx = tid; idx < M * LT; idx += nt) {
    const int m = idx / LT, l = idx % LT;
    zk::store(out + (b * M + m) * 8 * (long)NL + l0 + l, NL, src[idx]);
  }
}

// y, out: (B, M, 8, NL); tw: (S, M/2, 8) with S = log2 M; pre: (M, 8, NL)
// for variant 1; rs: (8, M) and ls: (8, NL) for variant 2.  M and NL are
// powers of two.
ZK_EXPORT int zk_ntt_stages(const uint32_t* y, uint32_t* out, const uint32_t* tw,
                            const uint32_t* pre, const uint32_t* rs, const uint32_t* ls,
                            int B, int M, int NL, int S, int variant, void* stream) {
  int LT = kTileElems / M;
  if (LT < 1) LT = 1;
  if (LT > NL) LT = NL;
  const int pairs = (M / 2) * LT;
  const int nt = pairs < kMaxThreads ? pairs : kMaxThreads;
  const size_t smem = 2 * (size_t)M * LT * sizeof(fe);
  ZK_SET_SMEM(ntt_stages_kernel, (int)smem);
  dim3 grid(NL / LT, B);
  ZK_LAUNCH(ntt_stages_kernel, grid, dim3(nt), smem, stream, y, out, tw, pre, rs, ls, M, NL, S,
            LT, variant);
  return ZK_LAST_ERROR();
}
