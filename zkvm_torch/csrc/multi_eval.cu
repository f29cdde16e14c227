// Multi-point evaluation: rows[q][c] = sum_t coeffs[c][t] * pt_q^t mod p,
// the C committed column polynomials at Q points
// (zkvm_torch/prover/multi_eval.py), on the int8 tensor cores.
//
// Replaces zkvm/prover/eval_mxu.py::_contract (:45), multi_eval_rows (:80)
// and its ladders (_ladders, :72), device work the reference left to XLA
// (no Pallas): it builds the (Q, 8, T) ladders, splits every element into
// 32 signed nibbles (the TPU's matrix unit takes only s8), runs the
// (C 32, T) x (T, Q 32) product as one int8 dot_general, sums the 63
// anti-diagonal buckets on the device, and recombines sum_k bucket_k 16^k
// mod p on the host.  The provers call it four times a proof: the OOD
// frame (28 trace columns at z and z g, the 8 composition columns at z^8)
// and the query rows (28 and 8 columns at up to 32 points).
//
// Here Hopper's mma.sync takes unsigned bytes, so an element is 16 byte
// digits, and the points come as the two factors of their ladders,
// pt^t = l1[t mod S] l2[t div S] (S a power of two, S N2 >= T; the
// wrapper takes ntt_t.ladders_split's S, about sqrt T).  The sum reorders
// to
//   rows[q][c] = sum_hi l2[q][hi] (sum_lo coeffs[c][hi S + lo] l1[q][lo]),
// and the inner sum is a u8 GEMM over K = lo < S: A, the coefficients'
// bytes, one 16-row group (an m16 tile) for each (c, hi); B, the bytes of
// l1, 16 rows a point (two n8 tiles).  A product of two bytes is at most
// 255^2, so the s32 sums are exact while S <= 2^15 (the entry refuses
// more), against the reference's T <= 2^23.
//
// Launch 1 (meval_mma_kernel): a block takes kMG groups of one column
// (kMG consecutive hi: a slice) and a tile of NQ points (16 for 3 points or
// more over 8 warps; the OOD's one or two points their own tiles, so a
// block carries no empty columns), and walks K in chunks of kKC, kStages
// - 1 of them in flight by cp.async: the coefficients' limb rows as they
// lie in device memory (16-bit limbs in 32-bit words; padded rows, so the
// fragment loads meet no bank conflict) and B's byte rows (16-byte chunks
// swizzled for the same).  Each warp holds kWM groups x WQ points of s32
// sums; a lane's A fragment is two 16-byte loads of one limb row split
// into its low and high bytes by four byte permutes (rows 0-7 of a group
// are limbs 0-7's low bytes, rows 8-15 their high bytes), its B fragment
// one 8-byte load (the contraction index of mma's k slot 4t + e is t's
// 8t + e, of 16 + 4t + e 8t + 4 + e, the same for A and B, so both loads
// are contiguous).  Then each (c, hi, q) tile's 16 x 16 sums G[i][j] go to
// shared memory; four threads a tile, one a quarter of its columns, form
// the anti-diagonal buckets of the digit weights (row i byte e(i), column
// j byte j) in 64 bits, join them into a value below 2^181 and reduce it
// mod p (fold256, times 2^(32 x) for quarter x); a thread a tile adds the
// quarters and multiplies by l2[q][hi], and the block adds its kMG groups:
// work[slice][q][c].  Launch 2 (a warp a pair) adds the slices' partials
// and writes the canonical limbs (Q, C, 8).  The slices fill the card at
// every shape (896 blocks at (28, 2, 2^16)).
//
// The ladder operands come from zk_meval_ladders: B's byte matrix (Q 16,
// ldb), byte j of l1[q][lo] at row 16 q + j, zeros past S, and l2 as
// packed cells.  A block takes one point and a tile of one factor, a warp
// 32 L consecutive outputs: each warp runs one squaring chain of the
// point (zk::sqr32, 10 limb products), its lanes multiplying their power
// by each level their exponent's bits name as the chain passes it, off
// the chain's critical path; each next output is one multiply.  Its floor
// is the launch and the ~log2 T dependent squarings of the chain (the
// bound, a multiply an output, is far below it).
//
// What bounds it on an H100: bytes.  The coefficients are read once from
// device memory, C T 32 bytes (0.94 GB, 0.28 ms at 3.35 TB/s for 28
// columns at 2^20), against 2 (16 C)(16 Q) T int8 operations (0.24 ms at
// 1,979 T/s for 32 points).  What the design pays beyond that: each point
// tile re-reads its block's coefficients from L2, and each block the
// ladder bytes (1.9 GB each from L2 at that shape); a lane's A fragment
// costs 32 bytes of shared memory for 16 of digits, and mma.sync issues
// from registers a warp at a time (wgmma / TMA is the later step).
#include "f128.cuh"

// a block's tile: kWM groups (m16 tiles) a warp, kBM warps along the
// groups; for 3 points or more ZK_MEVAL_WQ points a warp, ZK_MEVAL_BN
// warps along the points; ZK_MEVAL_KC t a chunk (32 or 64).  Other values
// are for the tests' emulation and for timing other shapes.
#ifndef ZK_MEVAL_WM
#define ZK_MEVAL_WM 2
#endif
#ifndef ZK_MEVAL_BM
#define ZK_MEVAL_BM 4
#endif
#ifndef ZK_MEVAL_WQ
#define ZK_MEVAL_WQ 8
#endif
#ifndef ZK_MEVAL_BN
#define ZK_MEVAL_BN 2
#endif
#ifndef ZK_MEVAL_KC
#define ZK_MEVAL_KC 64
#endif

namespace {

constexpr int kWM = ZK_MEVAL_WM;
constexpr int kBM = ZK_MEVAL_BM;
constexpr int kMG = kWM * kBM;      // groups (hi) a block
constexpr int kKC = ZK_MEVAL_KC;
constexpr int kStages = 4;         // cp.async stages: kStages - 1 chunks in flight
constexpr int kSplit = 4;           // threads a tile in the epilogue, 4 columns each
constexpr int kRowWords = kKC + 4;  // an A limb row in shared memory
constexpr int kTileWords = 16 * 16 + 4;  // an epilogue tile of sums
constexpr long kMaxS = 1L << 15;    // 255^2 S < 2^31
constexpr long kLdbAlign = 64;      // B's row bytes: a multiple of every kKC
constexpr int kSumThreads = 32;     // launch 2's block: a warp
static_assert(kKC == 32 || kKC == 64, "a chunk is one or two k32 steps");
static_assert(kWM >= 1 && kBM >= 1, "a block has groups");

struct alignas(16) u32x4 {
  uint32_t x, y, z, w;
};
struct alignas(8) u32x2 {
  uint32_t x, y;
};

template <int WQ, int BN>
struct Tile {
  static constexpr int kNQ = WQ * BN;  // points a block
  static constexpr int kThreads = 32 * kBM * BN;
  static constexpr int kAStage = kMG * 8 * kRowWords * 4;  // bytes
  static constexpr int kBStage = kNQ * 16 * kKC;
  static constexpr int kPipe = kStages * (kAStage + kBStage);
  static constexpr int kEpi = kMG * kNQ * kTileWords * 4;
  static constexpr int kSmem = kPipe > kEpi ? kPipe : kEpi;
};

// the 16-byte chunk of B row r that holds chunk x: swizzled at kKC = 64 so
// that a half-warp's 8-byte loads (rows g, g + 1, g + 2, g + 3) fall in
// distinct banks
__device__ __forceinline__ int b_chunk(int row, int x) { return kKC == 64 ? x ^ (((row >> 1) & 1) << 1) : x; }

// the low and the high bytes of four 16-bit limbs (in 32-bit words), each
// packed into one word, first limb lowest
__device__ __forceinline__ void limb_bytes(const u32x4& w, uint32_t& lo, uint32_t& hi) {
  const uint32_t p01 = __byte_perm(w.x, w.y, 0x5140), p23 = __byte_perm(w.z, w.w, 0x5140);
  lo = __byte_perm(p01, p23, 0x5410);
  hi = __byte_perm(p01, p23, 0x7632);
}

// launch 1: block (point tile, column, slice) -> work[slice][q][c], the sum
// over the slice's kMG hi of l2[q][hi] sum_lo coeffs[c][hi S + lo] l1[q][lo]
template <int WQ, int BN>
__global__ void __launch_bounds__(32 * kBM * BN)
meval_mma_kernel(const uint32_t* __restrict__ coeffs, const uint8_t* __restrict__ l1d, long ldb,
                 const zk::cell* __restrict__ l2, zk::cell* __restrict__ work, int C, int Q, long T, long S,
                 long N2, int qtiles, bool aligned) {
  using P = Tile<WQ, BN>;
  constexpr int NQ = P::kNQ, NT = P::kThreads;
  ZK_DYN_SMEM(unsigned char, smem);
  __shared__ zk::cell part[kMG * NQ][kSplit], zs[kMG][NQ];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // the lane's groupID and threadID_in_group
  const int wm = warp % kBM, wn = warp / kBM;
  const long blk = blockIdx.x;
  const int q0 = (int)(blk % qtiles) * NQ;
  const int c = (int)(blk / qtiles % C);
  const long slice = blk / qtiles / C, hi0 = slice * kMG;
  const long chunks = (S + kKC - 1) / kKC;

  // chunk kc of the block's A (its groups' limb rows, zeros past S and T)
  // and B (its points' byte rows, zeros past Q) into stage buf
  auto load = [&](int buf, long kc) {
    uint32_t* as = reinterpret_cast<uint32_t*>(smem + buf * (P::kAStage + P::kBStage));
    uint8_t* bs = smem + buf * (P::kAStage + P::kBStage) + P::kAStage;
    if (aligned) {  // T and S multiples of 4: a 16-byte chunk lies wholly inside or outside
      for (int i = tid; i < kMG * 8 * (kKC / 4); i += NT) {
        const int x = i % (kKC / 4), l = i / (kKC / 4) % 8, m = i / (8 * (kKC / 4));
        const long lo = kc * kKC + 4 * x, t = (hi0 + m) * S + lo;
        const bool ok = lo < S && t < T;
        zk::cp_async16(as + (m * 8 + l) * kRowWords + 4 * x, ok ? coeffs + ((long)c * 8 + l) * T + t : coeffs,
                       ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kMG * 8 * kKC; i += NT) {
        const int x = i % kKC, l = i / kKC % 8, m = i / (8 * kKC);
        const long lo = kc * kKC + x, t = (hi0 + m) * S + lo;
        const bool ok = lo < S && t < T;
        zk::cp_async4(as + (m * 8 + l) * kRowWords + x, ok ? coeffs + ((long)c * 8 + l) * T + t : coeffs,
                      ok ? 4 : 0);
      }
    }
    for (int i = tid; i < NQ * 16 * (kKC / 16); i += NT) {
      const int x = i % (kKC / 16), row = i / (kKC / 16);
      const bool ok = q0 + row / 16 < Q;
      zk::cp_async16(bs + row * kKC + 16 * b_chunk(row, x),
                     ok ? l1d + ((long)q0 * 16 + row) * ldb + kc * kKC + 16 * x : l1d, ok ? 16 : 0);
    }
  };

  int32_t acc[kWM][2 * WQ][4];  // [group][point p, n8 tile h: 2 p + h][fragment]
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int n = 0; n < 2 * WQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

  // kStages - 1 chunks in flight ahead of the one in use; the barrier at
  // the top of step kc also ends every warp's use of chunk kc - 1, whose
  // stage then takes chunk kc + kStages - 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) load(st, st);
    zk::cp_async_commit();
  }
  for (long kc = 0; kc < chunks; ++kc) {
    zk::cp_async_wait<kStages - 2>();  // chunk kc's copies are in
    __syncthreads();
    if (kc + kStages - 1 < chunks) load((int)((kc + kStages - 1) % kStages), kc + kStages - 1);
    zk::cp_async_commit();
    const unsigned char* stage = smem + (kc % kStages) * (P::kAStage + P::kBStage);
    const uint32_t* as = reinterpret_cast<const uint32_t*>(stage);
    const uint8_t* bs = stage + P::kAStage;
#pragma unroll
    for (int s = 0; s < kKC / 32; ++s) {
      uint32_t a[kWM][4], b[2 * WQ][2];
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
        const uint32_t* r = as + ((wm * kWM + i) * 8 + g) * kRowWords + 32 * s + 8 * t4;
        limb_bytes(*reinterpret_cast<const u32x4*>(r), a[i][0], a[i][1]);
        limb_bytes(*reinterpret_cast<const u32x4*>(r + 4), a[i][2], a[i][3]);
      }
#pragma unroll
      for (int p = 0; p < WQ; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wn * WQ + p) * 16 + 8 * h + g;
          const u32x2 v = *reinterpret_cast<const u32x2*>(bs + row * kKC + 16 * b_chunk(row, 2 * s + t4 / 2) +
                                                          8 * (t4 & 1));
          b[2 * p + h][0] = v.x;
          b[2 * p + h][1] = v.y;
        }
      zk::mma_u8(acc, a, b);
    }
  }
  zk::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages before the tiles take them

  // the tiles' sums G[i][j] (row i of the group, byte j of the point) into
  // shared memory, over the stages
  int32_t* tiles = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int p = 0; p < WQ; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int32_t* tile = tiles + ((wm * kWM + i) * NQ + wn * WQ + p) * kTileWords + 8 * h + 2 * t4;
        tile[g * 16] = acc[i][2 * p + h][0];
        tile[g * 16 + 1] = acc[i][2 * p + h][1];
        tile[(g + 8) * 16] = acc[i][2 * p + h][2];
        tile[(g + 8) * 16 + 1] = acc[i][2 * p + h][3];
      }
  __syncthreads();
  // kSplit threads a tile, thread x (the same x across a warp) over
  // columns 4x .. 4x + 3: its buckets d = e(i) + j - 4x (row i < 8 is limb
  // i's low byte, byte e(i) = 2 i; row i >= 8 limb i - 8's high byte), at
  // most 4 terms of up to 255^2 S < 2^31 each, so below 2^33; its value
  // sum_d bk[d] 2^(8 d) < 2^181 mod p, times 2^(32 x)
  for (int k = tid; k < kSplit * kMG * NQ; k += NT) {
    const int x = k / (kMG * NQ), tile = k % (kMG * NQ);
    const int32_t* sums = tiles + tile * kTileWords + 4 * x;
    uint64_t bk[20];
#pragma unroll
    for (int d = 0; d < 20; ++d) bk[d] = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = i < 8 ? 2 * i : 2 * (i - 8) + 1;
      const u32x4 v = *reinterpret_cast<const u32x4*>(sums + i * 16);
      bk[e] += v.x;
      bk[e + 1] += v.y;
      bk[e + 2] += v.z;
      bk[e + 3] += v.w;
    }
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint64_t carry = 0;
#pragma unroll
    for (int v = 0; v < 5; ++v) {  // four buckets a word, each word's sum below 2^58
      carry += bk[4 * v] + (bk[4 * v + 1] << 8) + (bk[4 * v + 2] << 16) + (bk[4 * v + 3] << 24);
      w[v] = (uint32_t)carry;
      carry >>= 32;
    }
    w[5] = (uint32_t)carry;
    const zk::fe shift{x < 2 ? 1ull << (32 * x) : 0, x < 2 ? 0 : 1ull << (32 * x - 64)};  // 2^(32 x)
    part[tile][x] = zk::pack(zk::mul32(zk::fold256(w), shift));
  }
  __syncthreads();
  for (int k = tid; k < kMG * NQ; k += NT) {
    const int m = k / NQ, qq = k % NQ;
    const long hi = hi0 + m;
    const int q = q0 + qq;
    zk::fe z{0, 0};
    if (hi * S < T && q < Q) {
      zk::fe y = zk::unpack(part[k][0]);
#pragma unroll
      for (int x = 1; x < kSplit; ++x) y = zk::add32(y, zk::unpack(part[k][x]));
      z = zk::mul32(y, zk::unpack(l2[(long)q * N2 + hi]));
    }
    zs[m][qq] = zk::pack(z);
  }
  __syncthreads();
  for (int qq = tid; qq < NQ; qq += NT) {
    zk::fe sum{0, 0};
#pragma unroll
    for (int m = 0; m < kMG; ++m) sum = zk::add32(sum, zk::unpack(zs[m][qq]));
    if (q0 + qq < Q) work[(slice * Q + q0 + qq) * C + c] = zk::pack(sum);
  }
}

// launch 2: block p (pair q C + c) -> out[p] (8 limbs), the sum of the
// pair's partials over the slices, by a tree in shared memory
__global__ void __launch_bounds__(kSumThreads)
meval_sum_kernel(const zk::cell* __restrict__ work, uint32_t* __restrict__ out, long pairs, long slices) {
  __shared__ zk::cell red[kSumThreads];
  const int tid = threadIdx.x;
  const long p = blockIdx.x;
  zk::fe acc{0, 0};
  for (long s = tid; s < slices; s += kSumThreads) acc = zk::add32(acc, zk::unpack(work[s * pairs + p]));
  red[tid] = zk::pack(acc);
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] = zk::pack(zk::add32(zk::unpack(red[tid]), zk::unpack(red[tid + half])));
    __syncthreads();
  }
  if (tid == 0) zk::store(out + 8 * p, 1, zk::unpack(red[0]));
}

// the ladder kernel: ZK_MLAD_THREADS threads a block, ZK_MLAD_LANES
// outputs a thread (a tile of a multiple of 64 outputs a block); a warp of
// 4 outputs a thread was the best shape of kernel_bench.py --sweep MLAD on
// an H100 (at 32 points and 2^20 lanes; within 0.0002 ms of the others
// elsewhere).  Other values are for the tests' emulation and for timing
// other shapes
#ifndef ZK_MLAD_THREADS
#define ZK_MLAD_THREADS 32
#endif
#ifndef ZK_MLAD_LANES
#define ZK_MLAD_LANES 4
#endif
constexpr int kLadThreads = ZK_MLAD_THREADS;
constexpr int kLadLanes = ZK_MLAD_LANES;
constexpr int kLadTile = kLadThreads * kLadLanes;  // outputs of one factor a block
static_assert(kLadThreads % 32 == 0 && kLadLanes >= 1, "whole warps");
static_assert(kLadTile % kLdbAlign == 0, "a tile of l1 is whole 16-byte vectors of each byte row");

ZK_HD int bit_length(long v) {
  int n = 0;
  for (; v > 0; v >>= 1) ++n;
  return n;
}

// block (q, tile) -> one tile of kLadTile outputs k0 + i of one factor of
// point q: of l1, the 16 bytes of bases[q]^k (zeros from k = S on) down
// column k of rows 16 q .. 16 q + 15; of l2, l2[q][k] = bases[q]^(S k).
// With b = bases[q]^(2^e0) (e0 = 0 for l1, log2 S for l2), an output is
// b^k.  Thread t of warp w takes k = k0 + 32 (w L + l) + t, l < L.  Each
// warp squares the base itself, every lane alike, up to the levels its
// outputs need (no table, no barrier, no warp waiting for another): at
// level e0 + i, i < 5, the lanes with bit i of t multiply their power by
// it (a select: the bits differ across the warp), at e0 + 5 + i the warp
// does where bit i of its k / 32 is set (the same across the warp), each
// multiply off the chain's critical path, so a warp's first output is
// ready one multiply after its last squaring; each next output is one
// multiply by b^32.  l1's bytes are staged in shared memory and written
// as 16-byte vectors of each byte row; l2's cells one 16-byte store each.
__global__ void __launch_bounds__(kLadThreads)
meval_ladders_kernel(const uint32_t* __restrict__ bases, uint8_t* __restrict__ l1d, long ldb,
                     zk::cell* __restrict__ l2, long S, int log_s, long N2, int tiles1, int tiles2) {
  __shared__ u32x4 staged[16][kLadTile / 16];  // l1's byte rows of the tile
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const long q = blockIdx.x / (tiles1 + tiles2);
  const int tile = (int)(blockIdx.x % (tiles1 + tiles2));
  const bool is_l1 = tile < tiles1;
  const long k0 = (long)(is_l1 ? tile : tile - tiles1) * kLadTile;
  const long count = is_l1 ? S : N2;  // outputs with a power; l1 past S is zeros
  const int e0 = is_l1 ? 0 : log_s;
  const long kw = k0 + 32L * warp * kLadLanes, hi = kw >> 5;  // the warp's first output, less the lane
  zk::fe v{1, 0}, step{0, 0};
  if (kw < count) {
    const int bits = bit_length(hi);  // levels used: the lanes' 5, k / 32's bits, b^32 for the next outputs
    const int top = e0 + 5 + (kLadLanes > 1 && bits == 0 ? 1 : bits);
    zk::fe b = zk::load(bases + 8 * q, 1);
    for (int e = 0; e < top; ++e) {
      const int i = e - e0;
      if (i >= 0 && i < 5) {
        const zk::fe m = zk::mul32(v, b);
        if (ln >> i & 1) v = m;
      } else if (i >= 5) {
        if (i == 5) step = b;
        if (hi >> (i - 5) & 1) v = zk::mul32(v, b);
      }
      if (e + 1 < top) b = zk::sqr32(b);
    }
  }
  uint8_t* rows = reinterpret_cast<uint8_t*>(staged);
#pragma unroll
  for (int l = 0; l < kLadLanes; ++l) {
    const long k = kw + 32L * l + ln;
    if (l && kw + 32L * l < count) v = zk::mul32(v, step);
    if (is_l1) {
      const zk::fe x = k < S ? v : zk::fe{0, 0};
      const int col = (int)(k - k0);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        rows[j * kLadTile + col] = (uint8_t)((j < 8 ? x.lo >> (8 * j) : x.hi >> (8 * j - 64)) & 0xFF);
    } else if (k < N2) {
      l2[q * N2 + k] = zk::pack(v);
    }
  }
  if (is_l1) {  // the block's whole tile is l1 or l2: the barrier is uniform
    __syncthreads();
    const int vecs = (int)((ldb - k0 < kLadTile ? ldb - k0 : kLadTile) / 16);  // 16-byte vectors a row
    for (int i = tid; i < 16 * vecs; i += kLadThreads) {
      const int j = i / vecs, x = i % vecs;
      *reinterpret_cast<u32x4*>(l1d + (16 * q + j) * ldb + k0 + 16 * x) = staged[j][x];
    }
  }
}

template <int WQ, int BN>
int launch_mma(const uint32_t* coeffs, const uint8_t* l1d, long ldb, const zk::cell* l2, zk::cell* work, int C,
               int Q, long T, long S, long N2, long slices, void* stream) {
  using P = Tile<WQ, BN>;
  const int qtiles = (Q + P::kNQ - 1) / P::kNQ;
  const long blocks = (long)qtiles * C * slices;
  if (blocks > 0x7fffffffL) return -1;
  const bool aligned = T % 4 == 0 && S % 4 == 0 && reinterpret_cast<uintptr_t>(coeffs) % 16 == 0;
  auto kernel = meval_mma_kernel<WQ, BN>;
  if (P::kSmem > 48 * 1024) ZK_SET_SMEM(kernel, P::kSmem);
  ZK_LAUNCH(kernel, dim3((unsigned)blocks), dim3(P::kThreads), P::kSmem, stream, coeffs, l1d, ldb, l2, work, C, Q,
            T, S, N2, qtiles, aligned);
  return ZK_LAST_ERROR();
}

}  // namespace

// The slices of hi that zk_multi_eval splits T coefficients over at factor
// S: its work buffer holds slices x Q x C packed elements (16 bytes each).
// 0 for sizes below 1.
ZK_EXPORT int zk_multi_eval_slices(int C, int Q, long T, long S) {
  if (C < 1 || Q < 1 || T < 1 || S < 1) return 0;
  return (int)(((T + S - 1) / S + kMG - 1) / kMG);
}

// The dynamic shared memory of launch 1 for Q points, in bytes.
ZK_EXPORT int zk_multi_eval_smem(int Q) {
  return Q == 1 ? Tile<1, 1>::kSmem : Q == 2 ? Tile<2, 1>::kSmem : Tile<ZK_MEVAL_WQ, ZK_MEVAL_BN>::kSmem;
}

// coeffs (C, 8, T) limbs, contiguous; the ladder operands of Q points at S
// (a power of two, at most 2^15) and N2 (S N2 >= T) as zk_meval_ladders
// writes them: l1d (Q 16, ldb) bytes, ldb a multiple of 64 and at least
// S, l2 (Q, N2) packed; work of work_slices x Q x C packed elements,
// work_slices at least what zk_multi_eval_slices says; out (Q, C, 8)
// canonical limbs of sum_t coeffs[c][t] l1[q][t mod S] l2[q][t div S].
// Anything else returns -1 with no launch.  Two launches on the stream, no
// allocation, no synchronisation.
ZK_EXPORT int zk_multi_eval(const uint32_t* coeffs, const uint8_t* l1d, long ldb, const zk::cell* l2,
                            zk::cell* work, long work_slices, uint32_t* out, int C, int Q, long T, long S, long N2,
                            void* stream) {
  if (C < 1 || Q < 1 || T < 1 || S < 1 || (S & (S - 1)) || S > kMaxS || N2 < 1 || S * N2 < T || ldb < S ||
      ldb % kLdbAlign)
    return -1;
  const long slices = zk_multi_eval_slices(C, Q, T, S);
  if (work_slices < slices) return -1;
  const int rc = Q == 1   ? launch_mma<1, 1>(coeffs, l1d, ldb, l2, work, C, Q, T, S, N2, slices, stream)
                 : Q == 2 ? launch_mma<2, 1>(coeffs, l1d, ldb, l2, work, C, Q, T, S, N2, slices, stream)
                          : launch_mma<ZK_MEVAL_WQ, ZK_MEVAL_BN>(coeffs, l1d, ldb, l2, work, C, Q, T, S, N2, slices,
                                                                 stream);
  if (rc != 0) return rc;
  const long pairs = (long)C * Q;
  ZK_LAUNCH(meval_sum_kernel, dim3((unsigned)pairs), dim3(kSumThreads), 0, stream, work, out, pairs, slices);
  return ZK_LAST_ERROR();
}

// The ladder operands of Q points bases (Q, 8) limbs at S (a power of two)
// and N2: l1d (Q 16, ldb) bytes, byte j of bases[q]^lo at row 16 q + j and
// column lo < S, zeros in columns S .. ldb - 1 (ldb a multiple of 64, at
// least S; l1d 16-byte aligned); l2 (Q, N2) packed, bases[q]^(S hi).  -1
// with no launch for anything else (S or N2 above 2^31 included).  One
// launch on the stream: a block a tile of one factor of one point.
ZK_EXPORT int zk_meval_ladders(const uint32_t* bases, uint8_t* l1d, long ldb, zk::cell* l2, int Q, long S, long N2,
                               void* stream) {
  if (Q < 1 || S < 1 || (S & (S - 1)) || S > (1L << 31) || N2 < 1 || N2 > (1L << 31) || ldb < S ||
      ldb % kLdbAlign || reinterpret_cast<uintptr_t>(l1d) % 16)
    return -1;
  const long tiles1 = (ldb + kLadTile - 1) / kLadTile, tiles2 = (N2 + kLadTile - 1) / kLadTile;
  const long blocks = Q * (tiles1 + tiles2);
  if (blocks > 0x7fffffffL) return -1;
  ZK_LAUNCH(meval_ladders_kernel, dim3((unsigned)blocks), dim3(kLadThreads), 0, stream, bases, l1d, ldb, l2, S,
            bit_length(S) - 1, N2, (int)tiles1, (int)tiles2);
  return ZK_LAST_ERROR();
}
