// The FRI layer's fold and the power ladders, each one launch.
//
// zk_fri_fold replaces the fold of zkvm/prover/fri.py::_fold_core_t
// (:104-117, the ladder q_t = beta/offset * w_D^(-j) of fri_prove_t
// included), device work that the reference leaves to XLA inside one jit
// (no Pallas).  The port ran it as K1 at M = 8 (the 8-point iNTT of each
// group), a multiply by 1/8, 7 multiply-add steps of Horner and a ladder
// of ~30 launches: ~45 launches and three blocking copies a layer.  Here
// one thread takes an output lane j at a time: it reads the lane's group
// (8 elements of the (FOLD, 8, n) groups, limb rows coalesced across the
// warp), runs the inverse 8-point DFT in registers as a radix-2 network
// (12 butterflies, 5 of them with a twiddle other than 1), evaluates the
// coefficients at q_j by Horner and multiplies by 1/8 once (Horner is
// linear in the coefficients), and writes the canonical (8, n) limbs.
//
// zk_ladder replaces ntt_t.ladder_t's doubling chain (the reference's
// zkvm/ntt/ntt_t.py::ladder_t, XLA, no Pallas): out[b][.][i] =
// x[b][.][i] * scale[b] * base[b]^i over (B, 8, n), x absent meaning all
// ones; base and scale come as device limbs (B rows each, any strides, a
// row stride of 0 broadcasting one value), so a caller with device values
// copies nothing.  zk_ladder_const is the same function for one base and
// one scale that the host knows (the domain offset, roots of unity, the
// class bases: every caller but the mid twiddles), x of B rows.
//
// The ladder is kept in registers in both: thread t of block k takes the
// lanes j = k L T + t + l T (l < L, T threads a block), so the warp's
// lanes are neighbours; its first power base^j is a product of a table of
// base^(2^e) over the set bits of j, and each next lane is one multiply by
// base^T.  The fold's base is a host int, so its tables come by value
// with the other scalars (built on the host once a base): no thread
// squares and none waits for another.  Beside base^(2^e) (48 cells) the
// fold takes base^i for i < 32 (32 cells), so the bits of j below 5,
// which differ across a warp, cost one multiply and not five: a warp
// multiplies wherever any of its lanes does.  zk_ladder_const takes the
// same tables by value, with its scale, built on the host once a (base,
// scale): a thread's first power costs 1 + (the set bits of j0 / 32)
// multiplies, each next lane one, and above ZK_LADDER_ONE_LANE_MAX (2^15)
// a thread takes ZK_LADDER_LANES (16) lanes, so a lane costs ~1.4
// multiplies at n = 2^20 against the ~3 and the 20-squaring prelude of
// zk_ladder (the lanes and the threshold from kernel_bench.py --sweep FRI
// on an H100: 8 lanes were 0.0176 ms at 2^20, 16 0.0148, 32 0.0131 but
// slower at 2^19 and 2^23).  zk_ladder's base is a device value, so one thread of its
// block builds the table in shared memory by squaring while the others
// wait.  No ladder tensor is built and the scalars and tables travel by
// value, so the wrappers copy nothing to the card.
//
// The fold's shape follows n: at n <= ZK_FOLD_ONE_LANE_MAX (2^17) one lane
// a thread, which puts n / T blocks on the card for the small layers (2^16
// lanes: 512 blocks of 128), where the lanes a thread would run in series
// are latency; above it ZK_FOLD_LANES lanes a thread, whose next lanes
// cost one multiply each where a first power costs a popcount of them.
// Both are instances of one template; the entry picks one from n.
//
// What bounds them on an H100: the fold moves 288 bytes an output lane (8
// elements read, 1 written) against 14 multiplies and 31 adds (the 5 of
// the DFT, 7 of Horner, the 1/8 and the ladder's step): 1,592 32-bit
// operations by the bound's count, 95 ps against 86 ps of bytes, so both
// nearly alike; at the path's smaller layers (n <= 2^17) the launch and
// a thread's dependent multiplies are most of its time.  The ladder
// writes 32 bytes a lane (64 with x) against one or two multiplies:
// bytes.
#include "f128.cuh"

// threads a block (a power of two) and lanes a thread; other values are
// for the tests' emulation and for timing other shapes
#ifndef ZK_FOLD_THREADS
#define ZK_FOLD_THREADS 128
#endif
#ifndef ZK_FOLD_LANES
#define ZK_FOLD_LANES 4
#endif
// the largest n that the fold takes at one lane a thread
#ifndef ZK_FOLD_ONE_LANE_MAX
#define ZK_FOLD_ONE_LANE_MAX (1L << 17)
#endif
// lanes a thread of zk_ladder_const above the largest n it takes at one
// lane a thread
#ifndef ZK_LADDER_LANES
#define ZK_LADDER_LANES 16
#endif
#ifndef ZK_LADDER_ONE_LANE_MAX
#define ZK_LADDER_ONE_LANE_MAX (1L << 15)
#endif

namespace {

using zk::cell;
using zk::fe;

constexpr int kThreads = ZK_FOLD_THREADS;
constexpr int kLanes = ZK_FOLD_LANES;
constexpr int kFold = 8;
constexpr int kMaxLevels = 48;  // base^(2^e) for e < 48: lanes below 2^48
constexpr int kWarpPowers = 32;  // the fold's base^i for i < 32: a lane's place in its warp
static_assert(kThreads >= 1 && (kThreads & (kThreads - 1)) == 0, "a power of two threads a block");
static_assert(kLanes >= 1 && ZK_LADDER_LANES >= 1, "a thread takes lanes");

constexpr int log2i(long v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }
constexpr int kLogThreads = log2i(kThreads);
constexpr int kLogWarp = log2i(kWarpPowers);

// the levels of zk_ladder's table: every set bit of a lane below n, and
// base^T
ZK_HD int levels_for(long n) {
  int bits = 0;
  while (bits < kMaxLevels && (1L << bits) < n) ++bits;
  return bits > kLogThreads ? bits : kLogThreads + 1;
}

// base^(2^e) for e < levels, by one thread (the others wait at the
// caller's barrier)
ZK_HD void build_powers(cell* pw, fe base, int levels) {
  pw[0] = zk::pack(base);
  for (int e = 1; e < levels; ++e) {
    base = zk::mul32(base, base);
    pw[e] = zk::pack(base);
  }
}

// scale * base^j from a table of base^(2^e)
ZK_HD fe power_from(const cell* pw, fe scale, long j) {
  for (int e = 0; j; ++e, j >>= 1)
    if (j & 1) scale = zk::mul32(scale, zk::unpack(pw[e]));
  return scale;
}

// scale * base^j0 from the tables base^(2^e) and base^i, i < 32: one
// multiply for the lane's place in its warp (a divergent read of the
// table), then one a set bit of j0 / 32, the same across the warp
ZK_HD fe first_power(const cell* pw, const cell* lane, fe scale, long j0) {
  return power_from(pw + kLogWarp, zk::mul32(scale, zk::unpack(lane[j0 & (kWarpPowers - 1)])), j0 >> kLogWarp);
}

// the fold's scalars: q_0 = beta / offset, 1/8, the powers r, r^2, r^3 of
// r = w_8^(-1) (the inverse DFT's twiddles) and the ladder's table
// base^(2^e), e < kMaxLevels, of its base w_D^(-1), and base^i, i < 32
struct FoldArgs {
  cell scale, inv8, r[3], pw[kMaxLevels], lane[kWarpPowers];
};

ZK_HD void butterfly(fe& a, fe& b) {
  const fe s = zk::add32(a, b);
  b = zk::sub32(a, b);
  a = s;
}

ZK_HD void butterfly(fe& a, fe& b, fe w) {
  const fe t = zk::mul32(b, w);
  b = zk::sub32(a, t);
  a = zk::add32(a, t);
}

// x[k] <- sum_t x[t] r^(t k): the 8-point DFT at r, decimation in time
// (even and odd halves of 4 points, each of two 2-point transforms)
ZK_HD void dft8(fe x[kFold], const FoldArgs& a) {
  const fe r1 = zk::unpack(a.r[0]), r2 = zk::unpack(a.r[1]), r3 = zk::unpack(a.r[2]);
  // 2-point transforms of (0, 4), (2, 6), (1, 5), (3, 7)
  butterfly(x[0], x[4]);
  butterfly(x[2], x[6]);
  butterfly(x[1], x[5]);
  butterfly(x[3], x[7]);
  // 4-point transforms at r^2: E = (x0, x4, x2, x6), O = (x1, x5, x3, x7)
  butterfly(x[0], x[2]);
  butterfly(x[4], x[6], r2);
  butterfly(x[1], x[3]);
  butterfly(x[5], x[7], r2);
  // now E_k sits at x[0], x[4], x[2], x[6] and O_k at x[1], x[5], x[3], x[7]
  // for k = 0, 1, 2, 3; X_k = E_k + r^k O_k, X_(k+4) = E_k - r^k O_k
  butterfly(x[0], x[1]);
  butterfly(x[4], x[5], r1);
  butterfly(x[2], x[3], r2);
  butterfly(x[6], x[7], r3);
  // X_0..X_7 sit at x[0], x[4], x[2], x[6], x[1], x[5], x[3], x[7]
  const fe y[kFold] = {x[0], x[4], x[2], x[6], x[1], x[5], x[3], x[7]};
#pragma unroll
  for (int k = 0; k < kFold; ++k) x[k] = y[k];
}

// the fold of lanes j0 + l T, l < LANES, j0 = k LANES T + t
template <int LANES>
__global__ void __launch_bounds__(kThreads)
fri_fold_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out, long n, const __grid_constant__ FoldArgs a) {
  const long j0 = (long)blockIdx.x * LANES * kThreads + threadIdx.x;
  if (j0 >= n) return;
  const fe inv8 = zk::unpack(a.inv8);
  fe q = first_power(a.pw, a.lane, zk::unpack(a.scale), j0);
  const long group = 8 * n;  // elements t and t + 1 of a group lie 8 n limbs apart
  for (int l = 0; l < LANES; ++l) {
    const long j = j0 + (long)l * kThreads;
    if (j >= n) break;
    if (l) q = zk::mul32(q, zk::unpack(a.pw[kLogThreads]));
    fe b[kFold];
#pragma unroll
    for (int t = 0; t < kFold; ++t) b[t] = zk::load(v + t * group + j, n);
    dft8(b, a);
    fe acc = b[kFold - 1];
#pragma unroll
    for (int k = kFold - 2; k >= 0; --k) acc = zk::add32(zk::mul32(acc, q), b[k]);
    zk::store(out + j, n, zk::mul32(acc, inv8));
  }
}

// the ladder's operands: row b of base and scale at base + b base_row
// (limbs base_limb apart; a row stride of 0 broadcasts), of x (absent:
// ones) at x + b x_row, limbs x_limb apart, lanes contiguous; out (B, 8, n)
struct LadderArgs {
  const uint32_t* x;
  long x_row, x_limb;
  const uint32_t* base;
  long base_row, base_limb;
  const uint32_t* scale;
  long scale_row, scale_limb;
  uint32_t* out;
  long n;
};

__global__ void __launch_bounds__(kThreads) ladder_kernel(const LadderArgs a) {
  __shared__ cell pw[kMaxLevels];
  const long row = blockIdx.y;
  if (threadIdx.x == 0) build_powers(pw, zk::load(a.base + row * a.base_row, a.base_limb), levels_for(a.n));
  __syncthreads();
  const long j0 = (long)blockIdx.x * kLanes * kThreads + threadIdx.x;
  if (j0 >= a.n) return;
  const fe step = zk::unpack(pw[kLogThreads]);
  fe q = power_from(pw, zk::load(a.scale + row * a.scale_row, a.scale_limb), j0);
  const uint32_t* x = a.x ? a.x + row * a.x_row : nullptr;
  uint32_t* out = a.out + row * 8 * a.n;
  for (int l = 0; l < kLanes; ++l) {
    const long j = j0 + (long)l * kThreads;
    if (j >= a.n) break;
    if (l) q = zk::mul32(q, step);
    zk::store(out + j, a.n, x ? zk::mul32(zk::load(x + j, a.x_limb), q) : q);
  }
}

// zk_ladder_const's operands: the table by value (the scale, base^(2^e)
// for e < kMaxLevels, base^i for i < 32), built on the host once a base and
// scale
struct LadderTable {
  cell scale, pw[kMaxLevels], lane[kWarpPowers];
};

// out[b][.][j] = x[b][.][j] scale base^j (x null: scale base^j) over the
// lanes j0 + l T, l < LANES, j0 = k LANES T + t, from the table by value:
// no thread squares and none waits for another
template <int LANES>
__global__ void __launch_bounds__(kThreads)
ladder_const_kernel(const uint32_t* __restrict__ x, long x_row, long x_limb, uint32_t* __restrict__ out, long n,
                    const __grid_constant__ LadderTable a) {
  const long row = blockIdx.y, j0 = (long)blockIdx.x * LANES * kThreads + threadIdx.x;
  if (j0 >= n) return;
  fe q = first_power(a.pw, a.lane, zk::unpack(a.scale), j0);
  const uint32_t* xr = x ? x + row * x_row : nullptr;
  uint32_t* o = out + row * 8 * n;
  for (int l = 0; l < LANES; ++l) {
    const long j = j0 + (long)l * kThreads;
    if (j >= n) break;
    if (l) q = zk::mul32(q, zk::unpack(a.pw[kLogThreads]));
    zk::store(o + j, n, xr ? zk::mul32(zk::load(xr + j, x_limb), q) : q);
  }
}

long lane_blocks(long n, int lanes = kLanes) { return (n + (long)lanes * kThreads - 1) / ((long)lanes * kThreads); }

// packed element i of a host array of 32-bit words, least significant first
cell cell_at(const uint32_t* words, int i) {
  const uint32_t* w = words + 4 * i;
  return cell{(uint64_t)w[1] << 32 | w[0], (uint64_t)w[3] << 32 | w[2]};
}

}  // namespace

// The fold of one FRI layer: v (FOLD, 8, n) contiguous limbs, group j's
// value t at v[t][.][j]; out (8, n) canonical limbs, out[j] = (1/8)
// sum_k c_k q_j^k with c_k = sum_t v[t][j] r^(t k) and q_j = scale
// base^j.  scalars: 5 + 48 + 32 packed elements (16 bytes each, its four
// 32-bit words least significant first): scale, 1/8, r, r^2, r^3, then
// base^(2^e) for e < 48, then base^i for i < 32.  One lane a thread for
// n <= ZK_FOLD_ONE_LANE_MAX, else ZK_FOLD_LANES.  -1 with no launch for
// n < 1.  One launch on the stream.
ZK_EXPORT int zk_fri_fold(const uint32_t* v, uint32_t* out, long n, const uint32_t* scalars, void* stream) {
  if (n < 1 || lane_blocks(n, 1) > 0x7fffffffL) return -1;
  auto at = [scalars](int i) { return cell_at(scalars, i); };
  FoldArgs a{at(0), at(1), {at(2), at(3), at(4)}, {}, {}};
  for (int e = 0; e < kMaxLevels; ++e) a.pw[e] = at(5 + e);
  for (int i = 0; i < kWarpPowers; ++i) a.lane[i] = at(5 + kMaxLevels + i);
  if (n <= ZK_FOLD_ONE_LANE_MAX)
    ZK_LAUNCH(fri_fold_kernel<1>, dim3((unsigned)lane_blocks(n, 1)), dim3(kThreads), 0, stream, v, out, n, a);
  else
    ZK_LAUNCH(fri_fold_kernel<kLanes>, dim3((unsigned)lane_blocks(n)), dim3(kThreads), 0, stream, v, out, n, a);
  return ZK_LAST_ERROR();
}

// out (B, 8, n) contiguous = x * scale * base^i (x null: scale * base^i);
// see LadderArgs for the strides.  -1 with no launch for B outside 1..65535
// or n < 1.  One launch on the stream.
ZK_EXPORT int zk_ladder(const uint32_t* x, long x_row, long x_limb, const uint32_t* base, long base_row,
                        long base_limb, const uint32_t* scale, long scale_row, long scale_limb, uint32_t* out,
                        long B, long n, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || lane_blocks(n) > 0x7fffffffL) return -1;
  const LadderArgs a{x, x_row, x_limb, base, base_row, base_limb, scale, scale_row, scale_limb, out, n};
  ZK_LAUNCH(ladder_kernel, dim3((unsigned)lane_blocks(n), (unsigned)B), dim3(kThreads), 0, stream, a);
  return ZK_LAST_ERROR();
}

// out (B, 8, n) contiguous = x * scale * base^i (x null: scale * base^i)
// for a base and a scale that the host knows: table, 1 + 48 + 32 packed
// elements (16 bytes each, its four 32-bit words least significant
// first): the scale, base^(2^e) for e < 48, base^i for i < 32; row b of x
// at x + b x_row (0: one row for all), limbs x_limb apart, lanes
// contiguous.  One lane a thread for n <= ZK_LADDER_ONE_LANE_MAX, else
// ZK_LADDER_LANES.  -1 with no launch for B outside 1..65535 or n < 1.
// One launch on the stream.
ZK_EXPORT int zk_ladder_const(const uint32_t* x, long x_row, long x_limb, const uint32_t* table, uint32_t* out,
                              long B, long n, void* stream) {
  constexpr int kMany = ZK_LADDER_LANES;
  if (B < 1 || B > 65535 || n < 1 || lane_blocks(n, 1) > 0x7fffffffL) return -1;
  LadderTable a{cell_at(table, 0), {}, {}};
  for (int e = 0; e < kMaxLevels; ++e) a.pw[e] = cell_at(table, 1 + e);
  for (int i = 0; i < kWarpPowers; ++i) a.lane[i] = cell_at(table, 1 + kMaxLevels + i);
  if (n <= ZK_LADDER_ONE_LANE_MAX)
    ZK_LAUNCH(ladder_const_kernel<1>, dim3((unsigned)lane_blocks(n, 1), (unsigned)B), dim3(kThreads), 0, stream, x,
              x_row, x_limb, out, n, a);
  else
    ZK_LAUNCH(ladder_const_kernel<kMany>, dim3((unsigned)lane_blocks(n, kMany), (unsigned)B), dim3(kThreads), 0,
              stream, x, x_row, x_limb, out, n, a);
  return ZK_LAST_ERROR();
}
