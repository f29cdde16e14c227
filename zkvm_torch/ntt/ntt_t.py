"""Transposed-layout four-step NTT over (..., 8, N) limb tensors.

Port of :mod:`zkvm.ntt.ntt_t` (and the ``ntt_jax`` layout/twiddle helpers).
With N = N1*N2, n = n1 + N1*n2 and k = k2 + N2*k1,

    X[k2 + N2*k1] = NTT_N1 over n1 [ w_N^(n1*k2) * NTT_N2 over n2 [ x ] ]

Each inner transform is the constant-geometry (Pease) stage network of
:func:`pease_stages` along the row axis of a (B1, B2, M, 8, L) view, natural
row order in and out: CUDA kernel K1 (``csrc/ntt_stages.cu``, which does the
layout permutations itself and reads and writes through its operands'
strides) for a CUDA tensor, its plain PyTorch version for a CPU tensor.
Every pass is a strided view of the input, one intermediate or the output,
so no transpose is materialised between passes.  The n1*k2 mid twiddles are
fused into the pass-2 kernel as a premultiplier (carrying the iNTT's 1/N at
the top level); a coset shift (:func:`premultiplier`) rides on the first
launch as a rank-1 premultiplier at every size.  When N2 exceeds
:data:`MAX_AXIS` pass 1 is itself a four-step transform over the same
buffers (:func:`_column_ntt`).

Device tables (layout indices, and the stage and mid twiddles packed for
K1 by :func:`pack_t`) are built once per (size, direction, device) and
cached.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from zkvm_torch.field import f128
from zkvm_torch import kernels
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, to_limbs

# Largest axis run as one stage-network launch (pass 1 recurses past it).
MAX_AXIS = 512


def _split(n: int):
    """N = N2 * N1; N1 (the pass-2 axis) capped at MAX_AXIS."""
    ln = n.bit_length() - 1
    n1 = min(1 << ((ln + 1) // 2), MAX_AXIS)
    return n // n1, n1  # (N2, N1)


def _rotl(x, r, ln):
    r = r % ln
    mask = (1 << ln) - 1
    return ((x << r) | (x >> (ln - r))) & mask


@functools.lru_cache(maxsize=None)
def _layout_indices(n: int):
    """(initial, final) int64 gather indices for the constant-geometry net."""
    ln = n.bit_length() - 1
    rev = np.zeros(n, dtype=np.int64)
    idx = np.arange(n)
    for b in range(ln):
        rev |= ((idx >> b) & 1) << (ln - 1 - b)
    initial = rev[_rotl(idx, 1, ln)]
    final = _rotl(idx, ln - 1, ln)  # out[i] = x[rotr(i, 1)]
    return initial, final


@functools.lru_cache(maxsize=None)
def _twiddle_table(n: int, inverse: bool) -> np.ndarray:
    """uint32 limb array (n//2, 8): w^k for k < n/2."""
    w = f128.get_root_of_unity(n)
    if inverse:
        w = f128.finv(w)
    tw = [1] * (n // 2)
    for k in range(1, n // 2):
        tw[k] = f128.fmul(tw[k - 1], w)
    return to_limbs(tw)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(m: int, inverse: bool) -> np.ndarray:
    """(S, M/2, 8) per-stage twiddles: stage s multiplies pair p by
    table[e_s(p)] (index math of ntt_jax._ntt_scan)."""
    ln = m.bit_length() - 1
    h = m // 2
    table = _twiddle_table(m, inverse)
    p = np.arange(h, dtype=np.int64)
    out = np.empty((ln, h, 8), dtype=np.uint32)
    mask = m - 1
    for s in range(ln):
        r = (s + 1) % ln
        i = ((p << r) | (p >> (ln - r))) & mask
        e = (i & ((1 << s) - 1)) * (m >> (s + 1))
        out[s] = table[e]
    return out


@functools.lru_cache(maxsize=None)
def _layout_dev(n: int, device):
    initial, final = _layout_indices(n)
    return (
        torch.from_numpy(initial).to(device),
        torch.from_numpy(final).to(device),
    )


@functools.lru_cache(maxsize=None)
def _stage_twiddles_dev(m: int, inverse: bool, device):
    """(S, M/2, 4): the stage twiddles packed for K1."""
    return pack_t(from_numpy(_stage_twiddles(m, inverse), device).transpose(-1, -2))


# ---------------------------------------------------------------------------
# power ladders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one(device: torch.device) -> torch.Tensor:
    """The (8,) limbs of 1 on ``device``, made once per device (a card's
    copy from the host waits for the stream).  Shared: never written."""
    return ft.const_col(1, device)[:, 0]


def _ladder_impl(base: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) = scale * base^i in the plain arithmetic: doubling up to 256
    lanes, then the sqrt split base^i = base^(i mod S) * (base^S)^(i div
    S) as one outer-product multiply."""
    if n <= 256:
        cur = scale[:, None]
        step = base[:, None]
        while cur.shape[1] < n:
            cur = torch.cat([cur, ft.fmul_plain(cur, step)], dim=1)
            step = ft.fsquare_plain(step)
        return cur
    s = 1 << ((n.bit_length() - 1 + 1) // 2)
    l1 = _ladder_impl(base, scale, s)  # (8, S), carries the scale
    base_s = base
    for _ in range(s.bit_length() - 1):
        base_s = ft.fsquare_plain(base_s[:, None])[:, 0]
    l2 = _ladder_impl(base_s, _one(base.device), n // s)  # (8, N2)
    prod = ft.fmul_plain(l2.transpose(0, 1)[:, :, None], l1[None])  # (N2, 8, S)
    return prod.transpose(0, 1).reshape(8, n)


LADDER_LEVELS = 48  # the tables of the fold and zk_ladder_const: base^(2^e) for e < 48 (kMaxLevels)
WARP_POWERS = 32  # and base^i for i < 32 (kWarpPowers)


def _ladder_rows(base, scale, n, x):
    """(B, x as (rows, 8, n) or None) of a ladder call, after the checks the
    kernel's wrapper makes on every device: int32 limbs on one device, base
    and scale (8,) or (B, 8), x (..., 8, n) of 1 or B rows, n a power of
    two."""
    ops = [t for t in (base, scale, x) if t is not None]
    if any(t.dtype != torch.int32 for t in ops) or any(t.device != base.device for t in ops):
        raise TypeError("ladder: expected int32 limbs on one device")
    if n < 1 or n & (n - 1):
        raise ValueError(f"ladder: n = {n}, expected a power of two")
    for name, t in (("base", base), ("scale", scale)):
        if t.dim() not in (1, 2) or t.shape[-1] != 8:
            raise ValueError(f"ladder: {name} of shape {tuple(t.shape)}, expected (8,) or (B, 8)")
    rows = [t.shape[0] for t in (base, scale) if t.dim() == 2]
    if x is not None:
        if x.dim() < 2 or x.shape[-2:] != (8, n):
            raise ValueError(f"ladder: x of shape {tuple(x.shape)}, expected (..., 8, {n})")
        x = x.reshape(-1, 8, n)
        rows.append(x.shape[0])
    b = max(rows, default=1)
    if any(r not in (1, b) for r in rows):
        raise ValueError(f"ladder: rows {rows} do not broadcast")
    return b, x


def ladder_plain(base: torch.Tensor, scale: torch.Tensor, n: int, x=None) -> torch.Tensor:
    """The ladder kernel's plain version, in the plain arithmetic: scale *
    base^i for i < n (base and scale (8,), or (B, 8) rows), times x
    (..., 8, n) where given; shaped as x, else (8, n) for one row and
    (B, 8, n) for B.  One row is :func:`_ladder_impl`'s doubling, B rows
    ``_ladders_impl``'s."""
    b, rows_x = _ladder_rows(base, scale, n, x)
    if base.dim() == 1 and scale.dim() == 1:
        lad = _ladder_impl(base, scale, n)
    else:
        bases = base.expand(b, 8) if base.dim() == 1 else base
        lad = ft.fmul_plain(_ladders_impl(bases, n, ft.PLAIN), scale.reshape(-1, 8)[:, :, None])
    if x is None:
        return lad
    out = ft.fmul_plain(rows_x, lad)
    return out.reshape(x.shape) if out.shape[0] == rows_x.shape[0] else out


def _limb_strides(t):
    """(row stride, limb stride) of an (8,) or (B, 8) operand, the row
    stride 0 for one row."""
    return (0, t.stride(0)) if t.dim() == 1 or t.shape[0] == 1 else (t.stride(0), t.stride(1))


def launch_ladder(lib, stream, base, scale, n: int, x=None) -> torch.Tensor:
    """Call the ladder entry point of ``lib``: :func:`ladder_plain`'s
    function in one launch, reading base, scale and x through their
    strides.  It copies nothing to the device, so it never waits for the
    stream."""
    b, rows_x = _ladder_rows(base, scale, n, x)
    if b > 65535:
        raise ValueError(f"ladder: {b} rows, at most 65535")
    if rows_x is not None and rows_x.stride(-1) != 1:
        rows_x = rows_x.contiguous()
    out = torch.empty((b, 8, n), dtype=torch.int32, device=base.device)
    xr, xl = (0, 0) if rows_x is None else ((0 if rows_x.shape[0] == 1 else rows_x.stride(0)), rows_x.stride(1))
    p = kernels.ptr
    rc = lib.zk_ladder(p(rows_x), xr, xl, p(base), *_limb_strides(base), p(scale), *_limb_strides(scale), p(out),
                       b, n, stream)
    kernels.check(rc, "zk_ladder")
    kernels.count("ladder", B=b, n=n)
    if x is not None:
        return out.reshape(x.shape) if b == rows_x.shape[0] else out
    return out[0] if base.dim() == 1 and scale.dim() == 1 else out


def ladder_t(base: torch.Tensor, scale: torch.Tensor, n: int, x=None) -> torch.Tensor:
    """scale * base^i for i < n (base and scale (8,) limbs, or (B, 8) rows),
    times x (..., 8, n) where given: (8, n), (B, 8, n) or x's shape.  A CUDA
    tensor launches the ladder kernel once (or it raises), a CPU tensor
    takes :func:`ladder_plain`."""
    _ladder_rows(base, scale, n, x)
    if base.device.type == "cpu":
        return ladder_plain(base, scale, n, x)
    if base.device.type != "cuda":
        raise ValueError(f"ladder: no kernel for device {base.device}")
    return launch_ladder(kernels.lib(), kernels.stream_of(base), base, scale, n, x)


def host_limbs(values, device) -> torch.Tensor:
    """Host ints -> (k, 8) int32 limbs on ``device``; a card's copy comes
    from pinned memory and does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(to_limbs([v % f128.P for v in values])).view(np.int32))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=256)
def power_table(base: int):
    """(base^(2^e) mod p for e < LADDER_LEVELS, by squaring; base^i mod p
    for i < WARP_POWERS) on the host: the ladder tables of the fold kernel
    and of ``zk_ladder_const``, built once a base."""
    squares = [base % f128.P]
    for _ in range(LADDER_LEVELS - 1):
        squares.append(squares[-1] * squares[-1] % f128.P)
    powers = [1]
    for _ in range(WARP_POWERS - 1):
        powers.append(powers[-1] * base % f128.P)
    return tuple(squares), tuple(powers)


@functools.lru_cache(maxsize=256)
def ladder_table(base: int, scale: int):
    """``zk_ladder_const``'s table by value, a host array of 4 (1 + 48 + 32)
    32-bit words: the scale, then :func:`power_table` of the base; built
    once a (base, scale) and shared (never written)."""
    squares, powers = power_table(base % f128.P)
    return kernels.words([scale % f128.P, *squares, *powers])


def _ladder_const_rows(n: int, x):
    """(B, x as (B, 8, n) or None) of a host-constant ladder, after the
    checks its kernel's wrapper makes on every device."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"ladder: n = {n}, expected a power of two")
    if x is None:
        return 1, None
    if x.dtype != torch.int32 or x.dim() < 2 or x.shape[-2:] != (8, n):
        raise ValueError(f"ladder: x of shape {tuple(x.shape)} and type {x.dtype}, expected int32 (..., 8, {n})")
    x = x.reshape(-1, 8, n)
    return x.shape[0], x


def launch_ladder_const(lib, stream, base: int, scale: int, n: int, x=None, device=None) -> torch.Tensor:
    """Call the host-constant ladder entry point of ``lib``: scale * base^i
    for i < n (host ints) times x (..., 8, n) where given, in one launch,
    shaped as x, else (8, n) on ``device``.  The table goes by value
    (:func:`ladder_table`), so it copies nothing to the device and never
    waits for the stream."""
    b, rows_x = _ladder_const_rows(n, x)
    if b > 65535:
        raise ValueError(f"ladder: {b} rows, at most 65535")
    if rows_x is not None and rows_x.stride(-1) != 1:
        rows_x = rows_x.contiguous()
    dev = device if rows_x is None else rows_x.device
    out = torch.empty((b, 8, n), dtype=torch.int32, device=dev)
    xr, xl = (0, 0) if rows_x is None else (rows_x.stride(0), rows_x.stride(1))
    rc = lib.zk_ladder_const(kernels.ptr(rows_x), xr, xl, ladder_table(base, scale), kernels.ptr(out), b, n, stream)
    kernels.check(rc, "zk_ladder_const")
    kernels.count("ladder_const", B=b, n=n)
    return out[0] if x is None else out.reshape(x.shape)


def ladder_t_host(base: int, n: int, scale: int = 1, device="cpu", x=None) -> torch.Tensor:
    """:func:`ladder_t` of host ints base and scale, on x's device where x
    is given, else on ``device``: a CUDA device launches the host-constant
    entry ``zk_ladder_const`` once (or it raises), the CPU takes
    :func:`ladder_plain`."""
    dev = torch.device(device if x is None else x.device)
    _ladder_const_rows(n, x)
    if dev.type == "cpu":
        ops = host_limbs([base, scale], dev)
        return ladder_plain(ops[0], ops[1], n, x)
    if dev.type != "cuda":
        raise ValueError(f"ladder: no kernel for device {dev}")
    return launch_ladder_const(kernels.lib(), torch.cuda.current_stream(dev).cuda_stream, base, scale, n, x, dev)


def ladders_split(bases: torch.Tensor, n: int, arith: ft.Arith = ft.DISPATCH):
    """The two factors of the ladders of n > 256 lanes, bases^i =
    l1[i mod S] * l2[i div S]: (l1 (Q, 8, S), l2 (Q, 8, n / S)).  ``arith``
    is the multiply's (``f128t.PLAIN`` for a yardstick)."""
    s = 1 << ((n.bit_length() - 1 + 1) // 2)
    l1 = _ladders_impl(bases, s, arith)  # (Q, 8, S)
    base_s = bases
    for _ in range(s.bit_length() - 1):
        base_s = arith.fmul(base_s[:, :, None], base_s[:, :, None])[:, :, 0]
    return l1, _ladders_impl(base_s, n // s, arith)


def ladders_join(l1: torch.Tensor, l2: torch.Tensor, arith: ft.Arith = ft.DISPATCH) -> torch.Tensor:
    """(Q, 8, S) x (Q, 8, N2) factors -> the (Q, 8, S N2) ladders: one
    outer-product multiply."""
    q, _, s = l1.shape
    prod = arith.fmul(l2.transpose(-1, -2)[:, :, :, None], l1[:, None])  # (Q, N2, 8, S)
    return prod.transpose(-3, -2).reshape(q, 8, s * l2.shape[-1])


def _ladders_impl(bases: torch.Tensor, n: int, arith: ft.Arith) -> torch.Tensor:
    q = bases.shape[0]
    if n <= 256:
        cur = _one(bases.device)[None, :, None].expand(q, 8, 1)
        step = bases[:, :, None]
        while cur.shape[-1] < n:
            cur = torch.cat([cur, arith.fmul(cur, step)], dim=-1)
            step = arith.fmul(step, step)
        return cur
    return ladders_join(*ladders_split(bases, n, arith), arith)


def ladders_t(bases: torch.Tensor, n: int, arith: ft.Arith = ft.DISPATCH) -> torch.Tensor:
    """(Q, 8, n): bases[q]^i for i < n, bases (Q, 8)."""
    assert n & (n - 1) == 0
    return _ladders_impl(bases, n, arith)


@functools.lru_cache(maxsize=None)
def _mid_twiddles_cached(n: int, n1: int, inverse: bool, scaled: bool, device):
    """(N1, N2, 4) packed: scale * w^(n1*k2), rows permuted by pass 2's
    initial layout indices (the tensor premultiplies pass 2's permuted
    input)."""
    n2 = n // n1
    w = f128.get_root_of_unity(n)
    if inverse:
        w = f128.finv(w)
    scale = f128.finv(n) if scaled else 1
    lad = ladder_t_host(w, n2, device=device)  # (8, N2): w^k2
    cols = ladder_t(lad.transpose(0, 1), host_limbs([scale], device)[0], n1)  # (N2, 8, N1)
    rows = cols.permute(2, 1, 0)
    if n1 > 1:
        rows = rows.index_select(0, _layout_dev(n1, device)[0])
    return pack_t(rows)


def _mid_twiddles(n: int, inverse: bool, scaled: bool, device) -> torch.Tensor:
    # the cache key holds the split (MAX_AXIS is test-patchable)
    return _mid_twiddles_cached(n, _split(n)[1], inverse, scaled, torch.device(device))


# ---------------------------------------------------------------------------
# kernel K1: the stage network along axis -3, natural order in and out
# ---------------------------------------------------------------------------

def pack_t(x: torch.Tensor) -> torch.Tensor:
    """(..., 8, L) limbs -> (..., L, 4) int32: each element as the four
    little-endian 32-bit words of its value (K1's packed constants)."""
    x = x.long().reshape(x.shape[:-2] + (4, 2, x.shape[-1]))
    w = x[..., 0, :] | (x[..., 1, :] << 16)
    w = torch.where(w >= 2**31, w - 2**32, w)
    return w.to(torch.int32).transpose(-1, -2).contiguous()


def unpack_t(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_t`: (..., L, 4) words -> (..., 8, L) limbs."""
    w = w.long().transpose(-1, -2) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-2)  # (..., 4, 2, L)
    return limbs.reshape(w.shape[:-2] + (8, w.shape[-1])).to(torch.int32)


def _apply_pre(y, pre, r1, fmul):
    """y times ``pre`` (limbs) or the rank-1 ``r1``, by ``fmul``: the plain
    multiply in K1's plain version, the dispatching one where an axis of
    one row needs no stage network."""
    if pre is not None:
        y = fmul(y, pre)
    elif r1 is not None:
        rs, ls = r1
        y = fmul(fmul(y, rs.transpose(0, 1)[:, :, None]), ls[None])
    return y


def pease_stages_plain(y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The bare stage network, in the plain arithmetic; y (..., M, 8, L)
    pre-permuted, tw (S, M/2, 8) limbs.  Counterpart of
    ntt_t._pease_stages_batched."""
    m = y.shape[-3]
    h = m // 2
    for s in range(tw.shape[0]):
        a = y[..., :h, :, :]
        b = ft.fmul_plain(y[..., h:, :, :], tw[s][:, :, None])
        y = torch.cat([ft.fadd_plain(a, b), ft.fsub_plain(a, b)], dim=-3)
        z = y.reshape(y.shape[:-3] + (h, 2, 8, y.shape[-1]))
        y = torch.cat([z[..., 0, :, :], z[..., 1, :, :]], dim=-3)
    return y


def stages_plain(yb, tw, pre=None, r1=None, out=None) -> torch.Tensor:
    """K1's plain version, natural row order in and out: gather by the
    initial layout indices, premultiply (``pre`` packed, broadcasting to
    (..., M, NL, 4), or ``r1`` = (rs (8, M), ls (8, NL)) limbs; both in the
    gathered row order), run the stages (``tw`` packed (S, M/2, 4)), gather
    by the final indices.  yb (..., M, 8, NL) is read through its strides,
    and the result written into ``out`` where given (a view of yb's shape,
    any strides).  The JAX ``ntt_t._axis_ntt``'s contract."""
    initial, final = _layout_dev(yb.shape[-3], yb.device)
    y = _apply_pre(yb.index_select(-3, initial), None if pre is None else unpack_t(pre), r1, ft.fmul_plain)
    res = pease_stages_plain(y, unpack_t(tw).transpose(-1, -2)).index_select(-3, final)
    return res if out is None else out.copy_(res)


def _sizes5(t):
    """A (M, 8, NL), (B, M, 8, NL) or (B1, B2, M, 8, NL) operand as 5-D."""
    return t.reshape((1,) * (5 - t.dim()) + tuple(t.shape)) if t.dim() < 5 else t


def _strides5(t):
    """The element strides of a 5-D operand, 0 along an axis of one."""
    return [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]


def _walk(t) -> str | None:
    """The axis K1 walks on a 5-D operand: "lanes" where the lanes are
    unit-stride, "rows" where the rows are, else None (it cannot)."""
    _, _, m, _, nl = t.shape
    if nl > 1 and t.stride(4) == 1:
        return "lanes"
    if t.stride(2) == 1:
        return "rows"
    return "lanes" if nl == 1 else None


def launch_stages(lib, stream, yb, tw, pre=None, r1=None, out=None) -> torch.Tensor:
    """Call the K1 entry point of ``lib`` on (M, 8, NL), (B, M, 8, NL) or
    (B1, B2, M, 8, NL) limbs, read through their strides, into ``out`` (a
    view of the same shape, any strides) or a new tensor.  Each side walks
    its unit-stride axis (rows or lanes); a side with neither is refused.
    ``pre`` (packed, last axis unit-stride, 16-byte cells) broadcasts to
    (B1, B2, M, NL, 4); ``r1`` = (rs (8, M), ls (8, NL))."""
    shape = tuple(yb.shape)
    if yb.dim() not in (3, 4, 5):
        raise ValueError(f"stage network: unsupported shape {shape}")
    y = _sizes5(yb)
    b1, b2, m, limbs, nl = y.shape
    s = m.bit_length() - 1
    dev = yb.device
    if limbs != 8 or m < 2 or m > 512 or m & (m - 1) or nl & (nl - 1) or b1 > 65535 or b2 > 65535:
        raise ValueError(f"stage network: unsupported shape {shape}")
    if yb.dtype != torch.int32:
        raise TypeError(f"y: expected int32 limbs, got {yb.dtype}")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    o = _sizes5(out)
    if tuple(o.shape) != tuple(y.shape) or out.dtype != torch.int32 or out.device != dev:
        raise ValueError(f"out: {tuple(out.shape)} {out.dtype} on {out.device}, expected {shape} int32 on {dev}")
    kernels.expect(tw, (s, m // 2, 4), dev, "tw")
    for name, t in (("y", y), ("out", o)):
        if _walk(t) is None:
            raise ValueError(f"{name}: strides {t.stride()} of {tuple(t.shape)} have neither unit-stride rows nor lanes")
    rs = ls = None
    variant, pstr = 0, [0] * 4
    if pre is not None:
        variant = 1
        pv = pre.expand(b1, b2, m, nl, 4)
        if pv.dtype != torch.int32 or pv.device != dev:
            raise ValueError(f"pre: {pre.dtype} on {pre.device}, expected int32 on {dev}")
        st = _strides5(pv)
        if pv.stride(4) != 1 or pv.data_ptr() % 16 or any(x % 4 for x in st[:4]):
            raise ValueError(f"pre: strides {pv.stride()} at byte {pv.data_ptr() % 16} of 16 are not whole "
                             "unit-stride 16-byte cells")
        pstr = [x // 4 for x in st[:4]]
        pre = pv
    elif r1 is not None:
        variant = 2
        rs, ls = r1
        kernels.expect(rs, (8, m), dev, "rs")
        kernels.expect(ls, (8, nl), dev, "ls")
    walks = (_walk(y), _walk(o))
    longs = lambda v: (ctypes.c_long * len(v))(*v)
    ys, os_ = _strides5(y), _strides5(o)
    for st, walk in ((ys, walks[0]), (os_, walks[1])):
        st[4 if walk == "lanes" else 2] = 1
    rc = lib.zk_ntt_stages(
        kernels.ptr(y), longs(ys), kernels.ptr(o), longs(os_), kernels.ptr(tw), kernels.ptr(pre), longs(pstr),
        kernels.ptr(rs), kernels.ptr(ls), b1, b2, m, nl, s, variant,
        (walks[0] == "rows") | (walks[1] == "rows") << 1, stream,
    )
    kernels.check(rc, "zk_ntt_stages")
    kernels.count("ntt_stages", M=m, B=b1 * b2, NL=nl, variant=("plain", "full", "r1")[variant], load=walks[0],
                  store=walks[1])
    return out


def pease_stages(yb, tw, pre=None, r1=None, out=None) -> torch.Tensor:
    """K1 on (M, 8, NL), (B, M, 8, NL) or (B1, B2, M, 8, NL) limbs in
    natural row order, any strides: the NTT along M, premultiplied, as
    :func:`stages_plain` states it, into ``out`` where given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if yb.device.type == "cpu":
        return stages_plain(yb, tw, pre, r1, out)
    if yb.device.type != "cuda":
        raise ValueError(f"stage network: no kernel for device {yb.device}")
    return launch_stages(kernels.lib(), kernels.stream_of(yb), yb, tw, pre, r1, out)


# ---------------------------------------------------------------------------
# axis transform and the flat four-step transform
# ---------------------------------------------------------------------------

def _axis_ntt(y, m, inverse, pre=None, r1=None):
    """NTT along axis -3 of (..., M, 8, L), any strides; natural order in/out.

    ``pre`` (packed, broadcasting to (..., M, L, 4)) or ``r1`` premultiply
    the INPUT, given in permuted row order."""
    if m == 1:
        return _apply_pre(y, None if pre is None else unpack_t(pre), r1, ft.fmul)
    batch = y.shape[:-3]
    yb = y if y.dim() <= 5 else y.reshape((-1,) + tuple(y.shape[-3:]))
    out = pease_stages(yb, _stage_twiddles_dev(m, inverse, y.device), pre=pre, r1=r1)
    return out.reshape(batch + tuple(out.shape[-3:]))


def _pass(src, dst, m, inverse, pre=None, r1=None):
    """One K1 launch along axis 2 of (B1, B2, M, 8, NL) views, src into dst
    (at M = 1, a size-1 transform's, the premultiply alone)."""
    if m == 1:
        dst.copy_(_apply_pre(src, None if pre is None else unpack_t(pre), r1, ft.fmul))
        return
    pease_stages(src, _stage_twiddles_dev(m, inverse, src.device), pre=pre, r1=r1, out=dst)


def _lanes3(x: torch.Tensor, name: str) -> torch.Tensor:
    """An (..., 8, N) operand as a (B, 8, N) view with unit-stride lanes, or
    a ValueError where it has none."""
    n = x.shape[-1]
    try:
        v = x.view(-1, 8, n)
    except RuntimeError:
        v = None
    if v is None or (n > 1 and v.stride(-1) != 1):
        raise ValueError(f"{name}: strides {x.stride()} of {tuple(x.shape)} have no (B, 8, N) view with "
                         "unit-stride lanes")
    return v


def _column_ntt(src, dst, scratch, inverse, r1=None):
    """The L-point transform along axis 2 of (B, 8, L, W) views (rows of W
    unit-stride lanes), natural order in and out, into ``dst``.  Where L <=
    MAX_AXIS, one K1 launch (``r1`` its premultiplier).  Else the four-step
    over n = a + L1 b: the L2-point transform along b of the (B, 8, L2, L1 W)
    view into ``scratch`` (recursing, with ``dst`` its scratch), then K1
    along a over the W lanes and the batch k_b, premultiplied by the mid
    twiddles w_L^(a k_b) by (row, batch), writing X[k_b + L2 k_a] into
    ``dst``.  ``r1`` rides on the first launch of all, whose rows are the
    top digit of n and whose lanes all the others (:func:`_first_pass`
    shapes it).  Every buffer is taken by ``view``, so a layout that has no
    such view raises rather than being written through a copy."""
    b, _, n, w = src.shape
    if n <= MAX_AXIS:
        if r1 is not None and (r1[0].shape[-1], r1[1].shape[-1]) != (n, w):
            raise ValueError(f"r1: shaped for a first launch of {r1[0].shape[-1]} rows and {r1[1].shape[-1]} "
                             f"lanes, the first launch has {n} and {w}")
        _pass(src.transpose(1, 2), dst.transpose(1, 2), n, inverse, r1=r1)
        return
    l2, l1 = _split(n)
    flat = lambda t: t.view(b, 8, l2, l1 * w)
    _column_ntt(flat(src), flat(scratch), flat(dst), inverse, r1)
    s = scratch.view(b, 8, l2, l1, w).permute(0, 2, 3, 1, 4)  # (B, L2[k_b], L1[a], 8, W)
    d = dst.view(b, 8, l1, l2, w).permute(0, 3, 2, 1, 4)  # (B, L2[k_b], L1[k_a], 8, W)
    pre = _mid_twiddles(n, inverse, False, src.device).transpose(0, 1)[None, :, :, None]  # (1, L2, L1, 1, 4)
    _pass(s, d, l1, inverse, pre=pre)


def _ntt_t_core(x, inverse, scale_r1=None, out=None):
    """Four-step transform of (..., 8, N) -> (..., 8, N), natural order,
    into ``out`` where given (its lanes unit-stride).

    With n = n1 + N1 n2 and k = k2 + N2 k1: pass 1, the N2-point transform
    along n2 of x's (B, 8, N2, N1) view into Z (B, 8, N2[k2], N1[n1])
    (:func:`_column_ntt`, recursing where N2 > MAX_AXIS, the output its
    scratch); pass 2, K1 along n1 of Z's rows (unit-stride: a walk along
    rows) over the lanes k2, premultiplied by the mid twiddles w_N^(n1 k2)
    (carrying the iNTT's 1/N), writing X[k2 + N2 k1] through the output's
    lanes.  Every pass reads and writes strided views of x, Z and the
    output: nothing copies between them.  ``scale_r1`` (a
    :func:`premultiplier`) premultiplies the input by base^n, fused into
    the first launch."""
    n = x.shape[-1]
    xb = _lanes3(x, "x")
    b, dev = xb.shape[0], x.device
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    res = _lanes3(out, "out")
    n2, n1 = _split(n)
    if n2 == 1:  # no pass 1: the scale alone
        z = xb if scale_r1 is None else _apply_pre(xb[:, None], None, scale_r1, ft.fmul)[:, 0]
    else:
        z = torch.empty((b, 8, n), dtype=torch.int32, device=dev)
        _column_ntt(xb.view(b, 8, n2, n1), z.view(b, 8, n2, n1), res.view(b, 8, n2, n1), inverse, scale_r1)
    src = z.view(b, 8, n2, n1).permute(0, 3, 1, 2)[:, None]  # (B, 1, N1[n1], 8, N2[k2])
    dst = res.view(b, 8, n1, n2).transpose(1, 2)[:, None]  # (B, 1, N1[k1], 8, N2[k2])
    _pass(src, dst, n1, inverse, pre=_mid_twiddles(n, inverse, inverse, dev)[None, None])
    return out


def _first_pass(n: int):
    """(M, W): the rows and lanes of the first K1 launch of a size-n
    transform (n = lane + W row): :func:`_column_ntt`'s descent, which
    refuses a premultiplier of other shapes."""
    n2, n1 = _split(n)
    while n2 > MAX_AXIS:
        n2, l1 = _split(n2)
        n1 *= l1
    return n2, n1


def premultiplier(base: int, n: int, device, factor: int = 1):
    """``factor`` * base^i (i < n; host ints) on ``device`` as the rank-1
    premultiplier of a size-n transform's first K1 launch (its rows M the
    top digit of i, its lanes the W others: base^i = (base^W)^row
    base^lane), so the scale is fused at every size: (rs (8, M) in the
    kernel's row order, ls (8, W)), two host-constant ladders; ls holds W =
    n / M elements (32,768 at n = 2^20)."""
    m, w = _first_pass(n)
    rs = ladder_t_host(pow(base, w, f128.P), m, device=device)
    if m > 1:
        rs = rs.index_select(1, _layout_dev(m, rs.device)[0])
    return rs, ladder_t_host(base, w, factor, device)


def ntt_t(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the lane axis of (..., 8, N); natural order."""
    if x.shape[-1] == 1:
        return x
    return _ntt_t_core(x, False)


def intt_t(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the lane axis of (..., 8, N)."""
    if x.shape[-1] == 1:
        return x
    return _ntt_t_core(x, True)


def class_ntt_t(coeffs_t: torch.Tensor, base: int, scale=None, out=None) -> torch.Tensor:
    """Evaluate degree-<T polynomials on the coset base*<w_T>: the base^n
    scale fused into the first K1 launch at every T.  coeffs_t (..., 8, T);
    base a host int; ``scale`` = a cached :func:`premultiplier` of the
    same base; ``out`` a view to write the result into (lanes
    unit-stride)."""
    t = coeffs_t.shape[-1]
    if t == 1:
        return coeffs_t if out is None else out.copy_(coeffs_t)
    if scale is None:
        scale = premultiplier(base, t, coeffs_t.device)
    return _ntt_t_core(coeffs_t, False, scale_r1=scale, out=out)


@functools.lru_cache(maxsize=None)
def _coset_premultiplier(offset: int, d: int, max_axis: int, device):
    """:func:`premultiplier` of offset^i for a size-d transform; the key
    holds MAX_AXIS, which shapes the form (tests patch it)."""
    return premultiplier(offset, d, device)


def coset_lde_t(coeffs_t: torch.Tensor, blowup: int, offset: int = f128.DOMAIN_OFFSET) -> torch.Tensor:
    """Evaluate degree-<T polynomials (..., 8, T) on the whole coset
    offset*<w_D>, D = blowup*T: (..., 8, D) in natural order
    (``ntt_jax.coset_lde``).  Zero-pad to D and run one size-D transform
    with the offset ladder fused into its first K1 launch; it holds the
    padded input, the output and one intermediate."""
    d = blowup * coeffs_t.shape[-1]
    pre = _coset_premultiplier(offset, d, MAX_AXIS, coeffs_t.device)
    return _ntt_t_core(torch.nn.functional.pad(coeffs_t, (0, d - coeffs_t.shape[-1])), False, scale_r1=pre)
