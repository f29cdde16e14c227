"""Transposed-layout four-step NTT over (..., 8, N) limb tensors.

Port of :mod:`zkvm.ntt.ntt_t` (and the ``ntt_jax`` layout/twiddle helpers).
With N = N1*N2, n = n1 + N1*n2 and k = k2 + N2*k1,

    X[k2 + N2*k1] = NTT_N1 over n1 [ w_N^(n1*k2) * NTT_N2 over n2 [ x ] ]

Both inner transforms run along axis -3 of a ``(..., M, 8, L)`` view as the
constant-geometry (Pease) stage network of :func:`pease_stages`, natural
row order in and out — CUDA kernel K1 (``csrc/ntt_stages.cu``, which does
the two layout permutations itself) for a CUDA tensor, its plain PyTorch
version for a CPU tensor.  The n1*k2 mid twiddles are fused into the
pass-2 kernel as a premultiplier (carrying the iNTT's 1/N at the top
level); the coset shift of :func:`class_ntt_t` is fused into pass 1 as a
rank-1 premultiplier.  When N2 exceeds :data:`MAX_AXIS` the first pass
recurses through the flat transform.

Device tables (layout indices, and the stage and mid twiddles packed for
K1 by :func:`pack_t`) are built once per (size, direction, device) and
cached.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


def stages_plain(yb, tw, pre=None, r1=None) -> torch.Tensor:
    """K1's plain version, natural row order in and out: gather by the
    initial layout indices, premultiply (``pre`` packed (M, NL, 4), or
    ``r1`` = (rs (8, M), ls (8, NL)) limbs; both in the gathered row
    order), run the stages (``tw`` packed (S, M/2, 4)), gather by the final
    indices.  The JAX ``ntt_t._axis_ntt``'s contract."""
    initial, final = _layout_dev(yb.shape[-3], yb.device)
    y = _apply_pre(yb.index_select(-3, initial), None if pre is None else unpack_t(pre), r1, ft.fmul_plain)
    return pease_stages_plain(y, unpack_t(tw).transpose(-1, -2)).index_select(-3, final)


def launch_stages(lib, stream, yb, tw, pre=None, r1=None) -> torch.Tensor:
    """Call the K1 entry point of ``lib`` on (B, M, 8, NL) limbs."""
    b, m, _, nl = yb.shape
    s = m.bit_length() - 1
    dev = yb.device
    if m < 2 or m > 512 or m & (m - 1) or nl & (nl - 1) or b > 65535:
        raise ValueError(f"stage network: unsupported shape {tuple(yb.shape)}")
    kernels.expect(yb, (b, m, 8, nl), dev, "y")
    kernels.expect(tw, (s, m // 2, 4), dev, "tw")
    rs = ls = None
    variant = 0
    if pre is not None:
        variant = 1
        kernels.expect(pre, (m, nl, 4), dev, "pre")
    elif r1 is not None:
        variant = 2
        rs, ls = r1
        kernels.expect(rs, (8, m), dev, "rs")
        kernels.expect(ls, (8, nl), dev, "ls")
    out = torch.empty_like(yb)
    rc = lib.zk_ntt_stages(
        kernels.ptr(yb), kernels.ptr(out), kernels.ptr(tw), kernels.ptr(pre),
        kernels.ptr(rs), kernels.ptr(ls), b, m, nl, s, variant, stream,
    )
    kernels.check(rc, "zk_ntt_stages")
    kernels.count("ntt_stages", M=m, B=b, NL=nl, variant=("plain", "full", "r1")[variant])
    return out


def pease_stages(yb, tw, pre=None, r1=None) -> torch.Tensor:
    """K1 on (B, M, 8, NL) limbs in natural row order: the NTT along M,
    premultiplied, as :func:`stages_plain` states it.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if yb.device.type == "cpu":
        return stages_plain(yb, tw, pre, r1)
    if yb.device.type != "cuda":
        raise ValueError(f"stage network: no kernel for device {yb.device}")
    contig = lambda t: None if t is None else t.contiguous()
    r1 = None if r1 is None else (contig(r1[0]), contig(r1[1]))
    return launch_stages(
        kernels.lib(), kernels.stream_of(yb), yb.contiguous(), tw.contiguous(),
        contig(pre), r1,
    )


# ---------------------------------------------------------------------------
# axis transform and the flat four-step transform
# ---------------------------------------------------------------------------

def _axis_ntt(y, m, inverse, pre=None, r1=None):
    """NTT along axis -3 of (..., M, 8, L); natural order in/out.

    ``pre`` (packed (M, L, 4)) or ``r1`` premultiply the INPUT, given in
    permuted row order."""
    if m == 1:
        return _apply_pre(y, None if pre is None else unpack_t(pre), r1, ft.fmul)
    batch = y.shape[:-3]
    yb = y.reshape((-1,) + tuple(y.shape[-3:]))
    out = pease_stages(yb, _stage_twiddles_dev(m, inverse, y.device), pre=pre, r1=r1)
    return out.reshape(batch + tuple(out.shape[-3:]))


def _ntt_t_core(x, inverse, top=True, scale_r1=None):
    """Four-step transform of (..., 8, N) -> (..., 8, N), natural order.

    ``scale_r1`` = (row ladder (8, N2), lane ladder (8, N1)) premultiplies
    the input by base^n, fused into the pass-1 kernel; where pass 1
    recurses it is a :class:`Recursed` form (:func:`premultiplier`).  The
    iNTT's 1/N is fused into the top-level mid-twiddle tensor."""
    n = x.shape[-1]
    n2, n1 = _split(n)
    batch = tuple(x.shape[:-2])
    y = x.reshape(batch + (8, n2, n1)).transpose(-3, -2)  # (..., N2, 8, N1)
    pre = _mid_twiddles(n, inverse, inverse and top, x.device)
    if n2 <= MAX_AXIS:
        r1 = None
        if scale_r1 is not None:
            lad_m, lad_lane = scale_r1
            if n2 > 1:
                lad_m = lad_m.index_select(1, _layout_dev(n2, x.device)[0])
            r1 = (lad_m, lad_lane)
        y = _axis_ntt(y, n2, inverse, r1=r1)  # [k2][limb][n1]
        y = y.transpose(-3, -1)  # (..., N1, 8, N2)
    else:
        inner = None
        if scale_r1 is not None:
            inner, pre = scale_r1
        y = y.transpose(-3, -1)  # (..., N1, 8, N2)
        y = _ntt_t_core(y.contiguous(), inverse, top=False, scale_r1=inner)
    y = _axis_ntt(y, n1, inverse, pre=pre)  # [k1][limb][k2]
    return y.transpose(-3, -2).reshape(batch + (8, n))


class Recursed(NamedTuple):
    """The premultiplier base^n of a transform whose pass 1 recurses, with
    n = n1 + N1 n2: ``inner``, the recursing pass-1 transform's own
    premultiplier (base^N1)^n2; and ``pre``, pass 2's packed mid twiddles
    times base^n1, which is constant over each pass-1 transform and so
    moves past it."""

    inner: object
    pre: torch.Tensor


def premultiplier(base: int, n: int, inverse: bool, device, factor: int = 1, top: bool = True):
    """``factor`` * base^i (i < n; host ints) on ``device`` in the form
    :func:`_ntt_t_core`'s ``scale_r1`` takes for a size-n (i)NTT: the two
    ladders of :func:`class_scale` where pass 1 is one launch, else a
    :class:`Recursed` form, so the scale is fused into the kernels at
    every size.  Holds an O(n) table where pass 1 recurses: cache it."""
    n2, n1 = _split(n)
    lad_lane = ladder_t_host(base, n1, factor, device)  # factor * base^n1
    base_m = pow(base, n1, f128.P)  # base^N1
    if n2 <= MAX_AXIS:
        return ladder_t_host(base_m, n2, device=device), lad_lane
    if n1 > 1:  # pass 2's rows are in its initial layout order
        lad_lane = lad_lane.index_select(1, _layout_dev(n1, lad_lane.device)[0])
    mid = unpack_t(_mid_twiddles(n, inverse, inverse and top, device))  # (N1, 8, N2)
    pre = pack_t(ft.fmul(mid, lad_lane.transpose(0, 1)[:, :, None]))
    return Recursed(premultiplier(base_m, n2, inverse, device, top=False), pre)


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


def scale_by_ladder_t(x: torch.Tensor, base: int, n: int, scale=None) -> torch.Tensor:
    """x[..., 8, n] * base^i along the lane axis (``base`` a host int), via
    the index split n = n1 + N1*n2 (two broadcast multiplies, O(sqrt N)
    ladder memory).  ``scale``: the two ladders, :func:`class_scale` of
    the same base."""
    n2, n1 = _split(n)
    batch = tuple(x.shape[:-2])
    lad2, lad1 = class_scale(base, n, x.device) if scale is None else scale  # (8, N2), (8, N1)
    y = x.reshape(batch + (8, n2, n1)).transpose(-3, -2)  # (..., N2, 8, N1)
    y = ft.fmul(ft.fmul(y, lad1), lad2.transpose(0, 1)[:, :, None])
    return y.transpose(-3, -2).reshape(batch + (8, n))


def class_scale(base: int, t: int, device):
    """The rank-1 premultiplier of a size-t coset NTT at ``base`` (a host
    int), on ``device``: ((base^N1)^n2 over N2 rows, base^n1 over N1
    lanes), two host-constant ladders.  When the transform recurses,
    :func:`class_ntt_t` applies it unfused."""
    n2, n1 = _split(t)
    return ladder_t_host(pow(base, n1, f128.P), n2, device=device), ladder_t_host(base, n1, device=device)


def class_ntt_t(coeffs_t: torch.Tensor, base: int, scale=None) -> torch.Tensor:
    """Evaluate degree-<T polynomials on the coset base*<w_T>: the base^n
    scale fused into the pass-1 kernel.  coeffs_t (..., 8, T); base a host
    int; ``scale`` = a cached :func:`class_scale` of the same base."""
    t = coeffs_t.shape[-1]
    if t == 1:
        return coeffs_t
    if scale is None:
        scale = class_scale(base, t, coeffs_t.device)
    if _split(t)[0] > MAX_AXIS:  # recursion path: apply the scale unfused
        return _ntt_t_core(scale_by_ladder_t(coeffs_t, base, t, scale), False)
    return _ntt_t_core(coeffs_t, False, scale_r1=scale)


@functools.lru_cache(maxsize=None)
def _coset_premultiplier(offset: int, d: int, max_axis: int, device):
    """:func:`premultiplier` of offset^i for a size-d transform; the key
    holds MAX_AXIS, which shapes the form (tests patch it).  An O(d) table
    where pass 1 recurses (128 MiB at d = 2^23)."""
    return premultiplier(offset, d, False, device)


def coset_lde_t(coeffs_t: torch.Tensor, blowup: int, offset: int = f128.DOMAIN_OFFSET) -> torch.Tensor:
    """Evaluate degree-<T polynomials (..., 8, T) on the whole coset
    offset*<w_D>, D = blowup*T: (..., 8, D) in natural order
    (``ntt_jax.coset_lde``).  Zero-pad to D and run one size-D transform
    with the offset ladder fused into K1 as its premultiplier (pass 1
    recurses past MAX_AXIS)."""
    d = blowup * coeffs_t.shape[-1]
    pre = _coset_premultiplier(offset, d, MAX_AXIS, coeffs_t.device)
    return _ntt_t_core(torch.nn.functional.pad(coeffs_t, (0, d - coeffs_t.shape[-1])), False, scale_r1=pre)
