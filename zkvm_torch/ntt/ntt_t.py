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

import collections
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

def _one(device) -> torch.Tensor:
    return ft.const_col(1, device)[:, 0]


def _ladder_impl(base: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) = scale * base^i: doubling up to 256 lanes, then the sqrt
    split base^i = base^(i mod S) * (base^S)^(i div S) as one outer-product
    multiply."""
    if n <= 256:
        cur = scale[:, None]
        step = base[:, None]
        while cur.shape[1] < n:
            cur = torch.cat([cur, ft.fmul(cur, step)], dim=1)
            step = ft.fsquare(step)
        return cur
    s = 1 << ((n.bit_length() - 1 + 1) // 2)
    l1 = _ladder_impl(base, scale, s)  # (8, S), carries the scale
    base_s = base
    for _ in range(s.bit_length() - 1):
        base_s = ft.fsquare(base_s[:, None])[:, 0]
    l2 = _ladder_impl(base_s, _one(base.device), n // s)  # (8, N2)
    prod = ft.fmul(l2.transpose(0, 1)[:, :, None], l1[None])  # (N2, 8, S)
    return prod.transpose(0, 1).reshape(8, n)


def ladder_t(base: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n): scale * base^i for (8,) limb tensors base and scale."""
    assert n & (n - 1) == 0
    return _ladder_impl(base, scale, n)


def ladder_t_host(base: int, n: int, scale: int = 1, device="cpu") -> torch.Tensor:
    """(8, n) transposed limb tensor: scale * base^i for host ints."""
    return ladder_t(
        ft.const_col(base, device)[:, 0], ft.const_col(scale, device)[:, 0], n
    )


def _ladders_impl(bases: torch.Tensor, n: int) -> torch.Tensor:
    q = bases.shape[0]
    if n <= 256:
        cur = _one(bases.device)[None, :, None].expand(q, 8, 1)
        step = bases[:, :, None]
        while cur.shape[-1] < n:
            cur = torch.cat([cur, ft.fmul(cur, step)], dim=-1)
            step = ft.fsquare(step)
        return cur
    s = 1 << ((n.bit_length() - 1 + 1) // 2)
    l1 = _ladders_impl(bases, s)  # (Q, 8, S)
    base_s = bases
    for _ in range(s.bit_length() - 1):
        base_s = ft.fsquare(base_s[:, :, None])[:, :, 0]
    l2 = _ladders_impl(base_s, n // s)  # (Q, 8, N2)
    prod = ft.fmul(l2.transpose(-1, -2)[:, :, :, None], l1[:, None])  # (Q, N2, 8, S)
    return prod.transpose(-3, -2).reshape(q, 8, n)


def ladders_t(bases: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, 8, n): bases[q]^i for i < n, bases (Q, 8)."""
    assert n & (n - 1) == 0
    return _ladders_impl(bases, n)


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
    cols = ladders_t(lad.transpose(0, 1).contiguous(), n1)  # (N2, 8, N1)
    rows = ft.fmul(cols, ft.const_col(scale, device)).permute(2, 1, 0)
    if n1 > 1:
        rows = rows.index_select(0, _layout_dev(n1, device)[0])
    return pack_t(rows)


def _mid_twiddles(n: int, inverse: bool, scaled: bool, device) -> torch.Tensor:
    # the cache key holds the split (MAX_AXIS is test-patchable)
    return _mid_twiddles_cached(n, _split(n)[1], inverse, scaled, torch.device(device))


# ---------------------------------------------------------------------------
# kernel K1: the stage network along axis -3, natural order in and out
# ---------------------------------------------------------------------------

# launches of the CUDA kernel in this process, by (M, B, NL, variant)
launches = collections.Counter()


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


def _apply_pre(y, pre, r1):
    if pre is not None:
        y = ft.fmul(y, pre)
    elif r1 is not None:
        rs, ls = r1
        y = ft.fmul(ft.fmul(y, rs.transpose(0, 1)[:, :, None]), ls[None])
    return y


def pease_stages_plain(y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The bare stage network; y (..., M, 8, L) pre-permuted, tw
    (S, M/2, 8) limbs.  Counterpart of ntt_t._pease_stages_batched."""
    m = y.shape[-3]
    h = m // 2
    for s in range(tw.shape[0]):
        a = y[..., :h, :, :]
        b = ft.fmul(y[..., h:, :, :], tw[s][:, :, None])
        y = torch.cat([ft.fadd(a, b), ft.fsub(a, b)], dim=-3)
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
    y = _apply_pre(yb.index_select(-3, initial), None if pre is None else unpack_t(pre), r1)
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
    out = launch_stages(
        kernels.lib(), kernels.stream_of(yb), yb.contiguous(), tw.contiguous(),
        contig(pre), r1,
    )
    b, m, _, nl = yb.shape
    launches[(m, b, nl, "full" if pre is not None else "r1" if r1 is not None else "plain")] += 1
    return out


# ---------------------------------------------------------------------------
# axis transform and the flat four-step transform
# ---------------------------------------------------------------------------

def _axis_ntt(y, m, inverse, pre=None, r1=None):
    """NTT along axis -3 of (..., M, 8, L); natural order in/out.

    ``pre`` (packed (M, L, 4)) or ``r1`` premultiply the INPUT, given in
    permuted row order."""
    if m == 1:
        return _apply_pre(y, None if pre is None else unpack_t(pre), r1)
    batch = y.shape[:-3]
    yb = y.reshape((-1,) + tuple(y.shape[-3:]))
    out = pease_stages(yb, _stage_twiddles_dev(m, inverse, y.device), pre=pre, r1=r1)
    return out.reshape(batch + tuple(out.shape[-3:]))


def _ntt_t_core(x, inverse, top=True, scale_r1=None):
    """Four-step transform of (..., 8, N) -> (..., 8, N), natural order.

    ``scale_r1`` = (row ladder (8, N2), lane ladder (8, N1)) premultiplies
    the input by base^n, fused into the pass-1 kernel.  The iNTT's 1/N is
    fused into the top-level mid-twiddle tensor."""
    n = x.shape[-1]
    n2, n1 = _split(n)
    batch = tuple(x.shape[:-2])
    y = x.reshape(batch + (8, n2, n1)).transpose(-3, -2)  # (..., N2, 8, N1)
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
        assert scale_r1 is None
        y = y.transpose(-3, -1)  # (..., N1, 8, N2)
        y = _ntt_t_core(y.contiguous(), inverse, top=False)
    pre = _mid_twiddles(n, inverse, inverse and top, x.device)
    y = _axis_ntt(y, n1, inverse, pre=pre)  # [k1][limb][k2]
    return y.transpose(-3, -2).reshape(batch + (8, n))


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


def _pow2k(base: torch.Tensor, k: int) -> torch.Tensor:
    """base^(2^k) for an (8,) limb tensor."""
    for _ in range(k):
        base = ft.fsquare(base[:, None])[:, 0]
    return base


def scale_by_ladder_t(x: torch.Tensor, base: torch.Tensor, n: int) -> torch.Tensor:
    """x[..., 8, n] * base^i along the lane axis, via the index split
    n = n1 + N1*n2 (two broadcast multiplies, O(sqrt N) ladder memory)."""
    n2, n1 = _split(n)
    batch = tuple(x.shape[:-2])
    one = _one(x.device)
    lad1 = ladder_t(base, one, n1)  # (8, N1)
    lad2 = ladder_t(_pow2k(base, n1.bit_length() - 1), one, n2)  # (8, N2)
    y = x.reshape(batch + (8, n2, n1)).transpose(-3, -2)  # (..., N2, 8, N1)
    y = ft.fmul(ft.fmul(y, lad1), lad2.transpose(0, 1)[:, :, None])
    return y.transpose(-3, -2).reshape(batch + (8, n))


def class_scale(base: torch.Tensor, t: int):
    """The rank-1 premultiplier of a size-t coset NTT at ``base``:
    ((base^N1)^n2 over N2 rows, base^n1 over N1 lanes), or None when the
    transform recurses (the scale is then applied unfused)."""
    n2, n1 = _split(t)
    if n2 > MAX_AXIS:
        return None
    one = _one(base.device)
    lad_lane = ladder_t(base, one, n1)  # (8, N1)
    lad_m = ladder_t(_pow2k(base, n1.bit_length() - 1), one, n2)  # (8, N2)
    return lad_m, lad_lane


def class_ntt_t(coeffs_t: torch.Tensor, base: torch.Tensor, scale=None) -> torch.Tensor:
    """Evaluate degree-<T polynomials on the coset base*<w_T>: the base^n
    scale fused into the pass-1 kernel.  coeffs_t (..., 8, T); base (8,)
    limbs; ``scale`` = a cached :func:`class_scale` of the same base."""
    t = coeffs_t.shape[-1]
    if t == 1:
        return coeffs_t
    if _split(t)[0] > MAX_AXIS:  # recursion path: apply the scale unfused
        return _ntt_t_core(scale_by_ladder_t(coeffs_t, base, t), False)
    if scale is None:
        scale = class_scale(base, t)
    return _ntt_t_core(coeffs_t, False, scale_r1=scale)


def coset_lde_t(coeffs_t: torch.Tensor, blowup: int, offset: int = f128.DOMAIN_OFFSET) -> torch.Tensor:
    """Evaluate degree-<T polynomials (..., 8, T) on the whole coset
    offset*<w_D>, D = blowup*T: (..., 8, D) in natural order
    (``ntt_jax.coset_lde``).  Scale by the offset ladder, zero-pad to D and
    run one size-D transform (pass 1 recurses past MAX_AXIS)."""
    t = coeffs_t.shape[-1]
    base = ft.const_col(offset, coeffs_t.device)[:, 0]
    scaled = scale_by_ladder_t(coeffs_t, base, t)
    return ntt_t(torch.nn.functional.pad(scaled, (0, (blowup - 1) * t)))
