"""Sharded NTT: the four-step decomposition over the ranks of a mesh.

Port of :mod:`zkvm.dist.ntt_dist` in the transposed layout.  Each rank
holds the local block (..., 8, L) of an (..., 8, N) array, rows
[qL, (q+1)L), N = P L.  Writing an input row n = n1 L + n2 (n1 the rank)
and an output row k = k1 + P k2,

    X[k1 + P k2] = NTT_L over n2 [ w^(n2 k1) NTT_P over n1 [ x[n1 L + n2] ] ]

1. exchange 1 (:func:`comm.all_to_all`): rank q receives every rank's
   chunk q of n2, so it holds all of n1 for L/P columns;
2. the P-point NTTs along n1 (kernel K1 at M = P, ``ntt_t._axis_ntt``);
3. exchange 2: rank q takes k1 = q for all n2;
4. the twiddles w^(n2 k1) = (w^q)^n2 and the L-point NTT along n2 (K1):
   on rank q the twiddles are a coset scale of base w^q, built from
   ``ntt_t.ladder_t`` ladders and fused into K1 as its premultiplier
   (``ntt_t.premultiplier``: pass 1's where it is one launch; where it
   recurses, L > 2^18, the inner transform's and pass 2's).  The reference
   multiplies them in before exchange 2, from P host starts
   (``zkvm/dist/ntt_dist.py:48-66``); after it they are one geometric
   ladder a rank, and fused they cost no launch of their own (a plain
   limb multiply over the whole block would hold ~50 bytes of int64
   transients an input byte on the CPU);
5. exchange 3 and a local transpose, back to natural row blocks.

The inverse transform's 1/N is 1/L from K1's mid twiddles times 1/P folded
into the premultiplier.  Every value is exact, so the blocks joined equal
``ntt_t.ntt_t`` of the whole array.  Where N < P^2 (no four-step split) the
blocks are gathered, transformed whole and sliced, in the open: the
reference's GSPMD fallback (``ntt_dist.py:117-121``).
"""

from __future__ import annotations

import functools

import torch

from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.ntt import ntt_t as nt
from . import comm

@functools.lru_cache(maxsize=None)
def _twiddle_scale(n: int, p: int, q: int, inverse: bool, device, max_axis: int):
    """Rank q's twiddles w_N^(q n2) over n2 < L = N / P (times 1/P for the
    inverse) as the premultiplier of its L-point transform
    (``ntt_t.premultiplier`` of base w^q, fused into K1 at every L; the
    cache key holds ``ntt_t.MAX_AXIS``, which shapes it)."""
    w = f128.get_root_of_unity(n)
    if inverse:
        w = f128.finv(w)
    col = lambda v: ft.const_col(v, device)[:, 0]
    return nt.premultiplier(col(pow(w, q, f128.P)), n // p, inverse, col(f128.finv(p)) if inverse else None)


def _twiddled_transform(y: torch.Tensor, n: int, p: int, q: int, inverse: bool) -> torch.Tensor:
    """The L-point (i)NTT along n2 of y[n2] w^(q n2) (and 1/N for the
    inverse), the twiddles premultiplying K1's passes as a coset NTT's
    scale does."""
    if p == 1:  # one rank: no twiddles
        return nt.intt_t(y) if inverse else nt.ntt_t(y)
    scale = _twiddle_scale(n, p, q, inverse, y.device, nt.MAX_AXIS)
    return nt._ntt_t_core(y, inverse, scale_r1=scale)


def _four_step_ok(local: int, p: int) -> bool:
    return local % p == 0


def _check_mesh(mesh) -> None:
    if mesh.size & (mesh.size - 1):
        raise ValueError(f"sharded NTT: a mesh of {mesh.size} ranks; the size must be a power of two")


def _ntt_dist(x: torch.Tensor, mesh, inverse: bool) -> torch.Tensor:
    """x: this rank's (..., 8, L) block -> its block of NTT(x), natural order."""
    p, q, local = mesh.size, mesh.rank, x.shape[-1]
    chunk = local // p
    batch = tuple(x.shape[:-2])
    # exchange 1: chunk r of n2 to rank r -> (..., P[n1], 8, chunk)
    y = x.reshape(batch + (8, p, chunk)).transpose(-3, -2)
    y = comm.all_to_all(y, mesh, dim=-3)
    # P-point NTTs along n1 (K1 at M = P)
    y = nt._axis_ntt(y, p, inverse)
    # exchange 2: k1 = r to rank r -> (..., P[n2 chunk], 8, chunk), n2 natural
    y = comm.all_to_all(y, mesh, dim=-3)
    y = y.transpose(-3, -2).reshape(batch + (8, local))
    # the twiddles w^(n2 q) and the L-point NTT along n2: position k2 holds
    # X[q + P k2]
    y = _twiddled_transform(y, local * p, p, q, inverse)
    # exchange 3: k2 block r to rank r; from rank q' at j comes X[r L + q' + P j]
    y = y.reshape(batch + (8, p, chunk)).transpose(-3, -2)
    y = comm.all_to_all(y, mesh, dim=-3)  # (..., P[q'], 8, chunk[j])
    return y.movedim(-3, -1).reshape(batch + (8, local))  # local row j P + q'


def _gathered(x: torch.Tensor, mesh, transform) -> torch.Tensor:
    """The fallback: gather the blocks, transform the whole array, slice."""
    whole = comm.all_gather(x, mesh, dim=-1)
    return transform(whole)[..., mesh.rows(whole.shape[-1])].contiguous()


def ntt_sharded(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward NTT of an (..., 8, N) array from this rank's block
    (..., 8, L): this rank's block of the result, natural order."""
    _check_mesh(mesh)
    if not _four_step_ok(x.shape[-1], mesh.size):
        return _gathered(x, mesh, nt.ntt_t)
    return _ntt_dist(x, mesh, False)


def intt_sharded(x: torch.Tensor, mesh) -> torch.Tensor:
    """Inverse NTT (scaled by 1/N) of a row-sharded (..., 8, N) array."""
    _check_mesh(mesh)
    if not _four_step_ok(x.shape[-1], mesh.size):
        return _gathered(x, mesh, nt.intt_t)
    return _ntt_dist(x, mesh, True)


def coset_lde_sharded(coeffs: torch.Tensor, blowup: int, mesh,
                      offset: int = f128.DOMAIN_OFFSET) -> torch.Tensor:
    """Sharded coset LDE: this rank's block (..., 8, T/P) of degree-<T
    coefficients -> its block (..., 8, D/P) of the evaluations on
    offset * <w_D>, D = blowup T (``ntt_t.coset_lde_t`` joined).

    Each rank scales its coefficients by offset^t; the scaled
    coefficients are gathered (the zero-padded array's first T rows lie in
    the first ranks' blocks), each rank takes its block of the padded
    array, and the size-D transform is the four-step one."""
    local_t = coeffs.shape[-1]
    t = local_t * mesh.size
    start = pow(offset, mesh.rank * local_t, f128.P)
    scaled = nt.ladder_t_host(offset, local_t, start, coeffs.device, x=coeffs)
    whole = comm.all_gather(scaled, mesh, dim=-1)  # (..., 8, T)
    rows = mesh.rows(blowup * t)
    block = torch.zeros(whole.shape[:-1] + (rows.stop - rows.start,), dtype=whole.dtype, device=whole.device)
    take = max(0, min(rows.stop, t) - rows.start)
    block[..., :take] = whole[..., rows.start:rows.start + take]
    return ntt_sharded(block, mesh)
