"""Multi-point polynomial evaluation: rows[q][c] = sum_t coeffs[c][t] * pt_q^t.

Port of ``zkvm.prover.eval_mxu`` (``_contract``, ``multi_eval_rows``): the
OOD frame and the query rows.  :func:`multi_eval_rows` (and
:func:`multi_eval_rows_many`, several coefficient tensors at one point
set) dispatches on the device.  On a CUDA tensor it makes the points'
ladder operands in one launch of ``zk_meval_ladders`` (pt^t = l1[t mod S]
l2[t div S] at ``ntt_t.ladders_split``'s S, l1 as the byte matrix of the
tensor cores, l2 packed; :class:`Ladders`) and launches ``zk_multi_eval``
once a coefficient tensor, both in ``csrc/multi_eval.cu``: a u8 ``mma``
contraction over l1 with the sums mod p and the l2 factors on the card,
returning canonical (Q, C, 8) limbs; the host copies those Q C 32 bytes
once a call and turns them into ints (or it raises: no fallback).  A
tensor may take a span of the point set (``spans``), so the OOD frame's
z, z g and z^8 share one ladder launch: the trace at the first two, the
composition at the third.  On a
CPU tensor it takes the plain version, :func:`multi_eval_rows_plain`; any
other device raises.

The plain version is the reference's nibble contraction: each field
element splits into 32 four-bit nibbles, so the evaluation becomes one
(C*32, T) x (T, Q*32) product S[c*32+i][q*32+j] = sum_t A_i[c,t] B_j[q,t].
The reference runs it as an int8 dot; here it is ``torch.matmul`` on
float64, which is exact: every partial sum is at most 15*15*T < 2^53
(float32 would not be past T = 2^16, and CUDA has no int64 matmul).  The
anti-diagonal buckets over i + j and the base-2^4 recombination mod p
happen on the host, and its ladders take the plain arithmetic
(``f128t.PLAIN``) by name.  On the card it runs only as the kernel's
yardstick (``chip_smoke.py``, ``kernel_bench.py``), and then launches no
kernel; each call counts in the launch ledger as ``multi_eval_plain``
(``kernels.count``), so a run can show that no prove took it.  The ladder kernel's plain version is :func:`ladders_plain`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import NLIMBS, from_limbs, from_numpy, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as nt
from . import limits

MAX_T = 1 << 40  # 225 * T stays below 2^53 (exact float64 sums)
MAX_S = 1 << 15  # the kernel's s32 sums of S products of two bytes, 255^2 S < 2^31
LADDER_ALIGN = 64  # a ladder byte row's length is a multiple of this (csrc/multi_eval.cu kLdbAlign)



class Ladders(NamedTuple):
    """The ladder operands of Q points over T lanes at factor S (the
    multi-eval kernel's B and its l2 factor): ``digits`` (Q 16, ldb) uint8,
    byte j of pt_q^lo at row 16 q + j, column lo < S, zeros past S (ldb a
    multiple of LADDER_ALIGN); ``cells`` (Q, N2, 4) int32, pt_q^(S hi) as
    its four 32-bit words."""

    digits: torch.Tensor
    cells: torch.Tensor
    s: int


def split(t: int):
    """(S, N2) of T lanes: ``ntt_t.ladders_split``'s factors; T past 2^30
    (S past MAX_S) raises."""
    s = 1 << ((t.bit_length() - 1 + 1) // 2)
    if s > MAX_S:
        raise ValueError(f"multi_eval: T = {t} needs a ladder factor of {s} lanes: above {MAX_S} the s32 sums of "
                         "byte products could wrap")
    return s, max(1, t // s)


def ladders_from(l1: torch.Tensor, l2: torch.Tensor) -> Ladders:
    """The ladder operands of factors l1 (Q, 8, S) and l2 (Q, 8, N2) limbs,
    in plain torch."""
    q, _, s = l1.shape
    ldb = -(-s // LADDER_ALIGN) * LADDER_ALIGN
    digits = torch.zeros((q, 8, 2, ldb), dtype=torch.uint8, device=l1.device)
    digits[..., 0, :s] = (l1 & 0xFF).to(torch.uint8)
    digits[..., 1, :s] = (l1 >> 8).to(torch.uint8)
    w = l2.long().transpose(-1, -2).reshape(q, l2.shape[-1], 4, 2)  # (Q, N2, word, limb)
    words = w[..., 0] | w[..., 1] << 16
    cells = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32).contiguous()
    return Ladders(digits.reshape(q * 16, ldb), cells, s)


def ladders_plain(bases: torch.Tensor, t: int) -> Ladders:
    """The ladder kernel's plain version: ``ladders_split`` of the (Q, 8)
    bases over T lanes in the plain arithmetic, taken to bytes."""
    return ladders_from(*nt.ladders_split(bases, t, ft.PLAIN))


def _nibbles(x: torch.Tensor) -> torch.Tensor:
    """(..., 8, T) 16-bit limbs -> (..., 32, T) nibbles, LSB first (slot
    4i + k holds bits 4k..4k+3 of limb i)."""
    parts = [(x >> (4 * k)) & 0xF for k in range(4)]
    s = torch.stack(parts, dim=-2)  # (..., 8, 4, T)
    return s.reshape(x.shape[:-2] + (32, x.shape[-1]))


def _contract(coeffs_t: torch.Tensor, lads_t: torch.Tensor) -> np.ndarray:
    """(C, 8, T) x (Q, 8, T) -> exact bucket sums (63, C, Q) int64 (host)."""
    c, _, t = coeffs_t.shape
    q = lads_t.shape[0]
    a = _nibbles(coeffs_t).reshape(c * 32, t).double()
    b = _nibbles(lads_t).reshape(q * 32, t).double()
    s = torch.matmul(a, b.transpose(0, 1)).cpu().numpy().astype(np.int64)
    s = s.reshape(c, 32, q, 32)
    out = np.zeros((63, c, q), dtype=np.int64)
    for i in range(32):
        out[i : i + 32] += np.transpose(s[:, i, :, :], (2, 0, 1))  # (j, c, q)
    return out


def _checked(coeffs_t: torch.Tensor, points: Sequence[int]):
    """(C, Q, T) of a call, after checking what the kernel takes: (C, 8, T)
    contiguous int32 limbs, T a power of two, at least one point.  Runs on
    every device, so a CPU test catches what the card would refuse."""
    t = coeffs_t.shape[-1]
    if coeffs_t.dim() != 3 or coeffs_t.shape[1] != NLIMBS or 0 in coeffs_t.shape or t & (t - 1):
        raise ValueError(f"multi_eval_rows: coeffs_t of shape {tuple(coeffs_t.shape)}, expected (C, 8, T), "
                         "T a power of two")
    kernels.expect(coeffs_t, coeffs_t.shape, coeffs_t.device, "coeffs_t")
    if not len(points):
        raise ValueError("multi_eval_rows: no points")
    return coeffs_t.shape[0], len(points), coeffs_t.shape[-1]


def multi_eval_rows_plain(coeffs_t: torch.Tensor, points: Sequence[int]) -> List[List[int]]:
    """The plain version: the ladders by the plain arithmetic, the nibble
    contraction as a float64 product, the buckets and the recombination
    on the host; host ints as rows[q][c]."""
    kernels.count("multi_eval_plain")
    t = coeffs_t.shape[-1]
    if t > MAX_T:
        raise ValueError(f"multi_eval_rows: T={t} exceeds exact float64 range")
    bases = from_numpy(to_limbs(list(points)), coeffs_t.device)
    if t >= limits.CHUNK_T and len(points) > 2:
        # points in pairs from CHUNK_T on (the reference's, eval_mxu.py:97):
        # the ladders of Q points build (Q, 8, T) through one broadcast limb
        # multiply, whose plain (CPU) int64 transients are ~50 bytes an
        # output byte (~51 GB at Q = 32, T = 2^20), and the float64 nibble
        # matrices of Q points are 2 KB a t; a pair is the OOD frame's
        # shape.  The two O(sqrt T) ladder factors are built once for every
        # point.  Values unchanged.
        l1, l2 = nt.ladders_split(bases, t, ft.PLAIN)
        vals = np.concatenate([_contract(coeffs_t, nt.ladders_join(l1[i : i + 2], l2[i : i + 2], ft.PLAIN))
                               for i in range(0, len(points), 2)], axis=-1)
    else:
        vals = _contract(coeffs_t, nt.ladders_t(bases, t, ft.PLAIN))
    c = coeffs_t.shape[0]
    rows: List[List[int]] = []
    for qi in range(len(points)):
        row = []
        for ci in range(c):
            acc = 0
            for k in range(63):
                acc += int(vals[k, ci, qi]) << (4 * k)
            row.append(acc % f128.P)
        rows.append(row)
    return rows


def launch_ladders(lib, stream, bases: torch.Tensor, t: int) -> Ladders:
    """Call the ladder entry point of ``lib`` on the (Q, 8) int32 limbs of
    the points: their :class:`Ladders` over T lanes at ``split(T)``, from
    the caching allocator, in one launch."""
    q = bases.shape[0]
    kernels.expect(bases, (q, NLIMBS), bases.device, "bases")
    s, n2 = split(t)
    ldb = -(-s // LADDER_ALIGN) * LADDER_ALIGN
    digits = torch.empty((q * 16, ldb), dtype=torch.uint8, device=bases.device)
    cells = torch.empty((q, n2, 4), dtype=torch.int32, device=bases.device)
    p = kernels.ptr
    kernels.check(lib.zk_meval_ladders(p(bases), p(digits), ldb, p(cells), q, s, n2, stream), "zk_meval_ladders")
    kernels.count("meval_ladders", Q=q, T=t)
    return Ladders(digits, cells, s)


def launch_multi_eval(lib, stream, coeffs_t: torch.Tensor, lad: Ladders) -> torch.Tensor:
    """Call the multi-eval entry point of ``lib`` on contiguous int32 limbs
    coeffs_t (C, 8, T) and the ladder operands ``lad`` of Q points on the
    same device (S a power of two, at most MAX_S, S N2 >= T): the (Q, C, 8)
    canonical limbs of sum_t coeffs[c][t] l1[q][t mod S] l2[q][t div S].
    The work buffer and the output come from the caching allocator;
    nothing is copied to the device, so it never waits for the stream."""
    if coeffs_t.dim() != 3 or lad.digits.dim() != 2 or lad.cells.dim() != 3 or 0 in (*coeffs_t.shape,
                                                                                      *lad.cells.shape):
        raise ValueError(f"multi_eval: shapes {tuple(coeffs_t.shape)}, {tuple(lad.digits.shape)} and "
                         f"{tuple(lad.cells.shape)}, expected (C, 8, T), (Q 16, ldb) and (Q, N2, 4)")
    c, _, t = coeffs_t.shape
    q, n2, _ = lad.cells.shape
    s, ldb = lad.s, lad.digits.shape[-1]
    if s < 1 or s & (s - 1) or s * n2 < t:
        raise ValueError(f"multi_eval: ladder factors of {s} x {n2} lanes for T = {t}")
    if s > MAX_S:
        raise ValueError(f"multi_eval: ladder factor of {s} lanes: above {MAX_S} the s32 sums of byte products "
                         "could wrap")
    if ldb < s or ldb % LADDER_ALIGN:
        raise ValueError(f"multi_eval: ladder rows of {ldb} bytes for S = {s}")
    kernels.expect(coeffs_t, (c, NLIMBS, t), coeffs_t.device, "coeffs_t")
    kernels.expect(lad.digits, (q * 16, ldb), coeffs_t.device, "digits", torch.uint8)
    kernels.expect(lad.cells, (q, n2, 4), coeffs_t.device, "cells")
    slices = lib.zk_multi_eval_slices(c, q, t, s)
    work = torch.empty((slices, q, c, 4), dtype=torch.int32, device=coeffs_t.device)
    out = torch.empty((q, c, NLIMBS), dtype=torch.int32, device=coeffs_t.device)
    p = kernels.ptr
    rc = lib.zk_multi_eval(p(coeffs_t), p(lad.digits), ldb, p(lad.cells), p(work), slices, p(out), c, q, t, s, n2,
                           stream)
    kernels.check(rc, "zk_multi_eval")
    kernels.count("multi_eval", C=c, Q=q, T=t)
    return out


def _spans(spans, q: int, k: int):
    """The (start, stop) point rows of each of ``k`` tensors at a set of
    ``q`` points: ``spans`` checked, or every point for each."""
    if spans is None:
        return [(0, q)] * k
    spans = [tuple(sp) for sp in spans]
    if len(spans) != k or any(not 0 <= a < b <= q for a, b in spans):
        raise ValueError(f"multi_eval: point spans {spans} for {k} tensors at {q} points")
    return spans


def evaluate(lib, stream, coeffs_ts: Sequence[torch.Tensor], bases: torch.Tensor, spans=None) -> List[torch.Tensor]:
    """Through the entry points of ``lib``: the ladder operands of the (Q, 8)
    bases in one launch, then for each coefficient tensor (one T for all)
    its (Q', C, 8) canonical limbs in one multi-eval call at the points of
    its span (``spans``: one (start, stop) a tensor, every point by
    default; a span reads its rows of the one :class:`Ladders`)."""
    q, t = bases.shape[0], coeffs_ts[0].shape[-1]
    spans = _spans(spans, q, len(coeffs_ts))
    lad = launch_ladders(lib, stream, bases, t)
    outs = []
    for x, (a, b) in zip(coeffs_ts, spans):
        view = lad if (a, b) == (0, q) else Ladders(lad.digits[16 * a:16 * b], lad.cells[a:b], lad.s)
        outs.append(launch_multi_eval(lib, stream, x, view))
    return outs


def multi_eval_many_t(coeffs_ts: Sequence[torch.Tensor], points: Sequence[int], spans=None) -> List[torch.Tensor]:
    """The card's part of :func:`multi_eval_rows_many`: for each coefficient
    tensor (one T for all) its (Q', C, 8) canonical limbs at the points of
    its span on the card, by :func:`evaluate`.  The points go to the card
    by one copy from pinned memory that does not wait for the stream, so
    nothing here waits for it."""
    lengths = [_checked(x, points)[2] for x in coeffs_ts]
    dev = coeffs_ts[0].device
    if any(x.device != dev for x in coeffs_ts) or len(set(lengths)) != 1:
        raise ValueError(f"multi_eval: coefficient tensors of lengths {lengths} on "
                         f"{[str(x.device) for x in coeffs_ts]}, expected one length on one device")
    if dev.type != "cuda":
        raise ValueError(f"multi_eval: no kernel for device {dev}")
    _spans(spans, len(points), len(coeffs_ts))
    bases = torch.from_numpy(to_limbs(list(points)).view(np.int32)).pin_memory()
    return evaluate(kernels.lib(), kernels.stream_of(coeffs_ts[0]), coeffs_ts, bases.to(dev, non_blocking=True), spans)


def multi_eval_t(coeffs_t: torch.Tensor, points: Sequence[int]) -> torch.Tensor:
    """:func:`multi_eval_many_t` of one tensor."""
    return multi_eval_many_t([coeffs_t], points)[0]


def multi_eval_rows_many(coeffs_ts: Sequence[torch.Tensor], points: Sequence[int],
                         spans=None) -> List[List[List[int]]]:
    """Evaluate each tensor's C transposed column polynomials at the points
    of its span (``spans``: one (start, stop) a tensor, every point by
    default); host ints as rows[q][c], one list a tensor: on CUDA tensors
    one ladder launch for all the points and the kernel a tensor (or it
    raises), on CPU tensors the plain version."""
    spans = _spans(spans, len(points), len(coeffs_ts))
    if coeffs_ts and all(x.device.type == "cpu" for x in coeffs_ts):
        for x in coeffs_ts:
            _checked(x, points)
        return [multi_eval_rows_plain(x, points[a:b]) for x, (a, b) in zip(coeffs_ts, spans)]
    outs = multi_eval_many_t(coeffs_ts, points, spans)
    vals = from_limbs(to_numpy(torch.cat([o.reshape(-1, NLIMBS) for o in outs])))  # one copy to the host
    rows, i = [], 0
    for out in outs:
        q, c = out.shape[:2]
        rows.append([[int(v) for v in vals[i + r * c:i + (r + 1) * c]] for r in range(q)])
        i += q * c
    return rows


def multi_eval_rows(coeffs_t: torch.Tensor, points: Sequence[int]) -> List[List[int]]:
    """:func:`multi_eval_rows_many` of one tensor."""
    return multi_eval_rows_many([coeffs_t], points)[0]
