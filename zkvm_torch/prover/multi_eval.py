"""Multi-point polynomial evaluation: rows[q][c] = sum_t coeffs[c][t] * pt_q^t.

Port of ``zkvm.prover.eval_mxu`` (``_contract``, ``multi_eval_rows``): the
OOD frame and the query rows.  :func:`multi_eval_rows` dispatches on the
device.  On a CUDA tensor it builds the two O(sqrt T) factors of the
power ladders of all Q points at once (``ntt_t.ladders_split``, field-op
launches; pt^t = l1[t mod S] l2[t div S]) and launches the kernel
``csrc/multi_eval.cu``, a direct field dot product that joins the factors
as it goes and returns canonical (Q, C, 8) limbs; the host copies those
Q C 32 bytes and turns them into ints (or it raises: no fallback).  On a CPU tensor it takes the
plain version, :func:`multi_eval_rows_plain`; any other device raises.

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
kernel; ``plain_calls`` counts its calls, so a run can show that no prove
took it.
"""

from __future__ import annotations

import collections
from typing import List, Sequence

import numpy as np
import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import NLIMBS, from_limbs, from_numpy, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as nt
from . import limits

MAX_T = 1 << 40  # 225 * T stays below 2^53 (exact float64 sums)

launches = 0  # calls of the multi-eval kernel's entry in this process (two launches each)
launches_by_shape = collections.Counter()  # the same, by (C, Q, T)
plain_calls = 0  # calls of multi_eval_rows_plain in this process


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
    global plain_calls
    plain_calls += 1
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


def launch_multi_eval(lib, stream, coeffs_t: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Call the multi-eval entry point of ``lib`` on contiguous int32 limbs
    coeffs_t (C, 8, T) and the ladder factors l1 (Q, 8, S), S a power of
    two, and l2 (Q, 8, N2), S N2 >= T, on one device: the (Q, C, 8)
    canonical limbs of sum_t coeffs[c][t] l1[q][t mod S] l2[q][t div S].
    The work buffer and the output come from the caching allocator;
    nothing is copied to the device, so it never waits for the stream."""
    if coeffs_t.dim() != 3 or l1.dim() != 3 or l2.dim() != 3 or 0 in (*coeffs_t.shape, *l1.shape, *l2.shape):
        raise ValueError(f"multi_eval: shapes {tuple(coeffs_t.shape)}, {tuple(l1.shape)} and {tuple(l2.shape)}, "
                         "expected (C, 8, T), (Q, 8, S) and (Q, 8, N2)")
    c, _, t = coeffs_t.shape
    q, _, s = l1.shape
    n2 = l2.shape[-1]
    if s & (s - 1) or s * n2 < t:
        raise ValueError(f"multi_eval: ladder factors of {s} x {n2} lanes for T = {t}")
    kernels.expect(coeffs_t, (c, NLIMBS, t), coeffs_t.device, "coeffs_t")
    kernels.expect(l1, (q, NLIMBS, s), coeffs_t.device, "l1")
    kernels.expect(l2, (q, NLIMBS, n2), coeffs_t.device, "l2")
    slices = lib.zk_multi_eval_slices(c, q, t)
    work = torch.empty((slices, q, c, 4), dtype=torch.int32, device=coeffs_t.device)
    out = torch.empty((q, c, NLIMBS), dtype=torch.int32, device=coeffs_t.device)
    p = kernels.ptr
    rc = lib.zk_multi_eval(p(coeffs_t), p(l1), p(l2), p(work), slices, p(out), c, q, t, s, n2, stream)
    kernels.check(rc, "zk_multi_eval")
    return out


def ladder_factors(bases: torch.Tensor, t: int):
    """(l1 (Q, 8, S), l2 (Q, 8, T / S)), contiguous: the factors of the
    ladders of the (Q, 8) bases over T lanes, base^i = l1[i mod S]
    l2[i div S] (``ntt_t.ladders_split``)."""
    return tuple(f.contiguous() for f in nt.ladders_split(bases, t))


def multi_eval_t(coeffs_t: torch.Tensor, points: Sequence[int]) -> torch.Tensor:
    """The card's part of :func:`multi_eval_rows`: (Q, C, 8) canonical limbs
    on the card, from the points' ladder factors and one kernel call.  The
    points go to the card by one copy from pinned memory that does not
    wait for the stream, so nothing here waits for it."""
    global launches
    c, q, t = _checked(coeffs_t, points)
    if coeffs_t.device.type != "cuda":
        raise ValueError(f"multi_eval: no kernel for device {coeffs_t.device}")
    bases = torch.from_numpy(to_limbs(list(points)).view(np.int32)).pin_memory()
    l1, l2 = ladder_factors(bases.to(coeffs_t.device, non_blocking=True), t)
    out = launch_multi_eval(kernels.lib(), kernels.stream_of(coeffs_t), coeffs_t, l1, l2)
    launches += 1
    launches_by_shape[(c, q, t)] += 1
    return out


def multi_eval_rows(coeffs_t: torch.Tensor, points: Sequence[int]) -> List[List[int]]:
    """Evaluate the C transposed column polynomials at each point; host ints
    as rows[q][c]: the kernel on a CUDA tensor (or it raises), the plain
    version on a CPU tensor."""
    if coeffs_t.device.type == "cpu":
        _checked(coeffs_t, points)
        return multi_eval_rows_plain(coeffs_t, points)
    vals = from_limbs(to_numpy(multi_eval_t(coeffs_t, points)))  # (Q, C) ints
    return [[int(v) for v in row] for row in vals]
