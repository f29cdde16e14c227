"""Multi-point polynomial evaluation as one exact float64 matrix product.

Port of ``zkvm.prover.eval_mxu`` (``_contract``, ``multi_eval_rows``).
rows[q][c] = sum_t coeffs[c][t] * pt_q^t.  Each field element splits into
32 four-bit nibbles, so the evaluation becomes one (C*32, T) x (T, Q*32)
product S[c*32+i][q*32+j] = sum_t A_i[c,t] B_j[q,t].  The reference runs it
as an int8 dot; here it is ``torch.matmul`` on float64, which is exact:
every partial sum is at most 15*15*T < 2^53 (float32 would not be past
T = 2^16, and CUDA has no int64 matmul).  The anti-diagonal buckets over
i + j and the base-2^4 recombination mod p happen on the host.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from zkvm_torch.field import f128
from zkvm_torch.field.limbs import from_numpy, to_limbs
from zkvm_torch.ntt import ntt_t as nt
from . import limits

MAX_T = 1 << 40  # 225 * T stays below 2^53 (exact float64 sums)


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


def multi_eval_rows(coeffs_t: torch.Tensor, points: Sequence[int]) -> List[List[int]]:
    """Evaluate the C transposed column polynomials at each point; host ints
    as rows[q][c]."""
    t = coeffs_t.shape[-1]
    if t > MAX_T:
        raise ValueError(f"multi_eval_rows: T={t} exceeds exact float64 range")
    bases = from_numpy(to_limbs(list(points)), coeffs_t.device)
    if t >= limits.CHUNK_T and len(points) > 2:
        # points in pairs from CHUNK_T on (the reference's, eval_mxu.py:97):
        # the ladders of Q points build (Q, 8, T) through one broadcast limb
        # multiply, whose plain (CPU) int64 transients are ~50 bytes an
        # output byte (~51 GB at Q = 32, T = 2^20); a pair is the OOD
        # frame's shape.  On a card the field-op kernel has none: the
        # queries stage at T = 2^18 peaked at 3.89 GiB in pairs, 6.25 GiB
        # in one piece (chip_smoke.py phase g, NVIDIA H100 80GB HBM3).
        # The two O(sqrt T) ladder factors are built once for every point
        # (the reference rebuilds them a pair; here each build is thousands
        # of kernel launches).  Values unchanged.
        l1, l2 = nt.ladders_split(bases, t)
        vals = np.concatenate([_contract(coeffs_t, nt.ladders_join(l1[i : i + 2], l2[i : i + 2]))
                               for i in range(0, len(points), 2)], axis=-1)
    else:
        vals = _contract(coeffs_t, nt.ladders_t(bases, t))
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
