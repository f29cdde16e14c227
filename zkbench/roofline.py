"""The yardstick of the roofline shares: one H100's peaks and the work of a
proof, worked out from the configuration's sizes by the algorithm, not by
what the kernels happen to do.

The peaks and the per-operation counts are a frozen copy of
``chip_smoke.py``'s (its ``bound_ms`` and the counts beside it):

- HBM: 3.35 TB/s, NVIDIA's data sheet for the H100 SXM;
- 32-bit integer work: 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.73 T/s,
  derived from the boost clock (not a published figure; the run's
  ``device`` entry gives the card's clock and power limit beside it);
- an f128 add or subtract 8 such operations, a multiply 96; an element
  32 bytes (8 limbs of 16 bits in 32-bit words);
- a row of the composition (K3): 109 + k multiplies and 110 + k adds,
  k the distinct boundary columns; 32 elements moved (the 28 trace
  columns and the 3 domain factors read, the value written).

A share is the least time the chip could take, the larger of bytes over
the HBM rate and operations over the integer rate, over the device time
the trace gives the kernels of that family.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_ADD, OPS_MUL = 8, 96
LIMB_BYTES = 32
K4_MULS, K4_ADDS = 106, 106
K3_MULS, K3_ADDS = K4_MULS + 3, K4_ADDS + 4


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of the work, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    return n.bit_length() - 1


def ntt_work(n: int, columns: int, coset: bool):
    """(bytes, operations) of ``columns`` size-n transforms: n/2 log2 n
    butterflies (a multiply, an add and a subtract) a column, and a coset's
    n multiplies by the offset's powers; each input element read once and
    each output written once."""
    ops = columns * ((n // 2) * _log2(n) * (OPS_MUL + 2 * OPS_ADD) + (n * OPS_MUL if coset else 0))
    return 2 * columns * n * LIMB_BYTES, ops


def proof_ntt_work(t_len: int, blowup: int, width: int, comp_columns: int):
    """(bytes, operations) of the transforms a proof cannot do without: the
    trace's interpolation (``width`` inverse transforms of size T), its
    low-degree extension to D = blowup T (``blowup`` coset transforms of
    size T a column), the composition's interpolation (one inverse
    transform of size D) and its extension (``comp_columns`` columns of
    size T, ``blowup`` cosets each).  A layout that recomputes an
    extension, or takes the DEEP or FRI through transforms, does more on
    top; none does less."""
    d = t_len * blowup
    parts = [ntt_work(t_len, width, False), ntt_work(t_len, width * blowup, True),
             ntt_work(d, 1, False), ntt_work(t_len, comp_columns * blowup, True)]
    return sum(b for b, _ in parts), sum(o for _, o in parts)


def composition_work(t_len: int, blowup: int, boundary_columns: int):
    """(bytes, operations) of evaluating the constraints over the whole
    domain of D = blowup T rows."""
    rows = t_len * blowup
    k = boundary_columns
    return rows * (28 + 4) * LIMB_BYTES, rows * ((K3_MULS + k) * OPS_MUL + (K3_ADDS + k) * OPS_ADD)


# the distinct columns of the AIR's two boundary groups: at step 0 the
# clock, the depth, two hash lanes and eight stack registers; at the last
# step the two hash lanes and eight stack registers
BOUNDARY_COLUMNS = 12 + 10
