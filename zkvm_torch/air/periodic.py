"""Periodic columns (CYCLE_MASK + 8 ARK columns) on the host.

Port of ``zkvm.air.periodic`` with numpy and the golden Rescue constants
and NTT.  A periodic column with a 16-step cycle has interpolant
poly16(x^(T/16)); on the LDE coset its values repeat with period
16 * blowup, so the full domain needs one table of that length
(:func:`periodic_table`), and its values restricted to one blowup class
repeat with literal period 16 in the class index, so a class's column is
one 16-value pattern (:func:`periodic_class_patterns`).
"""

from __future__ import annotations

import functools

import numpy as np

from zkvm_torch.air.layout import CYCLE_MASK
from zkvm_torch.field import f128
from zkvm_torch.hash.rescue import get_round_constants
from zkvm_torch.ntt import golden as gntt
from zkvm_torch.field.limbs import to_limbs

CYCLE = 16


@functools.lru_cache(maxsize=None)
def _periodic_small(trace_len: int, blowup: int) -> np.ndarray:
    """(9, 16*blowup, 8) limbs: CYCLE_MASK then 8 ARK columns on the coset."""
    offset = pow(f128.DOMAIN_OFFSET, trace_len // CYCLE, f128.P)
    cols = [CYCLE_MASK] + get_round_constants()
    out = [gntt.coset_lde(gntt.intt(list(c)), blowup, offset) for c in cols]
    return to_limbs(out)


def periodic_table(trace_len: int, blowup: int) -> np.ndarray:
    """(9, 8, 16*blowup) transposed uint32 limbs: CYCLE_MASK then the 8 ARK
    columns over one period of the LDE domain (domain point i reads i mod
    16*blowup)."""
    return np.ascontiguousarray(np.swapaxes(_periodic_small(trace_len, blowup), -1, -2))


def periodic_lde(trace_len: int, blowup: int):
    """The tables tiled over the domain D = trace_len * blowup: mask (8, D)
    and ark (8, 8, D) transposed limbs (``zkvm.air.periodic.periodic_lde``
    in the transposed layout)."""
    tab = periodic_table(trace_len, blowup)
    tiled = np.tile(tab, (1, 1, trace_len // CYCLE))
    return tiled[0], tiled[1:]


def periodic_class_patterns(trace_len: int, blowup: int):
    """Per-class 16-step patterns as uint32 limbs: mask (B, 16, 8) and
    ark (B, 8, 16, 8); class r holds LDE positions r + blowup*k."""
    small = _periodic_small(trace_len, blowup)
    per_class = np.stack([small[:, r::blowup, :] for r in range(blowup)], axis=0)
    return per_class[:, 0], per_class[:, 1:]


def periodic_at(trace_len: int, x: int):
    """Host eval of (mask, ark[8]) at an arbitrary point x (OOD checks)."""
    y = pow(x, trace_len // CYCLE, f128.P)
    cols = [CYCLE_MASK] + get_round_constants()
    vals = [gntt.eval_poly(gntt.intt(list(c)), y) for c in cols]
    return vals[0], vals[1:]
