"""Periodic columns (CYCLE_MASK + 8 ARK columns) on the host.

Port of ``zkvm.air.periodic.periodic_class_patterns`` and ``periodic_at``
with numpy and the JAX package's golden Rescue constants and NTT.  A
periodic column with a 16-step cycle has interpolant poly16(x^(T/16)); on
the LDE coset its values restricted to one blowup class repeat with literal
period 16 in the class index, so a class's column is one 16-value pattern.
"""

from __future__ import annotations

import functools

import numpy as np

from zkvm.air.layout import CYCLE_MASK
from zkvm.field import f128
from zkvm.hash.rescue import get_round_constants
from zkvm.ntt import golden as gntt
from zkvm_torch.field.limbs import to_limbs

CYCLE = 16


@functools.lru_cache(maxsize=None)
def _periodic_small(trace_len: int, blowup: int) -> np.ndarray:
    """(9, 16*blowup, 8) limbs: CYCLE_MASK then 8 ARK columns on the coset."""
    offset = pow(f128.DOMAIN_OFFSET, trace_len // CYCLE, f128.P)
    cols = [CYCLE_MASK] + get_round_constants()
    out = [gntt.coset_lde(gntt.intt(list(c)), blowup, offset) for c in cols]
    return to_limbs(out)


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
