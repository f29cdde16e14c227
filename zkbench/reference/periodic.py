# Frozen copy of periodic_at from zkvm_torch/air/periodic.py (the benchmark's
# yardstick: plain host code that imports nothing of the program).
"""The periodic columns (CYCLE_MASK + 8 ARK columns) at one point."""

from __future__ import annotations

from zkbench.reference import f128
from zkbench.reference import ntt as gntt
from zkbench.reference.layout import CYCLE_MASK
from zkbench.reference.rescue import get_round_constants

CYCLE = 16


def periodic_at(trace_len: int, x: int):
    """Host eval of (mask, ark[8]) at an arbitrary point x (OOD checks)."""
    y = pow(x, trace_len // CYCLE, f128.P)
    cols = [CYCLE_MASK] + get_round_constants()
    vals = [gntt.eval_poly(gntt.intt(list(c)), y) for c in cols]
    return vals[0], vals[1:]
