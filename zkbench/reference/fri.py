# Frozen copy of FOLD and fold_group_values from zkvm_torch/prover/fri.py (the
# benchmark's yardstick: plain host code that imports nothing of the program).
"""The verifier's fold of one opened FRI group."""

from __future__ import annotations

from typing import List

from zkbench.reference import f128

FOLD = 8


def fold_group_values(group: List[int], position: int, domain_size: int, beta: int, offset: int) -> int:
    """Host-side fold of one opened group — the verifier's counterpart."""
    j = position % (domain_size // FOLD)
    w_d = f128.get_root_of_unity(domain_size)
    x_j = f128.fmul(offset, pow(w_d, j, f128.P))
    w8 = f128.get_root_of_unity(FOLD)
    # b = iNTT_8 of group values
    inv8 = f128.finv(FOLD)
    b = []
    for k in range(FOLD):
        acc = 0
        for t in range(FOLD):
            acc = f128.fadd(acc, f128.fmul(group[t], pow(w8, (-t * k) % FOLD, f128.P)))
        b.append(f128.fmul(acc, inv8))
    q = f128.fmul(beta, f128.finv(x_j))
    acc = b[FOLD - 1]
    for k in range(FOLD - 2, -1, -1):
        acc = f128.fadd(f128.fmul(acc, q), b[k])
    return acc
