# Copy of zkvm/ntt/golden.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Reference NTT over f128 with Python ints (slow; oracle for the JAX path)."""

from __future__ import annotations

from typing import List

from zkvm_torch.field import f128


def ntt(values: List[int], root: int | None = None) -> List[int]:
    """Forward NTT: coefficients -> evaluations over <root> (natural order)."""
    n = len(values)
    if n == 1:
        return list(values)
    assert n & (n - 1) == 0
    if root is None:
        root = f128.get_root_of_unity(n)
    even = ntt(values[0::2], f128.fmul(root, root))
    odd = ntt(values[1::2], f128.fmul(root, root))
    out = [0] * n
    w = 1
    for k in range(n // 2):
        t = f128.fmul(w, odd[k])
        out[k] = f128.fadd(even[k], t)
        out[k + n // 2] = f128.fsub(even[k], t)
        w = f128.fmul(w, root)
    return out


def intt(values: List[int], root: int | None = None) -> List[int]:
    """Inverse NTT: evaluations -> coefficients."""
    n = len(values)
    if root is None:
        root = f128.get_root_of_unity(n)
    out = ntt(values, f128.finv(root))
    n_inv = f128.finv(n)
    return [f128.fmul(v, n_inv) for v in out]


def eval_poly(coeffs: List[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = f128.fadd(f128.fmul(acc, x), c)
    return acc


def coset_lde(coeffs: List[int], blowup: int, offset: int = f128.DOMAIN_OFFSET):
    """Evaluate a degree-<T polynomial on the coset offset*<w_{blowup*T}>."""
    n = len(coeffs) * blowup
    scaled = []
    p = 1
    for c in coeffs:
        scaled.append(f128.fmul(c, p))
        p = f128.fmul(p, offset)
    scaled += [0] * (n - len(coeffs))
    return ntt(scaled)
