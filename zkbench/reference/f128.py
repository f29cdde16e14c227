# Frozen copy of zkvm_torch/field/f128.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Host-side (Python int) arithmetic for the STARK base field f128.

The field is GF(p) with p = 2^128 - 45*2^40 + 1, the same prime used by the
reference stack through winterfell's ``f128::BaseElement`` (visible in the
Rescue MDS constants, Encrypt-zkVM crypto/src/rescue.rs:195-233, and the
INV_ALPHA exponent there).  Facts pinned by tests:

* two-adicity 40 (p - 1 = 2^40 * m with m odd)
* multiplicative generator g = 3
* two-adic root of unity (order 2^40): 23953097886125630542083529559205016746

This module is the *golden model*: slow, obviously-correct Python ints.  The
batched TPU arithmetic lives in :mod:`zkvm.field.jax_f128` and is tested
against this module element-by-element.
"""

from __future__ import annotations

P = 2**128 - 45 * 2**40 + 1
GENERATOR = 3
TWO_ADICITY = 40
TWO_ADIC_ROOT = 23953097886125630542083529559205016746

# Rescue S-box exponents (crypto/src/rescue.rs:194-195 in the reference).
ALPHA = 3
INV_ALPHA = 226854911280625642308916371969163307691

# Coset offset used for low-degree extension domains (winterfell uses the
# field generator as the LDE domain offset).
DOMAIN_OFFSET = GENERATOR

ZERO = 0
ONE = 1


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fneg(a: int) -> int:
    return (-a) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fexp(a: int, e: int) -> int:
    return pow(a, e, P)


def finv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in f128")
    return pow(a, P - 2, P)


def fdiv(a: int, b: int) -> int:
    return fmul(a, finv(b))


def from_u8(v: int) -> int:
    return v % P


def get_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity; n must be a power of two <= 2^40."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    log_n = n.bit_length() - 1
    if log_n > TWO_ADICITY:
        raise ValueError(f"n = 2^{log_n} exceeds two-adicity {TWO_ADICITY}")
    return pow(TWO_ADIC_ROOT, 2 ** (TWO_ADICITY - log_n), P)


def to_bytes(a: int) -> bytes:
    """16-byte little-endian encoding (matches winterfell f128 element bytes)."""
    return int(a % P).to_bytes(16, "little")


def from_bytes(data: bytes) -> int:
    if len(data) != 16:
        raise ValueError("f128 elements are 16 bytes")
    v = int.from_bytes(data, "little")
    if v >= P:
        raise ValueError("not a canonical f128 element")
    return v


def elements_to_bytes(elems) -> bytes:
    return b"".join(to_bytes(e) for e in elems)
