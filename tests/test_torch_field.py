"""zkvm_torch field arithmetic against the JAX reference (jax_f128t,
jax_f128.batch_inverse) and the Python-int golden model: exact equality on
random values from a numpy seed and the edges 0, 1, p-1 and eps."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zkvm.field import f128
from zkvm.field import jax_f128 as jf
from zkvm.field import jax_f128t as jt
from zkvm_torch import kernels
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_limbs, from_numpy, from_t, tlimbs, to_limbs, to_numpy

torch.set_num_threads(1)

EPS = 45 * 2**40 - 1
EDGES = [0, 1, f128.P - 1, EPS]


def _values(seed, n):
    rng = np.random.default_rng(seed)
    hi, lo = rng.integers(0, 2**63, size=(2, n), dtype=np.int64)
    return [(int(a) << 65 | int(b) << 1 | 1) % f128.P for a, b in zip(hi, lo)]


def _pairs():
    """Random pairs plus every pair of edge values."""
    a = _values(1, 200) + [x for x in EDGES for _ in EDGES]
    b = _values(2, 200) + [y for _ in EDGES for y in EDGES]
    return a, b


@jax.jit
def _ref_ops(a, b, stack):
    return jt.fadd(a, b), jt.fsub(a, b), jt.fmul(a, b), jt.fsquare(a), jt.fsum(stack, axis=0)


def test_ops_match_reference_and_golden():
    a, b = _pairs()
    ta, tb = tlimbs(a), tlimbs(b)  # (8, n)
    stack = np.stack([ta, tb, ta])
    ref = _ref_ops(jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(stack))
    xa, xb = from_numpy(ta), from_numpy(tb)
    got = (ft.fadd(xa, xb), ft.fsub(xa, xb), ft.fmul(xa, xb), ft.fsquare(xa),
           ft.fsum(from_numpy(stack), axis=0))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r))
    p = f128.P
    golden = [[(x + y) % p for x, y in zip(a, b)], [(x - y) % p for x, y in zip(a, b)],
              [x * y % p for x, y in zip(a, b)], [x * x % p for x in a],
              [(2 * x + y) % p for x, y in zip(a, b)]]
    for g, want in zip(got, golden):
        assert [int(v) for v in from_t(to_numpy(g))] == want


def test_sub_from_zero_and_broadcast_column():
    a = _values(3, 64) + EDGES
    x = from_numpy(tlimbs(a))
    neg = ft.fsub(torch.zeros_like(x), x)
    assert [int(v) for v in from_t(to_numpy(neg))] == [(-v) % f128.P for v in a]
    c = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321 % f128.P
    np.testing.assert_array_equal(to_numpy(ft.const_col(c)), np.asarray(jt.const_col(c)))
    got = ft.fmul(x, ft.const_col(c))  # (8, 1) broadcasts over the lanes
    assert [int(v) for v in from_t(to_numpy(got))] == [v * c % f128.P for v in a]


def test_batch_inverse_matches_reference():
    vals = _values(4, 50) + EDGES
    std = to_limbs(vals)  # (n, 8) limbs last
    want = np.asarray(jax.jit(jf.batch_inverse)(jnp.asarray(std)))
    got = ft.batch_inverse(from_numpy(np.ascontiguousarray(std.T)))
    np.testing.assert_array_equal(to_numpy(got).T, want)
    assert [int(v) for v in from_limbs(want)] == [pow(v, f128.P - 2, f128.P) for v in vals]


@pytest.mark.parametrize("n", [1, 37])
def test_batch_inverse_leading_dims_match_reference(n):
    """(3, 8, N), as the provers' DEEP stacks its three denominators: the
    plain version (the wrapper's, on a CPU tensor) against the JAX
    batch inverse of the same elements, zeros and edge values included."""
    vals = (_values(5 + n, 3 * n) + EDGES + [2**127])[: 3 * n]
    vals[n // 2] = 0
    std = to_limbs(vals)  # (3N, 8)
    want = np.asarray(jax.jit(jf.batch_inverse)(jnp.asarray(std)))  # (3N, 8)
    limbs = np.ascontiguousarray(std.reshape(3, n, 8).transpose(0, 2, 1))
    got = ft.batch_inverse(from_numpy(limbs))
    assert got.shape == (3, 8, n)
    np.testing.assert_array_equal(to_numpy(got).transpose(0, 2, 1).reshape(3 * n, 8), want)
    np.testing.assert_array_equal(to_numpy(ft.batch_inverse_plain(from_numpy(limbs))), to_numpy(got))


def test_batch_inverse_refuses_a_device_without_kernel():
    """A tensor that is neither on the CPU (the plain version) nor on a
    card (the kernel) raises before any launch; nothing is counted."""
    before = kernels.launched.copy()
    with pytest.raises(ValueError, match="no kernel"):
        ft.batch_inverse(torch.empty((3, 8, 4), dtype=torch.int32, device="meta"))
    assert kernels.launched == before


@pytest.mark.parametrize("vals", [[0], [f128.P - 1, 1, EPS], [[3, 4], [5, 6]]])
def test_limb_conversion_matches_reference(vals):
    np.testing.assert_array_equal(to_limbs(vals), jf.to_limbs(vals))
    np.testing.assert_array_equal(tlimbs(vals), jt.tlimbs(vals))
    back = from_limbs(to_limbs(vals))
    assert np.array_equal(np.asarray(back, dtype=object), np.asarray(jf.from_limbs(jf.to_limbs(vals)), dtype=object))
    assert to_numpy(from_numpy(to_limbs(vals))).dtype == np.uint32
