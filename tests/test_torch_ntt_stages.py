"""zkvm_torch stage network (kernel K1's plain version) against the JAX
reference ``ntt_t._pease_stages_batched`` (after ``_apply_pre``), in its
plain, full and r1 variants: exact equality on random limbs from a numpy
seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zkvm.ntt import ntt_t as jnt
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

_ORACLE = jax.jit(lambda y, tw, pre, r1: jnt._pease_stages_batched(jnt._apply_pre(y, pre, r1), tw))


def rand_limbs(rng, shape):
    """(..., 8, L) limbs of random canonical elements."""
    n = int(np.prod(shape)) // 8
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
    return np.swapaxes(to_limbs(vals).reshape(shape[:-2] + (shape[-1], 8)), -1, -2)


@pytest.mark.parametrize("variant", ["plain", "full", "r1"])
def test_stage_network_matches_reference(variant):
    rng = np.random.default_rng(len(variant))
    m, nl = 8, 16
    y = rand_limbs(rng, (3, m, 8, nl))
    tw = jnt._stage_twiddles(m, False)
    pre = rand_limbs(rng, (m, 8, nl)) if variant == "full" else None
    r1 = (rand_limbs(rng, (8, m)), rand_limbs(rng, (8, nl))) if variant == "r1" else None
    want = _ORACLE(
        jnp.asarray(y),
        jnp.asarray(tw),
        None if pre is None else jnp.asarray(pre),
        None if r1 is None else tuple(jnp.asarray(a) for a in r1),
    )
    got = tnt.pease_stages(
        from_numpy(y),
        from_numpy(tw),
        pre=None if pre is None else from_numpy(pre),
        r1=None if r1 is None else tuple(from_numpy(a) for a in r1),
    )
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_recursion_branch(monkeypatch):
    """MAX_AXIS = 4 in both packages forces N2 > MAX_AXIS (flat recursion:
    n = 32 splits 8 x 4, and the 8-point pass recurses 2 x 4)."""
    from zkvm.field import f128
    from zkvm.ntt import golden as gntt
    from zkvm_torch.field.limbs import from_t, tlimbs

    monkeypatch.setattr(jnt, "MAX_AXIS", 4)
    monkeypatch.setattr(tnt, "MAX_AXIS", 4)
    rng = np.random.default_rng(77)
    x = rand_limbs(rng, (2, 8, 32))
    got = tnt.ntt_t(from_numpy(x))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(jnt.ntt_t(jnp.asarray(x))))
    vals = [[int(v) for v in row] for row in from_t(x)]
    ints = lambda t: [[int(v) for v in row] for row in from_t(to_numpy(t))]
    assert ints(tnt.intt_t(from_numpy(x))) == [gntt.intt(r) for r in vals]
    base = 0xABCDEF
    got = tnt.class_ntt_t(from_numpy(x), from_numpy(tlimbs(base)))
    assert ints(got) == [
        gntt.ntt([v * pow(base, i, f128.P) % f128.P for i, v in enumerate(r)]) for r in vals
    ]


def test_stage_network_is_an_ntt():
    """Layout-permuted input through the network gives the natural-order
    NTT along axis M (M = 512, the largest axis the main path uses)."""
    rng = np.random.default_rng(9)
    m = 512
    y = rand_limbs(rng, (m, 8, 2))
    initial, final = tnt._layout_indices(m)
    got = tnt.pease_stages(
        from_numpy(np.ascontiguousarray(y[initial]))[None],
        from_numpy(tnt._stage_twiddles(m, False)),
    )[0]
    want = tnt.ntt_t(from_numpy(np.ascontiguousarray(y.transpose(2, 1, 0))))  # (2, 8, M)
    np.testing.assert_array_equal(to_numpy(got)[final], to_numpy(want).transpose(2, 1, 0))
