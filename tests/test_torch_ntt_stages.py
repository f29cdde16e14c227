"""zkvm_torch stage network (kernel K1's entry, natural row order in and
out; its plain version on the CPU) against the JAX reference
``ntt_t._axis_ntt``, in its plain, full and r1 variants, forward and
inverse: exact equality on random limbs from a numpy seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zkvm.field import f128
from zkvm.ntt import ntt_t as jnt
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

_ORACLE = jax.jit(jnt._axis_ntt, static_argnums=(1, 2))


def rand_limbs(rng, shape):
    """(..., 8, L) limbs of random canonical elements."""
    n = int(np.prod(shape)) // 8
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
    return np.swapaxes(to_limbs(vals).reshape(shape[:-2] + (shape[-1], 8)), -1, -2)


# each M in both directions, each variant in both directions
_CASES = [
    (2, "plain", False), (2, "full", True), (2, "r1", False),
    (8, "plain", True), (8, "full", False), (8, "r1", True),
    (32, "plain", False), (32, "full", True), (32, "r1", False),
    (256, "plain", True), (256, "full", False), (256, "r1", True),
]


@pytest.mark.parametrize("m,variant,inverse", _CASES)
def test_stage_network_matches_reference(m, variant, inverse):
    rng = np.random.default_rng(m + len(variant) + inverse)
    nl = 4
    y = rand_limbs(rng, (3, m, 8, nl))
    pre = rand_limbs(rng, (m, 8, nl)) if variant == "full" else None
    r1 = (rand_limbs(rng, (8, m)), rand_limbs(rng, (8, nl))) if variant == "r1" else None
    want = _ORACLE(
        jnp.asarray(y),
        m,
        inverse,
        None if pre is None else jnp.asarray(pre),
        None if r1 is None else tuple(jnp.asarray(a) for a in r1),
    )
    got = tnt.pease_stages(
        from_numpy(y),
        tnt._stage_twiddles_dev(m, inverse, torch.device("cpu")),
        pre=None if pre is None else tnt.pack_t(from_numpy(pre)),
        r1=None if r1 is None else tuple(from_numpy(a) for a in r1),
    )
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_pack_roundtrip():
    """pack_t gives each element's four little-endian 32-bit words."""
    vals = [0, 1, 2**127, 2**128 - 2**46 + 2**40 * 45, 0xFFFFFFFF_00000001_80000000_7FFFFFFF]
    x = from_numpy(np.ascontiguousarray(to_limbs(vals).T))  # (8, 5)
    words = tnt.pack_t(x).numpy().astype(np.uint32)  # (5, 4)
    for v, w in zip(vals, words):
        v %= f128.P
        assert [int(a) for a in w] == [(v >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    np.testing.assert_array_equal(to_numpy(tnt.unpack_t(tnt.pack_t(x))), to_numpy(x))


def test_recursion_branch(monkeypatch):
    """MAX_AXIS = 4 in both packages forces N2 > MAX_AXIS (flat recursion:
    n = 32 splits 8 x 4, and the 8-point pass recurses 2 x 4)."""
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
    # the recursion path takes the coset scale cached by the provers too
    scale = tnt.class_scale(from_numpy(tlimbs(base)), 32)
    np.testing.assert_array_equal(to_numpy(tnt.class_ntt_t(from_numpy(x), from_numpy(tlimbs(base)), scale)),
                                  to_numpy(got))


def test_stage_network_is_an_ntt():
    """Natural-order input through K1's entry gives the natural-order NTT
    along axis M (M = 512, the largest axis the main path uses)."""
    rng = np.random.default_rng(9)
    m = 512
    y = rand_limbs(rng, (m, 8, 2))
    got = tnt.pease_stages(from_numpy(y)[None], tnt._stage_twiddles_dev(m, False, torch.device("cpu")))[0]
    want = tnt.ntt_t(from_numpy(np.ascontiguousarray(y.transpose(2, 1, 0))))  # (2, 8, M)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want).transpose(2, 1, 0))
