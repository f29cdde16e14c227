"""zkvm_torch composition (kernel K3's plain version) and periodic patterns
against the JAX reference: exact equality on inputs from numpy seeds.

On the CPU the reference ``constraints_pallas.composition_t`` runs its
plain body (``composition_body_t``); Pallas interpret mode is slow-marked
in the reference's own tests."""

import random

import numpy as np
import jax.numpy as jnp
import torch

from zkvm.air import constraints_pallas as jcp
from zkvm.air import periodic as jper
from zkvm.air.layout import PublicInputs, get_assertions
from zkvm.fhe import LweParameters, ServerKey
from zkvm.field import f128
from zkvm_torch.air import composition as tcp
from zkvm_torch.air import periodic as tper
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy

torch.set_num_threads(1)

T = 128


EDGES = (0, 1, f128.P - 1, 45 * 2**40 - 1, 2**127)


def rand_limbs(rng, shape, edges=False):
    """(..., 8, L) limbs of random canonical elements.  With ``edges``,
    lane j = s k (s = min(7, L // 5)) of row r holds EDGES[(k + r) % 5]:
    every row meets every edge value, beside random ones."""
    n = int(np.prod(shape)) // 8
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
    if edges:
        lanes = shape[-1]
        step = min(7, max(1, lanes // 5))
        for r in range(n // lanes):
            for k, j in enumerate(range(0, lanes, step)):
                vals[r * lanes + j] = EDGES[(k + r) % 5]
    return np.swapaxes(to_limbs(vals).reshape(shape[:-2] + (shape[-1], 8)), -1, -2)


def composition_inputs(seed, t=T):
    """Random class inputs with the real boundary columns of get_assertions,
    the field's edge values mixed into the trace, the alphas, the periodic
    patterns and the boundary values and coefficients (see rand_limbs)."""
    rng = np.random.default_rng(seed)
    key = ServerKey(LweParameters(8, 128, 4, 2.412390240121573e-5), random.Random(seed))
    pub = PublicInputs((11, 22), tuple(range(16)), key)
    assertions = get_assertions(pub, t)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)
    # cur: bits, hash flag and mask near {0, 1} matter less than exactness;
    # random canonical values exercise every product
    rl = lambda shape: rand_limbs(rng, shape, edges=True)
    arrays = dict(
        cur=rl((28, 8, t)),
        mask=rl((8, 16)),
        ark=rl((8, 8, 16)),
        ee=rl((8, t)),
        i0=rl((8, t)),
        i1=rl((8, t)),
        alphas=np.swapaxes(rl((8, 20)), 0, 1).copy(),
        bv0=np.swapaxes(rl((8, len(bcols0))), 0, 1).copy(),
        bb0=np.swapaxes(rl((8, len(bcols0))), 0, 1).copy(),
        bv1=np.swapaxes(rl((8, len(bcols1))), 0, 1).copy(),
        bb1=np.swapaxes(rl((8, len(bcols1))), 0, 1).copy(),
    )
    return arrays, key.parameters.delta, bcols0, bcols1


_ORDER = ("cur", "mask", "ark", "ee", "i0", "i1", "alphas", "bv0", "bb0", "bv1", "bb1")


def test_composition_t_matches_reference():
    arrays, delta, bcols0, bcols1 = composition_inputs(5)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = jcp.composition_t(
        j["cur"], jnp.tile(j["mask"], (1, T // 16)), jnp.tile(j["ark"], (1, 1, T // 16)),
        j["ee"], j["i0"], j["i1"], j["alphas"], j["bv0"], j["bb0"], j["bv1"], j["bb1"],
        delta, bcols0, bcols1,
    )
    got = tcp.composition_t(*(from_numpy(arrays[k]) for k in _ORDER), delta, bcols0, bcols1)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_periodic_patterns_match_reference():
    for t, blowup in [(128, 8), (1 << 16, 8)]:
        mask, ark = tper.periodic_class_patterns(t, blowup)
        jmask, jark = jper.periodic_class_patterns(t, blowup)
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        np.testing.assert_array_equal(ark, np.asarray(jark))
    x = 0x1234567890ABCDEF1234567890
    assert tper.periodic_at(1 << 10, x) == jper.periodic_at(1 << 10, x)


def test_mds_constants_match_reference():
    from zkvm.hash import rescue_jax as rj

    np.testing.assert_array_equal(tcp.MDS_LIMBS, np.asarray(rj.mds_limbs()))
    np.testing.assert_array_equal(tcp.INV_MDS_LIMBS, np.asarray(rj.inv_mds_limbs()))
