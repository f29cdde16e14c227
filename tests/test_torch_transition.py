"""Kernel K4's plain version (``zkvm_torch.air.transition``), the periodic
tables of the full domain and the coset LDE at D, against the JAX
reference: exact equality on a real trace's LDE and on numpy-seeded inputs.

The CUDA source of K4 itself is checked on the CPU by
``tests/test_torch_csrc_emu.py`` and on the card by ``chip_smoke.py``.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm.air import periodic as jper
from zkvm.air.constraints_jax import merged_transition as jax_merged_transition
from zkvm.field import jax_f128 as jf
from zkvm.ntt import ntt_jax as nj
from zkvm_torch.air import periodic as tper
from zkvm_torch.air import transition as ttr
from zkvm_torch.field.limbs import from_numpy, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

BLOWUP = 8
CLASS = 3


@pytest.fixture(scope="module")
def trace_lde():
    """A real trace's LDE (28, D, 8), built as tests/test_pallas.py builds it,
    with the trace length, the LWE delta and 20 random alphas."""
    from zkvm.fhe import LweParameters, ServerKey
    from zkvm.isa import Program, ProgramInputs
    from zkvm.processor import Processor

    key = ServerKey(LweParameters(8, 128, 4, 2.412390240121573e-5), random.Random(7))
    program = Program.compile("read2\nread\nsadd\npush.1\npush.2\nadd\nsmul")
    trace = Processor.run(program, ProgramInputs((1, 3), (key.encrypt(2),), key)).trace()
    lde = nj.coset_lde(nj.intt(jnp.asarray(trace.as_limbs())), BLOWUP)
    rng = np.random.default_rng(11)
    alphas = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, 20), dtype=np.int64))]
    return lde, trace.length, key.parameters.delta, jf.to_limbs(alphas)


def _t(arr):
    """(..., N, 8) limbs -> (..., 8, N) torch limbs."""
    return from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(arr), -1, -2)))


def test_k4_plain_full_domain_matches_reference(trace_lde):
    lde, t, delta, alphas = trace_lde
    mask, ark = jper.periodic_lde(t, BLOWUP)
    want = np.asarray(jax_merged_transition(lde, BLOWUP, mask, ark, delta, jnp.asarray(alphas)))
    tab = from_numpy(tper.periodic_table(t, BLOWUP))
    got = ttr.merged_transition(_t(lde), tab[0], tab[1:], from_numpy(alphas), delta, BLOWUP)
    assert got.shape == (8, t * BLOWUP)
    np.testing.assert_array_equal(to_numpy(got).T, want)


def test_k4_plain_one_class_matches_reference(trace_lde):
    """One blowup class: next row +1, the 16-step class patterns."""
    lde, t, delta, alphas = trace_lde
    mask, ark = jper.periodic_lde(t, BLOWUP)
    lde_c = lde[:, CLASS::BLOWUP]
    want = np.asarray(jax_merged_transition(
        lde_c, 1, mask[CLASS::BLOWUP], ark[:, CLASS::BLOWUP], delta, jnp.asarray(alphas)))
    mask_p, ark_p = tper.periodic_class_patterns(t, BLOWUP)
    got = ttr.merged_transition(_t(lde_c), _t(mask_p[CLASS]), _t(ark_p[CLASS]), from_numpy(alphas),
                                delta, 1)
    np.testing.assert_array_equal(to_numpy(got).T, want)


def test_k4_wrapper_refuses_what_it_cannot_run():
    lde = torch.zeros((28, 8, 64), dtype=torch.int32)
    tab = torch.zeros((9, 8, 48), dtype=torch.int32)
    alphas = torch.zeros((20, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="table length"):  # 48 does not divide 64
        ttr.launch_transition(None, 0, lde, tab[0], tab[1:].contiguous(), alphas, 1, 8)
    with pytest.raises(ValueError, match="no kernel"):
        ttr.merged_transition(lde.to("meta"), tab[0], tab[1:], alphas, 1, 8)


@pytest.mark.parametrize("t", [16, 128])
def test_periodic_table_matches_reference(t):
    mask, ark = jper.periodic_lde(t, BLOWUP)
    tab = tper.periodic_table(t, BLOWUP)
    assert tab.shape == (9, 8, 16 * BLOWUP)
    np.testing.assert_array_equal(np.swapaxes(tab[0], 0, 1), np.asarray(mask)[: 16 * BLOWUP])
    tmask, tark = tper.periodic_lde(t, BLOWUP)
    np.testing.assert_array_equal(tmask, np.swapaxes(np.asarray(mask), -1, -2))
    np.testing.assert_array_equal(tark, np.swapaxes(np.asarray(ark), -1, -2))


@pytest.mark.parametrize("t", [16, 128])
def test_coset_lde_t_matches_reference(t):
    rng = np.random.default_rng(t)
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, 3 * t), dtype=np.int64))]
    coeffs = jf.to_limbs(vals).reshape(3, t, 8)
    want = np.asarray(nj.coset_lde(jnp.asarray(coeffs), BLOWUP))  # (3, D, 8)
    got = tnt.coset_lde_t(_t(coeffs), BLOWUP)
    np.testing.assert_array_equal(np.swapaxes(to_numpy(got), -1, -2), want)


@pytest.mark.slow  # Pallas interpret mode on the CPU takes minutes
def test_k4_plain_matches_pallas_interpret(trace_lde):
    from zkvm.air.constraints_pallas import merged_transition_via_pallas

    lde, t, delta, alphas = trace_lde
    mask, ark = jper.periodic_lde(t, BLOWUP)
    want = np.asarray(merged_transition_via_pallas(
        lde, BLOWUP, mask, ark, delta, jnp.asarray(alphas), block=128, interpret=True))
    tab = from_numpy(tper.periodic_table(t, BLOWUP))
    got = ttr.merged_transition(_t(lde), tab[0], tab[1:], from_numpy(alphas), delta, BLOWUP)
    np.testing.assert_array_equal(to_numpy(got).T, want)
