"""zkvm_torch NTT against the reference: exact equality.

Inputs are made from numpy seeds and fed to both sides; the field is exact,
so the tolerance is zero.  Every size 2^1..2^10 is held against the golden
NTT of the JAX package (``zkvm.ntt.golden``); the JAX transforms themselves
(``zkvm.ntt.ntt_t``) are compared at one size in the default suite, since
each of their shapes costs tens of seconds of XLA compilation on the CPU,
and at every size under ``-m slow``.  On the CPU the port runs the stage
network's plain PyTorch version; kernel K1 itself runs on the card
(chip_smoke.py) and through the host emulation (test_torch_csrc_emu.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm.field import f128
from zkvm.ntt import golden as gntt
from zkvm.ntt import ntt_t as jnt
from zkvm_torch.field.limbs import from_numpy, from_t, tlimbs, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)


def _rand_vals(seed, c, n):
    rng = np.random.default_rng(seed)
    return [
        [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
        for _ in range(c)
    ]


def _t(vals):
    """(c, n) ints -> (c, 8, n) uint32 limbs (reduced mod p)."""
    return np.swapaxes(to_limbs(vals), -1, -2)


def _same(t, j):
    np.testing.assert_array_equal(to_numpy(t), np.asarray(j))


def _ints(t):
    return [[int(v) for v in row] for row in from_t(to_numpy(t))]


def _coset(vals, base):
    return [gntt.ntt([v * pow(base, i, f128.P) % f128.P for i, v in enumerate(row)]) for row in vals]


@pytest.mark.parametrize("log_n", range(1, 11))
def test_transforms_match_golden(log_n):
    n = 1 << log_n
    vals = [[v % f128.P for v in row] for row in _rand_vals(log_n, 2, n)]
    x = from_numpy(_t(vals))
    base = (0xC0FFEE * n + 7) % f128.P
    assert _ints(tnt.ntt_t(x)) == [gntt.ntt(r) for r in vals]
    assert _ints(tnt.intt_t(x)) == [gntt.intt(r) for r in vals]
    assert _ints(tnt.class_ntt_t(x, from_numpy(tlimbs(base)))) == _coset(vals, base)


def _check_reference(n):
    x = _t(_rand_vals(n, 2, n))
    base = tlimbs((0xBEEF * n + 3) % f128.P)
    _same(tnt.ntt_t(from_numpy(x)), jnt.ntt_t(jnp.asarray(x)))
    _same(tnt.intt_t(from_numpy(x)), jnt.intt_t(jnp.asarray(x)))
    _same(
        tnt.class_ntt_t(from_numpy(x), from_numpy(base)),
        jnt.class_ntt_t(jnp.asarray(x), jnp.asarray(base)),
    )


def test_transforms_match_reference():
    _check_reference(16)  # both four-step passes (4 x 4) and the fused scale


@pytest.mark.slow  # ~30 XLA compiles of the reference transforms
@pytest.mark.parametrize("log_n", range(1, 11))
def test_transforms_match_reference_all_sizes(log_n):
    _check_reference(1 << log_n)


def test_tables_match_reference():
    for m in (2, 16, 512):
        np.testing.assert_array_equal(tnt._stage_twiddles(m, True), jnt._stage_twiddles(m, True))
        for a, b in zip(tnt._layout_indices(m), jnt._layout_indices(m)):
            np.testing.assert_array_equal(a, b)
    # mid twiddles: rows[i][k2] = w^(i*k2) / n, rows in pass-2 layout order
    n = 1 << 6
    n2, n1 = tnt._split(n)
    w = f128.finv(f128.get_root_of_unity(n))
    initial, _ = tnt._layout_indices(n1)
    got = from_t(to_numpy(tnt.unpack_t(tnt._mid_twiddles(n, True, True, "cpu"))))
    inv_n = f128.finv(n)
    for r, i in enumerate(initial):
        assert [int(v) for v in got[r]] == [
            pow(w, int(i) * k2, f128.P) * inv_n % f128.P for k2 in range(n2)
        ]


def test_ladders_match_golden():
    bases = [3, 0xDEADBEEF, f128.P - 1]
    got = tnt.ladders_t(from_numpy(to_limbs(bases)), 1024)
    assert _ints(got) == [[pow(b, i, f128.P) for i in range(1024)] for b in bases]
    lad = from_t(to_numpy(tnt.ladder_t_host(5, 512, 7)))
    assert [int(v) for v in lad] == [7 * pow(5, i, f128.P) % f128.P for i in range(512)]
    vals = [[v % f128.P for v in row] for row in _rand_vals(5, 2, 64)]
    got = tnt.scale_by_ladder_t(from_numpy(_t(vals)), from_numpy(tlimbs(11)), 64)
    assert _ints(got) == [[v * pow(11, i, f128.P) % f128.P for i, v in enumerate(r)] for r in vals]
