"""zkvm_torch prover components against the JAX reference: multi-point
evaluation, the DEEP quotient and the FRI fold (exact equality on inputs
from numpy seeds), and the copied host modules against their originals."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import torch

from zkvm.field import f128
from zkvm.ntt import ntt_t as jnt
from zkvm_torch.field.limbs import from_numpy, tlimbs, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _vals(seed, shape):
    rng = np.random.default_rng(seed)
    hi, lo = rng.integers(0, 2**63, size=(2,) + tuple(shape), dtype=np.int64)
    return (hi.astype(object) << 64 | lo.astype(object)) % f128.P


def _t(vals):
    """(..., n) ints -> (..., 8, n) uint32 limbs."""
    return np.ascontiguousarray(np.swapaxes(to_limbs(vals), -1, -2))


def test_multi_eval_matches_reference():
    from zkvm.prover import eval_mxu as em
    from zkvm_torch.prover import multi_eval as tme

    coeffs = _t(_vals(1, (4, 32)))
    pts = [int(v) for v in _vals(2, (3,))]
    want = em.multi_eval_rows(jnp.asarray(coeffs), pts)
    assert tme.multi_eval_rows(from_numpy(coeffs), pts) == want


def test_deep_quotient_matches_reference():
    from zkvm.prover import pipeline as jpl
    from zkvm_torch.prover import pipeline as tpl

    t = 16
    a = _t(_vals(3, (t,)))
    z = int(_vals(4, (1,))[0])
    zi = f128.finv(z)
    one = tlimbs(1)
    want = jpl._deep_quotient_t(
        jnp.asarray(a),
        jnt.ladder_t(jnp.asarray(tlimbs(z)), jnp.asarray(one), t),
        jnt.ladder_t(jnp.asarray(tlimbs(zi)), jnp.asarray(tlimbs(zi)), t),
    )
    got = tpl._deep_quotient_t(
        from_numpy(a),
        tnt.ladder_t(from_numpy(tlimbs(z)), from_numpy(one), t),
        tnt.ladder_t(from_numpy(tlimbs(zi)), from_numpy(tlimbs(zi)), t),
    )
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_fri_fold_matches_reference():
    from zkvm.prover import fri as jfri
    from zkvm_torch.prover import fri as tfri

    groups = _t(_vals(5, (tfri.FOLD, 64)))  # (FOLD, 8, L)
    q = _t(_vals(6, (64,)))  # (8, L)
    want = jfri._fold_core_t(jnp.asarray(groups), jnp.asarray(q))
    got = tfri._fold_core_t(from_numpy(groups), from_numpy(q))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # the verifier-side fold of one opened group agrees with the device fold
    beta, offset, d = 12345, f128.DOMAIN_OFFSET, tfri.FOLD * 64
    w_d = f128.get_root_of_unity(d)
    scale = f128.fmul(beta, f128.finv(offset))
    q_t = tnt.ladder_t_host(f128.finv(w_d), d // tfri.FOLD, scale)
    folded = tfri._fold_core_t(from_numpy(groups), q_t)
    from zkvm_torch.field.limbs import from_t

    j = 9
    group = [int(v) for v in from_t(groups)[:, j]]
    assert tfri.fold_group_values(group, j, d, beta, offset) == int(from_t(to_numpy(folded))[j])


def _code_lines(path, strip_header):
    lines = Path(path).read_text().splitlines()
    if strip_header:
        while lines[0].startswith("#"):
            lines.pop(0)
    return lines


def test_copied_host_modules_equal_originals():
    """Each copy is its original with only import lines rewritten from
    zkvm.* to zkvm_torch.* (below a comment header)."""
    pairs = [(f"zkvm/prover/{m}.py", f"zkvm_torch/prover/{m}.py") for m in
             ("options", "proof", "transcript", "wire")]
    pairs.append(("zkvm/verifier/verifier.py", "zkvm_torch/verifier/verifier.py"))
    for orig, copy in pairs:
        a = _code_lines(REPO / orig, False)
        b = _code_lines(REPO / copy, True)
        assert len(a) == len(b), copy
        changed = 0
        for la, lb in zip(a, b):
            if la != lb:
                assert lb.lstrip().startswith(("from ", "import ")), (copy, lb)
                assert lb.replace("zkvm_torch.", "zkvm.") == la, (copy, lb)
                changed += 1
        assert changed > 0 or copy.endswith(("options.py", "transcript.py"))
