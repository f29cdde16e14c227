"""The standard-layout class prover (``mode="cls"``) of zkvm_torch on the
CPU (plain versions of the kernels), held against the JAX reference and
the port's other two layouts, at tolerance 0 (exact field arithmetic).

* T = 128: the cls proof equals the committed conformance vector (bytes
  made by the JAX package), with and without the chunked stage forms
  (``prover.limits.CHUNK_T`` patched to 2^6);
* T = 256 (one FRI layer): the cls proof equals the T-mode and mono
  proofs byte for byte, verifies in both packages, and a tampered copy is
  rejected by both;
* the stages on numpy-seeded challenges: the cls composition (8, D)
  equals T-mode's ``_stage_composition_t`` (held to the JAX package
  elsewhere) at T = 128; the DEEP that cls and T-mode share
  (``ClassStages.deep``) equals a Python-int evaluation of the DEEP
  formula with the port's golden f128 at every domain point, from each
  prover's constants, at T = 16 and 128;
* the limits: T > ``CLS_MAX_TRACE_LENGTH`` raises, and so does a prove
  without a card unless it is given ``device="cpu"``;
* under ``-m slow``: the cls composition and DEEP against the JAX
  ``_stage_composition_cls(use_pallas=False)`` and ``_stage_deep_cls``,
  and the proof bytes against ``zkvm.prover.prove`` under ``ZKVM_CLASS=1
  ZKVM_TMODE=0`` (the reference's class path) at T = 2^10 for the three
  bench programs, their traces carried across by ``zkvm_torch.convert``.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm_torch import vm
from zkvm_torch.field import f128 as gf
from zkvm_torch.field.limbs import from_numpy, from_t, tensor, to_limbs, to_numpy
from zkvm_torch.prover import limits
from zkvm_torch.prover import multi_eval as me
from zkvm_torch.prover import pipeline as tpl
from zkvm_torch.prover.cls import ClsStages

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parents[1] / "conformance" / "vectors_e2e.json"
T = 128
CPU = torch.device("cpu")


@pytest.mark.parametrize("chunked", [False, True])
def test_cls_conformance_proof_bytes(chunked, monkeypatch):
    if chunked:
        monkeypatch.setattr(limits, "CHUNK_T", 1 << 6)
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    h, out, proof = vm.prove(program, inputs, device="cpu", mode="cls")
    assert proof.trace_length == T
    assert proof.trace_root.hex() == vec["trace_root_hex"]
    assert proof.comp_root.hex() == vec["comp_root_hex"]
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


@pytest.fixture(scope="module")
def t256():
    """The T = 256 READ/ADD chain: (key, trace, public inputs, cls proof)."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.read_add_chain(60, key)
    trace = vm.run(program, inputs)
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    return key, trace, pub, tpl.prove(trace, pub, device="cpu", mode="cls")


@pytest.mark.parametrize("mode", ["tmode", "mono"])
def test_cls_equals_the_other_layouts_t256(t256, mode):
    key, trace, pub, proof = t256
    assert proof.trace_length == 256 and len(proof.fri_roots) == 1
    assert proof.to_wire_bytes() == tpl.prove(trace, pub, device="cpu", mode=mode).to_wire_bytes()


def test_cls_t256_verifies_in_both_packages(t256):
    from zkvm.air.layout import PublicInputs as JaxPublicInputs
    from zkvm.fhe import ServerKey as JaxServerKey
    from zkvm.fhe.lwe import DEMO_PARAMETERS as JAX_DEMO_PARAMETERS
    from zkvm.verifier import VerificationError as JaxVerificationError
    from zkvm.verifier import verify_bytes as jax_verify_bytes
    from zkvm_torch.verifier import VerificationError

    key, trace, pub, proof = t256
    data = proof.to_wire_bytes()
    jax_key = JaxServerKey(JAX_DEMO_PARAMETERS, random.Random(3))
    assert jax_key.key == key.key
    jax_pub = JaxPublicInputs(pub.program_hash, pub.stack_outputs, jax_key)
    jax_verify_bytes(data, jax_pub)
    vm.verify_bytes(data, pub.program_hash, pub.stack_outputs, key)
    for at in (len(data) // 3, len(data) // 2, len(data) - 20):
        bad = bytearray(data)
        bad[at] ^= 0x01
        with pytest.raises(JaxVerificationError):
            jax_verify_bytes(bytes(bad), jax_pub)
        with pytest.raises(VerificationError):
            vm.verify_bytes(bytes(bad), pub.program_hash, pub.stack_outputs, key)


def _vals(rng, n):
    hi, lo = rng.integers(0, 2**63, size=(2, n), dtype=np.int64)
    return [(int(a) << 64 | int(b)) % f128.P for a, b in zip(hi, lo)]


def _cols(rng, c):
    """(c, 8, T) limbs of random field elements."""
    return from_numpy(np.swapaxes(to_limbs(np.array(_vals(rng, c * T), dtype=object).reshape(c, T)), -1, -2))


@pytest.fixture(scope="module")
def stage_inputs():
    """Random trace and composition coefficients at T = 128, numpy-seeded
    challenges, the AIR's boundary columns and the true OOD values."""
    rng = np.random.default_rng(2026)
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    pub = vm.PublicInputs((1, 2, 3, 4), tuple(range(16)), key)
    assertions = vm.get_assertions(pub, T)
    betas = _vals(rng, len(assertions))
    groups = [[(c, v, b) for (c, s, v), b in zip(assertions, betas) if (s != 0) == g] for g in (0, 1)]
    z = _vals(rng, 1)[0]
    zg, zm = f128.fmul(z, f128.get_root_of_unity(T)), pow(z, 8, f128.P)
    coeffs, h = _cols(rng, 28), _cols(rng, 8)
    ood_cur, ood_nxt = me.multi_eval_rows(coeffs, [z, zg])
    return dict(
        coeffs=coeffs, h=h, alphas=_vals(rng, 20), groups=groups, delta=key.parameters.delta,
        gammas=_vals(rng, 28), epsilons=_vals(rng, 8), points=(z, zg, zm),
        ood=(ood_cur, ood_nxt, me.multi_eval_rows(h, [zm])[0]),
    )


def _composition_args(s):
    g0, g1 = s["groups"]
    col = lambda group, k: tensor([e[k] for e in group])
    return (s["coeffs"], tensor(s["alphas"]), col(g0, 1), col(g0, 2), col(g1, 1), col(g1, 2), s["delta"],
            tuple(c for c, _, _ in g0), tuple(c for c, _, _ in g1))


def test_cls_composition_equals_tmode(stage_inputs):
    args = _composition_args(stage_inputs)
    got = ClsStages(T, 8, CPU).composition(*args)
    want = tpl._stage_composition_t(args[0], tpl._class_constants_t(T, 8, CPU), *args[1:])
    assert got.shape == (8, 8 * T)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = gf.fadd(gf.fmul(acc, x), c)
    return acc


def _combine(cols, weights):
    """Coefficients of sum_c weights[c] * cols[c] (Python ints)."""
    acc = [0] * len(cols[0])
    for w, col in zip(weights, cols):
        acc = [gf.fadd(a, gf.fmul(w, c)) for a, c in zip(acc, col)]
    return acc


def _deep_case(t, seed):
    """Random trace (28) and composition (8) coefficients of length t as
    Python ints, numpy-seeded weights and z, and the OOD values by Horner."""
    rng = np.random.default_rng(seed)
    coeffs = [_vals(rng, t) for _ in range(28)]
    h = [_vals(rng, t) for _ in range(8)]
    gammas, epsilons, z = _vals(rng, 28), _vals(rng, 8), _vals(rng, 1)[0]
    points = (z, gf.fmul(z, gf.get_root_of_unity(t)), pow(z, 8, gf.P))
    ood = ([_horner(c, points[0]) for c in coeffs], [_horner(c, points[1]) for c in coeffs],
           [_horner(c, points[2]) for c in h])
    return coeffs, h, gammas, epsilons, points, ood


def _golden_deep(coeffs, h, gammas, epsilons, points):
    """The DEEP witness at every point x_i = offset * w_D^i of the domain, in
    Python ints: (A(x) - A(z)) / (x - z) + (A(x) - A(z g)) / (x - z g) +
    (H(x) - H(z^8)) / (x - z^8), A = sum_c gamma_c P_c (the z and z g terms
    share their weights), H = sum_k epsilon_k H_k."""
    a, hh = _combine(coeffs, gammas), _combine(h, epsilons)
    terms = [(a, points[0]), (a, points[1]), (hh, points[2])]
    at = [_horner(poly, pt) for poly, pt in terms]
    d = 8 * len(coeffs[0])
    w_d, x, out = gf.get_root_of_unity(d), gf.DOMAIN_OFFSET, []
    for _ in range(d):
        y = 0
        for (poly, pt), v in zip(terms, at):
            y = gf.fadd(y, gf.fmul(gf.fsub(_horner(poly, x), v), gf.finv(gf.fsub(x, pt))))
        out.append(y)
        x = gf.fmul(x, w_d)
    return out


def _check_deep_golden(t, seed):
    coeffs, h, gammas, epsilons, points, ood = _deep_case(t, seed)
    want = _golden_deep(coeffs, h, gammas, epsilons, points)
    limbs = lambda cols: from_numpy(np.swapaxes(to_limbs(np.array(cols, dtype=object)), -1, -2))
    for stages in (ClsStages(t, 8, CPU), tpl._TModeStages(t, 8, CPU)):
        got = stages.deep(limbs(coeffs), limbs(h), gammas, gammas, epsilons, points, ood)
        assert got.shape == (8, 8 * t)
        assert [int(v) for v in from_t(to_numpy(got))] == want


def test_cls_deep_equals_tmode():
    """The DEEP of cls and T-mode (one ``ClassStages.deep``, run from each
    prover's constants) equals the DEEP formula in Python ints at T = 128."""
    _check_deep_golden(T, 2027)


def test_class_deep_equals_golden_formula_t16():
    """The same at T = 16 (a domain of 128 points)."""
    _check_deep_golden(16, 2028)


class _Trace:
    def __init__(self, length):
        self.length = length


def test_cls_limits(t256, monkeypatch):
    pub = tpl.PublicInputs((0, 0), (0,) * 16, None)
    assert limits.CLS_MAX_TRACE_LENGTH == 1 << 20
    with pytest.raises(ValueError, match="not supported"):
        tpl.prove(_Trace(2 * limits.CLS_MAX_TRACE_LENGTH), pub, device="cpu", mode="cls")
    key, trace, pub, _ = t256
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpl.prove(trace, pub, mode="cls")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vm.prove(*vm.read_add_chain(8, key), mode="cls")


def _jax_limbs(vals):
    import jax.numpy as jnp
    from zkvm.field import jax_f128 as jf

    return jnp.asarray(jf.to_limbs(vals))


def _std(t):
    """(C, 8, T) port limbs -> the JAX package's (C, T, 8)."""
    import jax.numpy as jnp

    return jnp.asarray(np.ascontiguousarray(np.swapaxes(to_numpy(t), -1, -2)))


@pytest.mark.slow  # the JAX stage's CPU compile takes about 80 s
def test_cls_composition_equals_jax_stage(stage_inputs):
    from zkvm.prover import pipeline as jpl

    s = stage_inputs
    dc = jpl._class_constants(T, 8)
    g0, g1 = s["groups"]
    want = jpl._stage_composition_cls(
        _std(s["coeffs"]), dc["mask_cls"], dc["ark_cls"], _jax_limbs(s["alphas"]), dc["class_bases"],
        dc["inv_xt_cls"], *jpl._boundary_args(g0, g1), dc["ntt_consts"], blowup=8, delta=s["delta"],
        e1=dc["e1"], e2=dc["e2"], x_last=dc["x_last"], use_pallas=False,
    )  # (D, 8)
    got = ClsStages(T, 8, CPU).composition(*_composition_args(s))
    np.testing.assert_array_equal(to_numpy(got).T, np.asarray(want))


@pytest.mark.slow  # the JAX stage's CPU compile takes about 40 s
def test_cls_deep_equals_jax_stage(stage_inputs):
    from zkvm.prover import pipeline as jpl

    s = stage_inputs
    dc = jpl._class_constants(T, 8)
    ood_cur, ood_nxt, ood_comp = s["ood"]
    want = jpl._stage_deep_cls(
        _std(s["coeffs"]), _std(s["h"]), _jax_limbs(s["gammas"]), _jax_limbs(s["gammas"]),
        _jax_limbs(s["epsilons"]), _jax_limbs(tpl.weighted_host(s["gammas"], ood_cur)),
        _jax_limbs(tpl.weighted_host(s["gammas"], ood_nxt)), _jax_limbs(tpl.weighted_host(s["epsilons"], ood_comp)),
        *(_jax_limbs(p) for p in s["points"]), dc["class_bases"], dc["ntt_consts"],
    )  # (D, 8)
    got = ClsStages(T, 8, CPU).deep(s["coeffs"], s["h"], s["gammas"], s["gammas"], s["epsilons"], s["points"],
                                    s["ood"])
    np.testing.assert_array_equal(to_numpy(got).T, np.asarray(want))


@pytest.mark.slow  # the JAX prover's CPU compile costs minutes per program
@pytest.mark.parametrize("name,n_ops", [("read_add", 300), ("mul_add", 300), ("fhe", 120)])
def test_cls_bytes_equal_jax_class_prover(name, n_ops, monkeypatch):
    import zkvm.isa
    from test_torch_slice import _bench_program
    from zkvm.air.layout import PublicInputs as JaxPublicInputs
    from zkvm.fhe import ServerKey as JaxServerKey
    from zkvm.fhe.lwe import DEMO_PARAMETERS as JAX_DEMO_PARAMETERS
    from zkvm.processor import Processor as JaxProcessor
    from zkvm.prover import prove as jax_prove
    from zkvm_torch import convert

    monkeypatch.setenv("ZKVM_CLASS", "1")
    monkeypatch.setenv("ZKVM_TMODE", "0")
    jax_key = JaxServerKey(JAX_DEMO_PARAMETERS, random.Random(3))
    program, inputs = _bench_program(name, n_ops, jax_key, zkvm.isa)
    jax_trace = JaxProcessor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    assert jax_trace.length == 1 << 10
    want = jax_prove(jax_trace, JaxPublicInputs(program.hash, jax_trace.outputs, jax_key)).to_wire_bytes()
    trace = convert.execution_trace(jax_trace.as_limbs(), program.hash, jax_trace.outputs)
    pub = convert.public_inputs(program.hash, jax_trace.outputs, jax_key)
    assert tpl.prove(trace, pub, device="cpu", mode="cls").to_wire_bytes() == want
