"""The large-trace path of the port at small T, on the CPU.

* the chunked stage forms (``prover.limits.CHUNK_T`` patched to 2^6, so T =
  2^8 takes them): the DEEP's weighted sums (in column blocks at every T)
  and the multi-point evaluation in pairs (``test_torch_prover.py``) equal their
  one-shot forms and the JAX package's sums / ``eval_mxu.multi_eval_rows``,
  exactly (under ``-m slow`` the DEEP that T-mode and cls share against the
  whole JAX ``_stage_deep_t``); a T = 2^8
  proof is the same bytes with and without them;
* ``zkvm_torch.examples.prove_lr_large`` at log2_rows = 8 gives T = 2^8,
  the clear prediction and a proof that verifies, in T-mode and with
  ``--mode cls`` and ``--mode mono`` (in row blocks);
* the limits: mono and T-mode past 2^20 raise; a rank of a mesh keeps
  2^17.
"""

import ast
import io
import json
import random
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm.field import jax_f128 as jf
from zkvm_torch.examples import prove_lr_large as lrl
from zkvm_torch.field.limbs import from_numpy, tensor, to_limbs, to_numpy
from zkvm_torch.prover import deep
from zkvm_torch.prover import limits
from zkvm_torch.prover import multi_eval as me
from zkvm_torch.prover import pipeline as tpl

torch.set_num_threads(1)

T = 1 << 8
REPO = Path(__file__).resolve().parents[1]


def _vals(seed, shape):
    rng = np.random.default_rng(seed)
    hi, lo = rng.integers(0, 2**63, size=(2,) + tuple(shape), dtype=np.int64)
    return (hi.astype(object) << 64 | lo.astype(object)) % f128.P


def _t(vals):
    """(..., n) ints -> (..., 8, n) uint32 limbs."""
    return np.ascontiguousarray(np.swapaxes(to_limbs(vals), -1, -2))


@pytest.fixture
def chunked(monkeypatch):
    """A function that patches the chunk threshold below T = 2^8 (undone
    after the test)."""
    return lambda: monkeypatch.setattr(limits, "CHUNK_T", 1 << 6)


def _deep_inputs():
    coeffs, h = _t(_vals(1, (28, T))), _t(_vals(2, (8, T)))
    gammas = [int(v) for v in _vals(3, (28,))]
    epsilons = [int(v) for v in _vals(4, (8,))]
    z = int(_vals(5, (1,))[0])
    return coeffs, h, gammas, epsilons, z, f128.fmul(z, f128.get_root_of_unity(T)), pow(z, 8, f128.P)


def _port_deep(coeffs, h, gammas, epsilons, z, zg, zm):
    """The DEEP that T-mode and cls share (``ClassStages.deep``), from
    T-mode's constants, with the OOD values by the multi-point evaluation."""
    cols, hc = from_numpy(coeffs), from_numpy(h)
    ood = (*me.multi_eval_rows(cols, [z, zg]), me.multi_eval_rows(hc, [zm])[0])
    stages = tpl._TModeStages(T, 8, torch.device("cpu"))
    return to_numpy(stages.deep(cols, hc, gammas, gammas, epsilons, (z, zg, zm), ood))


def test_deep_chunked_equals_one_shot_and_jax_sums(chunked):
    """The DEEP witness with the chunked stage forms equals the one-shot
    form, and the weighted sums' plain version (in column blocks) and its
    dispatch on the CPU equal the JAX package's one-shot sums (the rest of
    the stage is unchanged; the whole JAX stage is held against it under
    -m slow)."""
    from zkvm.field import jax_f128t as jt

    coeffs, h, gammas, epsilons, z, zg, zm = _deep_inputs()
    one_shot = _port_deep(coeffs, h, gammas, epsilons, z, zg, zm)
    chunked()
    np.testing.assert_array_equal(_port_deep(coeffs, h, gammas, epsilons, z, zg, zm), one_shot)
    for cols, w in ((coeffs, gammas), (h, epsilons)):
        got = deep.weighted_sum_plain(from_numpy(cols), tensor(w))
        want = jt.fsum(jt.fmul(jnp.asarray(cols), jnp.asarray(jf.to_limbs(w))[:, :, None]), axis=0)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        np.testing.assert_array_equal(to_numpy(deep.weighted_sum(from_numpy(cols), [w])[0]), np.asarray(want))


@pytest.mark.slow  # the JAX stage's CPU compile takes minutes
def test_deep_chunked_equals_jax_stage(chunked):
    from zkvm.prover import pipeline as jpl

    coeffs, h, gammas, epsilons, z, zg, zm = _deep_inputs()
    chunked()
    got = _port_deep(coeffs, h, gammas, epsilons, z, zg, zm)
    jdct = jpl._class_constants_t(T, 8)
    tl = lambda v: jnp.asarray(jf.to_limbs(v))
    want = jpl._stage_deep_t(
        jnp.asarray(coeffs), jnp.asarray(h), tl(gammas), tl(gammas), tl(epsilons), tl(z), tl(zg), tl(zm),
        tl(f128.finv(z)), tl(f128.finv(zg)), tl(f128.finv(zm)), jdct["class_bases_t"], jdct["ntt_consts_t"],
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_chunked_proof_bytes_equal(chunked):
    """A T = 2^8 proof of the linear regression is the same bytes with the
    chunked forms (column blocks, column scans, point pairs) as without,
    and it verifies."""
    run = lrl.LrRun(8)
    run.prepare()
    plain = run.prove("cpu")[0].to_wire_bytes()
    chunked()
    proof = run.prove("cpu")[0]
    assert proof.to_wire_bytes() == plain
    clear, _, rejected = run.check(proof)
    assert clear == run.expected and rejected


def _check_script(argv, mode):
    out = io.StringIO()
    with redirect_stdout(out):
        lrl.main(argv)
    lines = out.getvalue().splitlines()
    assert lines[0] == "cpu"
    phases = {d["phase"]: d for d in map(json.loads, lines[1:])}
    assert phases["inputs"]["trace_length"] == T and phases["inputs"]["card"] == "cpu"
    assert phases["inputs"]["mode"] == mode
    assert set(phases) == {"inputs", "cold_prove", "steady_prove", "verify"}
    assert phases["steady_prove"]["rows_per_sec"] > 0 and "deep" in phases["steady_prove"]["stage_seconds"]
    v = phases["verify"]
    assert v["decrypted"] == v["expected"] and v["tampered_rejected"]


def test_prove_lr_large_script_on_cpu():
    _check_script(["8", "--device", "cpu"], "tmode")


def test_prove_lr_large_script_cls_on_cpu():
    """``--mode cls``: the same run through the class prover."""
    _check_script(["8", "--device", "cpu", "--mode", "cls"], "cls")


def test_prove_lr_large_script_mono_on_cpu(monkeypatch):
    """``--mode mono``: the same run through the full-LDE prover, in row
    blocks (the threshold and the block patched to 2^6)."""
    from zkvm_torch.prover import mono

    monkeypatch.setattr(limits, "CHUNK_T", 1 << 6)
    monkeypatch.setattr(limits, "MONO_ROW_BLOCK", 1 << 6)
    mono._domain_constants.cache_clear()
    try:
        _check_script(["8", "--device", "cpu", "--mode", "mono"], "mono")
    finally:
        mono._domain_constants.cache_clear()


class _Trace:
    def __init__(self, length):
        self.length = length


@pytest.mark.parametrize("mode,t", [("mono", 1 << 21), ("tmode", 1 << 21)])
def test_trace_length_limits(mode, t):
    """Past 2^20 both raise; mono's limit in one process is T-mode's, and a
    rank's share of a mesh keeps its measured 2^17 (T <= 2^17 P)."""
    pub = tpl.PublicInputs((0, 0), (0,) * 16, None)
    with pytest.raises(ValueError, match=f"{mode}: trace length {t} > {1 << 20} is not supported"):
        tpl.prove(_Trace(t), pub, device="cpu", mode=mode)
    assert limits.MONO_MAX_TRACE_LENGTH == limits.TMODE_MAX_TRACE_LENGTH == 1 << 20
    assert limits.MONO_RANK_MAX_TRACE_LENGTH == 1 << 17


def test_inputs_follow_the_reference_script():
    """The program and the sizing are scripts/prove_lr_large.py's: its
    build_program (taken from its source, which imports the JAX package)
    gives the same program, and its sizing the same term count."""
    src = (REPO / "scripts" / "prove_lr_large.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "build_program")
    scope = {}
    exec(compile(ast.Module([fn], []), "prove_lr_large", "exec"), scope)
    assert lrl.build_program(37) == scope["build_program"](37)
    for k in (8, 18, 20):
        max_ops = 7 * 2 ** (k - 1) // 8
        assert lrl.n_terms_for(k) == (max_ops - 1) // 4 - 8
    run = lrl.LrRun(10)
    rng = random.Random(7)
    assert run.weights == [rng.randrange(8) for _ in range(run.n_terms)]
