"""The port's profiler and kernel-health report on the CPU, held against the
reference's own checks (``tests/test_config_profiler.py``).

* :class:`zkvm_torch.utils.profiler.Profiler` collects phases as the
  reference's does; a profiled ``vm.prove`` records the reference's phase
  names (read from ``zkvm/prover/pipeline.py::_prove_t``), with rows = D
  where the reference gives rows; ``config.runtime.profile`` enables it in
  every mode; ``ZKVM_PROFILE_DIR`` / ``enable(trace_dir)`` writes a
  ``torch.profiler`` trace; on the CPU ``live_bytes`` stays None;
* :mod:`zkvm_torch.utils.kernel_health` lists every kernel family, with
  0 launches after a CPU prove, formats and sums the launch ledger's
  entries (``kernels.launched``), and ``reset`` clears it;
* ``vm.verify`` / ``verify_bytes`` read ``min_security`` from ``config``.
"""

import ast
import collections
import json
import random
from pathlib import Path

import pytest
import torch

from zkvm_torch import vm
from zkvm_torch.config import RuntimeConfig, ZkVmConfig
from zkvm_torch.prover import pipeline as tpl
from zkvm_torch.utils import kernel_health
from zkvm_torch.utils.profiler import Profiler, profiler

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _program():
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(1))
    return key, vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)


@pytest.fixture
def clean_profiler():
    profiler.disable()
    profiler.phases.clear()
    yield profiler
    profiler.disable()
    profiler.phases.clear()


def _reference_phases():
    """{phase name: whether it is given rows} of the reference's T-mode
    prover (``profiler.phase(...)`` in ``zkvm/prover/pipeline.py::_prove_t``)."""
    tree = ast.parse((REPO / "zkvm" / "prover" / "pipeline.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_prove_t")
    out = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "phase"
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "profiler"):
            out[node.args[0].value] = any(k.arg == "rows" for k in node.keywords)
    return out


def test_profiler_collects_phases():
    prof = Profiler()
    prof.enable()
    with prof.phase("alpha", rows=1000):
        sum(range(10000))
    with prof.phase("alpha", rows=1000):
        pass
    with prof.phase("beta"):
        pass
    prof.disable()
    assert len(prof.phases) == 3
    assert prof.phases[0].rows_per_sec > 0
    totals = prof.totals()
    assert set(totals) == {"alpha", "beta"}
    assert "alpha" in prof.report()
    with prof.phase("gamma"):  # disabled: nothing recorded
        pass
    assert len(prof.phases) == 3


def test_profiled_prove_records_pipeline_phases(clean_profiler):
    key, program, inputs = _program()
    profiler.enable()
    try:
        _, _, proof = vm.prove(program, inputs, device="cpu")
    finally:
        phases = list(profiler.phases)
        profiler.disable()
    (root,) = [i for i, p in enumerate(phases) if p.name == "prove"]
    assert [p.name for p in phases if p.parent is None] == ["trace_gen", "prove"]
    names = {p.name for p in phases if p.parent == root} - {"transcript"}  # the stages
    assert {"trace_lde_commit", "constraint_eval", "composition_commit", "deep_composition",
            "fri", "query_assembly"} <= names
    ref = _reference_phases()
    assert set(tpl.PROFILE_PHASES.values()) == set(ref) | {"constants"}
    assert names == set(ref) | {"constants"}
    d = proof.trace_length * proof.blowup
    for p in phases:
        assert p.rows == (d if ref.get(p.name) else None), p
        assert p.seconds >= 0 and p.live_bytes is None


@pytest.mark.parametrize("mode", tpl.MODES)
def test_config_profile_enables_the_profiler(clean_profiler, mode):
    key, program, inputs = _program()
    cfg = ZkVmConfig(runtime=RuntimeConfig(profile=True))
    h, out, proof = vm.prove(program, inputs, device="cpu", mode=mode, config=cfg)
    assert profiler.enabled
    phases = profiler.phases
    assert [p.name for p in phases][:4] == ["trace_gen", "prove", "constants", "trace_lde_commit"]
    assert [p.name for p in phases if p.parent == 1][-1] == "query_assembly"
    vm.verify(proof, h, out, key)


def test_profile_dir_writes_a_trace(clean_profiler, tmp_path, monkeypatch):
    monkeypatch.setenv("ZKVM_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("ZKVM_PROFILE_MEM", "1")
    key, program, inputs = _program()
    vm.prove(program, inputs, device="cpu", config=ZkVmConfig(runtime=RuntimeConfig(profile=True)))
    assert all(p.live_bytes is None for p in profiler.phases)  # no card: no device bytes
    profiler.disable()
    (trace,) = tmp_path.glob("zkvm_trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"zkvm.trace_gen", "zkvm.prove", "zkvm.trace_commit.transpose"} <= {e.get("name") for e in events}


def test_kernel_health_on_the_cpu():
    key, program, inputs = _program()
    kernel_health.reset()
    vm.prove(program, inputs, device="cpu", mode="mono")
    rep = kernel_health.report()
    assert rep["backend"] == "cpu"
    assert set(rep["launches"]) == set(rep["launches_by_shape"]) == set(kernel_health.FAMILIES)
    assert rep["launches"] == dict.fromkeys(kernel_health.FAMILIES, 0) and rep["total"] == 0
    assert all(v == {} for v in rep["launches_by_shape"].values())
    assert rep["plain_calls"] == {"multi_eval": 2}  # mono's OOD frame, in the plain version on the CPU


# one ledger entry a family (times, shape) and its formatted key; merkle
# has two sizes
_LEDGER = {
    "ntt_stages": [(3, dict(M=256, B=28, NL=256, variant="r1"), "M=256 B=28 NL=256 variant=r1")],
    "blake3_rows": [(2, dict(C=28, N=1 << 16), "C=28 N=65536")],
    "merkle": [(2, dict(N=1 << 19), "N=524288"), (3, dict(N=1 << 16), "N=65536")],
    "composition": [(1, dict(T=1 << 16), "T=65536")],
    "transition": [(1, dict(N=1 << 19, step=8), "N=524288 step=8")],
    "batch_inverse": [(4, dict(R=3, N=1 << 16), "R=3 N=65536")],
    "field_ops": [(6, dict(op="mul", n=1 << 16), "op=mul n=65536")],
    "multi_eval": [(4, dict(C=28, Q=32, T=1 << 16), "C=28 Q=32 T=65536")],
    "meval_ladders": [(3, dict(Q=32, T=1 << 16), "Q=32 T=65536")],
    "fri_fold": [(3, dict(n=1 << 16), "n=65536")],
    "ladder": [(1, dict(B=1024, n=512), "B=1024 n=512")],
    "ladder_const": [(1, dict(B=1, n=1024), "B=1 n=1024")],
    "weighted_sum": [(2, dict(K=2, C=28, N=1 << 16), "K=2 C=28 N=65536")],
    "deep_quotient": [(8, dict(K=3, N=1 << 16), "K=3 N=65536")],
    "limb_transpose": [(1, dict(C=28, N=1 << 16), "C=28 N=65536")],
}


def test_kernel_health_reset_zeroes_the_counters(monkeypatch):
    from zkvm_torch import kernels

    monkeypatch.setattr(kernels, "launched", collections.Counter())
    assert set(_LEDGER) == set(kernel_health.FAMILIES)
    for family, entries in _LEDGER.items():
        for times, shape, _ in entries:
            kernels.count(family, times, **shape)
    kernels.count("multi_eval_plain", 2)
    kernels.count("upload", kind="pinned")  # not a kernel: in no family
    rep = kernel_health.report()
    assert rep["launches"] == {family: sum(e[0] for e in entries) for family, entries in _LEDGER.items()}
    assert rep["total"] == 45 and rep["plain_calls"] == {"multi_eval": 2}
    assert rep["launches_by_shape"] == {family: {key: times for times, _, key in entries}
                                        for family, entries in _LEDGER.items()}
    assert list(rep["launches_by_shape"]["merkle"]) == ["N=65536", "N=524288"]  # by shape, ascending
    kernel_health.reset()
    assert not kernels.launched
    assert kernel_health.launches() == dict.fromkeys(kernel_health.FAMILIES, 0)
    assert all(v == {} for v in kernel_health.launches_by_shape().values())
    assert kernel_health.plain_calls() == {"multi_eval": 0}


def test_verify_reads_min_security_from_the_config():
    from zkvm_torch.verifier import VerificationError

    key, program, inputs = _program()
    h, out, proof = vm.prove(program, inputs, device="cpu")
    data = proof.to_wire_bytes()
    strict = ZkVmConfig(min_security=200)
    vm.verify(proof, h, out, key)
    vm.verify_bytes(data, h, out, key, config=ZkVmConfig())
    with pytest.raises(VerificationError):
        vm.verify(proof, h, out, key, config=strict)
    with pytest.raises(VerificationError):
        vm.verify_bytes(data, h, out, key, config=strict)
    vm.verify(proof, h, out, key, min_security=95, config=strict)  # an explicit bound wins
