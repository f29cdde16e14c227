"""The port's profiler and kernel-health report on the CPU, held against the
reference's own checks (``tests/test_config_profiler.py``).

* :class:`zkvm_torch.utils.profiler.Profiler` collects phases as the
  reference's does; a profiled ``vm.prove`` records the reference's phase
  names (read from ``zkvm/prover/pipeline.py::_prove_t``), with rows = D
  where the reference gives rows; ``config.runtime.profile`` enables it in
  every mode; ``ZKVM_PROFILE_DIR`` / ``enable(trace_dir)`` writes a
  ``torch.profiler`` trace; on the CPU ``live_bytes`` stays None;
* :mod:`zkvm_torch.utils.kernel_health` lists every kernel family, with
  0 launches after a CPU prove, and ``reset`` zeroes counters a test set;
* ``vm.verify`` / ``verify_bytes`` read ``min_security`` from ``config``.
"""

import ast
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


def test_kernel_health_reset_zeroes_the_counters():
    from zkvm_torch.air import composition as cp
    from zkvm_torch.air import transition as tr
    from zkvm_torch.field import f128t as ft
    from zkvm_torch.field import limbs as lm
    from zkvm_torch.hash import blake3_t as b3t
    from zkvm_torch.hash import merkle as mk
    from zkvm_torch.ntt import ntt_t as nt
    from zkvm_torch.prover import deep as dp
    from zkvm_torch.prover import fri
    from zkvm_torch.prover import multi_eval as me

    nt.launches[(256, 28, 256, "r1")] += 3
    b3t.launches, cp.launches, tr.launches, ft.launches, mk.launches = 2, 1, 1, 4, 5
    b3t.launches_by_shape[(28, 1 << 16)] += 2
    tr.launches_by_shape[(1 << 19, 8)] += 1
    ft.launches_by_shape[(3, 1 << 16)] += 4
    mk.launches_by_size[1 << 19] += 2
    mk.trees_by_size[1 << 19] += 1
    ft.op_launches["mul"] += 6
    ft.op_launches_by_shape[("mul", 1 << 16)] += 6
    me.launches, me.plain_calls, me.ladder_launches = 4, 2, 3
    me.launches_by_shape[(28, 32, 1 << 16)] += 4
    me.ladder_launches_by_shape[(32, 1 << 16)] += 3
    fri.fold_launches, nt.ladder_launches, dp.sum_launches, dp.quotient_launches = 3, 1, 2, 8
    nt.ladder_const_launches = 1
    fri.fold_launches_by_shape[1 << 16] += 3
    nt.ladder_launches_by_shape[(1024, 512)] += 1
    nt.ladder_const_launches_by_shape[(1, 1024)] += 1
    dp.sum_launches_by_shape[(2, 28, 1 << 16)] += 2
    dp.quotient_launches_by_shape[(3, 1 << 16)] += 8
    lm.transpose_launches = 1
    lm.transpose_launches_by_shape[(28, 1 << 16)] += 1
    try:
        rep = kernel_health.report()
        assert rep["launches"] == {"ntt_stages": 3, "blake3_rows": 2, "merkle": 5, "composition": 1,
                                   "transition": 1, "batch_inverse": 4, "field_ops": 6, "multi_eval": 4,
                                   "meval_ladders": 3, "fri_fold": 3, "ladder": 1, "ladder_const": 1,
                                   "weighted_sum": 2, "deep_quotient": 8, "limb_transpose": 1}
        assert rep["total"] == 45 and rep["plain_calls"] == {"multi_eval": 2}
        assert rep["launches_by_shape"]["ntt_stages"] == {"M=256 B=28 NL=256 r1": 3}
        assert rep["launches_by_shape"]["merkle"] == {"N=524288 trees=1": 2}
        assert rep["launches_by_shape"]["transition"] == {"N=524288 step=8": 1}
        assert rep["launches_by_shape"]["batch_inverse"] == {"R=3 N=65536": 4}
        assert rep["launches_by_shape"]["field_ops"] == {"mul n=65536": 6}
        assert rep["launches_by_shape"]["multi_eval"] == {"C=28 Q=32 T=65536": 4}
        assert rep["launches_by_shape"]["meval_ladders"] == {"Q=32 T=65536": 3}
        assert rep["launches_by_shape"]["fri_fold"] == {"n=65536": 3}
        assert rep["launches_by_shape"]["ladder"] == {"B=1024 n=512": 1}
        assert rep["launches_by_shape"]["ladder_const"] == {"B=1 n=1024": 1}
        assert rep["launches_by_shape"]["weighted_sum"] == {"K=2 C=28 N=65536": 2}
        assert rep["launches_by_shape"]["deep_quotient"] == {"K=3 N=65536": 8}
        assert rep["launches_by_shape"]["limb_transpose"] == {"C=28 N=65536": 1}
    finally:
        kernel_health.reset()
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
