"""The program-span readers (``zkbench/spans.py`` and the metrics
``trace_transpose_ms``, ``trace_upload_ms``, ``dispatch_idle_ms``) on
hand-built traces with known spans and device intervals, and the span names
they look for against those a CPU prove of the port emits."""

import random
from types import SimpleNamespace

import pytest
import torch

from zkbench import spans as sp
from zkbench.metrics import dispatch_idle_ms, trace_transpose_ms, trace_upload_ms
from zkbench.trace import Trace

M = 1_000_000  # ns in a ms


def _proof(t0, transpose):
    """One prove's spans from t0 (ms): a trace commit of 50 ms whose
    transpose takes ``transpose`` ms, then 30 ms of composition and 20 of
    FRI with one layer."""
    at = lambda a, b: (t0 * M + a * M, t0 * M + b * M)
    return [("zkvm.prove", *at(0, 100)), ("zkvm.trace_commit", *at(0, 50)),
            ("zkvm.trace_commit.transpose", *at(0, transpose)), ("zkvm.trace_commit.upload", *at(transpose, transpose + 10)),
            ("zkvm.trace_commit.lde", *at(transpose + 10, 48)), ("zkvm.trace_commit.tree", *at(48, 50)),
            ("zkvm.composition", *at(50, 80)), ("zkvm.fri", *at(80, 100)), ("zkvm.fri.layer", *at(80, 90))]


def _trace(host=None):
    host = host if host is not None else _proof(0, 20) + _proof(100, 30)
    others = [("zkbench.prove", 0, 200 * M), ("cudaLaunchKernel", 31 * M, 32 * M), ("cudaDeviceSynchronize", 50 * M, 50 * M)]
    device = [("Memcpy HtoD", 25 * M, 30 * M), ("k1", 30 * M, 45 * M), ("k3", 60 * M, 75 * M), ("fold", 82 * M, 98 * M),
              ("Memcpy HtoD", 135 * M, 140 * M), ("k1", 140 * M, 148 * M), ("k3", 154 * M, 178 * M),
              ("fold", 185 * M, 195 * M)]
    return Trace((0, 200 * M), device, others + host)


def _ctx(trace):
    return SimpleNamespace(trace=trace)


def test_spans_nest_by_time():
    spans = sp.nest(_trace())
    assert [s.name for s in spans[:4]] == ["zkvm.prove", "zkvm.trace_commit", "zkvm.trace_commit.transpose",
                                           "zkvm.trace_commit.upload"]
    parent = {s.name: spans[s.parent].name if s.parent is not None else None for s in spans[:9]}
    assert parent == {"zkvm.prove": None, "zkvm.trace_commit": "zkvm.prove", "zkvm.composition": "zkvm.prove",
                      "zkvm.fri": "zkvm.prove", "zkvm.fri.layer": "zkvm.fri",
                      **{f"zkvm.trace_commit.{c}": "zkvm.trace_commit" for c in ("transpose", "upload", "lde", "tree")}}
    assert sp.proofs(spans) == 2 and spans[9].parent is None  # the second prove
    assert [sp.stage_of(spans, i) for i in (0, 2, 8)] == [None, "zkvm.trace_commit", "zkvm.fri"]


def test_readers_give_exact_values():
    tr = _trace()
    # transposes of 20 and 30 ms, uploads of 10 and 10
    assert trace_transpose_ms.read(_ctx(tr)) == pytest.approx(25.0)
    assert trace_upload_ms.read(_ctx(tr)) == pytest.approx(10.0)
    # idle gaps by midpoint: [0, 25] and [98, 135] in the transposes; [45, 60] and [75, 82] in the first
    # composition, [148, 154] in the second, [178, 185] in its FRI layer and [195, 200] in its FRI:
    # 15 + 7 + 6 + 7 + 5 ms
    assert dispatch_idle_ms.read(_ctx(tr)) == pytest.approx(40.0 / 2)
    spans = sp.nest(tr)
    idle = sp.idle_s(tr, spans)
    by_name = {}
    for s, v in zip(spans, idle):
        by_name[s.name] = by_name.get(s.name, 0.0) + v
    assert by_name["zkvm.trace_commit.transpose"] == pytest.approx(0.062)
    assert by_name["zkvm.fri"] == pytest.approx(0.005) and by_name["zkvm.fri.layer"] == pytest.approx(0.007)
    assert sum(idle) == pytest.approx(0.062 + 0.040)


def test_readers_give_none_without_spans():
    bare = _trace(host=[])
    for reader in (trace_transpose_ms, trace_upload_ms, dispatch_idle_ms):
        assert reader.read(_ctx(bare)) is None
        assert reader.read(_ctx(None)) is None
    no_stages = _trace(host=[("zkvm.prove", 0, 100 * M), ("zkvm.trace_commit", 0, 50 * M)])
    assert dispatch_idle_ms.read(_ctx(no_stages)) is None
    assert trace_transpose_ms.read(_ctx(no_stages)) is None


def test_spans_that_overlap_across_threads_give_none():
    second_thread = [(n, s + 60 * M, e + 60 * M) for n, s, e in _proof(0, 20)]
    tr = _trace(host=_proof(0, 20) + second_thread)
    assert sp.nest(tr) is None
    for reader in (trace_transpose_ms, trace_upload_ms, dispatch_idle_ms):
        assert reader.read(_ctx(tr)) is None


def test_readers_look_for_the_spans_a_cpu_prove_emits():
    from zkvm_torch import vm
    from zkvm_torch.prover.pipeline import prove

    torch.set_num_threads(1)
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)
    trace = vm.run(program, inputs, use_native=False)
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    # mono: a T-mode or cls prove's plain version makes millions of profiler events on the CPU
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prove(trace, pub, device="cpu", mode="mono", stage_seconds={})
    host = [(ev.name(), ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()]
    names = {n for n, _, _ in host}
    assert {sp.ROOT, "zkvm.trace_commit.transpose", "zkvm.trace_commit.upload"} | set(dispatch_idle_ms.STAGES) <= names
    lo, hi = min(s for _, s, _ in host), max(e for _, _, e in host)
    tr = Trace((lo, hi), [("kernel", lo, lo + 1)], host)
    spans = sp.nest(tr)
    assert sp.proofs(spans) == 1
    assert {sp.stage_of(spans, i) for i in range(len(spans))} - {None} == {
        "zkvm." + st for st in ("constants", "trace_commit", "transcript", "composition", "comp_commit", "ood",
                                "deep", "fri", "queries")}
    for reader in (trace_transpose_ms, trace_upload_ms, dispatch_idle_ms):
        assert reader.read(_ctx(tr)) >= 0
