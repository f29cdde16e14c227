"""The prover's spans (``zkvm_torch/utils/profiler.py``) on the CPU.

A prove in each mode, with a ``torch.profiler`` trace running and the
profiler enabled, gives the span ``zkvm.prove``, the eight stage spans in
proof order inside it (with the transcript's draws between them) and the
children of the trace commit, the DEEP, FRI and the queries inside their
stage, each nested by time; the profiler's records form the same tree, one
proof id a prove, with the stages under the reference's phase names and
``stage_seconds``' keys.  With neither on, a
prove opens no ``record_function`` and records nothing.  The proof options
take FRI's remainder down to degree 31 so that the T = 64 trace folds once.

Mono's prove runs under ``torch.profiler`` itself (CPU activity) and its
spans are read from kineto's events.  T-mode's and cls's plain proves make
2-3 million such events (6.5 GB and 45 s for cls), so there the profiler's
flag is set and ``record_function`` replaced by a recorder of the same
spans on the host clock: the code path of the prover is the same.
"""

import random
import time
from collections import Counter

import pytest
import torch

from zkvm_torch import vm
from zkvm_torch.prover import pipeline as tpl
from zkvm_torch.prover.options import ProofOptions
from zkvm_torch.utils.profiler import Profiler, profiler

torch.set_num_threads(1)

OPTIONS = ProofOptions(fri_remainder_max_degree=31)
STAGES = list(tpl.PROFILE_PHASES)  # proof order
# the root's children: the stages, with the transcript's draws between them
ROOT_CHILDREN = ["constants", "trace_commit", "transcript", "composition", "comp_commit", "transcript", "ood",
                 "transcript", "deep", "fri", "transcript", "queries"]
CHILDREN = {"trace_commit": ["transpose", "upload", "lde", "tree"], "queries": ["rows", "paths", "assemble"]}


def _trace():
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(1))
    program, inputs = vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)
    trace = vm.run(program, inputs, use_native=False)
    return trace, vm.PublicInputs(program.hash, trace.outputs, key)


def _expected_children(mode, d):
    """{stage: its children's names in order} of a prove in ``mode``."""
    out = {st: [f"{st}.{c}" for c in cs] for st, cs in CHILDREN.items()}
    out["fri"] = ["fri.layer"] * OPTIONS.num_fri_layers(d) + ["fri.remainder"]
    # mono sums by row block (one block below ``limits.CHUNK_T``), the others a class at a time
    out["deep"] = ["deep.sums"] if mode == "mono" else ["deep.sums"] + ["deep.class"] * OPTIONS.blowup
    return out


def _nest(spans):
    """Each (name, start, end) span's parent by time: the index of the
    latest-starting span that holds it, or None."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent, stack = [None] * len(spans), []
    for i in order:
        e = spans[i][2]
        while stack and spans[stack[-1]][2] < e:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _tree(names, parent):
    """{parent's name: its children's names in order}; the roots under None."""
    out = {}
    for i, p in enumerate(parent):
        out.setdefault(None if p is None else names[p], []).append(names[i])
    return out


@pytest.fixture
def clean_profiler():
    profiler.disable()
    yield profiler
    profiler.disable()
    profiler.phases.clear()


class _Recorder:
    """A stand-in for ``torch.profiler.record_function`` that keeps each
    span's (name, start, end) on the host clock."""

    def __init__(self):
        self.spans = []

    def __call__(self, name):
        rec = self

        class _Span:
            def __enter__(self):
                self.start = time.perf_counter_ns()

            def __exit__(self, *exc):
                rec.spans.append((name, self.start, time.perf_counter_ns()))

        return _Span()


def _zkvm_spans(events):
    return sorted(((n[len("zkvm."):], s, e) for n, s, e in events if n.startswith("zkvm.")), key=lambda sp: sp[1])


@pytest.mark.parametrize("mode", tpl.MODES)
def test_prove_spans_nest_in_the_trace_and_the_records(clean_profiler, monkeypatch, mode):
    trace, pub = _trace()
    seconds = {}

    def prove():
        profiler.enable()
        tpl.prove(trace, pub, OPTIONS, device="cpu", mode=mode, stage_seconds=seconds)
        profiler.disable()
        return list(profiler.phases)

    if mode == "mono":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            phases = prove()
        spans = _zkvm_spans((ev.name(), ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events())
    else:
        rec = _Recorder()
        monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
        monkeypatch.setattr(torch.profiler, "record_function", rec)
        phases = prove()
        spans = _zkvm_spans(rec.spans)
    names = [n for n, _, _ in spans]
    d = trace.length * OPTIONS.blowup
    want = {None: ["prove"], "prove": ROOT_CHILDREN, **_expected_children(mode, d)}
    assert _tree(names, _nest(spans)) == want

    # the records: the same tree, the stages under the reference's phase names
    phase_of = tpl.PROFILE_PHASES
    rec_want = {phase_of.get(k, k): [phase_of.get(n, n) for n in v] for k, v in want.items()}
    assert _tree([p.name for p in phases], [p.parent for p in phases]) == rec_want
    assert {p.proof for p in phases} == {profiler.proofs}
    assert list(seconds) == STAGES
    assert [p.name for p in phases if p.parent == 0 and p.name != "transcript"] == [phase_of[st] for st in STAGES]
    assert all(p.seconds >= 0 for p in phases)
    own = Profiler(phases=phases).self_seconds()
    assert own[0] == pytest.approx(phases[0].seconds - sum(p.seconds for p in phases if p.parent == 0))


@pytest.mark.parametrize("mode", tpl.MODES)
def test_prove_with_neither_on_opens_no_span(clean_profiler, monkeypatch, mode):
    opened = Counter()
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened[name] += 1
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    trace, pub = _trace()
    assert not torch.autograd.profiler._is_profiler_enabled
    tpl.prove(trace, pub, OPTIONS, device="cpu", mode=mode)
    assert opened == Counter() and profiler.phases == []
    # the same spans open under torch.profiler, with nothing recorded
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.phase("trace_commit"), profiler.phase("trace_commit.upload"):
            pass
    assert opened == Counter({"zkvm.trace_commit": 1, "zkvm.trace_commit.upload": 1})
    assert profiler.phases == []


def test_records_form_a_tree_with_proof_ids():
    prof = Profiler()
    prof.enable()
    with prof.phase("trace_gen"):
        pass
    for _ in range(2):
        with prof.phase("prove"):
            with prof.phase("fri", rows=64, stat_name="fri_phase"):
                with prof.phase("fri.layer"):
                    sum(range(1000))
                with prof.phase("fri.remainder"):
                    pass
    prof.disable()
    names = [p.name for p in prof.phases]
    assert names == ["trace_gen"] + ["prove", "fri_phase", "fri.layer", "fri.remainder"] * 2
    assert [p.parent for p in prof.phases] == [None, None, 1, 2, 2, None, 5, 6, 6]
    assert [p.proof for p in prof.phases] == [None] + [prof.proofs - 1] * 4 + [prof.proofs] * 4
    own = prof.self_seconds()
    assert own[2] == pytest.approx(prof.phases[2].seconds - prof.phases[3].seconds - prof.phases[4].seconds)
    assert own[3] == prof.phases[3].seconds and prof.phases[2].rows == 64
    lines = prof.report().splitlines()
    assert [ln.split()[0] for ln in lines[1:]] == names
    assert [ln[:len(ln) - len(ln.lstrip())] for ln in lines[1:6]] == ["", "", "  ", "    ", "    "]
