"""The program's own spans in a traced window: the ``zkvm.*`` host events
that ``zkvm_torch/utils/profiler.py`` opens with ``record_function`` (the
root ``zkvm.prove``, a span a stage such as ``zkvm.trace_commit``, and their
children such as ``zkvm.trace_commit.transpose``), nested by time, and the
card's idle time inside them.

A host event carries a name and an interval, not a thread, so the spans are
nested by time alone.  That holds while one client thread proves, as in
every cell so far (the ``serial`` mix); where two spans overlap without one
holding the other, as two threads' spans may, :func:`nest` returns None and
so does every reader.  A program that opens no such span (one older than
the spans) gives None too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from zkbench.trace import gaps_ns, label_points

PREFIX = "zkvm."
ROOT = "zkvm.prove"


@dataclass
class Span:
    name: str
    start: int  # ns
    end: int
    parent: Optional[int]  # index of the enclosing span


def nest(trace) -> Optional[List[Span]]:
    """The window's ``zkvm.*`` spans in order of their start, each with its
    enclosing span; None without a trace, without such a span, or where two
    spans overlap without nesting."""
    if trace is None:
        return None
    events = sorted((s, -e, n) for n, s, e in trace.host if n.startswith(PREFIX))
    out: List[Span] = []
    stack: List[int] = []
    for s, neg_e, name in events:
        e = -neg_e
        while stack and out[stack[-1]].end <= s:
            stack.pop()
        if stack and out[stack[-1]].end < e:
            return None
        out.append(Span(name, s, e, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out or None


def proofs(spans: Sequence[Span]) -> int:
    return sum(1 for sp in spans if sp.name == ROOT)


def mean_ms(trace, name: str) -> Optional[float]:
    """Milliseconds a proof of the spans named ``name``: their summed
    duration over the window's ``zkvm.prove`` spans; None where there is
    no such span."""
    spans = nest(trace)
    if not spans or not proofs(spans):
        return None
    named = [sp.end - sp.start for sp in spans if sp.name == name]
    return sum(named) / 1e6 / proofs(spans) if named else None


def idle_s(trace, spans: Sequence[Span]) -> List[float]:
    """Each span's own idle seconds of the card: the gaps between the
    device's operations in the window whose midpoint lies in that span and
    in none of its children (the labels of ``zkbench.trace``'s breakdown,
    by the program's spans)."""
    gaps = gaps_ns([(s, e) for _, s, e in trace.device], *trace.window)
    owner = label_points([(a + b) // 2 for a, b in gaps], [(i, sp.start, sp.end) for i, sp in enumerate(spans)])
    out = [0.0] * len(spans)
    for (a, b), i in zip(gaps, owner):
        if i is not None:
            out[i] += (b - a) / 1e9
    return out


def stage_of(spans: Sequence[Span], i: int) -> Optional[str]:
    """The name of span i's stage: its ancestor (or itself) whose parent is
    a ``zkvm.prove`` span."""
    while spans[i].parent is not None:
        p = spans[i].parent
        if spans[p].name == ROOT:
            return spans[i].name
        i = p
    return None


def idle_ms_in_stages(trace, stages: Sequence[str]) -> Optional[float]:
    """The card's idle milliseconds a proof while the host was in one of
    ``stages`` (span names, children included); None where there is no
    span of them."""
    spans = nest(trace)
    if not spans or not proofs(spans) or not trace.device:
        return None
    inside = [stage_of(spans, i) in stages for i in range(len(spans))]
    if not any(inside):
        return None
    idle = idle_s(trace, spans)
    return sum(v for v, yes in zip(idle, inside) if yes) * 1e3 / proofs(spans)
