"""The reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics read: the device's activity (kernels, copies and
memsets, each with its name and interval), the union of it (busy time),
the idle gaps between it and what the host was doing in each, and device
time by name.

The window is the harness's own span, ``zkbench.window``, which opens when
the clients start and closes when the last proof of the window is on the
host.  Device intervals are clipped to it.  The union arithmetic is
``zkvm_torch/profile_prove.py::_busy_seconds``'s, copied here.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW_SPAN = "zkbench.window"
HOST_SPANS = ("zkbench.prove", "zkbench.to_wire_bytes")
SYNC = "cudaDeviceSynchronize"

Interval = Tuple[int, int]  # ns


def union_ns(spans: Sequence[Interval]) -> int:
    """Length of the union of intervals."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps_ns(spans: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The intervals of [lo, hi] that no span covers."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def label_points(points: Sequence[int], host: Sequence[Tuple[str, int, int]]) -> List[Optional[str]]:
    """For each time point, the name of the innermost host event (the one
    that started last) covering it, or None."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    events = sorted(host, key=lambda ev: ev[1])
    heap: List[Tuple[int, int, str]] = []  # (-start, end, name): the latest start first
    out: List[Optional[str]] = [None] * len(points)
    j = 0
    for i in order:
        m = points[i]
        while j < len(events) and events[j][1] <= m:
            name, s, e = events[j]
            heapq.heappush(heap, (-s, e, name))
            j += 1
        while heap and heap[0][1] <= m:
            heapq.heappop(heap)  # ended: never covers a later point either
        out[i] = heap[0][2] if heap else None
    return out


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@dataclass
class Trace:
    """The window's device activity and host events, in ns."""

    window: Interval
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device]) / 1e9

    def seconds_where(self, pred) -> float:
        """Device seconds of the operations whose name satisfies ``pred``."""
        return sum(e - s for n, s, e in self.device if pred(n)) / 1e9

    def count_where(self, pred) -> int:
        return sum(1 for n, _, _ in self.device if pred(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def stage_spans(self, stages: Sequence[str]) -> List[Tuple[str, int, int]]:
        """The prover's stages inside each prove span: a traced prove ends
        each stage with a ``cudaDeviceSynchronize`` (its stage timer), so
        the k-th one closes stage k.  A prove whose synchronisations do not
        match the stages stays one span, ``zkbench.prove``."""
        syncs = sorted(e for n, _, e in self.host if n == SYNC)
        out = []
        for n, s, e in self.host:
            if n not in HOST_SPANS:
                continue
            inside = [x for x in syncs if s < x <= e]
            if n == HOST_SPANS[0] and stages and len(inside) == len(stages):
                bounds = [s] + inside
                out.extend((f"prove: {st}", a, b) for st, a, b in zip(stages, bounds, bounds[1:]))
            out.append((n, s, e))
        return out

    def idle_gaps(self, stages: Sequence[str] = ()) -> List[Tuple[str, float]]:
        """Idle seconds of the device by what the host was doing: each gap
        by the span at its middle, the prover's stage where the traced
        prove's synchronisations give it (``stage_spans``), else the
        harness's span of the prove or of its wire bytes, else "between
        proofs"."""
        gaps = gaps_ns([(s, e) for _, s, e in self.device], *self.window)
        names = label_points([(a + b) // 2 for a, b in gaps], self.stage_spans(stages))
        out: Dict[str, float] = {}
        for (a, b), n in zip(gaps, names):
            label = n or "between proofs"
            out[label] = out.get(label, 0.0) + (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])


def from_profiler(prof) -> Trace:
    """The window's trace out of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    window = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        s, e = ev.start_ns(), ev.end_ns()
        if str(ev.device_type()).endswith("CUDA"):
            # the device's copies of host spans (user annotations) are no work
            if not (ev.is_user_annotation() or name.startswith("zkbench.")):
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the profiler's trace has no {WINDOW_SPAN} span")
    lo, hi = window
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    host = [(n, s, e) for n, s, e in host if e > lo and s < hi]
    return Trace(window, device, host)


def breakdown(tr: Trace, stages: Sequence[str] = (), top: int = 10) -> dict:
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = tr.idle_gaps(stages)[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n[:120], s] for n, s in gaps]}
