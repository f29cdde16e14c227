"""The prover's spans: port of :mod:`zkvm.utils.profiler`, and the port's
one span mechanism.

:meth:`Profiler.phase` opens a span named ``zkvm.<name>``.

* While a ``torch.profiler`` trace runs (in any thread: the benchmark's
  traced window, or the one ``ZKVM_PROFILE_DIR`` starts), the span is a
  ``record_function`` on kineto's host timeline, which is the clock of the
  CUPTI device activity, so each idle gap of the card lies inside the span
  the host was in.
* While the profiler is enabled (``ZKVM_PROFILE=1`` through
  ``config.from_env()``, ``config.runtime.profile`` or :meth:`enable`), the
  span also appends a :class:`PhaseStat`: its wall-clock seconds, its rows,
  the index of the enclosing span (``parent``) and the proof it belongs to
  (``proof``, a per-process counter that each ``prove`` root span
  increments), so the spans of one proof share an identifier.
* Otherwise it costs one check: no ``record_function``, no record, no
  device memory, no synchronisation.

No span synchronises the device.  :func:`zkvm_torch.prover.pipeline.prove`
opens the root span ``prove`` and, through its one stage timer
(``pipeline._Stages``), a span a stage (``zkvm.trace_commit``, ...) recorded
under the reference's phase name; the stage timer synchronises the card at
a stage's end when asked for stage seconds or peaks or while the profiler
is enabled, so a recorded stage includes its kernels.  The stages open
child spans where the host's time goes (``zkvm.trace_commit.upload``,
``.transpose``, ``.lde``, ``.tree``; ``zkvm.queries.rows``, ``.paths``,
``.assemble``; ``zkvm.fri.layer``, ``zkvm.fri.remainder``;
``zkvm.deep.sums``, ``zkvm.deep.class``), and :func:`zkvm_torch.vm.run`
opens ``zkvm.trace_gen``.  A ``torch.profiler`` trace (CPU activity, and
CUDA activity where there is a card) can wrap everything: ``enable(trace_dir)``
or ``ZKVM_PROFILE_DIR``, written as a Chrome trace by :meth:`disable`.
With ``ZKVM_PROFILE_MEM=1`` each span given a card records the allocated
device bytes at its end (``live_bytes``; ``None`` on the CPU).

Each process has its own profiler, so over a mesh each rank records its own
spans.  Records nest by the order spans open and close in the process: one
thread a process records (the benchmark's client threads trace through
``torch.profiler``, which keeps each thread's spans apart).

Usage::

    from zkvm_torch.utils.profiler import profiler
    profiler.enable()
    ... prove ...
    profiler.report()   # or profiler.phases for raw numbers
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

ROOT = "prove"  # the span that opens a proof: it takes the next proof id


@dataclass
class PhaseStat:
    name: str
    seconds: float
    rows: Optional[int] = None
    live_bytes: Optional[int] = None
    parent: Optional[int] = None  # index in ``Profiler.phases`` of the enclosing span
    proof: Optional[int] = None  # the proof id of the enclosing ``prove`` span

    @property
    def rows_per_sec(self) -> Optional[float]:
        if self.rows is None or self.seconds == 0:
            return None
        return self.rows / self.seconds


@dataclass
class Profiler:
    enabled: bool = False
    phases: List[PhaseStat] = field(default_factory=list)
    proofs: int = 0  # the last proof id given
    _open: List[int] = field(default_factory=list)  # indices of the open spans' records
    _trace_dir: Optional[str] = None
    _trace: Optional[torch.profiler.profile] = None

    def enable(self, trace_dir: Optional[str] = None):
        self.enabled = True
        self.phases = []
        self._open = []
        self._trace_dir = trace_dir or os.environ.get("ZKVM_PROFILE_DIR")
        if self._trace_dir and self._trace is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=acts)
            self._trace.start()

    def disable(self):
        """Stop recording; write the trace, if one runs, to
        ``<trace_dir>/zkvm_trace_<pid>.json``."""
        if self._trace is not None:
            self._trace.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            self._trace.export_chrome_trace(os.path.join(self._trace_dir, f"zkvm_trace_{os.getpid()}.json"))
            self._trace = None
        self._trace_dir = None
        self.enabled = False

    @contextlib.contextmanager
    def phase(self, name: str, rows: Optional[int] = None, stat_name: Optional[str] = None, device=None):
        """The span ``zkvm.<name>`` (see the module's docstring); its record
        takes ``stat_name`` where given, else ``name``, and ``device``: where
        it ran, for ``ZKVM_PROFILE_MEM``."""
        traced = _autograd_profiler._is_profiler_enabled
        if not (traced or self.enabled):
            yield
            return
        with torch.profiler.record_function("zkvm." + name) if traced else contextlib.nullcontext():
            if not self.enabled:
                yield
                return
            parent = self._open[-1] if self._open else None
            if name == ROOT:
                self.proofs += 1
                proof = self.proofs
            else:
                proof = None if parent is None else self.phases[parent].proof
            stat = PhaseStat(stat_name or name, 0.0, rows, parent=parent, proof=proof)
            self._open.append(len(self.phases))
            self.phases.append(stat)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._open.pop()
            stat.seconds = time.perf_counter() - t0
            if (os.environ.get("ZKVM_PROFILE_MEM", "") == "1" and device is not None
                    and torch.device(device).type == "cuda"):
                stat.live_bytes = torch.cuda.memory_allocated(device)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.phases:
            out[p.name] = out.get(p.name, 0.0) + p.seconds
        return out

    def self_seconds(self) -> List[float]:
        """Each record's seconds less its children's."""
        out = [p.seconds for p in self.phases]
        for p in self.phases:
            if p.parent is not None:
                out[p.parent] -= p.seconds
        return out

    def report(self) -> str:
        """The records as a tree, a child indented under its span, with
        each one's seconds and self seconds."""
        lines = [f"{'phase':<36} {'seconds':>9} {'self':>9} {'rows/s':>14} {'live GiB':>9}"]
        depth: List[int] = []
        for p, own in zip(self.phases, self.self_seconds()):
            depth.append(0 if p.parent is None else depth[p.parent] + 1)
            rps = f"{p.rows_per_sec:,.0f}" if p.rows_per_sec else ""
            mem = f"{p.live_bytes / 2**30:.2f}" if p.live_bytes else ""
            lines.append(f"{'  ' * depth[-1] + p.name:<36} {p.seconds:>9.4f} {own:>9.4f} {rps:>14} {mem:>9}")
        text = "\n".join(lines)
        print(text)
        return text


profiler = Profiler()
"""Process-wide profiler instance used by the prover pipeline."""
