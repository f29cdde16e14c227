"""Per-phase prover instrumentation: port of :mod:`zkvm.utils.profiler`.

The prover's phases (trace-gen, LDE+commit, constraint eval, composition
commit, OOD, DEEP, FRI, query assembly) report wall-clock seconds and
rows/sec through a process-wide :class:`Profiler`.  Disabled (the
default) it costs one attribute check per phase; enabled, the device is
synchronised at phase boundaries, so the numbers include the kernels.  A
``torch.profiler`` trace (CPU activity, and CUDA activity where there is a
card) can wrap everything too: ``enable(trace_dir)`` or
``ZKVM_PROFILE_DIR``, written as a Chrome trace by :meth:`Profiler.disable`.
With ``ZKVM_PROFILE_MEM=1`` each phase of a prove on a card records the
allocated device bytes at its end (``live_bytes``; ``None`` on the CPU).

:func:`zkvm_torch.prover.pipeline.prove` records its stages here (its one
stage timer), under the reference's phase names; :func:`zkvm_torch.vm.prove`
enables the profiler on ``config.runtime.profile`` and records
``trace_gen``.  Each process has its own profiler, so over a mesh each rank
records its own phases.

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


def _tensors(x) -> list:
    """The tensors of ``x``: None, a tensor, or a list, tuple or dict of
    them."""
    if x is None:
        return []
    if isinstance(x, dict):
        x = list(x.values())
    return [t for t in (x if isinstance(x, (list, tuple)) else [x]) if isinstance(t, torch.Tensor)]


@dataclass
class PhaseStat:
    name: str
    seconds: float
    rows: Optional[int] = None
    live_bytes: Optional[int] = None

    @property
    def rows_per_sec(self) -> Optional[float]:
        if self.rows is None or self.seconds == 0:
            return None
        return self.rows / self.seconds


@dataclass
class Profiler:
    enabled: bool = False
    phases: List[PhaseStat] = field(default_factory=list)
    _trace_dir: Optional[str] = None
    _trace: Optional[torch.profiler.profile] = None

    def enable(self, trace_dir: Optional[str] = None):
        self.enabled = True
        self.phases = []
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

    @staticmethod
    def sync(x) -> None:
        """Wait for the device of each CUDA tensor in ``x`` (a tensor, or a
        list, tuple or dict of them); nothing for CPU tensors."""
        for t in _tensors(x):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)

    def record(self, name: str, seconds: float, rows: Optional[int] = None, device=None) -> None:
        """Append one phase that the caller timed, its device synchronised
        (``device``: where the phase ran, for ``ZKVM_PROFILE_MEM``)."""
        live = None
        if (os.environ.get("ZKVM_PROFILE_MEM", "") == "1" and device is not None
                and torch.device(device).type == "cuda"):
            live = torch.cuda.memory_allocated(device)
        self.phases.append(PhaseStat(name, seconds, rows, live))

    @contextlib.contextmanager
    def phase(self, name: str, rows: Optional[int] = None, sync=None):
        """Time a phase; ``sync`` is a tensor (or a collection of them) to
        wait for at exit."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        tensors = _tensors(sync)
        self.sync(tensors)
        self.record(name, time.perf_counter() - t0, rows, tensors[0].device if tensors else None)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.phases:
            out[p.name] = out.get(p.name, 0.0) + p.seconds
        return out

    def report(self) -> str:
        lines = ["phase                    seconds      rows/s   live GiB"]
        for p in self.phases:
            rps = f"{p.rows_per_sec:,.0f}" if p.rows_per_sec else ""
            mem = f"{p.live_bytes / 2**30:.2f}" if p.live_bytes else ""
            lines.append(
                f"{p.name:<24} {p.seconds:>8.4f}  {rps:>10}  {mem:>8}"
            )
        text = "\n".join(lines)
        print(text)
        return text


profiler = Profiler()
"""Process-wide profiler instance used by the prover pipeline."""
