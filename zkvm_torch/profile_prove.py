"""Where the time of one prove goes, on a CUDA card.

    python -m zkvm_torch.profile_prove [--mode tmode|mono|cls] [--tree DIR]

Proves the bench's READ/ADD chain (n_ops = 20000 gives T = 2^16) once to
warm up, once with per-stage synchronised wall clocks and peak device
memory, and once under ``torch.profiler`` (CPU and CUDA activity).  Prints
one JSON line: the card, the stage seconds and peaks, the profiled prove's
wall time, device-busy seconds (the union of kernel intervals) and idle
share, the number of device kernels per prove, the kernels with the
most device time, the copies by direction and kind (host-to-device from
pinned or pageable memory, ...), and the kernel-health report of the synced prove
(:mod:`zkvm_torch.utils.kernel_health`: each hand-written kernel's
launches, by shape).  ``--tree DIR`` proves with the ``zkvm_torch`` of
another checkout (e.g. the parent unpacked with ``git archive`` into
``zkvm_torch/build/parent``), so one script measures both.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from zkvm_torch.prover.pipeline import MODES


def _busy_seconds(events) -> float:
    """Length of the union of the device kernel intervals, in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=MODES, default="tmode", help="the prover's stages")
    parser.add_argument("--tree", type=Path, help="prove with another checkout's zkvm_torch")
    args = parser.parse_args()
    mode = args.mode
    if args.tree is not None:
        for name in [m for m in sys.modules if m.split(".")[0] == "zkvm_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(args.tree.resolve()))
    from zkvm_torch import vm
    from zkvm_torch.prover.pipeline import prove
    from zkvm_torch.utils import kernel_health

    if not torch.cuda.is_available():
        raise SystemExit("profile_prove: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.read_add_chain(vm.BENCH_N_OPS, key)
    trace = vm.run(program, inputs)
    pub = vm.PublicInputs(program.hash, trace.outputs, key)

    prove(trace, pub, device=dev, mode=mode)  # warm-up: kernel build, device tables
    stages, peaks = {}, {}
    kernel_health.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove(trace, pub, device=dev, stage_seconds=stages, mode=mode, stage_peaks=peaks)
    synced = time.perf_counter() - t0
    health = kernel_health.report()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(trace, pub, device=dev, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_seconds(kernels)
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]

    print(json.dumps({
        "card": smi, "mode": mode, "tree": str(args.tree or "."), "trace_length": trace.length,
        "stage_seconds": stages, "stage_peak_gib": {k: v / 2**30 for k, v in peaks.items()},
        "peak_gib": max(peaks.values()) / 2**30, "synced_prove_seconds": synced, "profiled_prove_seconds": wall,
        "device_busy_seconds": busy, "device_idle_share": 1.0 - busy / wall,
        "device_kernels": len(kernels),
        "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": n} for k, (us, n) in top],
        "copies": {k: n for k, (_, n) in sorted(by_name.items()) if k.startswith("Memcpy")},
        "kernel_health": health,
    }))


if __name__ == "__main__":
    main()
