#!/usr/bin/env python3
"""Time kernel K1 (zkvm_torch/csrc/ntt_stages.cu) on one CUDA card.

    python3 k1_bench.py [--tree DIR] [--label NAME]
    python3 k1_bench.py --sweep

The first form times, at each K1 case of chip_smoke.py's phase (c), four
calls of the ``zkvm_torch`` package found in DIR (default: this checkout),
from the call the prover makes down to the C entry point:

  axis     ``ntt_t._axis_ntt`` (natural order in and out; with any layout
           gathers the tree does around the kernel),
  wrapper  ``ntt_t.pease_stages``,
  launch   ``ntt_t.launch_stages`` (the input checks and the C call),
  entry    the C entry point ``zk_ntt_stages`` alone.

For each it prints one JSON line: ``ms``, the card's milliseconds per
call with the calls queued behind a spin (see :func:`cuda_ms`);
``host_ms``, the host's milliseconds to queue one call; and ``rate_ms``,
three timings of back-to-back calls with no spin (a call shorter than its
host cost is then timed at the host's rate).  So the same timer runs on
two trees (unpack the other one with ``git archive``), in one process
each.

``--sweep`` builds ``ntt_stages.cu`` alone at each launch shape (the
``ZK_K1_TILE`` / ``ZK_K1_LANES`` / ``ZK_K1_PER_THREAD`` defines; one nvcc
each, all started together, into ``zkvm_torch/build/k1_sweep``) and prints,
for each shape and case, ``ms`` and whether the output equals the plain
version.  Both forms first print the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# K1's cases in chip_smoke.py's phase (c): (M, B, NL, variants), the axes of
# the main paths (see there)
ALL3 = ("plain", "full", "r1")
K1_CASES = [(8, 1, 1 << 16, ALL3), (256, 28, 256, ALL3), (512, 1, 1024, ALL3),
            (512, 28, 1024, ("full",)), (32, 28 * 512, 32, ("plain", "full"))]
# the launch shapes of --sweep: (tile, lanes, butterflies per thread); the
# shipped default is (2048, 8, 4)
SWEEP = ([(tile, 8, k) for tile in (1024, 2048, 4096) for k in (2, 4, 8)]
         + [(tile, 4, k) for tile in (1024, 2048) for k in (2, 4)])
SWEEP_CASES = [(256, 28, 256, "r1"), (256, 8, 256, "full"), (512, 28, 1024, "full"),
               (32, 28 * 512, 32, "full"), (8, 1, 1 << 16, "plain"), (512, 1, 1024, "full")]


def cuda_ms(fn, reps, spin=True):
    """(card ms, host ms) per call, after one warm-up call.

    The card's time is taken by CUDA events around ``reps`` calls.  With
    ``spin`` the card first spins for ~10 ms (torch.cuda._sleep) while the
    host queues the calls, so a call shorter than its host-side launch
    cost is still timed on the card's clock alone, back to back.  The
    host's time is the wall time to queue the calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / reps


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


def _limbs(rng, shape, dev):
    """Random canonical elements as (..., 8, L) int32 limbs."""
    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    limbs[..., 7, :] %= 0xFFFF
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def _inputs(nt, rng, m, b, nl, variant, dev):
    """y, stage twiddles, pre and r1 in the tree's own formats (the full
    premultiplier is packed where the tree has ``pack_t``)."""
    y = _limbs(rng, (b, m, 8, nl), dev)
    tw = nt._stage_twiddles_dev(m, False, dev)
    pre = r1 = None
    if variant == "full":
        pre = _limbs(rng, (m, 8, nl), dev)
        pre = nt.pack_t(pre) if hasattr(nt, "pack_t") else pre
    elif variant == "r1":
        r1 = (_limbs(rng, (8, m), dev), _limbs(rng, (8, nl), dev))
    return y, tw, pre, r1


def bench_tree(tree, label, reps=20):
    sys.path.insert(0, str(tree))
    from zkvm_torch import kernels
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_of(torch.empty(1, device=dev))
    rng = np.random.default_rng(20261017)
    for m, b, nl, variants in K1_CASES:
        for variant in variants:
            y, tw, pre, r1 = _inputs(nt, rng, m, b, nl, variant, dev)
            rs, ls = r1 if r1 is not None else (None, None)
            out = torch.empty_like(y)
            args = [kernels.ptr(t) for t in (y, out, tw, pre, rs, ls)]
            args += [b, m, nl, m.bit_length() - 1, ("plain", "full", "r1").index(variant), stream]
            calls = {
                "axis": lambda: nt._axis_ntt(y, m, False, pre=pre, r1=r1),
                "wrapper": lambda: nt.pease_stages(y, tw, pre=pre, r1=r1),
                "launch": lambda: nt.launch_stages(lib, stream, y, tw, pre, r1),
                "entry": lambda: kernels.check(lib.zk_ntt_stages(*args), "zk_ntt_stages"),
            }
            for level, fn in calls.items():
                ms, host_ms = cuda_ms(fn, reps)
                rate = [cuda_ms(fn, reps, spin=False)[0] for _ in range(3)]
                _emit({"tree": label, "case": f"K1 M={m} B={b} NL={nl} {variant}", "level": level,
                       "ms": ms, "host_ms": host_ms, "rate_ms": rate})
            del y, out, pre, r1, rs, ls, args
            torch.cuda.empty_cache()


def _build_sweep(kernels):
    """One library of ntt_stages.cu per launch shape of SWEEP."""
    out = kernels.BUILD / "k1_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    sos, procs = [], []
    for tile, lanes, k in SWEEP:
        so = out / f"k1_{tile}_{lanes}_{k}_{kernels._digest()}.so"
        defs = [f"-DZK_K1_TILE={tile}", f"-DZK_K1_LANES={lanes}", f"-DZK_K1_PER_THREAD={k}"]
        cmd = [nvcc, *kernels.NVCC_FLAGS, *defs, "-shared", "-o", str(so), str(kernels.CSRC / "ntt_stages.cu")]
        sos.append(so)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for so, proc, shape in zip(sos, procs, SWEEP):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for launch shape {shape}:\n{log[-4000:]}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        _emit({"sweep_build": dict(zip(("tile", "lanes", "per_thread"), shape)), "ptxas": regs})
        lib = ctypes.CDLL(str(so))
        lib.zk_ntt_stages.argtypes = list(kernels.SIGNATURES["zk_ntt_stages"])
        lib.zk_ntt_stages.restype = ctypes.c_int
        libs.append(lib)
    return libs


def sweep(reps=20):
    sys.path.insert(0, str(ROOT))
    from zkvm_torch import kernels
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    libs = _build_sweep(kernels)
    stream = kernels.stream_of(torch.empty(1, device=dev))
    rng = np.random.default_rng(4)
    for m, b, nl, variant in SWEEP_CASES:
        y, tw, pre, r1 = _inputs(nt, rng, m, b, nl, variant, dev)
        want = nt.stages_plain(y, tw, pre, r1)
        for (tile, lanes, k), lib in zip(SWEEP, libs):
            row = {"case": f"K1 M={m} B={b} NL={nl} {variant}", "tile": tile, "lanes": lanes, "per_thread": k}
            run = lambda: nt.launch_stages(lib, stream, y, tw, pre, r1)
            try:
                exact = bool(torch.equal(run(), want))
            except RuntimeError as err:  # more threads than a block holds
                _emit({**row, "error": str(err)})
                continue
            ms, host_ms = cuda_ms(run, reps)
            _emit({**row, "exact": exact, "ms": ms, "host_ms": host_ms})
        del y, pre, r1, want
        torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose zkvm_torch is timed")
    ap.add_argument("--label", default="this", help="name of the tree in the output")
    ap.add_argument("--sweep", action="store_true", help="time K1 at each launch shape of SWEEP")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: torch.cuda.is_available() is false; this needs a CUDA card")
    _card()
    if args.sweep:
        sweep()
    else:
        bench_tree(args.tree.resolve(), args.label)


if __name__ == "__main__":
    main(sys.argv[1:])
