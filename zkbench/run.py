"""The benchmark of the PyTorch and CUDA prover (``zkvm_torch``) on one card.

    python -m zkbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in the root ``BENCHMARK.json``: a
configuration (``zkbench/configs/<config>.json``: the program, its inputs'
ranges, the LWE parameters, the trace length, the proof options and the
prover's layout) under a traffic mix (``zkbench/traffic/<traffic>.json``:
the clients of a closed loop and the distinct traces each proves in turn).

Set-up (``setup_s``): the kernel library and the trace generator are
loaded (built by the first run of a checkout), the inputs are drawn from
the seed, the program is compiled, each client's pool is traced, and the
prover runs once cold and once more for every client at once.  Then the
window: the clients, one thread each, prove back to back, from handing a
trace to ``zkvm_torch.prover.pipeline.prove`` to holding the proof's wire
bytes, and start proofs for ``--seconds``; the window closes when the last
of them is on the host.  With ``--trace 1`` the window runs under
``torch.profiler`` and each prove records its stage seconds (which
synchronise the card at each stage's end), and the run reports the
per-layer metrics instead of the end-to-end ones.

Once the window has closed and the card's peak is read, every proof is
judged by the plain reference (:mod:`zkbench.check`).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` and, traced, ``breakdown``, and last
the numbers compared with their limits under ``check``; those numbers are
also the last lines of standard error.  Each metric is read by its own
module, ``zkbench/metrics/<name>.py`` (``read(ctx)``; ``None`` leaves the
metric out), and reported in the cells that ``BENCHMARK.json`` names for it.

The run fails, printing no result, without a CUDA card (or with fewer than
the cell's), and when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``zkvm`` is loaded in this process.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from zkbench import check as ck
from zkbench import traffic as tf

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zkvm")
# a proof still running this long after the window's last start never came
LATE_S = 600.0
# traces made at once in set-up (the card's machine has 8 cores)
TRACE_THREADS = 4


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one the benchmark may not load; ``zkvm_torch`` is not ``zkvm``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own nvcc build directory is ``zkvm_torch/build``)."""
    base = root / "zkbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def benchmark_entry(name: str) -> tuple:
    """(workload, end-to-end metrics, per-layer metrics) of a cell, each
    metric being reported in it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"zkbench: no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return cells[name], mine(bench["end_to_end"]), mine(bench["per_layer"])


@dataclass
class Record:
    """One proof of the window: its trace (client, index), its wire bytes'
    digest, its start and end on the host clock, its stage seconds."""

    key: tuple
    digest: str
    t0: float
    t1: float
    stages: Optional[dict] = None


@dataclass
class Ctx:
    """What the metric readers read."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    trace_gen_s: List[float] = field(default_factory=list)
    records: List[Record] = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    peak_bytes: int = 0
    trace: object = None  # zkbench.trace.Trace of a traced run

    @property
    def proofs(self) -> int:
        return len(self.records)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def make_prover(config: dict, device, prove=None) -> Callable:
    """``fn(trace, pub, stages=None) -> wire bytes``: the timed path, the
    port's ``pipeline.prove`` in the configuration's layout and options
    (``prove`` replaces it for a control or a planted fault)."""
    import torch
    from zkvm_torch.prover.options import ProofOptions
    from zkvm_torch.prover.pipeline import prove as port_prove

    prove = prove or port_prove
    opts = config["proof"]
    options = ProofOptions(opts["num_queries"], opts["blowup"], opts["grinding_factor"],
                           opts["fri_folding_factor"], opts["fri_remainder_max_degree"])
    mode = config["mode"]

    def fn(trace, pub, stages=None):
        with torch.profiler.record_function("zkbench.prove"):
            proof = prove(trace, pub, options, device=device, mode=mode, stage_seconds=stages)
        with torch.profiler.record_function("zkbench.to_wire_bytes"):
            return proof.to_wire_bytes()

    return fn


class Client(threading.Thread):
    """One client of the closed loop: proves its pool in turn, starting
    proofs until the deadline."""

    def __init__(self, idx: int, pool: list, prover: Callable, start: threading.Event, stages: bool,
                 limit: Optional[int] = None):
        super().__init__(name=f"zkbench-client-{idx}", daemon=True)
        self.idx, self.pool, self.prover, self.start_evt, self.stages = idx, pool, prover, start, stages
        self.limit = limit  # at most this many proofs, whatever the deadline
        self.deadline = 0.0
        self.records: List[Record] = []
        self.proofs: Dict[tuple, bytes] = {}
        self.attempted = 0
        self.errors: List[str] = []

    def prove_one(self, k: int) -> Record:
        trace, pub = self.pool[k]
        stages = {} if self.stages else None
        t0 = time.perf_counter()
        data = self.prover(trace, pub, stages)
        t1 = time.perf_counter()
        key = (self.idx, k)
        digest = hashlib.sha256(data).hexdigest()
        self.proofs.setdefault((key, digest), data)
        return Record(key, digest, t0, t1, stages)

    def run(self):
        self.start_evt.wait()
        i = 0
        while (i < self.limit) if self.limit is not None else (time.perf_counter() < self.deadline):
            self.attempted += 1
            try:
                self.records.append(self.prove_one(i % len(self.pool)))
            except Exception as exc:  # a failed proof counts; the client stops
                self.errors.append(f"client {self.idx}: {exc!r}")
                return
            i += 1


def run_clients(pools: list, prover: Callable, seconds: float, stages: bool, limit: Optional[int] = None):
    """One window: every client starts at once (with ``limit``, each makes
    that many proofs); returns (clients, start, end), end being when the
    last proof was on the host.  A proof that has not ended ``LATE_S``
    after the last start counts as failed."""
    start = threading.Event()
    clients = [Client(c, pool, prover, start, stages, limit) for c, pool in enumerate(pools)]
    for cl in clients:
        cl.start()
    w0 = time.perf_counter()
    for cl in clients:
        cl.deadline = w0 + seconds
    start.set()
    for cl in clients:
        cl.join(timeout=max(0.0, w0 + seconds + LATE_S - time.perf_counter()))
    ends = [r.t1 for cl in clients for r in cl.records]
    return clients, w0, max(ends, default=time.perf_counter())


def all_threads():
    """The profiler's option to record the client threads' host events too
    (the threads start before the profiler), where this torch has it."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def card(device) -> dict:
    """The card's name, count, power limit and clocks (nvidia-smi)."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=power.limit,clocks.max.sm,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        lim, clk_max, clk = [s.strip() for s in smi.stdout.strip().split(",")]
        out.update(power_limit=lim, sm_clock_max=clk_max, sm_clock=clk)
    except (OSError, ValueError, subprocess.SubprocessError) as exc:
        out["power_limit"] = f"not read: {exc!r}"
    return out


def read_metrics(names: List[dict], ctx: Ctx) -> dict:
    out = {}
    for m in names:
        value = importlib.import_module(f"zkbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def build_pools(config: dict, traffic: dict, seed: int, device):
    """The run's inputs (drawn from the seed), the program compiled by the
    port and each client's traces with their public inputs: (the inputs'
    pools, the traced pools, the trace generator's seconds a trace)."""
    from zkvm_torch import vm
    from zkvm_torch.air.layout import PublicInputs
    from zkvm_torch.fhe import FheUInt8, LweParameters, ServerKey
    from zkvm_torch.isa import Program, ProgramInputs
    from zkvm_torch.runtime import native_available

    if traffic["loop"] != "closed":
        raise ValueError(f"traffic {traffic['name']}: only a closed loop is generated, not {traffic['loop']!r}")
    if device.type == "cuda":
        from zkvm_torch import kernels

        kernels.lib()
    key, pools_in = tf.pools(config, traffic, seed)
    lwe = config["lwe"]
    server_key = ServerKey.from_key(key, LweParameters(lwe["plaintext_modulus"], lwe["ciphertext_modulus"],
                                                       lwe["k"], lwe["std"]))
    program = Program.compile(tf.program_source(config))
    if not native_available():
        raise RuntimeError("the native trace generator did not build (g++)")

    def one(inp):
        inputs = ProgramInputs(inp.public, tuple(FheUInt8(ct) for ct in inp.secret), server_key)
        t0 = time.perf_counter()
        trace = vm.run(program, inputs)
        seconds = time.perf_counter() - t0
        if trace.length != config["trace_length"]:
            raise RuntimeError(f"trace of {trace.length} rows, {config['name']} states {config['trace_length']}")
        return (trace, PublicInputs(program.hash, trace.outputs, server_key)), seconds

    # the native generator releases the interpreter lock: the pool's traces
    # are made side by side
    flat = [inp for pool_in in pools_in for inp in pool_in]
    with ThreadPoolExecutor(max_workers=min(len(flat), TRACE_THREADS)) as ex:
        made = list(ex.map(one, flat))
    it = iter(made)
    pools = [[next(it)[0] for _ in pool_in] for pool_in in pools_in]
    return pools_in, pools, [s for _, s in made]


def warm_up(pools: list, prover: Callable, stages: bool) -> None:
    """One cold prove (the kernels' first launches, the per-T constants),
    then one prove of every client at once."""
    prover(*pools[0][0])
    warm, *_ = run_clients([[pool[1 % len(pool)]] for pool in pools], prover, 0.0, stages, limit=1)
    errors = [e for cl in warm for e in cl.errors]
    if errors:
        raise RuntimeError(f"warm-up prove failed: {errors[0]}")


def run_cell(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
             prove=None) -> dict:
    """Set-up, window and check of one cell, a configuration under a
    traffic mix, on ``device``; returns the pieces of the result line (the
    caller has made sure of the card).  ``prove`` replaces the port's
    ``pipeline.prove`` (a control or a planted fault)."""
    import torch

    cuda = device.type == "cuda"
    ctx = Ctx(config, traffic)
    pools_in, pools, ctx.trace_gen_s = build_pools(config, traffic, seed, device)
    prover = make_prover(config, device, prove)
    warm_up(pools, prover, traced)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    ctx.setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts, experimental_config=all_threads())
        prof.__enter__()
    span = torch.profiler.record_function("zkbench.window") if traced else contextlib.nullcontext()
    with span:
        clients, w0, w1 = run_clients(pools, prover, seconds, traced)
    if prof is not None:
        prof.__exit__(None, None, None)
    ctx.window = (w0, w1)
    ctx.records = sorted((r for cl in clients for r in cl.records), key=lambda r: r.t0)
    if cuda:
        torch.cuda.synchronize(device)
        ctx.peak_bytes = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        from zkbench import trace as tr

        ctx.trace = tr.from_profiler(prof)
        del prof
    attempted = sum(cl.attempted for cl in clients)
    failed = attempted - len(ctx.records)
    proofs = {}
    for cl in clients:
        proofs.update(cl.proofs)
    for cl in clients:
        for e in cl.errors:
            print(e, file=sys.stderr)

    device_entry = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if cuda:
        device_entry = dict(card(device), memory_peak_bytes=max(setup_peak, ctx.peak_bytes))
    # the program's state goes before the reference runs
    del pools, clients
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, numbers, reasons = ck.check(config, pools_in, ctx.records, proofs, failed, device)
    print(f"zkbench: the reference judged {len(proofs)} distinct proofs in {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    return dict(ctx=ctx, correct=correct, attempted=attempted, failed=failed, numbers=numbers,
                reasons=reasons, device=device_entry)


def result_line(out: dict, metrics: dict, traced: bool) -> dict:
    entry, _ = ck.report(out["numbers"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if traced and out["ctx"].trace is not None:
        from zkbench import trace as tr

        t = out["ctx"].trace
        line["device"] = dict(line["device"], busy_s=t.busy_s(), window_s=t.window_s)
        stages = next((list(r.stages) for r in out["ctx"].records if r.stages), [])
        line["breakdown"] = tr.breakdown(t, stages)
    lat = sorted(r.t1 - r.t0 for r in out["ctx"].records)
    if lat:
        line["proof_latency_s"] = {"n": len(lat), "min": lat[0], "median": statistics.median(lat), "max": lat[-1]}
    line["check"] = entry
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m zkbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, e2e, per_layer = benchmark_entry(args.workload)
    cache_env(ROOT)
    import torch

    need = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zkbench: {args.workload} needs {need} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(tf.load_json("configs", workload["config"]), tf.load_json("traffic", workload["traffic"]),
                   args.seed, args.seconds, bool(args.trace), device, t_start)
    metrics = read_metrics(per_layer if args.trace else e2e, out["ctx"])
    found = forbidden_modules()
    if found:
        print(f"zkbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(out, metrics, bool(args.trace))
    for reason in out["reasons"][:20]:
        print(f"rejected: {reason}", file=sys.stderr)
    _, lines = ck.report(out["numbers"])
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
