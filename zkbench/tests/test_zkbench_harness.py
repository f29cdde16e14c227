"""The harness's discovery, arithmetic and result line, on the CPU."""

import ast
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from zkbench import roofline as rf
from zkbench import run as rn
from zkbench import trace as tr
from zkbench import traffic as tf
from zkbench.reference import machine, program

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_config_traffic_and_metric_is_found_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert tf.load_json("configs", c["name"]) == cfg
    for w in BENCH["workloads"]:
        assert w["config"] in names
        traffic = tf.load_json("traffic", w["traffic"])
        assert traffic["name"] == w["traffic"] and traffic["loop"] == "closed"
        workload, e2e, per_layer = rn.benchmark_entry(w["name"])
        assert workload == w
        got = {m["name"] for m in e2e}
        assert "setup_s" in got and len(got) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in got
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(importlib.import_module(f"zkbench.metrics.{m['name']}").read)


@pytest.mark.parametrize("name", ["read_add_2p16", "lr_enc_2p20"])
def test_each_configuration_has_the_trace_length_it_states(name):
    cfg = tf.load_json("configs", name)
    key = tf.secret_key(cfg, 5)
    inputs = tf.trace_inputs(cfg, key, 5, 0, 0)
    ops = tf.program_ops(cfg)
    assert len(inputs.public) == ops.count("read") and len(inputs.secret) == ops.count("read2")
    code = program.compile_code(tf.program_source(cfg))
    _, t_len = machine.run(code, inputs.public, inputs.secret, cfg["lwe"]["k"], tf.lwe_delta(cfg))
    assert t_len == cfg["trace_length"]


def test_inputs_come_from_the_seed():
    cfg = tf.load_json("configs", "read_add_2p16")
    traffic = {"clients": 2, "pool": 2}
    assert tf.pools(cfg, traffic, 2**31 + 77) == tf.pools(cfg, traffic, 2**31 + 77)
    key, pools = tf.pools(cfg, traffic, 3)
    assert len({p.public for pool in pools for p in pool}) == 4
    assert tf.pools(cfg, traffic, 4)[1] != pools


def _ctx(spans, window):
    ctx = rn.Ctx({}, {})
    ctx.records = [rn.Record((0, i % 2), "d", a, b) for i, (a, b) in enumerate(spans)]
    ctx.window = window
    return ctx


def test_proof_s_and_p95_over_the_window_with_a_stall():
    proof_s = importlib.import_module("zkbench.metrics.proof_s").read
    p95 = importlib.import_module("zkbench.metrics.proof_p95_s").read
    steady = _ctx([(i, i + 1.0) for i in range(20)], (0.0, 20.0))
    assert proof_s(steady) == pytest.approx(1.0)
    assert p95(steady) == pytest.approx(1.0)
    # proof 10 stalls for 5 s: the window is 5 s longer over the same proofs
    spans = [(i, i + 1.0) for i in range(10)] + [(10.0, 16.0)] + [(i + 5.0, i + 6.0) for i in range(11, 20)]
    stalled = _ctx(spans, (0.0, 25.0))
    assert proof_s(stalled) == pytest.approx(25.0 / 20)
    lat = [b - a for a, b in spans]
    assert p95(stalled) == pytest.approx(statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert p95(stalled) > 1.0
    # four clients at once: the card's time a proof, not a client's latency
    four = _ctx([(c * 0.01 + i, c * 0.01 + i + 1.0) for i in range(5) for c in range(4)], (0.0, 5.03))
    assert proof_s(four) == pytest.approx(5.03 / 20)
    assert p95(four) == pytest.approx(1.0)


def test_device_idle_is_the_window_less_the_union_of_device_intervals():
    device = [("kernel_a", 10, 30), ("Memcpy HtoD (Pageable -> Device)", 20, 40), ("kernel_b", 60, 70),
              ("kernel_c", 65, 68), ("kernel_d", 95, 130)]
    host = [("zkbench.prove", 0, 100), ("aten::copy_", 45, 55), ("cudaDeviceSynchronize", 30, 45),
            ("cudaDeviceSynchronize", 80, 90), ("zkbench.to_wire_bytes", 100, 104)]
    t = tr.Trace((0, 110), [(n, max(s, 0), min(e, 110)) for n, s, e in device], host)
    assert tr.union_ns([(s, e) for _, s, e in t.device]) == 30 + 10 + 15
    assert t.busy_s() == pytest.approx(55e-9)
    assert t.window_s == pytest.approx(110e-9)
    idle = importlib.import_module("zkbench.metrics.device_idle").read
    ctx = rn.Ctx({}, {})
    ctx.trace = t
    assert idle(ctx) == pytest.approx(50.0)
    assert tr.gaps_ns([(s, e) for _, s, e in t.device], 0, 110) == [(0, 10), (40, 60), (70, 95)]
    # each gap by the prover's stage at its middle: the k-th synchronisation
    # of a prove closes its stage k
    assert dict(t.idle_gaps(["a", "b"])) == pytest.approx({"prove: a": 10e-9, "prove: b": 45e-9})
    assert dict(t.idle_gaps()) == pytest.approx({"zkbench.prove": 55e-9})
    assert dict(t.idle_gaps(["a", "b", "c"])) == pytest.approx({"zkbench.prove": 55e-9})
    assert dict(tr.Trace((100, 106), [], host).idle_gaps()) == pytest.approx({"zkbench.to_wire_bytes": 6e-9})
    assert dict(tr.Trace((104, 120), [], host).idle_gaps()) == pytest.approx({"between proofs": 16e-9})
    ctx.records = [rn.Record((0, 0), "d", 0.0, 1.0)] * 2
    assert importlib.import_module("zkbench.metrics.h2d_ms_per_proof").read(ctx) == pytest.approx(20e-9 * 1e3 / 2)
    assert importlib.import_module("zkbench.metrics.device_kernels_per_proof").read(ctx) == 2.0
    b = tr.breakdown(t, ["a", "b"])
    assert dict(b["device_ops"]) == pytest.approx({"kernel_a": 20e-9, "Memcpy HtoD (Pageable -> Device)": 20e-9,
                                                   "kernel_b": 10e-9, "kernel_c": 3e-9, "kernel_d": 15e-9})
    assert [n for n, _ in b["idle_gaps"]] == ["prove: b", "prove: a"]


def test_roofline_counts_match_the_bounds_of_one_k1_and_one_k3_shape():
    # PERF.md section 6: K1 at M = 512 over 28 x 1024 lanes with its full
    # premultiplier, 0.527 ms (operations); K3 over one 2^16-row class,
    # 0.0534 ms (operations)
    nbytes, ops = rf.ntt_work(512, 28 * 1024, coset=True)
    assert rf.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.527, abs=5e-4)
    assert ops / rf.INT32_OPS_PER_S > nbytes / rf.HBM_BYTES_PER_S
    nbytes, ops = rf.composition_work(1 << 16, 1, rf.BOUNDARY_COLUMNS)
    assert rf.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0534, abs=5e-5)
    # a proof's transforms: the trace's, its extension, the composition's
    b16, o16 = rf.proof_ntt_work(1 << 16, 8, 28, 8)
    parts = [rf.ntt_work(1 << 16, 28, False), rf.ntt_work(1 << 16, 224, True), rf.ntt_work(1 << 19, 1, False),
             rf.ntt_work(1 << 16, 64, True)]
    assert (b16, o16) == (sum(p[0] for p in parts), sum(p[1] for p in parts))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_the_benchmark_runs_is_jax_or_the_jax_package():
    files = sorted(f for f in (ROOT / "zkbench").rglob("*.py")
                   if not any(part.startswith(".") for part in f.relative_to(ROOT).parts))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in rn.FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"
    # in a process of its own: the whole top-level name, as zkvm_torch (the
    # port) begins with zkvm (the JAX package)
    mods = ["zkbench." + ".".join(f.relative_to(ROOT / "zkbench").with_suffix("").parts)
            for f in files if "tests" not in f.parts and f.name != "__main__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import zkvm_torch.vm, zkvm_torch.prover.pipeline\n"
            "from zkbench.run import forbidden_modules\n"
            "assert 'zkvm_torch' in sys.modules\n"
            "print(forbidden_modules())\n"
            "sys.modules['zkvm.prover'] = sys.modules['zkvm_torch']\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "['zkvm.prover']"]


def test_the_command_fails_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "zkbench", "--workload", "chain16.serial", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
