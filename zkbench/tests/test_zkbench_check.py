"""A run of the harness on the CPU at a small size, the card's look
skipped: a sound run comes out correct, the control and each planted fault
(:mod:`zkbench.faults`) underneath the timed path come out not correct."""

import json
import time

import pytest
import torch

from zkbench import faults
from zkbench import run as rn
from zkbench import traffic as tf

# the cells' programs cut to T = 128 rows, the test's size
SMALL = {
    "read_add": dict(tf.load_json("configs", "read_add_2p16"), name="read_add_small", trace_length=128,
                     program={"head": ["read"], "body": ["read", "add"], "tail": [], "terms": 10}),
    "lr": dict(tf.load_json("configs", "lr_enc_2p20"), name="lr_small", trace_length=128,
               program={"head": ["read2", "read", "smul"], "body": ["read2", "read", "smul", "add2"],
                        "tail": ["read", "sadd"], "terms": 5}),
}
SERIAL = {"name": "serial", "loop": "closed", "clients": 1, "pool": 2}
CPU = torch.device("cpu")


def _run(config, traced=False, prove=None, seconds=0.5):
    return rn.run_cell(config, SERIAL, 2**31 + 1234, seconds, traced, CPU, time.perf_counter(), prove=prove)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct_and_its_line_has_the_result_keys(name):
    out = _run(SMALL[name], traced=True)
    assert out["correct"], out["reasons"]
    assert out["numbers"] == {"proofs": out["attempted"], "rejected_proofs": 0, "trace_root_mismatches": 0,
                              "extra_proofs_per_trace": 0, "failed_proofs": 0}
    bench = json.load(open(rn.ROOT / "BENCHMARK.json"))
    metrics = rn.read_metrics(bench["per_layer"], out["ctx"])
    assert {"trace_gen_s", "trace_commit_s"} <= set(metrics)
    line = rn.result_line(out, metrics, traced=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "proof_latency_s", "check"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s", "memory_peak_bytes", "platform", "kind", "count"} <= set(line["device"])
    assert line["check"]["rejected_proofs"] == {"value": 0, "limit": 0}
    json.dumps(line)
    e2e = rn.read_metrics(bench["end_to_end"], out["ctx"])
    assert e2e["proof_s"]["value"] > 0 and e2e["setup_s"]["value"] > 0


@pytest.mark.parametrize("variant", sorted(faults.VARIANTS))
def test_the_control_and_each_fault_come_out_not_correct(variant):
    from zkvm_torch.prover.pipeline import prove

    out = _run(SMALL["read_add"], prove=faults.VARIANTS[variant](prove))
    assert not out["correct"]
    caught = "trace_root_mismatches" if variant == "lde_rows" else "rejected_proofs"
    assert out["numbers"][caught] >= 1


@pytest.mark.chip
@pytest.mark.parametrize("variant", ["sound", *sorted(faults.VARIANTS)])
def test_on_the_card_a_small_run_is_judged_as_on_the_cpu(card, variant):
    from zkvm_torch.prover.pipeline import prove

    out = rn.run_cell(SMALL["lr"], SERIAL, 2**31 + 99, 0.5, variant == "sound", card, time.perf_counter(),
                      prove=None if variant == "sound" else faults.VARIANTS[variant](prove))
    assert out["correct"] == (variant == "sound"), out["reasons"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(card)
