"""The check's control and planted faults on the card, at a cell's own size.

    python -m zkbench.control --workload <cell> --seeds <n> [<n> ...] [--proofs K]

For each seed: the cell's set-up (its pools, traced by the port), then
short windows at the cell's own load, each client making ``K`` proofs
(default 2), one window each with the port as it is (``sound``), with the
control and with each planted fault of :mod:`zkbench.faults`, each judged
by :func:`zkbench.check.check` as a benchmark run judges its window.  One
JSON line a window: the seed, the variant, ``correct`` and the numbers
compared.  The readings of ``sound`` are the lower ones of the limits,
those of the control and the faults the upper ones (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from zkbench import check as ck
from zkbench import faults
from zkbench import run as rn
from zkbench import traffic as tf


def readings(config: dict, traffic: dict, seed: int, device, proofs: int, variants) -> list:
    from zkvm_torch.prover.pipeline import prove as port_prove

    out = []
    pools_in, pools, _ = rn.build_pools(config, traffic, seed, device)
    rn.warm_up(pools, rn.make_prover(config, device), False)
    for name in variants:
        prove = port_prove if name == "sound" else faults.VARIANTS[name](port_prove)
        t0 = time.perf_counter()
        clients, *_ = rn.run_clients(pools, rn.make_prover(config, device, prove), 0.0, False, limit=proofs)
        records = [r for cl in clients for r in cl.records]
        got = {}
        for cl in clients:
            got.update(cl.proofs)
        failed = sum(cl.attempted for cl in clients) - len(records)
        correct, numbers, reasons = ck.check(config, pools_in, records, got, failed, device)
        out.append({"seed": seed, "variant": name, "correct": correct, "numbers": numbers,
                    "reasons": reasons[:3], "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zkbench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--proofs", type=int, default=2)
    ap.add_argument("--variants", nargs="+", default=["sound", *faults.VARIANTS])
    args = ap.parse_args(argv)
    workload, _, _ = rn.benchmark_entry(args.workload)
    rn.cache_env(rn.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("zkbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    config = tf.load_json("configs", workload["config"])
    traffic = tf.load_json("traffic", workload["traffic"])
    for seed in args.seeds:
        for line in readings(config, traffic, seed, device, args.proofs, args.variants):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
