"""The large-trace linear regression over LWE-encrypted inputs (BASELINE.md
configuration 5), proved in T-mode (or the class prover, or mono) and
verified by the port.

    python -m zkvm_torch.examples.prove_lr_large [log2_rows] [--device cpu] [--mode {tmode,mono,cls}]

Port of ``scripts/prove_lr_large.py``: the same program (the
``lr.txt`` block repeated, an n-term dot product of encrypted features with
public weights plus a bias), sized so that the trace has exactly
2^log2_rows rows (default 20), with the same key, weights and features
seeds.  Its steps: encrypt the features, compile, trace with the native
C++ generator (:mod:`zkvm_torch.runtime`; it fails if g++ cannot build it),
prove on the card once cold (the per-T constants built) and once steady
in the layout ``--mode`` names (all three reach log2_rows = 20 and give
the same bytes; mono keeps the whole (28, 8, 2^23) LDE on the card),
decrypt the prediction and hold it against the clear one, verify with the
port's verifier, and expect a one-byte tamper to be rejected.

Each phase prints one JSON line with its seconds and the card's name and
power limit (``nvidia-smi``); the proves add their per-stage seconds and
peak device memory, and rows/s.  With ``ZKVM_PROFILE=1``
(``config.from_env()``) the profiler records the proves' spans and prints
their tree at the end (:mod:`zkvm_torch.utils.profiler`); with
``ZKVM_PROFILE_DIR=DIR`` too, a ``torch.profiler`` trace of the run, its
``zkvm.*`` spans on the clock of the device's activity, is written to
``DIR/zkvm_trace_<pid>.json``.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import torch

from zkvm_torch import vm
from zkvm_torch.air.layout import PublicInputs
from zkvm_torch.config import from_env
from zkvm_torch.fhe import FheUInt8, LweParameters, ServerKey
from zkvm_torch.isa import Program, ProgramInputs
from zkvm_torch.prover import limits
from zkvm_torch.prover.pipeline import prove as stark_prove
from zkvm_torch.runtime import NativeProcessor, native_available
from zkvm_torch.utils.profiler import profiler
from zkvm_torch.verifier import VerificationError


def build_program(n_terms: int) -> str:
    """Dot product of n_terms encrypted features with public weights."""
    ops = ["read2", "read", "smul"]
    for _ in range(n_terms - 1):
        ops += ["read2", "read", "smul", "add2"]
    ops += ["read", "sadd"]
    return "\n".join(ops)


def n_terms_for(log2_rows: int) -> int:
    """Terms of the program whose trace has 2^log2_rows rows: the chiplet
    capacity starts at 16 and doubles when clk reaches it, and the trace
    length is next_pow2(capacity + 1), so the padded program (16/14 NOOP
    cycle overhead) must fit in (2^(k-2), 2^(k-1)] clock steps; 4 ops a
    term, with a small margin below the edge."""
    max_ops = 7 * 2 ** (log2_rows - 1) // 8
    return (max_ops - 1) // 4 - 8


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for
    a CPU run)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class LrRun:
    """One large-trace run: its inputs, trace and expected prediction."""

    def __init__(self, log2_rows: int):
        self.log2_rows = log2_rows
        self.n_terms = n_terms_for(log2_rows)
        params = LweParameters(8, 128, 4, 2.412390240121573e-5)
        self.key = ServerKey(params, random.Random(2026))
        rng = random.Random(7)
        self.weights = [rng.randrange(8) for _ in range(self.n_terms)]
        self.bias = rng.randrange(8)
        self.features = [rng.randrange(2) for _ in range(self.n_terms)]
        # decrypt rounds by delta, then truncates to a byte (server_key.rs:64-76)
        self.expected = (self.bias + sum(w * x for w, x in zip(self.weights, self.features))) & 0xFF
        self.seconds = {}

    def prepare(self):
        """Encrypt, compile and trace; returns the trace."""
        t0 = time.perf_counter()
        cts = tuple(self.key.encrypt(x) for x in self.features)
        self.seconds["encrypt"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.program = Program.compile(build_program(self.n_terms))
        self.seconds["compile"] = time.perf_counter() - t0
        if not native_available():
            raise RuntimeError("prove_lr_large: the native trace generator did not build (g++); "
                               "the golden Python processor would take minutes at this size")
        inputs = ProgramInputs(tuple(self.weights) + (self.bias,), cts, self.key)
        t0 = time.perf_counter()
        self.trace = NativeProcessor.run(self.program, inputs, seed=vm.DEFAULT_SEED)
        self.seconds["trace_gen"] = time.perf_counter() - t0
        if self.trace.length != 2**self.log2_rows:
            raise AssertionError(f"trace of {self.trace.length} rows, expected 2^{self.log2_rows}")
        self.pub = PublicInputs(self.program.hash, self.trace.outputs, self.key)
        return self.trace

    def prove(self, device, mode="tmode"):
        """One timed prove in ``mode`` (``pipeline.prove``'s): (proof,
        seconds, stage seconds, stage peak bytes, peak bytes or None on the
        CPU)."""
        stages, peaks = {}, {}
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = stark_prove(self.trace, self.pub, device=device, stage_seconds=stages, stage_peaks=peaks,
                            mode=mode)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return proof, seconds, stages, peaks, (max(peaks.values()) if peaks else None)

    def check(self, proof):
        """Decrypt the prediction, verify with the port's verifier and reject
        a one-byte tamper; returns (decrypted, verify seconds, rejected)."""
        clear = self.key.decrypt(FheUInt8(list(self.trace.outputs[:5])))
        if clear != self.expected:
            raise AssertionError(f"decrypted prediction {clear}, expected {self.expected}")
        data = proof.to_wire_bytes()
        t0 = time.perf_counter()
        vm.verify_bytes(data, self.program.hash, self.trace.outputs, self.key)
        verify_seconds = time.perf_counter() - t0
        bad = bytearray(data)
        bad[len(data) // 2] ^= 0x01
        try:
            vm.verify_bytes(bytes(bad), self.program.hash, self.trace.outputs, self.key)
        except VerificationError:
            return clear, verify_seconds, True
        raise AssertionError("the verifier accepted a tampered proof")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2_rows", type=int, nargs="?", default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="tmode", choices=["tmode", "mono", "cls"], help="the prover's layout")
    args = ap.parse_args(argv)
    card = card_name(args.device)
    print(card, flush=True)
    emit = lambda obj: print(json.dumps({**obj, "card": card}), flush=True)
    profiled = from_env().runtime.profile
    if profiled:
        profiler.enable()

    run = LrRun(args.log2_rows)
    run.prepare()
    emit({"phase": "inputs", "n_terms": run.n_terms, "ops": len(run.program.code),
          "trace_length": run.trace.length, "lde_domain": 8 * run.trace.length,
          "chunk_t": limits.CHUNK_T, "mode": args.mode,
          **{f"{k}_seconds": v for k, v in run.seconds.items()}})
    for name in ("cold", "steady"):
        proof, seconds, stages, peaks, peak = run.prove(args.device, args.mode)
        emit({"phase": f"{name}_prove", "seconds": seconds, "rows_per_sec": run.trace.length / seconds,
              "stage_seconds": stages, "stage_peak_gib": {k: v / 2**30 for k, v in peaks.items()},
              "peak_gib": None if peak is None else peak / 2**30})
    clear, verify_seconds, rejected = run.check(proof)
    emit({"phase": "verify", "verify_seconds": verify_seconds, "decrypted": clear, "expected": run.expected,
          "tampered_rejected": rejected, "proof_bytes": len(proof.to_wire_bytes())})
    if profiled:
        profiler.report()
        profiler.disable()


if __name__ == "__main__":
    sys.exit(main())
