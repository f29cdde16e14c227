#!/usr/bin/env python3
"""Smoke run of the zkvm_torch prover on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) device: the card (nvidia-smi name and power limit), torch and CUDA;
  (b) build: nvcc builds the kernels of zkvm_torch/csrc for sm_90a;
  (c) kernels: K1 (NTT stage network), K2 (BLAKE3 rows) and K3
      (composition) against their plain PyTorch versions on the card, at
      the main path's shapes, on random limbs from a numpy seed; exact
      equality is required; kernel and plain times by CUDA events;
  (d) conformance: the T = 128 program of conformance/vectors_e2e.json,
      whose roots and proof bytes must match the vector byte for byte;
  (e) the bench's primary configuration: a READ/ADD chain of 20000 ops
      (T = 2^16, D = 2^19), proved once to warm up and once timed, with
      per-stage seconds; every kernel must have launched in the timed
      prove; the proof must verify and fail with one byte flipped.

Then a {"kernels": [...]} line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkvm_torch import kernels, vm  # noqa: E402
from zkvm_torch.air import composition as cp  # noqa: E402
from zkvm_torch.air.periodic import periodic_class_patterns  # noqa: E402
from zkvm_torch.field.limbs import from_numpy, to_limbs  # noqa: E402
from zkvm_torch.hash import blake3_t as b3t  # noqa: E402
from zkvm_torch.ntt import ntt_t as nt  # noqa: E402
from zkvm_torch.prover import prove  # noqa: E402
from zkvm_torch.verifier import VerificationError  # noqa: E402

DEV = torch.device("cuda", 0)


def emit(obj):
    print(json.dumps(obj), flush=True)


def rand_limbs(rng, shape):
    """Random canonical elements as (..., 8, L) int32 limbs on the card."""
    n = int(np.prod(shape)) // 8
    hi = rng.integers(0, 2**63, size=n, dtype=np.int64).astype(object)
    lo = rng.integers(0, 2**63, size=n, dtype=np.int64).astype(object)
    limbs = to_limbs((hi << 64) | lo).reshape(shape[:-2] + (shape[-1], 8))
    return from_numpy(np.ascontiguousarray(np.swapaxes(limbs, -1, -2)), DEV)


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item())


def compare(name, kernel_fn, plain_fn, reps=20, plain_reps=2):
    """Kernel vs plain on the card: exact equality, and both times."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)
    emit({"phase": "kernels", "case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return err, ms, plain_ms


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    t0 = time.perf_counter()
    kernels.lib()
    regs = [line.strip() for line in kernels.build_log.splitlines() if "registers" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": kernels.build_seconds,
          "library": kernels.library_path().name, "ptxas": regs})


def phase_kernels():
    rng = np.random.default_rng(20261016)
    results = {}
    # K1 at the main path's axes: M = 8 (FRI fold, D/8 lanes), 256 (both
    # passes of every T = 2^16 transform, 28 columns), 512 (pass 2 of the
    # size-2^19 composition iNTT)
    k1 = []
    for m, b, nl in [(8, 1, 1 << 16), (256, 28, 256), (512, 1, 1024)]:
        tw = from_numpy(nt._stage_twiddles(m, False), DEV)
        y = rand_limbs(rng, (b, m, 8, nl))
        for variant in ("plain", "full", "r1"):
            pre = rand_limbs(rng, (m, 8, nl)) if variant == "full" else None
            r1 = (rand_limbs(rng, (8, m)), rand_limbs(rng, (8, nl))) if variant == "r1" else None
            k1.append(compare(
                f"K1 M={m} B={b} NL={nl} {variant}",
                lambda: nt.pease_stages(y, tw, pre=pre, r1=r1),
                lambda: nt.pease_stages_plain(nt._apply_pre(y, pre, r1), tw),
            ))
    results["ntt_stages"] = (max(e for e, _, _ in k1), k1[5][1], k1[5][2])  # M=256 r1
    # K2: trace rows (C = 28) and composition / FRI rows (C = 8), N = 2^16
    k2 = []
    for c in (28, 8):
        x = rand_limbs(rng, (c, 8, 1 << 16))
        k2.append(compare(f"K2 C={c} N=65536", lambda: b3t.hash_rows_t(x), lambda: b3t.hash_rows_plain(x)))
    results["blake3_rows"] = (max(e for e, _, _ in k2), k2[0][1], k2[0][2])
    # K3: one class at T = 2^16 with the real boundary columns
    t = 1 << 16
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    assertions = vm.get_assertions(vm.PublicInputs((1, 2), tuple(range(16)), key), t)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)
    mask, ark = periodic_class_patterns(t, 8)
    args = [
        rand_limbs(rng, (28, 8, t)),
        from_numpy(np.ascontiguousarray(mask[3].T), DEV),
        from_numpy(np.ascontiguousarray(np.swapaxes(ark[3], -1, -2)), DEV),
        rand_limbs(rng, (8, t)), rand_limbs(rng, (8, t)), rand_limbs(rng, (8, t)),
        rand_limbs(rng, (8, 20)).T.contiguous(),
        rand_limbs(rng, (8, len(bcols0))).T.contiguous(), rand_limbs(rng, (8, len(bcols0))).T.contiguous(),
        rand_limbs(rng, (8, len(bcols1))).T.contiguous(), rand_limbs(rng, (8, len(bcols1))).T.contiguous(),
    ]
    delta = key.parameters.delta
    results["composition"] = compare(
        "K3 T=65536",
        lambda: cp.composition_t(*args, delta, bcols0, bcols1),
        lambda: cp.composition_plain(*args, delta, bcols0, bcols1),
        plain_reps=1,
    )
    return results


def phase_conformance():
    vec = json.loads((Path(__file__).resolve().parent / "conformance" / "vectors_e2e.json").read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    t0 = time.perf_counter()
    _, _, proof = vm.prove(program, inputs, device=DEV)
    data = proof.to_wire_bytes()
    checks = {
        "trace_root": proof.trace_root.hex() == vec["trace_root_hex"],
        "comp_root": proof.comp_root.hex() == vec["comp_root_hex"],
        "proof_bytes": data.hex() == vec["proof_bytes_hex"],
    }
    emit({"phase": "conformance", "trace_length": proof.trace_length, "seconds": time.perf_counter() - t0,
          "proof_bytes": len(data), **checks})
    if not all(checks.values()):
        raise AssertionError(f"conformance proof differs from the vector: {checks}")


def phase_bench():
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.read_add_chain(vm.BENCH_N_OPS, key)
    t0 = time.perf_counter()
    trace = vm.run(program, inputs)
    trace_seconds = time.perf_counter() - t0
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    t0 = time.perf_counter()
    prove(trace, pub, device=DEV)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    nt.launches = b3t.launches = cp.launches = 0
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prove(trace, pub, device=DEV, stage_seconds=stages)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {"ntt_stages": nt.launches, "blake3_rows": b3t.launches, "composition": cp.launches}

    data = proof.to_wire_bytes()
    vm.verify_bytes(data, program.hash, trace.outputs, key)
    tampered = bytearray(data)
    tampered[len(data) // 2] ^= 0x01
    try:
        vm.verify_bytes(bytes(tampered), program.hash, trace.outputs, key)
        rejected = False
    except VerificationError:
        rejected = True
    emit({"phase": "bench", "config": "READ/ADD chain", "n_ops": vm.BENCH_N_OPS, "trace_length": trace.length,
          "lde_domain": trace.length * 8, "trace_gen_seconds": trace_seconds, "warmup_prove_seconds": warm,
          "prove_seconds": steady, "rows_per_sec": trace.length / steady, "stage_seconds": stages,
          "proof_bytes": len(data), "verified": True, "tampered_rejected": rejected,
          "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not rejected:
        raise AssertionError("the verifier accepted a tampered proof")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


SOURCES = {
    "ntt_stages": ("zkvm_torch/csrc/ntt_stages.cu", "zkvm/ntt/ntt_t.py:320"),
    "blake3_rows": ("zkvm_torch/csrc/blake3_rows.cu", "zkvm/hash/blake3_t.py:115"),
    "composition": ("zkvm_torch/csrc/composition.cu", "zkvm/air/constraints_pallas.py:230"),
}


def main():
    phase_device()
    phase_build()
    results = phase_kernels()
    phase_conformance()
    launches = phase_bench()
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2]}
        for name in SOURCES
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
