#!/usr/bin/env python3
"""Smoke run of the zkvm_torch prover on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) device: the card (nvidia-smi name and power limit), torch and CUDA;
  (b) build: nvcc builds the kernels of zkvm_torch/csrc for sm_90a;
  (c) kernels: K1 (NTT stage network), K2 (BLAKE3 rows), K3 (composition)
      and K4 (merged transition) against their plain PyTorch versions on
      the card, at the main paths' shapes, on random limbs from a numpy
      seed; exact equality is required; kernel and plain times by CUDA
      events, and each case's bound (see bound_ms);
  (d) conformance: the T = 128 program of conformance/vectors_e2e.json,
      proved in both modes, whose roots and proof bytes must match the
      vector byte for byte;
  (e) the bench's primary configuration: a READ/ADD chain of 20000 ops
      (T = 2^16, D = 2^19), proved in T-mode once to warm up and once
      timed, with per-stage seconds; K1, K2 and K3 must have launched in
      the timed prove; the proof must verify and fail with one byte flipped;
  (f) the same chain in mono (full-LDE) mode: warm-up, timed prove, verify
      and tamper check; K1, K2 and K4 must have launched in the timed
      prove; with the peak device memory and the time of the DEEP stage's
      batch inverse.

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
from zkvm_torch.air import transition as tr  # noqa: E402
from zkvm_torch.air.periodic import periodic_class_patterns, periodic_table  # noqa: E402
from zkvm_torch.field import f128t as ft  # noqa: E402
from zkvm_torch.field.limbs import from_numpy  # noqa: E402
from zkvm_torch.hash import blake3_t as b3t  # noqa: E402
from zkvm_torch.ntt import ntt_t as nt  # noqa: E402
from zkvm_torch.prover import prove  # noqa: E402
from zkvm_torch.verifier import VerificationError  # noqa: E402

DEV = torch.device("cuda", 0)

# The least time one H100 SXM could take (NVIDIA's data sheet): 3.35 TB/s of
# HBM3, and 32-bit integer work at 132 SMs x 64 INT32 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations per f128 operation, a lower count: an add or sub is four
# 32-bit adds with carries and the four of its correction by eps; a multiply
# is the 16 32x32-bit partial products of the 256-bit product (low and high
# halves, 32), their carried sum (32), and the eps folds to a canonical
# value (32).
OPS_ADD, OPS_MUL = 8, 96
LIMB_BYTES = 32  # one element: 8 limbs of 16 bits in 32-bit words
# f128 operations per row of the merged transition (csrc/transition.cuh),
# and those K3 adds for the domain factor and its 12 + 10 boundary terms
K4_MULS, K4_ADDS = 138, 118
K3_MULS, K3_ADDS = K4_MULS + 1 + 22 + 2, K4_ADDS + 2 * 22 + 2
# BLAKE3: 7 rounds x 8 G functions x 14 ops (6 adds, 4 xors, 4 rotates) and
# 16 output xors per 64-byte block; 2 ops to pack two limbs into a word
BLAKE3_BLOCK_OPS = 7 * 8 * 14 + 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def rand_limbs(rng, shape):
    """Random canonical elements as (..., 8, L) int32 limbs on the card: 16
    random bits per limb, the top limb below 0xFFFF (so below p)."""
    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    limbs[..., 7, :] %= 0xFFFF
    return from_numpy(limbs, DEV)


def bound_ms(nbytes, ops):
    """The larger of the memory and the integer-operation time, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def compare(name, kernel_fn, plain_fn, nbytes, ops, reps=20, plain_reps=2):
    """Kernel vs plain on the card: exact equality, both times and the
    bound of the work (``nbytes`` moved, ``ops`` 32-bit operations)."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    del got, want
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)
    bound, bound_by = bound_ms(nbytes, ops)
    emit({"phase": "kernels", "case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": bound_by})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


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
    regs = [line.strip() for line in kernels.build_log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": kernels.build_seconds,
          "library": kernels.library_path().name, "ptxas": regs})


def _k1_work(b, m, nl, variant):
    """Bytes and operations of one stage-network call on (B, M, 8, NL)."""
    elems = b * m * nl
    nbytes = 2 * elems * LIMB_BYTES + (m.bit_length() - 1) * (m // 2) * LIMB_BYTES
    ops = (elems // 2) * (m.bit_length() - 1) * (OPS_MUL + 2 * OPS_ADD)  # butterflies
    if variant == "full":
        nbytes += m * nl * LIMB_BYTES
        ops += elems * OPS_MUL
    elif variant == "r1":
        nbytes += (m + nl) * LIMB_BYTES
        ops += 2 * elems * OPS_MUL
    return nbytes, ops


def _transition_args(rng, n, mask, ark, n_alphas=20):
    return [rand_limbs(rng, (28, 8, n)), mask, ark, rand_limbs(rng, (8, n_alphas)).T.contiguous()]


def phase_kernels():
    rng = np.random.default_rng(20261016)
    results = {}
    # K1 at the main paths' axes: M = 8 (FRI fold, D/8 lanes), 256 (both
    # passes of every T = 2^16 transform, 28 columns), 512 (pass 2 of the
    # size-2^19 transforms: the composition iNTT, and the mono coset LDE of
    # the 28 trace columns), 32 (both passes of that LDE's size-1024 pass 1,
    # over 28 x 512 rows)
    k1 = []
    all3 = ("plain", "full", "r1")
    for m, b, nl, variants in [(8, 1, 1 << 16, all3), (256, 28, 256, all3), (512, 1, 1024, all3),
                               (512, 28, 1024, ("full",)), (32, 28 * 512, 32, ("plain", "full"))]:
        tw = from_numpy(nt._stage_twiddles(m, False), DEV)
        y = rand_limbs(rng, (b, m, 8, nl))
        for variant in variants:
            pre = rand_limbs(rng, (m, 8, nl)) if variant == "full" else None
            r1 = (rand_limbs(rng, (8, m)), rand_limbs(rng, (8, nl))) if variant == "r1" else None
            k1.append(compare(
                f"K1 M={m} B={b} NL={nl} {variant}",
                lambda: nt.pease_stages(y, tw, pre=pre, r1=r1),
                lambda: nt.pease_stages_plain(nt._apply_pre(y, pre, r1), tw),
                *_k1_work(b, m, nl, variant), plain_reps=1,
            ))
    results["ntt_stages"] = dict(k1[5], max_abs_err=max(r["max_abs_err"] for r in k1))  # M=256 r1
    # K2: trace rows (C = 28) and composition / FRI rows (C = 8), N = 2^16
    # per class in T-mode, N = 2^19 over the whole domain in mono
    k2 = []
    for c, n in [(28, 1 << 16), (8, 1 << 16), (28, 1 << 19), (8, 1 << 19)]:
        x = rand_limbs(rng, (c, 8, n))
        work = ((c + 1) * LIMB_BYTES * n, (-(-c // 4) * BLAKE3_BLOCK_OPS + 8 * c) * n)
        k2.append(compare(f"K2 C={c} N={n}", lambda: b3t.hash_rows_t(x), lambda: b3t.hash_rows_plain(x),
                          *work, plain_reps=1))
    results["blake3_rows"] = dict(k2[0], max_abs_err=max(r["max_abs_err"] for r in k2))
    # K3: one class at T = 2^16 with the real boundary columns
    t = 1 << 16
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    assertions = vm.get_assertions(vm.PublicInputs((1, 2), tuple(range(16)), key), t)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)
    mask, ark = periodic_class_patterns(t, 8)
    mask_cls = from_numpy(np.ascontiguousarray(mask[3].T), DEV)
    ark_cls = from_numpy(np.ascontiguousarray(np.swapaxes(ark[3], -1, -2)), DEV)
    args = [
        rand_limbs(rng, (28, 8, t)), mask_cls, ark_cls,
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
        t * (28 + 4) * LIMB_BYTES, t * (K3_MULS * OPS_MUL + K3_ADDS * OPS_ADD), plain_reps=1,
    )
    del args
    # K4: the mono shape (the full domain D = 2^19, next row +8, tables of
    # period 128) and one class (T = 2^16, next row +1, 16-step patterns)
    tab = from_numpy(periodic_table(t, 8), DEV)
    k4 = {}
    for name, n, step, mk, ak in [("mono", 8 * t, 8, tab[0], tab[1:].contiguous()),
                                  ("class", t, 1, mask_cls, ark_cls)]:
        a = _transition_args(rng, n, mk, ak)
        k4[name] = compare(
            f"K4 {name} N={n} step={step}",
            lambda: tr.merged_transition(*a, delta, step),
            lambda: tr.merged_transition_plain(*a, delta, step),
            n * 29 * LIMB_BYTES, n * (K4_MULS * OPS_MUL + K4_ADDS * OPS_ADD), plain_reps=1,
        )
        del a
    results["transition"] = dict(k4["mono"], max_abs_err=max(r["max_abs_err"] for r in k4.values()))
    torch.cuda.empty_cache()
    return results


def phase_conformance():
    vec = json.loads((Path(__file__).resolve().parent / "conformance" / "vectors_e2e.json").read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    for mode in ("tmode", "mono"):
        t0 = time.perf_counter()
        _, _, proof = vm.prove(program, inputs, device=DEV, mode=mode)
        data = proof.to_wire_bytes()
        checks = {
            "trace_root": proof.trace_root.hex() == vec["trace_root_hex"],
            "comp_root": proof.comp_root.hex() == vec["comp_root_hex"],
            "proof_bytes": data.hex() == vec["proof_bytes_hex"],
        }
        emit({"phase": "conformance", "mode": mode, "trace_length": proof.trace_length,
              "seconds": time.perf_counter() - t0, "proof_bytes": len(data), **checks})
        if not all(checks.values()):
            raise AssertionError(f"{mode} conformance proof differs from the vector: {checks}")


COUNTERS = {"ntt_stages": nt, "blake3_rows": b3t, "composition": cp, "transition": tr}
PATH_KERNELS = {"tmode": ("ntt_stages", "blake3_rows", "composition"),
                "mono": ("ntt_stages", "blake3_rows", "transition")}


def phase_bench(mode):
    """Prove the bench's READ/ADD chain in ``mode``: warm-up, then one
    timed prove with every launch count set to 0 just before it and read
    just after; verify, and reject a one-byte tamper."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.read_add_chain(vm.BENCH_N_OPS, key)
    t0 = time.perf_counter()
    trace = vm.run(program, inputs)
    trace_seconds = time.perf_counter() - t0
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    t0 = time.perf_counter()
    prove(trace, pub, device=DEV, mode=mode)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    for mod in COUNTERS.values():
        mod.launches = 0
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prove(trace, pub, device=DEV, stage_seconds=stages, mode=mode)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()

    data = proof.to_wire_bytes()
    vm.verify_bytes(data, program.hash, trace.outputs, key)
    tampered = bytearray(data)
    tampered[len(data) // 2] ^= 0x01
    try:
        vm.verify_bytes(bytes(tampered), program.hash, trace.outputs, key)
        rejected = False
    except VerificationError:
        rejected = True
    extra = {}
    if mode == "mono":
        # the DEEP stage's one batch inverse, (3, 8, D), timed alone
        den = rand_limbs(np.random.default_rng(5), (3, 8, trace.length * 8))
        inv_s = cuda_ms(lambda: ft.batch_inverse(den), 2) / 1e3
        extra = {"batch_inverse_seconds": inv_s, "batch_inverse_share": inv_s / steady}
    emit({"phase": "bench", "mode": mode, "config": "READ/ADD chain", "n_ops": vm.BENCH_N_OPS,
          "trace_length": trace.length, "lde_domain": trace.length * 8, "trace_gen_seconds": trace_seconds,
          "warmup_prove_seconds": warm, "prove_seconds": steady, "rows_per_sec": trace.length / steady,
          "stage_seconds": stages, "proof_bytes": len(data), "verified": True, "tampered_rejected": rejected,
          "launches": launches, "peak_mem_gib": peak / 2**30, **extra})
    if not rejected:
        raise AssertionError(f"{mode}: the verifier accepted a tampered proof")
    for name in PATH_KERNELS[mode]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {mode} path")
    return launches


SOURCES = {
    "ntt_stages": ("zkvm_torch/csrc/ntt_stages.cu", "zkvm/ntt/ntt_t.py:320"),
    "blake3_rows": ("zkvm_torch/csrc/blake3_rows.cu", "zkvm/hash/blake3_t.py:115"),
    "composition": ("zkvm_torch/csrc/composition.cu", "zkvm/air/constraints_pallas.py:230"),
    "transition": ("zkvm_torch/csrc/transition.cu", "zkvm/air/constraints_pallas.py:378"),
}


def main():
    phase_device()
    phase_build()
    results = phase_kernels()
    phase_conformance()
    by_path = {mode: phase_bench(mode) for mode in ("tmode", "mono")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {mode: n[name] for mode, n in by_path.items()},
         **{k: results[name][k] for k in keys}, "library_ms": None}
        for name in SOURCES
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
