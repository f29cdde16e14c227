#!/usr/bin/env python3
"""Smoke run of the zkvm_torch prover on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) device: the card (nvidia-smi name and power limit), torch and CUDA;
  (b) build: nvcc builds the kernels of zkvm_torch/csrc for sm_90a; each
      kernel's registers and spills as ptxas reports them; the SASS
      instructions of the f128 multiply zk::mul32, counted from its probe
      kernel by cuobjdump, and the opcodes of K2 and the Merkle kernels
      (each BLAKE3 rotation one PRMT or SHF);
  (c) kernels: K1 (NTT stage network, natural row order in and out), K2
      (BLAKE3 rows), the Merkle heap, K3 (composition) and K4 (merged
      transition) against their plain PyTorch versions on the card, at the
      main paths' shapes,
      on random limbs from a numpy seed with the field's edge values mixed
      in; exact equality is required; kernel and plain times by CUDA
      events (kernel_bench.cuda_ms: the card's time, and the host's time
      to queue one call), and each case's bound (see bound_ms); K3 and K4
      are timed at their C entry (the kernel alone, its arguments built
      beforehand) and at their wrapper, and one wrapper call of each (and
      of the Merkle heap) runs under torch.cuda.set_sync_debug_mode("error"),
      so a wrapper that waits for the stream fails the run; and zk::mul32
      alone against the plain multiply on every pair of edge values;
  (d) conformance: the T = 128 program of conformance/vectors_e2e.json,
      proved in both modes, whose roots and proof bytes must match the
      vector byte for byte;
  (e) the bench's primary configuration: a READ/ADD chain of 20000 ops
      (T = 2^16, D = 2^19), proved in T-mode once to warm up and once
      timed, with per-stage seconds; K1, K2 and K3 must have launched in
      the timed prove (K1's launches also by shape), and the Merkle heap;
      the proof must verify and fail with one byte flipped;
  (f) the same chain in mono (full-LDE) mode: warm-up, timed prove, verify
      and tamper check; K1, K2, K4 and the Merkle heap must have launched
      in the timed prove; with the peak device memory and the time of the
      DEEP stage's batch inverse; the proofs of (e) and (f) must be equal
      byte for byte.

Then a {"kernels": [...]} line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_bench import (K1_CASES, K2_CASES, MERKLE_CASES, air_calls, air_cases,  # noqa: E402
                          capture_entry, cuda_ms, ptxas_summary, sass_opcodes)
from zkvm_torch import kernels, vm  # noqa: E402
from zkvm_torch.air import composition as cp  # noqa: E402
from zkvm_torch.air import transition as tr  # noqa: E402
from zkvm_torch.field import f128  # noqa: E402
from zkvm_torch.field import f128t as ft  # noqa: E402
from zkvm_torch.field.limbs import from_numpy  # noqa: E402
from zkvm_torch.hash import blake3_t as b3t  # noqa: E402
from zkvm_torch.hash import merkle as mk  # noqa: E402
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
PACKED_BYTES = 16  # one element as four 32-bit words (K1's constants)
# f128 operations per row of the merged transition (csrc/transition.cuh,
# counted in its host emulation: 106 multiplies, 106 adds or subtracts),
# and those K3 adds: the domain factor and the two group factors, the
# groups' constants; one multiply and one add per distinct boundary column
K4_MULS, K4_ADDS = 106, 106
K3_MULS, K3_ADDS = K4_MULS + 3, K4_ADDS + 4
# BLAKE3: 7 rounds x 8 G functions x 12 ops (a + b + m is one three-input
# add, twice; c + d twice; 4 xors; 4 rotates of one instruction each) and 8
# output xors per 64-byte block; 4 ops to pack an element's 8 limbs into
# its 4 words (one byte permute a word)
BLAKE3_BLOCK_OPS = 7 * 8 * 12 + 8
BLAKE3_PACK_OPS = 4
# Merkle heap of N leaves: N - 1 compresses; 32 bytes a leaf read, the
# 2N rows of 32 bytes written
MERKLE_BYTES_PER_LEAF = 3 * 32


def emit(obj):
    print(json.dumps(obj), flush=True)


EDGES = (0, 1, f128.P - 1, ft.EPS, 2**127)


EDGE_LIMBS = np.array([[(v >> (16 * k)) & 0xFFFF for k in range(8)] for v in EDGES], dtype=np.uint32)


def rand_limbs(rng, shape, pair=0, spread=False):
    """Random canonical elements as (..., 8, L) int32 limbs on the card: 16
    random bits per limb, the top limb below 0xFFFF (so below p).  Lanes
    j < 25 of the first row hold the edge values EDGES[j % 5] (pair 0) or
    EDGES[j // 5] (pair 1), so a product of a pair-0 and a pair-1 input
    meets every pair of edge values.  With ``spread``, every row instead
    holds edge values at every s-th lane, s = min(61, L // 5): lane s k of
    row r holds EDGES[(k + r) % 5], so every trace column and every
    vector of alphas or boundary values meets each edge value."""
    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    limbs[..., 7, :] %= 0xFFFF
    rows = limbs.reshape(-1, 8, shape[-1])
    if spread:
        lanes = np.arange(0, shape[-1], min(61, max(1, shape[-1] // 5)))
        for r, row in enumerate(rows):
            row[:, lanes] = EDGE_LIMBS[(np.arange(len(lanes)) + r) % 5].T
    else:
        for j in range(min(25, shape[-1])):
            rows[0][:, j] = EDGE_LIMBS[j % 5 if pair == 0 else j // 5]
    return from_numpy(limbs, DEV)


def bound_ms(nbytes, ops):
    """The larger of the memory and the integer-operation time, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item())


def compare(name, kernel_fn, plain_fn, nbytes, ops, reps=20, plain_reps=2, entry_fn=None):
    """Kernel vs plain on the card: exact equality, both times and the
    bound of the work (``nbytes`` moved, ``ops`` 32-bit operations).  With
    ``entry_fn`` (the C entry alone), ``ms`` is its time and the wrapper's
    is ``wrapper_ms``."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    del got, want
    ms, host_ms = cuda_ms(kernel_fn, reps)
    extra = {}
    if entry_fn is not None:
        extra = {"wrapper_ms": ms, "wrapper_host_ms": host_ms}
        ms, host_ms = cuda_ms(entry_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)[0]
    bound, bound_by = bound_ms(nbytes, ops)
    emit({"phase": "kernels", "case": name, "max_abs_err": err, "ms": ms, "host_ms": host_ms, **extra,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


def sync_free(name, wrapper_call):
    """A warmed-up wrapper call must not wait for the stream: run one under
    torch.cuda.set_sync_debug_mode("error")."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wrapper_call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "case": name, "wrapper_sync_free": True})


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def library_sass():
    """cuobjdump -sass of the built library."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                      "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", str(kernels.library_path())], capture_output=True, text=True,
                          check=True).stdout


def phase_build():
    t0 = time.perf_counter()
    kernels.lib()
    log = kernels.build_log or (kernels.BUILD / "nvcc.log").read_text()
    sass = library_sass()
    ops = sass_opcodes(sass, "zk_mul32_probe")
    # K2's and the Merkle kernels' opcodes: each rotation of a G step is one
    # PRMT (by 16, 8) or SHF (by 12, 7), so 112 of each a compress; its 232
    # xors are LOP3, its 224 adds IADD3 or IMAD (BLAKE3_BLOCK_OPS)
    hash_ops = {}
    for fn in re.findall(r"Function : (\S+)\n", sass):
        if "blake3_rows_kernel" in fn or "merkle_" in fn:
            counts = sass_opcodes(sass, fn)
            alu = ("PRMT", "SHF", "IADD3", "LOP3", "IMAD")
            hash_ops[fn] = {"total": sum(counts.values()),
                            **{op: n for op, n in counts.items() if op.split(".")[0] in alu}}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": kernels.build_seconds,
          "library": kernels.library_path().name, "ptxas": ptxas_summary(log),
          "mul32_probe_sass": {"total": sum(ops.values()), "opcodes": ops}, "hash_sass": hash_ops})


def _k1_work(b, m, nl, variant):
    """Bytes and operations of one stage-network call on (B, M, 8, NL); the
    stage twiddles and the full premultiplier come packed, 16 bytes each."""
    elems = b * m * nl
    nbytes = 2 * elems * LIMB_BYTES + (m.bit_length() - 1) * (m // 2) * PACKED_BYTES
    ops = (elems // 2) * (m.bit_length() - 1) * (OPS_MUL + 2 * OPS_ADD)  # butterflies
    if variant == "full":
        nbytes += m * nl * PACKED_BYTES
        ops += elems * OPS_MUL
    elif variant == "r1":
        nbytes += (m + nl) * LIMB_BYTES
        ops += 2 * elems * OPS_MUL
    return nbytes, ops


def _air_work(kind, args, host):
    """Bytes and operations of one K3 or K4 call: the trace columns (and
    K3's ee, i0, i1) read once, the output written once."""
    n = args[0].shape[-1]
    if kind == "composition":
        k = len(set(host[1])) + len(set(host[2]))
        return n * (28 + 4) * LIMB_BYTES, n * ((K3_MULS + k) * OPS_MUL + (K3_ADDS + k) * OPS_ADD)
    return n * 29 * LIMB_BYTES, n * (K4_MULS * OPS_MUL + K4_ADDS * OPS_ADD)


def phase_kernels():
    rng = np.random.default_rng(20261016)
    results = {}
    # K1 at the main paths' axes: M = 8 (FRI fold, D/8 lanes), 256 (both
    # passes of every T = 2^16 transform, 28 columns), 512 (pass 2 of the
    # size-2^19 transforms: the composition iNTT, and the mono coset LDE of
    # the 28 trace columns), 32 (both passes of that LDE's size-1024 pass 1,
    # over 28 x 512 rows)
    k1 = []
    for m, b, nl, variants in K1_CASES:
        tw = nt._stage_twiddles_dev(m, False, DEV)
        y = rand_limbs(rng, (b, m, 8, nl))
        for variant in variants:
            pre = nt.pack_t(rand_limbs(rng, (m, 8, nl), pair=1)) if variant == "full" else None
            r1 = None
            if variant == "r1":
                r1 = (rand_limbs(rng, (8, m), pair=1), rand_limbs(rng, (8, nl), pair=1))
            k1.append(compare(
                f"K1 M={m} B={b} NL={nl} {variant}",
                lambda: nt.pease_stages(y, tw, pre=pre, r1=r1),
                lambda: nt.stages_plain(y, tw, pre=pre, r1=r1),
                *_k1_work(b, m, nl, variant), plain_reps=1,
            ))
    results["ntt_stages"] = dict(k1[5], max_abs_err=max(r["max_abs_err"] for r in k1))  # M=256 r1
    # zk::mul32 alone: every pair of edge values, then random pairs
    a, b = rand_limbs(rng, (8, 1 << 16)), rand_limbs(rng, (8, 1 << 16), pair=1)
    pa, pb = nt.pack_t(a), nt.pack_t(b)  # held until the kernel has run
    out = torch.empty(1 << 16, 4, dtype=torch.int32, device=DEV)
    kernels.check(kernels.lib().zk_mul32(kernels.ptr(pa), kernels.ptr(pb), kernels.ptr(out), 1 << 16,
                                         kernels.stream_of(out)), "zk_mul32")
    err = max_abs_err(nt.unpack_t(out), ft.fmul(a, b))
    emit({"phase": "kernels", "case": "mul32 alone, 2^16 pairs", "max_abs_err": err})
    if err != 0:
        raise AssertionError(f"zk::mul32 differs from the plain multiply (max abs err {err})")
    # K2: trace rows (C = 28) and composition / FRI rows (C = 8), N = 2^16
    # per class in T-mode, N = 2^19 over the whole domain in mono
    # K2 and the Merkle heap: ms at the C entry (its arguments recorded from
    # one launch call), beside the wrapper's
    lib = kernels.lib()
    k2 = []
    for c, n in K2_CASES:
        x = rand_limbs(rng, (c, 8, n))
        work = ((c + 1) * LIMB_BYTES * n, (-(-c // 4) * BLAKE3_BLOCK_OPS + BLAKE3_PACK_OPS * c) * n)
        cname, cargs, keep = capture_entry(kernels, b3t.launch_rows, x)
        k2.append(compare(f"K2 C={c} N={n}", lambda: b3t.hash_rows_t(x), lambda: b3t.hash_rows_plain(x),
                          *work, plain_reps=1, entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname)))
        sync_free(f"K2 C={c} N={n}", lambda: b3t.hash_rows_t(x))
        del x, cargs, keep
    results["blake3_rows"] = dict(k2[0], max_abs_err=max(r["max_abs_err"] for r in k2))
    # the Merkle heap over random digests, given as the provers give them:
    # the (N, 8) transposed view of (8, N) words
    heaps = []
    for n in MERKLE_CASES:
        leaves = torch.from_numpy(rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
                                  .view(np.int32)).to(DEV)
        cname, cargs, keep = capture_entry(kernels, mk.launch_heap, leaves)
        heaps.append(compare(f"Merkle N={n}", lambda: mk.merkle_flat(leaves.T),
                             lambda: mk.merkle_flat_plain(leaves.T), MERKLE_BYTES_PER_LEAF * n,
                             (n - 1) * BLAKE3_BLOCK_OPS, plain_reps=1,
                             entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname)))
        sync_free(f"Merkle N={n}", lambda: mk.merkle_flat(leaves.T))
        del leaves, cargs, keep
    results["merkle"] = dict(heaps[0], max_abs_err=max(r["max_abs_err"] for r in heaps))
    # K3 (one class at T = 2^16, the real boundary columns) and K4 (the
    # mono shape and one class): kernel_bench.air_cases
    k4 = {}
    for name, kind, args, host in air_cases(lambda shape: rand_limbs(rng, shape, spread=True), DEV):
        wrapper, plain, launch = air_calls(kind)
        cname, cargs, keep = capture_entry(kernels, launch, *args, *host)
        lib = kernels.lib()
        res = compare(
            name, lambda: wrapper(*args, *host), lambda: plain(*args, *host), *_air_work(kind, args, host),
            plain_reps=1, entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        )
        sync_free(name, lambda: wrapper(*args, *host))
        if kind == "composition":
            results["composition"] = res
        else:
            k4[name] = res
        del args, cargs, keep
    results["transition"] = dict(k4[next(iter(k4))], max_abs_err=max(r["max_abs_err"] for r in k4.values()))
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


COUNTERS = {"ntt_stages": nt, "blake3_rows": b3t, "merkle": mk, "composition": cp, "transition": tr}
PATH_KERNELS = {"tmode": ("ntt_stages", "blake3_rows", "merkle", "composition"),
                "mono": ("ntt_stages", "blake3_rows", "merkle", "transition")}


def phase_bench(mode):
    """Prove the bench's READ/ADD chain in ``mode``: warm-up, then one
    timed prove with every launch count set to 0 just before it and read
    just after; verify, and reject a one-byte tamper.  Returns the launch
    counts and the proof's bytes."""
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
    for mod in (b3t, mk, cp, tr):
        mod.launches = 0
    nt.launches.clear()  # K1 counts its launches by shape
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prove(trace, pub, device=DEV, stage_seconds=stages, mode=mode)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    k1_shapes = {f"M={m} B={b} NL={nl} {v}": n for (m, b, nl, v), n in sorted(launches["ntt_stages"].items())}
    launches["ntt_stages"] = sum(k1_shapes.values())
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
        inv_s = cuda_ms(lambda: ft.batch_inverse(den), 2)[0] / 1e3
        extra = {"batch_inverse_seconds": inv_s, "batch_inverse_share": inv_s / steady}
    emit({"phase": "bench", "mode": mode, "config": "READ/ADD chain", "n_ops": vm.BENCH_N_OPS,
          "trace_length": trace.length, "lde_domain": trace.length * 8, "trace_gen_seconds": trace_seconds,
          "warmup_prove_seconds": warm, "prove_seconds": steady, "rows_per_sec": trace.length / steady,
          "stage_seconds": stages, "proof_bytes": len(data), "verified": True, "tampered_rejected": rejected,
          "launches": launches, "k1_launches_by_shape": k1_shapes, "peak_mem_gib": peak / 2**30, **extra})
    if not rejected:
        raise AssertionError(f"{mode}: the verifier accepted a tampered proof")
    for name in PATH_KERNELS[mode]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {mode} path")
    return launches, data


SOURCES = {
    "ntt_stages": ("zkvm_torch/csrc/ntt_stages.cu", "zkvm/ntt/ntt_t.py:320"),
    "blake3_rows": ("zkvm_torch/csrc/blake3_rows.cu", "zkvm/hash/blake3_t.py:115"),
    "merkle": ("zkvm_torch/csrc/merkle.cu", "zkvm/hash/blake3_jax.py:178 merkle_flat (XLA, no Pallas)"),
    "composition": ("zkvm_torch/csrc/composition.cu", "zkvm/air/constraints_pallas.py:230"),
    "transition": ("zkvm_torch/csrc/transition.cu", "zkvm/air/constraints_pallas.py:378"),
}


def main():
    phase_device()
    phase_build()
    results = phase_kernels()
    phase_conformance()
    runs = {mode: phase_bench(mode) for mode in ("tmode", "mono")}
    by_path = {mode: launches for mode, (launches, _) in runs.items()}
    # both layouts prove the same trace: their proofs must be the same bytes
    same = runs["tmode"][1] == runs["mono"][1]
    emit({"phase": "bench", "tmode_equals_mono": same, "proof_bytes": len(runs["tmode"][1])})
    if not same:
        raise AssertionError("the T-mode and mono proofs of the same trace differ")
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
