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
      alone against the plain multiply on every pair of edge values; the
      batch inverse (csrc/batch_inverse.cu) against its plain Fermat
      version at the provers' shapes (kernel_bench.BINV_CASES: (3, 8,
      2^19), (16, 8, 2^16), (16, 8, 2^20), (3, 8, 2^16), (8, 2^16), and
      the 2^20-row proves' (3, 8, 2^20), (8, 2^20)), with zeros and the
      edge values mixed in, its wrapper under the sync check, and its
      addition chain for a^(p-2) alone against pow on the host; then mono's
      shapes at T = 2^20 (D = 2^23; kernel_bench's *_MONO_CASES): K1 at the
      launches of the coset LDE of 28 columns, K2 at C = 28 and 8 over 2^23
      lanes, K4 over the 2^23-row domain at step 8 and the batch inverse at
      (3, 8, 2^23) and (2, 8, 2^23), each over the whole input, its plain
      version on windows of it (K1's first and last batch rows, three
      windows of lanes, K4's first and last 2^16 output rows with the
      wrap), inputs drawn on the card; every yardstick above runs the
      plain arithmetic (f128t's *_plain) by name, and the field-op kernel
      must launch no time across them; then the field-op kernel
      (csrc/field_ops.cu: f128t.fadd / fsub / fmul on a CUDA tensor)
      against the plain add, sub and mul at kernel_bench.FOP_CASES, the
      multi-eval's ladders_join broadcast, a transposed operand, and
      mono's 2^23-lane LDE and a row block of it at T = 2^20 (plain on
      windows); then the multi-eval's two kernels (csrc/multi_eval.cu:
      multi_eval_rows on a CUDA tensor): the ladder kernel
      (launch_ladders) against ladders_plain, and the u8 mma contraction
      (multi_eval_t: the ladders and the kernel) against
      multi_eval_rows_plain (both plain versions in the plain arithmetic:
      the field-op kernel must launch no time in them) at
      kernel_bench.MEVAL_CASES (the OOD frame's and the query rows' shapes
      at T = 2^16 and 2^20), exactly; the contraction's ms at the C entry
      and at the wrapper, the rows' host ms (the copy of the result and
      its ints included), its bound (the larger of the bytes it reads and
      writes, C T 32 + Q (16 S + 16 N2 + 32 C) for the coefficients, the
      ladder bytes and cells and the rows, and its 2 (16 C)(16 Q) T int8
      operations at 1,979 T/s), its dynamic shared memory; the ladder
      kernel's ms and bound (the bytes it writes, and one multiply an
      element); one wrapper call under the sync check (the copy of the
      result apart); torch._int_mm on the reference's two nibble
      matrices at the 2^20 query shape (the contraction alone, the
      yardstick); and a failing launch of either kernel that must raise
      without a fall back to the plain version; then the FRI and DEEP
      kernels (csrc/fri_fold.cu: fri.fold_t, one launch a FRI layer, and
      ntt_t.ladder_t; csrc/deep.cu: deep.weighted_sum and
      deep.deep_quotient) against their plain versions (in the plain
      arithmetic: neither the field-op kernel nor K1 may launch in them),
      exactly, at kernel_bench.fri_deep_cases: the fold at every layer of
      a 2^16 and a 2^20 prove, the ladder at the remainder's scale and
      the cold constants' shapes (strided rows, a broadcast scale), the
      DEEP sums and quotients of T-mode, cls and mono at 2^16 and 2^20
      and a strided row block of each; ms at the C entry and the wrapper,
      the bound, the sync check, and a failing launch of each entry that
      must raise without reaching a plain version;
  (d) conformance: the T = 128 program of conformance/vectors_e2e.json,
      proved in all three modes (T-mode, mono, cls), whose roots and proof
      bytes must match the vector byte for byte;
  (e) the bench's primary configuration: a READ/ADD chain of 20000 ops
      (T = 2^16, D = 2^19), proved in T-mode once to warm up and once
      timed, with per-stage seconds and the kernel-health report of the
      timed prove (zkvm_torch.utils.kernel_health: every kernel's launches,
      by shape; so in (f) and (e2)); K1, K2, K3 and the Merkle heap must
      (and the field-op kernel, as on every path below) have launched in
      the timed prove (K1's launches also by shape), the
      batch inverse exactly 8 times (the DEEP, once a class), K4 never,
      the multi-eval kernel exactly 4 times (the OOD frame twice, the
      query rows twice; mono and each rank of (h) twice, the OOD frame's),
      its ladder kernel exactly 3 times (once a point set: z and z g, z^8,
      the query points; mono and each rank twice) and its plain version
      never (so in every timed prove below); the FRI fold once a layer (3
      at T = 2^16, 5 at 2^20), the ladder once (the remainder's scale; the
      cold proves more), the DEEP sums twice and the quotient once a class
      (8; mono once a row block: 1 at 2^16, 16 at 2^20, with 32 sums), on
      every path; and T-mode's field-op and K1 launches below the counts
      before these kernels (230 and 74, PATH_BELOW);
      the proof must verify and fail with one byte flipped;
  (f) the same chain in mono (full-LDE) mode: warm-up, timed prove, verify
      and tamper check; K1, K2, K4 and the Merkle heap must have launched
      in the timed prove; with the peak device memory and the time of the
      DEEP stage's batch inverse; the batch inverse must have launched;
  (e2) the same chain in the standard-layout class prover (cls): warm-up,
      timed prove, verify and tamper check; K1, K2 and the Merkle heap
      must have launched in the timed prove, K4 exactly 8 times (once a
      class, step 1, N = 2^16), the batch inverse exactly 16 times (twice
      a class), K3 never; the proofs of (e), (f) and (e2) must be equal
      byte for byte;
  (g) lr_large: the linear regression over encrypted inputs at T = 2^20
      (zkvm_torch.examples.prove_lr_large), traced by the native generator,
      proved in T-mode once cold and once steady (each stage's seconds and
      peak device memory), decrypted against the clear prediction,
      verified, and a one-byte tamper rejected; the batch inverse must have
      launched 9 times in the cold prove (the constants once, the DEEP 8)
      and 8 in the steady one; K1, K2, K3 and the Merkle heap must have
      launched in the steady prove (printed by shape), the Merkle heap in
      at most ceil(23 / 10) launches a tree of 2^23 leaves.
      Then the same trace proved once in cls and once in mono (each with
      its constants built in that prove), whose bytes must equal the
      T-mode proof's, with each stage's seconds and peaks and its launches
      by shape (cls: K4 8, the batch inverse 16; mono: K4 once over the
      2^23-row domain, the batch inverse twice, no K3).
      Before the 2^20 proves, two checks: at T = 2^18 the proof with the chunked stage
      forms (the default there) equals the one without them and mono's (in
      row blocks there); at T = 2^17
      and 2^20, multi_eval_rows of two random columns at two random points
      equals a host Horner evaluation.  Phase (c) also runs K1, K2, K3,
      K4's class shape, the Merkle heap and the batch inverse at this
      path's shapes (kernel_bench's *_LARGE_*, K3_LARGE_T, BINV_CASES).

  (h) dist: the chain of (e) proved in mono sharded by rows over spawned
      ranks (zkvm_torch.dist; the kernels built once, before the ranks
      start): one rank over NCCL, 2 and 4 ranks sharing cuda:0 over gloo
      (every collective staged through the host and counted), and NCCL
      over min(cards, 4) ranks where there is more than one card; each
      rank proves twice (a warm-up, then the one counted); every rank's
      proof must equal (e)'s bytes and verify, and every rank must launch
      K1, K2, K4, the Merkle heap and the batch inverse (K3 never);
      each rank's seconds, launches, collectives and peaks are printed (the
      shared-card seconds are not speed figures).  Phase (c) also runs K1,
      K2, K4, the Merkle heap and the batch inverse at this path's shapes
      (kernel_bench's *_DIST_*, K4's halo blocks).

Then a {"kernels": [...]} line (each kernel's launches by path: the timed
proves of (e), (f) and (e2), the cold, steady, cls and mono proves of (g),
and every rank of (h)), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

import itertools
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

from kernel_bench import (BINV_CASES, BINV_MONO_CASES, K1_CASES, K1_DIST_CASES, K1_LARGE_CASES,  # noqa: E402
                          K1_MONO_CASES, K2_CASES, K2_DIST_CASES, K2_LARGE_CASES, K2_MONO_CASES, K3_LARGE_T,
                          MERKLE_CASES, MERKLE_DIST_CASES, MERKLE_LARGE_CASES, MEVAL_CASES, MONO_T, air_calls,
                          air_cases, binv_name, capture_entry, clock_ms, cuda_ms, fop_calls, fop_cases, fop_name,
                          fri_deep_cases, meval_name, meval_operands, meval_plain_t, meval_points, ptxas_summary,
                          sass_opcodes)
from zkvm_torch import kernels, vm  # noqa: E402
from zkvm_torch.dist import multihost  # noqa: E402
from zkvm_torch.dist import run as dist_run  # noqa: E402
from zkvm_torch.air import composition as cp  # noqa: E402
from zkvm_torch.air import transition as tr  # noqa: E402
from zkvm_torch.field import f128  # noqa: E402
from zkvm_torch.field import f128t as ft  # noqa: E402
from zkvm_torch.examples.prove_lr_large import LrRun  # noqa: E402
from zkvm_torch.field.limbs import from_numpy, from_t, to_limbs, to_numpy, ttensor  # noqa: E402
from zkvm_torch.hash import blake3_t as b3t  # noqa: E402
from zkvm_torch.hash import merkle as mk  # noqa: E402
from zkvm_torch.ntt import ntt_t as nt  # noqa: E402
from zkvm_torch.prover import deep as dp  # noqa: E402
from zkvm_torch.prover import fri, limits, prove  # noqa: E402
from zkvm_torch.prover import multi_eval as me  # noqa: E402
from zkvm_torch.runtime import native_available  # noqa: E402
from zkvm_torch.utils import kernel_health  # noqa: E402
from zkvm_torch.verifier import VerificationError  # noqa: E402

DEV = torch.device("cuda", 0)

# The least time one H100 SXM could take (NVIDIA's data sheet): 3.35 TB/s of
# HBM3, and 32-bit integer work at 132 SMs x 64 INT32 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int8 tensor-core operations (dense): the rate of the multi-eval's byte
# contraction, 2 (16 C)(16 Q) T operations
INT8_OPS_PER_S = 1.979e15
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
# the batch inverse by Montgomery's trick over a whole row: 3 multiplies an
# element (prefix product, and two in the backward sweep; the one
# exponentiation a row is negligible), 32 bytes read and 32 written
BINV_MULS = 3


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


def dev_limbs(seed, shape):
    """rand_limbs(spread=True) for the 2^23-row shapes (~1.9e9 limbs, which
    numpy draws in tens of seconds): drawn on the card by torch's generator
    from ``seed``, every row's lane s k holding EDGES[(k + r) % 5]."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=DEV, dtype=torch.int32)
    x[..., 7, :] %= 0xFFFF
    rows = x.view(-1, 8, shape[-1])
    lanes = torch.arange(0, shape[-1], min(61, max(1, shape[-1] // 5)), device=DEV)
    which = (torch.arange(len(lanes), device=DEV)[None] + torch.arange(rows.shape[0], device=DEV)[:, None]) % 5
    rows[:, :, lanes] = torch.from_numpy(EDGE_LIMBS.astype(np.int32)).to(DEV)[which].transpose(1, 2)
    return x


def bound_ms(nbytes, ops, ops_rate=INT32_OPS_PER_S):
    """The larger of the memory and the integer-operation time, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item())


def compare(name, kernel_fn, plain_fn, nbytes, ops, reps=20, plain_reps=2, entry_fn=None, windows=None,
            ops_rate=INT32_OPS_PER_S):
    """Kernel vs plain on the card: exact equality, both times and the
    bound of the work (``nbytes`` moved, ``ops`` operations at
    ``ops_rate``, by default 32-bit integer ones).  With
    ``entry_fn`` (the C entry alone), ``ms`` is its time and the wrapper's
    is ``wrapper_ms``.  With ``plain_reps=0`` the plain time is that of the
    one call that the check makes (for a plain version that takes
    seconds).  With ``windows`` = (description, pick), for a shape whose
    plain version does not fit the card: ``plain_fn`` computes the plain
    version on those windows of the input alone, and ``pick`` takes the
    same windows of the kernel's output over the whole input."""
    got = kernel_fn()
    if windows is not None:
        got = windows[1](got)
    want, plain_once_ms = timed_once(plain_fn)
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    del got, want
    ms, host_ms = cuda_ms(kernel_fn, reps)
    extra = {}
    if entry_fn is not None:
        extra = {"wrapper_ms": ms, "wrapper_host_ms": host_ms}
        ms, host_ms = cuda_ms(entry_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)[0] if plain_reps else plain_once_ms
    bound, bound_by = bound_ms(nbytes, ops, ops_rate)
    if windows is not None:
        extra["plain_on"] = windows[0]
    emit({"phase": "kernels", "case": name, "max_abs_err": err, "ms": ms, "host_ms": host_ms, **extra,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


def timed_once(fn):
    """(fn's result, its ms on the card by CUDA events), one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def k1_plain(y, tw, pre, r1, elems=1 << 22):
    """K1's plain version over slices of y along B of about ``elems``
    elements (its int64 transients are ~50 bytes an input byte), joined:
    the same values at the 2^20-row path's shapes within the card's
    memory."""
    step = max(1, elems // (y.shape[1] * y.shape[3]))
    return torch.cat([nt.stages_plain(y[i:i + step], tw, pre=pre, r1=r1) for i in range(0, y.shape[0], step)])


def phase_kernels():
    rng = np.random.default_rng(20261016)
    results = {}
    # the yardsticks below run the plain arithmetic by name: across them
    # the field-op kernel must not launch
    ft.op_launches.clear()
    ft.op_launches_by_shape.clear()
    # K1 at the main paths' axes: M = 8 (FRI fold, D/8 lanes), 256 (both
    # passes of every T = 2^16 transform, 28 columns), 512 (pass 2 of the
    # size-2^19 transforms: the composition iNTT, and the mono coset LDE of
    # the 28 trace columns), 32 (both passes of that LDE's size-1024 pass 1,
    # over 28 x 512 rows); then the 2^20-row path's (K1_LARGE_CASES)
    k1 = []
    for m, b, nl, variants in K1_CASES + K1_LARGE_CASES + K1_DIST_CASES:
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
                lambda: k1_plain(y, tw, pre, r1),
                *_k1_work(b, m, nl, variant), plain_reps=1,
            ))
    results["ntt_stages"] = dict(k1[5], max_abs_err=max(r["max_abs_err"] for r in k1))  # M=256 r1
    # zk::mul32 alone: every pair of edge values, then random pairs
    a, b = rand_limbs(rng, (8, 1 << 16)), rand_limbs(rng, (8, 1 << 16), pair=1)
    pa, pb = nt.pack_t(a), nt.pack_t(b)  # held until the kernel has run
    out = torch.empty(1 << 16, 4, dtype=torch.int32, device=DEV)
    kernels.check(kernels.lib().zk_mul32(kernels.ptr(pa), kernels.ptr(pb), kernels.ptr(out), 1 << 16,
                                         kernels.stream_of(out)), "zk_mul32")
    err = max_abs_err(nt.unpack_t(out), ft.fmul_plain(a, b))
    emit({"phase": "kernels", "case": "mul32 alone, 2^16 pairs", "max_abs_err": err})
    if err != 0:
        raise AssertionError(f"zk::mul32 differs from the plain multiply (max abs err {err})")
    # K2: trace rows (C = 28) and composition / FRI rows (C = 8), N = 2^16
    # per class in T-mode, N = 2^19 over the whole domain in mono
    # K2 and the Merkle heap: ms at the C entry (its arguments recorded from
    # one launch call), beside the wrapper's
    lib = kernels.lib()
    k2 = []
    for c, n in K2_CASES + K2_LARGE_CASES + K2_DIST_CASES:
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
    for n in MERKLE_CASES + MERKLE_LARGE_CASES + MERKLE_DIST_CASES:
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
    # mono shape and one class): kernel_bench.air_cases; then K3 and K4's
    # class shape (the cls prove's, step 1) at the 2^20-row path's T; then
    # K4 on the sharded mono's halo blocks (phase h); made one case at a time
    k4 = {}
    limbs = lambda shape: rand_limbs(rng, shape, spread=True)
    for name, kind, args, host in itertools.chain(air_cases(limbs, DEV),
                                                  air_cases(limbs, DEV, K3_LARGE_T, ("class",)),
                                                  air_cases(limbs, DEV, k4=("halo P=2", "halo P=4"), k3=False)):
        wrapper, plain, launch = air_calls(kind)
        cname, cargs, keep = capture_entry(kernels, launch, *args, *host)
        lib = kernels.lib()
        res = compare(
            name, lambda: wrapper(*args, *host), lambda: plain(*args, *host), *_air_work(kind, args, host),
            plain_reps=1, entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        )
        sync_free(name, lambda: wrapper(*args, *host))
        if kind == "composition":
            results.setdefault("composition", res)
        else:
            k4[name] = res
        del args, cargs, keep
    results["transition"] = dict(k4[next(iter(k4))], max_abs_err=max(r["max_abs_err"] for r in k4.values()))
    # the batch inverse at the provers' shapes, zeros and edge values in
    # every row; its plain version takes seconds at the large shapes, so
    # its time is that of the checking call (one call) from 2^20 lanes on
    binv = []
    for shape in BINV_CASES:
        x = rand_limbs(rng, shape, spread=True)
        n_elems = x.numel() // 8
        cname, cargs, keep = capture_entry(kernels, ft.launch_batch_inverse, x)
        binv.append(compare(
            binv_name(shape), lambda: ft.batch_inverse(x), lambda: ft.batch_inverse_plain(x),
            2 * LIMB_BYTES * n_elems, BINV_MULS * OPS_MUL * n_elems, plain_reps=int(shape[-1] < 1 << 20),
            entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        ))
        sync_free(binv_name(shape), lambda: ft.batch_inverse(x))
        del x, cargs, keep
        torch.cuda.empty_cache()
    # the kernels line reports the shape that T-mode launches 8 times a
    # prove: a class of the DEEP at T = 2^16
    deep_class = binv[BINV_CASES.index((3, 8, 1 << 16))]
    results["batch_inverse"] = dict(deep_class, max_abs_err=max(r["max_abs_err"] for r in binv))
    # the batch inverse's addition chain for a^(p-2) alone (its probe
    # kernel): the edge values and random elements against pow on the host
    vals = [v for v in EDGES if v] + [2, f128.P - 2, 2**64 - 1, 2**64]
    vals += [int(rng.integers(0, 2**62)) << 66 | int(rng.integers(0, 2**62)) for _ in range(4096)]
    vals = [v % f128.P for v in vals]
    a = nt.pack_t(ttensor(vals, DEV))
    out = torch.empty_like(a)
    kernels.check(kernels.lib().zk_binv_power(kernels.ptr(a), kernels.ptr(out), len(vals), kernels.stream_of(out)),
                  "zk_binv_power")
    got = [int(v) for v in from_t(to_numpy(nt.unpack_t(out)))]
    wrong = sum(g != pow(v, f128.P - 2, f128.P) for g, v in zip(got, vals))
    emit({"phase": "kernels", "case": f"batch inverse a^(p-2) alone, {len(vals)} elements", "wrong": wrong})
    if wrong:
        raise AssertionError(f"the batch inverse's addition chain differs from pow in {wrong} elements")
    torch.cuda.empty_cache()
    # mono's shapes at T = 2^20: the max_abs_err of each kernel covers them
    for name, res in mono_kernels().items():
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + [r["max_abs_err"] for r in res])
    yard = sum(ft.op_launches.values())
    emit({"phase": "kernels", "check": "field_ops launches across the yardsticks", "launches": yard})
    if yard:
        raise AssertionError(f"the yardsticks of phase (c) launched the field-op kernel {yard} times")
    results["field_ops"] = field_op_kernels(rng)
    results["multi_eval"], results["meval_ladders"] = meval_kernels(rng)
    results.update(fri_deep_kernels(rng))
    return results


LANE_WINDOW = 1 << 17  # lanes a window, where the plain version of a 2^23-lane case does not fit
K4_WINDOW = 1 << 16  # K4's output rows a window, on its 2^23-row domain


def lane_windows(n):
    """(description, lane index) of the first, a middle and the last
    LANE_WINDOW lanes of n."""
    starts = (0, n // 2, n - LANE_WINDOW)
    idx = torch.cat([torch.arange(a, a + LANE_WINDOW, device=DEV) for a in starts])
    return ", ".join(f"lanes [{a}, {a + LANE_WINDOW})" for a in starts), idx


def k4_window_plain(args, host, start, rows):
    """K4's plain version on output rows [start, start + rows) of the
    domain: on those rows and one table period after them (wrapping at N;
    the halo of air/constraints_dist.py), the first ``rows`` kept."""
    lde, mask = args[0], args[1]
    idx = torch.arange(start, start + rows + mask.shape[-1], device=DEV) % lde.shape[-1]
    return tr.merged_transition_plain(lde.index_select(-1, idx), *args[1:], *host)[:, :rows]


def mono_kernels():
    """Phase (c) at mono's shapes at T = 2^20 (D = 2^23; kernel_bench's
    *_MONO_CASES): each kernel over the whole input, held against its plain
    version on windows of it (the plain versions' int64 transients over
    the whole input do not fit the card): K1 on the first and last rows of
    its batch axis, K2 and the batch inverse on three windows of lanes, K4
    on the first and last K4_WINDOW output rows, the wrap included.  Returns
    each kernel's results."""
    seeds = itertools.count(2026)
    lib = kernels.lib()
    out = {"ntt_stages": [], "blake3_rows": [], "transition": [], "batch_inverse": []}
    for m, b, nl, variants in K1_MONO_CASES:
        tw = nt._stage_twiddles_dev(m, False, DEV)
        y = dev_limbs(next(seeds), (b, m, 8, nl))
        w = max(1, min(b // 2, (1 << 22) // (m * nl)))  # batch rows a window: ~2^22 elements
        pick = lambda o: torch.cat([o[:w], o[-w:]])
        for variant in variants:
            pre = nt.pack_t(dev_limbs(next(seeds), (m, 8, nl))) if variant == "full" else None
            r1 = (dev_limbs(next(seeds), (8, m)), dev_limbs(next(seeds), (8, nl))) if variant == "r1" else None
            out["ntt_stages"].append(compare(
                f"K1 M={m} B={b} NL={nl} {variant}", lambda: nt.pease_stages(y, tw, pre=pre, r1=r1),
                lambda: k1_plain(pick(y), tw, pre, r1), *_k1_work(b, m, nl, variant), plain_reps=0,
                windows=(f"batch rows [0, {w}), [{b - w}, {b})", pick)))
        del y, pre, r1
        torch.cuda.empty_cache()
    for c, n in K2_MONO_CASES:
        x = dev_limbs(next(seeds), (c, 8, n))
        desc, idx = lane_windows(n)
        cname, cargs, keep = capture_entry(kernels, b3t.launch_rows, x)
        out["blake3_rows"].append(compare(
            f"K2 C={c} N={n}", lambda: b3t.hash_rows_t(x), lambda: b3t.hash_rows_plain(x.index_select(-1, idx)),
            (c + 1) * LIMB_BYTES * n, (-(-c // 4) * BLAKE3_BLOCK_OPS + BLAKE3_PACK_OPS * c) * n, plain_reps=0,
            entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
            windows=(desc, lambda h: h.index_select(-1, idx))))
        del x, cargs, keep
        torch.cuda.empty_cache()
    for name, kind, args, host in air_cases(lambda shape: dev_limbs(next(seeds), shape), DEV, MONO_T, ("mono",),
                                            k3=False):
        n, rows = args[0].shape[-1], K4_WINDOW
        cname, cargs, keep = capture_entry(kernels, tr.launch_transition, *args, *host)
        out["transition"].append(compare(
            name, lambda: tr.merged_transition(*args, *host),
            lambda: torch.cat([k4_window_plain(args, host, 0, rows), k4_window_plain(args, host, n - rows, rows)], -1),
            *_air_work(kind, args, host), plain_reps=0,
            entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
            windows=(f"output rows [0, {rows}), [{n - rows}, {n})",
                     lambda q: torch.cat([q[:, :rows], q[:, -rows:]], -1))))
        del args, cargs, keep
        torch.cuda.empty_cache()
    for shape in BINV_MONO_CASES:
        x = dev_limbs(next(seeds), shape)
        n_elems = x.numel() // 8
        desc, idx = lane_windows(shape[-1])
        cname, cargs, keep = capture_entry(kernels, ft.launch_batch_inverse, x)
        out["batch_inverse"].append(compare(
            binv_name(shape), lambda: ft.batch_inverse(x), lambda: ft.batch_inverse_plain(x.index_select(-1, idx)),
            2 * LIMB_BYTES * n_elems, BINV_MULS * OPS_MUL * n_elems, plain_reps=0,
            entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
            windows=(desc, lambda o: o.index_select(-1, idx))))
        del x, cargs, keep
        torch.cuda.empty_cache()
    return out


def _fop_work(op, a, b, out):
    """Bytes and operations of one field-op call: each operand's own
    elements read once (a broadcast one's fewer), the output written once."""
    return (a.numel() + b.numel() + out.numel()) * 4, out.numel() // 8 * (OPS_MUL if op == "mul" else OPS_ADD)


def _fop_patterns():
    """The broadcast and strided operands of the main paths beside
    kernel_bench.FOP_CASES, as (op, make) with make(limbs) -> (a, b): the
    multi-eval's ladders_join at the queries' 32 points over T = 2^16
    ((Q, N2, 8, 1) x (Q, 1, 8, S), stride 0 along the lanes and along a
    batch axis), and the class scale of ntt_t.scale_by_ladder_t on a
    transposed (C, N2, 8, N1) view of 28 columns at T = 2^16."""
    yield "mul", lambda limbs: (limbs((32, 8, 256)).transpose(-1, -2)[:, :, :, None], limbs((32, 8, 256))[:, None])
    yield "mul", lambda limbs: (limbs((28, 8, 256, 256)).transpose(-3, -2), limbs((8, 256)))


def field_op_kernels(rng):
    """Phase (c) for the field-op kernel: add, sub and mul against their
    plain versions, exactly, at kernel_bench.FOP_CASES, the broadcast
    patterns of _fop_patterns, and mono's 2^23-lane operands at T = 2^20
    (the kernel over the whole input, the plain version on three windows
    of lanes): the (28, 8, 2^23) trace LDE times a column of weights, and
    a (4, 8, 2^19) block of it, a strided batch as mono's row blocks are
    read (its batch stride 2^26 limbs).  Returns the first case's results, and the
    largest error of all."""
    lib = kernels.lib()
    limbs = lambda shape: rand_limbs(rng, shape, spread=True)
    cases = list(fop_cases(limbs))
    for op, make in _fop_patterns():
        a, b = make(limbs)
        cases.append((fop_name(op, a, b), op, a, b))
    out = []
    for name, op, a, b in cases:
        wrapper, plain, launch = fop_calls(ft, op)
        cname, cargs, keep = capture_entry(kernels, launch, a, b)  # keep: a, b and the output
        out.append(compare(name, lambda: wrapper(a, b), lambda: plain(a, b),
                           *_fop_work(op, a, b, keep[-1]), plain_reps=1,
                           entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname)))
        sync_free(name, lambda: wrapper(a, b))
        del a, b, cargs, keep
    del cases
    torch.cuda.empty_cache()
    d, r = 8 * MONO_T, limits.MONO_ROW_BLOCK
    lde = dev_limbs(2031, (28, 8, d))
    w = dev_limbs(2032, (28, 8, 1))
    block = lde[4:8, :, r:2 * r]
    for op, a, b in (("mul", lde, w), ("add", block, w[4:8]), ("mul", block, w[4:8])):
        wrapper, plain, launch = fop_calls(ft, op)
        cname, cargs, keep = capture_entry(kernels, launch, a, b)
        desc, lanes = lane_windows(a.shape[-1])
        out.append(compare(fop_name(op, a, b) + (" (a block of the LDE)" if a is block else ""),
                           lambda: wrapper(a, b), lambda: plain(a.index_select(-1, lanes), b),
                           *_fop_work(op, a, b, keep[-1]), plain_reps=0,
                           entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
                           windows=(desc, lambda o: o.index_select(-1, lanes))))
        del cargs, keep
    del lde, w, block
    torch.cuda.empty_cache()
    return dict(out[0], max_abs_err=max(r["max_abs_err"] for r in out))


class _FailingLib:
    """A kernel library whose entries named in ``failing`` report a failed
    launch; every other entry (the ladders', the field ops') is the real
    one."""

    def __init__(self, real, failing):
        self.real, self.failing = real, failing

    def __getattr__(self, name):
        if name in self.failing:
            return lambda *args: 700  # cudaErrorIllegalAddress
        return getattr(self.real, name)


def int_mm_ms(coeffs, points, reps=5):
    """torch._int_mm of the reference's nibble matrices of coeffs (C 32, T)
    and the points' ladders (T, Q 32), int8 -> int32: the contraction that
    the reference runs on its matrix unit, without the buckets and the sum
    mod p."""
    lads = nt.ladders_t(from_numpy(to_limbs(points), DEV), coeffs.shape[-1])
    a = me._nibbles(coeffs).reshape(-1, coeffs.shape[-1]).to(torch.int8)
    b = me._nibbles(lads).reshape(-1, lads.shape[-1]).to(torch.int8).t()
    del lads
    return cuda_ms(lambda: torch._int_mm(a, b), reps)[0]


def ladders_flat(lad):
    """A Ladders' bytes and cells as one int tensor (for the comparison)."""
    return torch.cat([lad.digits.flatten().int(), lad.cells.flatten()])


def meval_kernels(rng):
    """Phase (c) for the multi-eval's kernels at kernel_bench.MEVAL_CASES:
    the ladder kernel (launch_ladders) against ladders_plain and the
    contraction (multi_eval_t: the ladders and the kernel) against the
    plain version (as (Q, C, 8) limbs), exactly; the C entry's ms, the
    wrapper's and the rows' host ms; one wrapper call under the sync
    check; at the 2^20 query shape torch._int_mm of the nibble matrices;
    then a launch of either kernel that fails must raise from
    multi_eval_rows on a CUDA tensor and leave the plain version uncalled.
    The plain versions take the plain arithmetic, so the field-op kernel
    must launch no time across their calls; phase (g) holds the kernel
    against a host Horner evaluation.  Returns the 2^20 query shape's
    results of each kernel, with the largest error of all."""
    lib, stream, out, lad_out, plain_op_launches = kernels.lib(), kernels.stream_of(torch.empty(1, device=DEV)), {}, {}, 0

    def plain(fn, *args):
        nonlocal plain_op_launches
        before = sum(ft.op_launches.values())
        res = fn(*args)
        plain_op_launches += sum(ft.op_launches.values()) - before
        return res

    big = max(MEVAL_CASES, key=lambda cqt: cqt[0] * cqt[1] * cqt[2])  # the 2^20 query shape
    emit({"phase": "kernels", "case": "multi-eval dynamic shared memory, bytes",
          **{f"Q={q}": lib.zk_multi_eval_smem(q) for q in (1, 2, 32)}})
    for c, q, t in MEVAL_CASES:
        name = meval_name(c, q, t)
        coeffs, points = rand_limbs(rng, (c, 8, t), spread=True), meval_points(rng, q)
        bases = from_numpy(to_limbs(points), DEV)
        s, n2 = me.split(t)
        ldb = -(-s // me.LADDER_ALIGN) * me.LADDER_ALIGN
        lad_bytes = q * (16 * ldb + n2 * PACKED_BYTES)
        lad_out[(c, q, t)] = compare(f"{name} ladders", lambda: ladders_flat(me.launch_ladders(lib, stream, bases, t)),
                                     lambda: plain(lambda: ladders_flat(me.ladders_plain(bases, t))),
                                     lad_bytes, q * (s + n2) * OPS_MUL)
        (lad,) = meval_operands(me, coeffs, points)
        cname, cargs, keep = capture_entry(kernels, me.launch_multi_eval, coeffs, lad)
        # the kernel reads the coefficients, the ladder bytes and cells, and writes the rows
        nbytes = c * t * LIMB_BYTES + q * (16 * s + n2 * PACKED_BYTES) + q * c * LIMB_BYTES
        res = compare(name, lambda: me.multi_eval_t(coeffs, points), lambda: plain(meval_plain_t, me, coeffs, points),
                      nbytes, 2 * (16 * c) * (16 * q) * t, plain_reps=int(t < 1 << 20),
                      entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname), ops_rate=INT8_OPS_PER_S)
        sync_free(name, lambda: me.multi_eval_t(coeffs, points))
        res["rows_host_ms"] = clock_ms(lambda: me.multi_eval_rows(coeffs, points), 3)
        if (c, q, t) == big:
            res["library_ms"] = int_mm_ms(coeffs, points)
            res["library_call"] = "torch._int_mm of the int8 nibble matrices (the contraction alone)"
        emit({"phase": "kernels", "case": name, "rows_host_ms": res["rows_host_ms"],
              **({"library_ms": res["library_ms"]} if "library_ms" in res else {})})
        out[(c, q, t)] = res
        del coeffs, bases, lad, cargs, keep
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "check": "field_ops launches across the multi-eval's plain versions",
          "launches": plain_op_launches})
    if plain_op_launches:
        raise AssertionError(f"the multi-eval's plain versions launched the field-op kernel {plain_op_launches} times")
    coeffs, points = rand_limbs(rng, (8, 8, 1 << 10)), meval_points(rng, 4)
    real_lib = kernels.lib
    for entry in ("zk_meval_ladders", "zk_multi_eval"):
        plain_before = me.plain_calls
        failing = _FailingLib(real_lib(), {entry})
        kernels.lib = lambda: failing
        try:
            me.multi_eval_rows(coeffs, points)
            raised = None
        except RuntimeError as err:
            raised = str(err)
        finally:
            kernels.lib = real_lib
        emit({"phase": "kernels", "check": f"a failing {entry} launch raises, no fall back", "raised": raised,
              "plain_calls": me.plain_calls - plain_before})
        if raised is None or f"{entry}: CUDA launch failed with error 700" not in raised or me.plain_calls != plain_before:
            raise AssertionError(f"multi_eval_rows did not raise on a failing {entry} launch, or fell back to the "
                                 "plain version")
    return (dict(out[big], max_abs_err=max(r["max_abs_err"] for r in out.values())),
            dict(lad_out[big], max_abs_err=max(r["max_abs_err"] for r in lad_out.values())))


# the case of each FRI and DEEP family that the kernels line reports: the
# shape a 2^16 T-mode prove launches (the first fold, the remainder's
# scale, the sums over the 28 trace columns, a class's quotient)
FRI_DEEP_REPORTED = {"fri_fold": "FRI fold n=2^16", "ladder": "FRI ladder B=1 n=2^10 x",
                     "weighted_sum": "DEEP sum K=2 C=28 N=2^16", "deep_quotient": "DEEP quotient K=3 N=2^16"}
# their plain versions, which a failing launch must not reach
FRI_DEEP_PLAIN = ((fri, "fold_plain"), (nt, "ladder_plain"), (dp, "weighted_sum_plain"),
                  (dp, "deep_quotient_plain"))


def fri_deep_kernels(rng):
    """Phase (c) for csrc/fri_fold.cu and csrc/deep.cu at
    kernel_bench.fri_deep_cases (the fold at every layer of a 2^16 and a
    2^20 prove, the ladder at the remainder's and the cold constants'
    shapes with strided, broadcast rows, the DEEP sums and quotients of
    T-mode, cls and mono at 2^16 and 2^20 and a strided row block of
    each): exact against the plain versions, the C entry's and the
    wrapper's ms, the bound, one wrapper call under the sync check; the
    plain versions launch neither the field-op kernel nor K1.  Then a
    failing launch of each entry must raise from the wrapper the prover
    calls and reach no plain version.  Returns each family's reported
    case (FRI_DEEP_REPORTED) with the largest error of the family."""
    lib, out = kernels.lib(), {}
    limbs = lambda shape: rand_limbs(rng, shape, spread=True)
    plain_launches = 0
    for case in fri_deep_cases(rng, limbs):
        cname, cargs, keep = capture_entry(kernels, case["launch"], None)

        def plain(fn=case["plain"]):
            nonlocal plain_launches
            before = sum(ft.op_launches.values()) + sum(nt.launches.values())
            res = fn()
            plain_launches += sum(ft.op_launches.values()) + sum(nt.launches.values()) - before
            return res

        res = compare(case["name"], case["wrapper"], plain, case["nbytes"],
                      case["muls"] * OPS_MUL + case["adds"] * OPS_ADD, plain_reps=1,
                      entry_fn=lambda: kernels.check(getattr(lib, cname)(*cargs), cname))
        sync_free(case["name"], case["wrapper"])
        out.setdefault(case["family"], {})[case["name"]] = res
        del case, cargs, keep
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "check": "field_ops and K1 launches across the FRI and DEEP plain versions",
          "launches": plain_launches})
    if plain_launches:
        raise AssertionError(f"the FRI and DEEP plain versions launched the field-op kernel or K1 {plain_launches} "
                             "times")
    v, one = rand_limbs(rng, (fri.FOLD, 8, 1 << 10)), rand_limbs(rng, (8, 1))[:, 0]
    cols = rand_limbs(rng, (3, 8, 1 << 10))
    calls = {"zk_fri_fold": lambda: fri.fold_t(v, 5, 7), "zk_ladder": lambda: nt.ladder_t(one, one, 1 << 10),
             "zk_weighted_sum": lambda: dp.weighted_sum(cols, [[1, 2, 3]]),
             "zk_deep_quotient": lambda: dp.deep_quotient(cols, [1, 2, 3], cols)}
    real_lib, saved = kernels.lib, [getattr(mod, name) for mod, name in FRI_DEEP_PLAIN]
    ran = []
    for mod, name in FRI_DEEP_PLAIN:
        setattr(mod, name, lambda *args, name=name, **kwargs: ran.append(name))
    try:
        for entry, call in calls.items():
            failing = _FailingLib(real_lib(), {entry})
            kernels.lib = lambda: failing
            try:
                call()
                raised = None
            except RuntimeError as err:
                raised = str(err)
            finally:
                kernels.lib = real_lib
            emit({"phase": "kernels", "check": f"a failing {entry} launch raises, no fall back", "raised": raised,
                  "plain_calls": len(ran)})
            if raised is None or f"{entry}: CUDA launch failed with error 700" not in raised or ran:
                raise AssertionError(f"a failing {entry} launch did not raise, or fell back to the plain version")
    finally:
        for (mod, name), fn in zip(FRI_DEEP_PLAIN, saved):
            setattr(mod, name, fn)
    return {family: dict(cases[FRI_DEEP_REPORTED[family]], max_abs_err=max(r["max_abs_err"] for r in cases.values()))
            for family, cases in out.items()}


def phase_conformance():
    vec = json.loads((Path(__file__).resolve().parent / "conformance" / "vectors_e2e.json").read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    for mode in MODES:
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


MODES = ("tmode", "mono", "cls")
# the kernels each path's run must have launched, and the launch counts it
# must have made exactly (T-mode: the batch inverse once a class in the DEEP,
# and once more for the constants of a cold prove; the cls path: K4 once a
# class, the batch inverse twice a class, no K3; cold mono at T = 2^20: K4
# once over the domain, the batch inverse for the constants and the DEEP)
FRI_DEEP = ("fri_fold", "ladder", "weighted_sum", "deep_quotient")
MONO_KERNELS = ("ntt_stages", "blake3_rows", "merkle", "transition", "batch_inverse", "field_ops", "multi_eval",
                "meval_ladders") + FRI_DEEP
TMODE_KERNELS = ("ntt_stages", "blake3_rows", "merkle", "composition", "batch_inverse", "field_ops", "multi_eval",
                 "meval_ladders") + FRI_DEEP
PATH_KERNELS = {"tmode": TMODE_KERNELS,
                "mono": MONO_KERNELS,
                "cls": MONO_KERNELS,
                "lr_large_cold": ("batch_inverse", "field_ops", "multi_eval", "meval_ladders") + FRI_DEEP,
                "lr_large": TMODE_KERNELS,
                "lr_large_cls": MONO_KERNELS,
                "lr_large_mono": MONO_KERNELS}
# the multi-eval: the OOD frame's two calls and the query rows' two in
# T-mode and cls, the OOD frame's alone in mono (and on each rank of h);
# its ladder kernel once a point set (z and z g, z^8, the query points).
# FRI: a fold a layer (3 at D = 2^19, 5 at 2^23) and, in a steady prove,
# the remainder's scale the one ladder; the DEEP: two column sums and a
# quotient a class (T-mode, cls) or a row block (mono: one at 2^16, 16 at
# 2^20)
FRI_DEEP_16 = {"fri_fold": 3, "ladder": 1, "weighted_sum": 2, "deep_quotient": 8}
FRI_DEEP_20 = {"fri_fold": 5, "weighted_sum": 2, "deep_quotient": 8}
CLS_EXACT = {"transition": 8, "batch_inverse": 16, "composition": 0, "multi_eval": 4, "meval_ladders": 3}
PATH_EXACT = {"tmode": {"transition": 0, "batch_inverse": 8, "multi_eval": 4, "meval_ladders": 3, **FRI_DEEP_16},
              "mono": {"composition": 0, "multi_eval": 2, "meval_ladders": 2, **FRI_DEEP_16, "deep_quotient": 1},
              "cls": {**CLS_EXACT, **FRI_DEEP_16},
              "lr_large_cold": {"batch_inverse": 9, "multi_eval": 4, "meval_ladders": 3, **FRI_DEEP_20},
              "lr_large": {"batch_inverse": 8, "transition": 0, "multi_eval": 4, "meval_ladders": 3, **FRI_DEEP_20,
                           "ladder": 1},
              "lr_large_cls": {**CLS_EXACT, **FRI_DEEP_20},
              "lr_large_mono": {"composition": 0, "transition": 1, "batch_inverse": 2, "multi_eval": 2,
                                "meval_ladders": 2, "fri_fold": 5, "weighted_sum": 32, "deep_quotient": 16}}
# the timed 2^16 T-mode prove launched fewer field ops and K1 than these
# (the parent's counts before the FRI and DEEP kernels: PERF.md §4, one
# H100, 230 field-op and 74 K1 launches)
PATH_BELOW = {"tmode": {"field_ops": 230, "ntt_stages": 74}}


def check_plain(where, plain):
    """No plain version that stands in for a kernel ran in a prove."""
    if any(plain.values()):
        raise AssertionError(f"plain versions ran {plain} times in {where}")


def check_path(path, launches, by_shape, plain):
    """The kernels ``path`` must have launched, the counts it must have
    made exactly, for the cls paths K4 at step 1 alone, and no plain
    version in place of a kernel."""
    check_plain(f"the {path} prove", plain)
    for name in PATH_KERNELS[path]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    for name, n in PATH_EXACT.get(path, {}).items():
        if launches[name] != n:
            raise AssertionError(f"kernel {name} launched {launches[name]} times on the {path} path, "
                                 f"expected {n}")
    for name, n in PATH_BELOW.get(path, {}).items():
        if launches[name] >= n:
            raise AssertionError(f"kernel {name} launched {launches[name]} times on the {path} path, "
                                 f"expected fewer than {n}")
    if path in ("cls", "lr_large_cls") and any(not k.endswith(" step=1") for k in by_shape["transition"]):
        raise AssertionError(f"K4 on the {path} path at {by_shape['transition']}, expected step 1")


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
    kernel_health.reset()
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prove(trace, pub, device=DEV, stage_seconds=stages, mode=mode)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    health = kernel_health.report()
    launches, by_shape = health["launches"], health["launches_by_shape"]
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
          **health, "k1_launches_by_shape": by_shape["ntt_stages"], "peak_mem_gib": peak / 2**30, **extra})
    if not rejected:
        raise AssertionError(f"{mode}: the verifier accepted a tampered proof")
    check_path(mode, launches, by_shape, health["plain_calls"])
    return launches, data


def gib(nbytes):
    return None if nbytes is None else nbytes / 2**30


def horner(coeffs, x):
    """sum_t coeffs[t] x^t mod p on the host, by Horner's rule."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % f128.P
    return acc


def check_multi_eval(rng, t):
    """multi_eval_rows of two random columns of length t at two random
    points against the host Horner evaluation (exact)."""
    cols = rand_limbs(rng, (2, 8, t))
    points = [int(rng.integers(0, 2**62)) << 64 | int(rng.integers(0, 2**62)) for _ in range(2)]
    got = me.multi_eval_rows(cols, points)
    host = [[int(v) for v in col] for col in from_t(to_numpy(cols))]
    want = [[horner(col, x) for col in host] for x in points]
    emit({"phase": "lr_large", "check": "multi_eval equals host Horner", "t": t, "equal": got == want})
    if got != want:
        raise AssertionError(f"multi_eval_rows at T = {t} differs from the host Horner evaluation")


def phase_lr_large(card):
    """(g): the linear regression over encrypted inputs at T = 2^20, after
    the chunked-forms and multi-eval checks.  Returns the launch counts of
    its paths: the cold and the steady T-mode prove, the cls prove and the
    mono prove."""
    if not native_available():
        raise AssertionError("lr_large: the native trace generator did not build (g++)")
    # (i) at T = 2^18 the chunked forms are the default; without them the
    # proof must be the same bytes, and so must mono's (in row blocks)
    small = LrRun(18)
    small.prepare()
    chunked = small.prove(DEV)
    saved = limits.CHUNK_T
    limits.CHUNK_T = 2 * small.trace.length
    try:
        unchunked = small.prove(DEV)
    finally:
        limits.CHUNK_T = saved
    mono = small.prove(DEV, "mono")
    same = chunked[0].to_wire_bytes() == unchunked[0].to_wire_bytes()
    mono_same = mono[0].to_wire_bytes() == chunked[0].to_wire_bytes()
    emit({"phase": "lr_large", "check": "chunked proof equals unchunked and mono", "t": small.trace.length,
          "equal": same, "mono_equal": mono_same, "chunked_seconds": chunked[1],
          "unchunked_seconds": unchunked[1], "mono_seconds": mono[1],
          "chunked_peak_gib": gib(chunked[4]), "unchunked_peak_gib": gib(unchunked[4]), "mono_peak_gib": gib(mono[4]),
          "chunked_stage_peak_gib": {k: gib(v) for k, v in chunked[3].items()},
          "unchunked_stage_peak_gib": {k: gib(v) for k, v in unchunked[3].items()},
          "mono_stage_peak_gib": {k: gib(v) for k, v in mono[3].items()}, "card": card})
    if not same:
        raise AssertionError("the chunked and unchunked T = 2^18 proofs differ")
    if not mono_same:
        raise AssertionError("the mono and T-mode T = 2^18 proofs differ")
    del small, chunked, unchunked, mono
    # (ii) the multi-point evaluation is exact at scale
    rng = np.random.default_rng(17)
    for t in (1 << 17, 1 << 20):
        check_multi_eval(rng, t)
    torch.cuda.empty_cache()

    run = LrRun(20)
    run.prepare()
    emit({"phase": "lr_large", "n_terms": run.n_terms, "ops": len(run.program.code),
          "trace_length": run.trace.length, "lde_domain": 8 * run.trace.length, "native_trace": True,
          **{f"{k}_seconds": v for k, v in run.seconds.items()}, "card": card})
    # the cold T-mode prove (the constants built), the steady one, then the
    # same trace in cls and in mono (each with its constants built); every
    # count set to 0 before each, read after it
    counts, proofs = {}, {}
    for path, name, mode in (("lr_large_cold", "cold", "tmode"), ("lr_large", "steady", "tmode"),
                             ("lr_large_cls", "cls", "cls"), ("lr_large_mono", "mono", "mono")):
        if mode == "mono":
            torch.cuda.empty_cache()  # the whole (28, 8, 2^23) LDE and its transform's copies
        kernel_health.reset()
        proofs[path], seconds, stages, peaks, peak = run.prove(DEV, mode)
        counts[path] = kernel_health.launches(), kernel_health.launches_by_shape()
        plain = kernel_health.plain_calls()
        emit({"phase": "lr_large", "prove": name, "mode": mode, "seconds": seconds,
              "rows_per_sec": run.trace.length / seconds, "stage_seconds": stages,
              "stage_peak_gib": {k: gib(v) for k, v in peaks.items()}, "peak_gib": gib(peak),
              "launches": counts[path][0], "launches_by_shape": counts[path][1], "plain_calls": plain,
              "card": card})
        check_path(path, *counts[path], plain)
        if path == "lr_large":
            # the trace and the composition trees have 2^23 leaves each:
            # the launches the Merkle entry reported for them, a tree
            trees, merkle_2_23 = mk.trees_by_size[1 << 23], mk.launches_by_size[1 << 23]
    steady = proofs["lr_large"].to_wire_bytes()
    for path in ("lr_large_cls", "lr_large_mono"):
        same = proofs[path].to_wire_bytes() == steady
        emit({"phase": "lr_large", "check": f"{path} equals the steady T-mode proof", "equal": same, "card": card})
        if not same:
            raise AssertionError(f"the {path} and T-mode proofs of the 2^20-row trace differ")
    launches, by_shape = counts["lr_large"]
    clear, verify_seconds, rejected = run.check(proofs["lr_large"])
    per_tree, rest = divmod(merkle_2_23, max(trees, 1))
    emit({"phase": "lr_large", "decrypted": clear, "expected": run.expected, "verified": True,
          "verify_seconds": verify_seconds, "tampered_rejected": rejected,
          "proof_bytes": len(steady), "launches": launches, "launches_by_shape": by_shape,
          "merkle_launches_per_tree_2^23": per_tree, "card": card})
    if trees != 2 or rest or not 0 < per_tree <= -(-23 // 10):
        raise AssertionError(f"the Merkle heap of 2^23 leaves: {trees} trees in the prove, "
                             f"{merkle_2_23} launches")
    return {path: launches for path, (launches, _) in counts.items()}


DIST_TIMEOUT = 300.0  # seconds for one spawned run


def dist_runs():
    """(world size, backend) of phase (h): one rank over NCCL; 2 and 4 ranks
    sharing cuda:0 over gloo (NCCL refuses ranks that share a card); and
    NCCL over min(cards, 4) ranks, one card each, where there is more than
    one card."""
    runs = [(1, "nccl"), (2, "gloo"), (4, "gloo")]
    if torch.cuda.device_count() > 1:
        runs.append((min(torch.cuda.device_count(), 4), "nccl"))
    return runs


def phase_dist(card, want):
    """(h): the bench's chain (T = 2^16) proved in mono over spawned ranks
    (``zkvm_torch.dist.run.prove_chain``: a warm-up prove, then the
    reported one): every rank's proof must be the bytes ``want`` (phase
    (e)'s), the proof must verify, and every rank must have launched K1,
    K2, K4, the Merkle heap and the batch inverse in the reported prove
    (counts set to 0 in each rank just before it, read just after).  Ranks
    that share one card over gloo contend for it and stage every
    collective through the host, so their seconds are not speed figures.
    Returns the launches summed over every rank of every run."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    torch.cuda.empty_cache()
    total = {name: 0 for name in kernel_health.FAMILIES}
    for world, backend in dist_runs():
        device = None if backend == "nccl" else str(DEV)
        t0 = time.perf_counter()
        ranks = multihost.spawn(dist_run.prove_chain, world, backend, device, args=(vm.BENCH_N_OPS, 3),
                                timeout=DIST_TIMEOUT)
        wall = time.perf_counter() - t0
        first = ranks[0]
        vm.verify_bytes(first["proof"], first["program_hash"], first["outputs"], key)
        same = all(r["proof"] == want for r in ranks)
        emit({"phase": "dist", "world": world, "backend": backend, "device": device or "cuda:rank",
              "shared_card": backend == "gloo" and world > 1,
              "trace_length": first["trace_length"], "wall_seconds": wall, "equals_phase_e": same,
              "verified": True, "card": card,
              "ranks": [{"rank": r["rank"], "cold_prove_seconds": r["cold_seconds"], "prove_seconds": r["seconds"],
                         "stage_seconds": r["stage_seconds"],
                         "stage_peak_gib": {k: gib(v) for k, v in r["stage_peaks"].items()},
                         "peak_gib": gib(r["peak_bytes"]), "launches": r["launches"],
                         "plain_calls": r["plain_calls"], "comm": r["comm"]}
                        for r in ranks]})
        if not same:
            raise AssertionError(f"dist: a proof over {world} {backend} ranks differs from phase (e)'s")
        for r in ranks:
            for name in MONO_KERNELS:
                if r["launches"][name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched on rank {r['rank']} of the "
                                         f"{world}-rank {backend} run")
            if r["launches"]["composition"] != 0:
                raise AssertionError("K3 launched on the sharded mono path")
            for name, n in (("multi_eval", 2), ("meval_ladders", 2), ("fri_fold", 3), ("weighted_sum", 2),
                            ("deep_quotient", 1)):
                if r["launches"][name] != n:
                    raise AssertionError(f"kernel {name} launched {r['launches'][name]} times on rank {r['rank']}, "
                                         f"expected {n} (the OOD frame's, a fold a layer, one row block's DEEP)")
            check_plain(f"rank {r['rank']} of the {world}-rank {backend} run", r["plain_calls"])
            staged = r["comm"]["host_staged_bytes"]
            if (backend == "gloo") != (staged > 0):
                raise AssertionError(f"dist: {staged} bytes staged through the host under {backend}")
            for name in total:
                total[name] += r["launches"][name]
    return total


SOURCES = {
    "ntt_stages": ("zkvm_torch/csrc/ntt_stages.cu", "zkvm/ntt/ntt_t.py:320"),
    "blake3_rows": ("zkvm_torch/csrc/blake3_rows.cu", "zkvm/hash/blake3_t.py:115"),
    "merkle": ("zkvm_torch/csrc/merkle.cu", "zkvm/hash/blake3_jax.py:178 merkle_flat (XLA, no Pallas)"),
    "composition": ("zkvm_torch/csrc/composition.cu", "zkvm/air/constraints_pallas.py:230"),
    "transition": ("zkvm_torch/csrc/transition.cu", "zkvm/air/constraints_pallas.py:378"),
    "batch_inverse": ("zkvm_torch/csrc/batch_inverse.cu",
                      "zkvm/field/jax_f128.py:310 batch_inverse (XLA, no Pallas)"),
    "field_ops": ("zkvm_torch/csrc/field_ops.cu",
                  "zkvm/field/jax_f128t.py:142 fadd, :148 fsub, :192 fmul (XLA, no Pallas)"),
    "multi_eval": ("zkvm_torch/csrc/multi_eval.cu",
                   "zkvm/prover/eval_mxu.py:45 _contract, :80 multi_eval_rows (XLA, no Pallas)"),
    "meval_ladders": ("zkvm_torch/csrc/multi_eval.cu",
                      "zkvm/prover/eval_mxu.py:72 _ladders (ntt_t.ladders_t; XLA, no Pallas)"),
    "fri_fold": ("zkvm_torch/csrc/fri_fold.cu",
                 "zkvm/prover/fri.py:104 _fold_core_t (its M = 8 iNTT K1, zkvm/ntt/ntt_t.py:320 _pallas_stages; "
                 "the rest XLA)"),
    "ladder": ("zkvm_torch/csrc/fri_fold.cu", "zkvm/ntt/ntt_t.py:185 ladder_t (XLA, no Pallas)"),
    "weighted_sum": ("zkvm_torch/csrc/deep.cu",
                     "zkvm/prover/pipeline.py:630-632 _stage_deep_cls's column sums (XLA, no Pallas)"),
    "deep_quotient": ("zkvm_torch/csrc/deep.cu",
                      "zkvm/prover/pipeline.py:641-643 _stage_deep_cls's quotient (XLA, no Pallas)"),
}


def main():
    card = phase_device()
    phase_build()
    results = phase_kernels()
    phase_conformance()
    runs = {mode: phase_bench(mode) for mode in MODES}
    by_path = {mode: launches for mode, (launches, _) in runs.items()}
    # the three layouts prove the same trace: their proofs must be the same bytes
    same = runs["tmode"][1] == runs["mono"][1] == runs["cls"][1]
    emit({"phase": "bench", "tmode_mono_cls_equal": same, "proof_bytes": len(runs["tmode"][1])})
    if not same:
        raise AssertionError("the T-mode, mono and cls proofs of the same trace differ")
    bench_proof = runs["tmode"][1]
    del runs
    torch.cuda.empty_cache()
    by_path.update(phase_lr_large(card))
    by_path["dist"] = phase_dist(card, bench_proof)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {mode: n[name] for mode, n in by_path.items()},
         **{k: results[name][k] for k in keys}, "library_ms": results[name].get("library_ms"),
         **({"library_call": results[name]["library_call"]} if "library_call" in results[name] else {})}
        for name in SOURCES
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
