#!/usr/bin/env python3
"""Time the hand-written kernels K1-K4 and the Merkle heap on one CUDA card.

    python3 kernel_bench.py [--tree DIR] [--label NAME] [--only K1 K2 K3 K4 Merkle]
    python3 kernel_bench.py --sweep [K1 K2 K3 K4 Merkle] [--tree DIR] [--label NAME]
    python3 kernel_bench.py --sass [--tree DIR]

The first form times, at the cases of chip_smoke.py's phase (c), the
calls of the ``zkvm_torch`` package found in DIR (default: this checkout)
from the call the prover makes down to the C entry point:

  K1 (zkvm_torch/csrc/ntt_stages.cu):
    axis     ``ntt_t._axis_ntt`` (natural order in and out; with any layout
             gathers the tree does around the kernel),
    wrapper  ``ntt_t.pease_stages``,
    launch   ``ntt_t.launch_stages`` (the input checks and the C call),
    entry    the C entry point ``zk_ntt_stages`` alone;
  K2 (blake3_rows.cu), K3 (composition.cu), K4 (transition.cu) and the
  Merkle heap (merkle.cu):
    wrapper  ``blake3_t.hash_rows_t`` / ``composition.composition_t`` /
             ``transition.merged_transition`` / ``merkle.merkle_flat``,
    launch   ``launch_rows`` / ``launch_composition`` /
             ``launch_transition`` / ``launch_heap`` (the input checks,
             the constants the tree builds per call, the C call),
    entry    the C entry point alone, with the arguments that one launch
             call passed to it, recorded beforehand (see capture_entry).
  A tree without the Merkle kernel (the parent of its port) times its
  ``merkle_flat``, plain torch on the card, at the wrapper level alone.

For each it prints one JSON line: ``ms``, the card's milliseconds per
call with the calls queued behind a spin (see :func:`cuda_ms`);
``host_ms``, the host's milliseconds to queue one call; and, for K1,
``rate_ms``, three timings of back-to-back calls with no spin (a call
shorter than its host cost is then timed at the host's rate).  So the same
timer runs on two trees (unpack the other one with ``git archive``), in
one process each.  Before the cases it prints the registers and spills
that ptxas reported for each kernel of the tree's library.

``--sweep`` builds one kernel's source (DIR's) alone at each of its other
launch shapes (the ``-D`` defines of SWEEPS; one nvcc each, all started
together, into DIR's ``zkvm_torch/build/sweep``) and prints, for each shape and
case, ptxas's registers, ``ms`` and whether the output equals the plain
version.  The library that the package builds holds only the default
shape.

``--sass`` compiles a probe kernel for each f128 multiply that the tree's
``csrc/f128.cuh`` defines (``zk::mul``, ``zk::mul32``) and prints the
SASS opcode counts of each (cuobjdump), the probe's own loads, stores and
indexing included.

Every form first prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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

ROOT = Path(__file__).resolve().parent

# K1's cases in chip_smoke.py's phase (c): (M, B, NL, variants), the axes of
# the main paths (see there)
ALL3 = ("plain", "full", "r1")
K1_CASES = [(8, 1, 1 << 16, ALL3), (256, 28, 256, ALL3), (512, 1, 1024, ALL3),
            (512, 28, 1024, ("full",)), (32, 28 * 512, 32, ("plain", "full"))]
K1_SWEEP_CASES = [(256, 28, 256, "r1"), (256, 8, 256, "full"), (512, 28, 1024, "full"),
                  (32, 28 * 512, 32, "full"), (8, 1, 1 << 16, "plain"), (512, 1, 1024, "full")]
# The other launch shapes of each kernel, as -D defines; the first of each
# list is the shipped default.  K1: (tile, lanes, butterflies per thread).
# K3 / K4: threads per block, the blocks per SM that __launch_bounds__
# asks for (so the register cap: 65536 / (threads x blocks), at most 255)
# and threads per row (2: part A and part B of the body in separate warps).
AIR_SHAPES = [(128, 1, 1), (128, 3, 1), (128, 4, 1), (256, 2, 1), (64, 8, 1),
              (128, 4, 2), (128, 5, 2), (128, 6, 2), (256, 2, 2), (256, 3, 2), (64, 8, 2), (64, 10, 2),
              (64, 12, 2)]
K3_SHAPE, K4_SHAPE = (256, 2, 2), (256, 3, 2)  # the shipped defaults
# K2's cases in chip_smoke.py's phase (c): (C, N), trace rows (C = 28) and
# composition / FRI rows (C = 8), N = 2^16 a class in T-mode, 2^19 the
# whole domain in mono; and the Merkle heap's leaf counts: the trace and
# composition trees (2^19 leaves) and the FRI layers (2^16, 2^13, 2^10)
K2_CASES = [(28, 1 << 16), (8, 1 << 16), (28, 1 << 19), (8, 1 << 19)]
MERKLE_CASES = [1 << 19, 1 << 16, 1 << 13, 1 << 10]
# K2: threads a block, blocks an SM for __launch_bounds__; the first is the
# shipped default
K2_SHAPES = [(256, 2), (128, 1), (64, 1), (256, 1), (128, 4)]
SWEEPS = {
    "K1": ("ntt_stages.cu", "zk_ntt_stages", [
        {"ZK_K1_TILE": tile, "ZK_K1_LANES": lanes, "ZK_K1_PER_THREAD": k}
        for tile, lanes, k in [(2048, 8, 4)] + [(tile, 8, k) for tile in (1024, 2048, 4096)
                                                for k in (2, 4, 8) if (tile, k) != (2048, 4)]
        + [(tile, 4, k) for tile in (1024, 2048) for k in (2, 4)]]),
    "K2": ("blake3_rows.cu", "zk_blake3_rows", [
        {"ZK_K2_THREADS": th, "ZK_K2_MIN_BLOCKS": mb} for th, mb in K2_SHAPES]),
    # log2 of the leaves a block of the first launch takes
    "Merkle": ("merkle.cu", "zk_merkle_heap", [{"ZK_MERKLE_K": k} for k in (10, 8, 9, 11)]),
    "K3": ("composition.cu", "zk_composition", [
        {"ZK_AIR_THREADS": th, "ZK_AIR_MIN_BLOCKS": mb, "ZK_AIR_SPLIT": sp}
        for th, mb, sp in [K3_SHAPE] + [x for x in AIR_SHAPES if x != K3_SHAPE]]),
    "K4": ("transition.cu", "zk_transition", [
        {"ZK_AIR_THREADS": th, "ZK_AIR_MIN_BLOCKS": mb, "ZK_AIR_SPLIT": sp}
        for th, mb, sp in [K4_SHAPE] + [x for x in AIR_SHAPES if x != K4_SHAPE]]),
}


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


def _kernel_name(mangled):
    """A readable name of a mangled kernel: its identifier and, for a
    template on one int, that int (ntt_stages_kernel<8>)."""
    if not mangled.startswith("_Z"):  # extern "C"
        return mangled
    i, name = 2 + mangled.startswith("_ZN"), mangled
    while m := re.match(r"\d+", mangled[i:]):
        n = int(m.group())
        name, i = mangled[i + m.end():i + m.end() + n], i + m.end() + n
        if not name.startswith("_GLOBAL__N"):  # skip an anonymous namespace
            break
    arg = re.search(r"ILi(\d+)E", mangled)
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_summary(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from an
    ``nvcc -Xptxas -v`` log (spills in bytes)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def _limbs(rng, shape, dev):
    """Random canonical elements as (..., 8, L) int32 limbs."""
    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    limbs[..., 7, :] %= 0xFFFF
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def air_cases(limbs, dev, t=1 << 16):
    """K3 and K4 at the main paths' shapes, one case at a time: (name,
    kind, limb tensors, host arguments).  K3 is one class at T = 2^16 with
    the real boundary columns; K4 the mono shape (the full domain D = 2^19,
    next row +8, tables of period 128) and one class (T = 2^16, next row
    +1, 16-step patterns).  ``limbs(shape)`` makes random limbs on ``dev``;
    a smaller ``t`` is for rehearsing on the CPU."""
    from zkvm_torch import vm
    from zkvm_torch.air.periodic import periodic_class_patterns, periodic_table
    from zkvm_torch.field.limbs import from_numpy

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    assertions = vm.get_assertions(vm.PublicInputs((1, 2), tuple(range(16)), key), t)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)
    delta = key.parameters.delta
    mask, ark = periodic_class_patterns(t, 8)
    mask_cls = from_numpy(np.ascontiguousarray(mask[3].T), dev)
    ark_cls = from_numpy(np.ascontiguousarray(np.swapaxes(ark[3], -1, -2)), dev)
    rows = lambda k: limbs((8, k)).T.contiguous()  # (k, 8) limbs last
    yield (f"K3 T={t}", "composition",
           [limbs((28, 8, t)), mask_cls, ark_cls, limbs((8, t)), limbs((8, t)), limbs((8, t)), rows(20),
            rows(len(bcols0)), rows(len(bcols0)), rows(len(bcols1)), rows(len(bcols1))],
           (delta, bcols0, bcols1))
    tab = from_numpy(periodic_table(t, 8), dev)
    for name, n, step, mk, ak in [("mono", 8 * t, 8, tab[0], tab[1:].contiguous()),
                                  ("class", t, 1, mask_cls, ark_cls)]:
        yield f"K4 {name} N={n} step={step}", "transition", [limbs((28, 8, n)), mk, ak, rows(20)], (delta, step)


def air_calls(kind):
    """(wrapper, plain version, launch function) of K3 or K4."""
    from zkvm_torch.air import composition as cp
    from zkvm_torch.air import transition as tr

    if kind == "composition":
        return cp.composition_t, cp.composition_plain, cp.launch_composition
    return tr.merged_transition, tr.merged_transition_plain, tr.launch_transition


def _words(rng, shape, dev):
    """Random 32-bit words as an int32 tensor (digest words)."""
    return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def hash_cases(rng, dev, k2=K2_CASES, merkle=MERKLE_CASES):
    """K2 and the Merkle heap at the main paths' shapes, one case at a
    time: (name, kind, input tensors): K2 random limbs (C, 8, N), the
    Merkle heap random leaf digests (8, N), as the provers hold them."""
    for c, n in k2:
        yield f"K2 C={c} N={n}", "K2", [_limbs(rng, (c, 8, n), dev)]
    for n in merkle:
        yield f"Merkle N={n}", "Merkle", [_words(rng, (8, n), dev)]


def hash_calls(kind):
    """(wrapper, plain version, launch function) of K2 or the Merkle heap,
    each taking hash_cases' inputs; a tree without the Merkle kernel has
    no launch function, and its wrapper is plain torch."""
    from zkvm_torch.hash import blake3_t as b3t
    from zkvm_torch.hash import merkle as mk

    if kind == "K2":
        return b3t.hash_rows_t, b3t.hash_rows_plain, b3t.launch_rows
    plain = getattr(mk, "merkle_flat_plain", mk.merkle_flat)
    return (lambda l8n: mk.merkle_flat(l8n.T)), (lambda l8n: plain(l8n.T)), getattr(mk, "launch_heap", None)


class _Recorder:
    """A stand-in kernel library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def capture_entry(kernels, launch, *args):
    """(name, arguments, tensors) of the one C entry call that
    ``launch(lib, stream, *args)`` makes, recorded without launching: the
    tensors whose pointers it passed (the output and any constants it
    built) are returned too, to keep them alive while the entry is timed."""
    keep, real_ptr = [], kernels.ptr

    def ptr(t):
        keep.append(t)
        return real_ptr(t)

    rec = _Recorder()
    kernels.ptr = ptr
    try:
        launch(rec, kernels.stream_of(args[0]), *args)
    finally:
        kernels.ptr = real_ptr
    (name, cargs), = rec.calls
    return name, cargs, keep


def bench_tree(tree, label, only, reps=20):
    sys.path.insert(0, str(tree))
    from zkvm_torch import kernels
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_of(torch.empty(1, device=dev))
    _emit({"tree": label, "build_seconds": kernels.build_seconds, "ptxas": ptxas_summary(kernels.build_log)})
    rng = np.random.default_rng(20261017)
    for m, b, nl, variants in K1_CASES if "K1" in only else []:
        for variant in variants:
            y, tw, pre, r1 = _k1_inputs(nt, rng, m, b, nl, variant, dev)
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
    for name, kind, args in hash_cases(rng, dev):
        if kind not in only:
            continue
        wrapper, _, launch = hash_calls(kind)
        calls = {"wrapper": lambda: wrapper(*args)}
        if launch is not None:
            cname, cargs, keep = capture_entry(kernels, launch, *args)
            calls["launch"] = lambda: launch(lib, stream, *args)
            calls["entry"] = lambda: kernels.check(getattr(lib, cname)(*cargs), cname)
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
        del args, calls
        torch.cuda.empty_cache()
    for name, kind, args, host in air_cases(lambda shape: _limbs(rng, shape, dev), dev):
        if name.split()[0] not in only:
            continue
        wrapper, _, launch = air_calls(kind)
        cname, cargs, keep = capture_entry(kernels, launch, *args, *host)
        calls = {
            "wrapper": lambda: wrapper(*args, *host),
            "launch": lambda: launch(lib, stream, *args, *host),
            "entry": lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        }
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
        del args, cargs, keep
        torch.cuda.empty_cache()


def _k1_inputs(nt, rng, m, b, nl, variant, dev):
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


def _build_sweep(kernels, kernel):
    """One library of the kernel's source per launch shape of SWEEPS."""
    source, entry, shapes = SWEEPS[kernel]
    out = kernels.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    sos, procs = [], []
    for defs in shapes:
        tag = "_".join(str(v) for v in defs.values())
        so = out / f"{kernel}_{tag}_{kernels._digest()}.so"
        flags = [f"-D{k}={v}" for k, v in defs.items()]
        cmd = [nvcc, *kernels.NVCC_FLAGS, *flags, "-shared", "-o", str(so), str(kernels.CSRC / source)]
        sos.append(so)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for so, proc, defs in zip(sos, procs, shapes):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} at {defs}:\n{log[-4000:]}")
        _emit({"sweep_build": kernel, "tree": str(kernels.CSRC.parent.parent), "defines": defs,
               "ptxas": ptxas_summary(log)})
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = list(kernels.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def sweep(tree, label, kernels_to_sweep, reps=20):
    sys.path.insert(0, str(tree))
    from zkvm_torch import kernels
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    stream = kernels.stream_of(torch.empty(1, device=dev))
    rng = np.random.default_rng(4)
    for kernel in kernels_to_sweep:
        libs = _build_sweep(kernels, kernel)
        shapes = SWEEPS[kernel][2]
        if kernel == "K1":
            cases = []
            for m, b, nl, variant in K1_SWEEP_CASES:
                y, tw, pre, r1 = _k1_inputs(nt, rng, m, b, nl, variant, dev)
                cases.append((f"K1 M={m} B={b} NL={nl} {variant}", nt.stages_plain(y, tw, pre, r1),
                              lambda lib, y=y, tw=tw, pre=pre, r1=r1: nt.launch_stages(lib, stream, y, tw, pre, r1)))
        elif kernel in ("K2", "Merkle"):
            _, plain, launch = hash_calls(kernel)
            cases = [(name, plain(*args), lambda lib, a=args: launch(lib, stream, *a))
                     for name, kind, args in hash_cases(rng, dev) if kind == kernel]
        else:
            cases = []
            for name, kind, args, host in air_cases(lambda shape: _limbs(rng, shape, dev), dev):
                if name.startswith(kernel):
                    _, plain, launch = air_calls(kind)
                    cases.append((name, plain(*args, *host),
                                  lambda lib, a=args, h=host, f=launch: f(lib, stream, *a, *h)))
        for name, want, run in cases:
            for defs, lib in zip(shapes, libs):
                row = {"tree": label, "case": name, **defs}
                try:
                    exact = bool(torch.equal(run(lib), want))
                except RuntimeError as err:  # a shape the card refuses
                    _emit({**row, "error": str(err)})
                    continue
                ms, host_ms = cuda_ms(lambda: run(lib), reps)
                _emit({**row, "exact": exact, "ms": ms, "host_ms": host_ms})
        del cases
        torch.cuda.empty_cache()


def sass(tree):
    """SASS opcode counts of a probe kernel for each f128 multiply of the
    tree's f128.cuh."""
    sys.path.insert(0, str(ROOT))
    from zkvm_torch import kernels

    header = tree / "zkvm_torch" / "csrc" / "f128.cuh"
    text = header.read_text()
    out = kernels.BUILD / "sass_probe"
    out.mkdir(parents=True, exist_ok=True)
    probes = [f for f in ("mul", "mul32") if re.search(rf"\bfe {f}\(fe a, fe b\)", text)]
    src = [f'#include "{header}"']
    for f in probes:
        src.append(f'extern "C" __global__ void probe_{f}(const zk::fe* a, const zk::fe* b, zk::fe* o, int n) '
                   f"{{ int i = blockIdx.x * blockDim.x + threadIdx.x; if (i < n) o[i] = zk::{f}(a[i], b[i]); }}")
    cu = out / "probe.cu"
    cu.write_text("\n".join(src) + "\n")
    cubin = out / "probe.cubin"
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-o", str(cubin), str(cu)],
                   check=True, capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                      "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    for f in probes:
        ops = sass_opcodes(text, f"probe_{f}")
        _emit({"tree": str(tree), "sass_probe": f"zk::{f}", "total": sum(ops.values()), "opcodes": ops})


def sass_opcodes(sass_text, function):
    """Opcode counts of one function in cuobjdump -sass output."""
    body = sass_text.split(f"Function : {function}\n", 1)[1].split("Function : ", 1)[0]
    ops = {}
    for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)", body):
        ops[op] = ops.get(op, 0) + 1
    return ops


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose zkvm_torch is timed")
    ap.add_argument("--label", default="this", help="name of the tree in the output")
    ap.add_argument("--only", nargs="+", default=["K1", "K2", "K3", "K4", "Merkle"],
                    choices=["K1", "K2", "K3", "K4", "Merkle"],
                    help="kernels to time")
    ap.add_argument("--sweep", nargs="*", choices=list(SWEEPS), help="time these kernels at each shape of SWEEPS")
    ap.add_argument("--sass", action="store_true", help="SASS counts of the tree's f128 multiplies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: torch.cuda.is_available() is false; this needs a CUDA card")
    _card()
    if args.sweep is not None:
        sweep(args.tree.resolve(), args.label, args.sweep or list(SWEEPS))
    elif args.sass:
        sass(args.tree.resolve())
    else:
        bench_tree(args.tree.resolve(), args.label, args.only)


if __name__ == "__main__":
    main(sys.argv[1:])
