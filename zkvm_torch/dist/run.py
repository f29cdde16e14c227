"""Per-rank programs for :func:`zkvm_torch.dist.multihost.spawn`, and a
command line that proves the bench chain over spawned ranks.

Each function takes the rank's mesh first and returns picklable host
values; the children import this module, never the caller's.

    python -m zkvm_torch.dist.run [--world 2] [--backend gloo] [--device cuda:0]
                                  [--n-ops 20000]

proves the bench's READ/ADD chain (``vm.read_add_chain``; 20000 ops is
T = 2^16, 40000 T = 2^17, 80000 T = 2^18) in mono over ``--world``
spawned ranks (gloo: every rank on ``--device``, the card by default;
nccl: rank r on cuda:r), requires every rank's proof to be the same bytes,
verifies it, and prints one JSON line a rank and a last line with the
result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import time
from dataclasses import replace

import torch

from zkvm_torch import kernels, vm
from zkvm_torch.air.constraints_dist import merged_transition_sharded
from zkvm_torch.config import ZkVmConfig
from zkvm_torch.field.limbs import from_numpy, to_numpy
from zkvm_torch.hash import merkle as mk
from zkvm_torch.prover.pipeline import prove as stark_prove
from zkvm_torch.utils import kernel_health
from . import comm, multihost
from .mesh import make_mesh, row_block
from .ntt_dist import coset_lde_sharded, intt_sharded, ntt_sharded
from .sharded import sharded_prove_step  # noqa: F401 (a program ``calls`` runs by name)


def reset_launches() -> None:
    """Every kernel's launch count (:mod:`zkvm_torch.utils.kernel_health`),
    and the collectives', to 0."""
    kernel_health.reset()
    comm.reset_counts()


# ---------------------------------------------------------------------------
# per-rank programs
# ---------------------------------------------------------------------------

def ntt_blocks(mesh, x_host, blowup):
    """This rank's blocks of ntt, intt and (of the first N / blowup rows as
    coefficients) the coset LDE of a whole (..., 8, N) uint32 array, and
    the collectives they made."""
    reset_launches()
    x = from_numpy(x_host, mesh.device)
    coeffs = x[..., : x.shape[-1] // blowup]
    out = {
        "ntt": to_numpy(ntt_sharded(row_block(mesh, x), mesh)),
        "intt": to_numpy(intt_sharded(row_block(mesh, x), mesh)),
        "lde": to_numpy(coset_lde_sharded(row_block(mesh, coeffs), blowup, mesh)),
    }
    return dict(out, comm=comm.read_counts())


def transition_block(mesh, lde_host, mask_host, ark_host, alphas_host, delta, step):
    """This rank's block of the merged transition over a whole (28, 8, N)
    LDE."""
    args = [from_numpy(a, mesh.device) for a in (mask_host, ark_host, alphas_host)]
    lde = row_block(mesh, from_numpy(lde_host, mesh.device))
    return to_numpy(merged_transition_sharded(lde, *args, delta, step, mesh))


def forest(mesh, rows_host, positions):
    """Root and paths of the sharded tree over a whole (C, 8, N) array's
    rows."""
    rows = row_block(mesh, from_numpy(rows_host, mesh.device))
    tree = mk.ShardedMerkleTree(mk.merkle_forest_flat(rows), mesh)
    return tree.root, tree.open_many(positions)


def _prove_once(mesh, program, inputs, trace, use_native, via_vm):
    """One prove over the mesh: (proof, outputs, stage seconds, stage peaks)."""
    stages, peaks = {}, ({} if mesh.device.type == "cuda" else None)
    if via_vm:
        cfg = ZkVmConfig().with_mesh(mesh.size)
        cfg = replace(cfg, runtime=replace(cfg.runtime, use_native_trace=use_native))
        _, outputs, proof = vm.prove(program, inputs, device=mesh.device, config=cfg)
        return proof, outputs, stages, peaks
    pub = vm.PublicInputs(program.hash, trace.outputs, inputs.server_key)
    proof = stark_prove(trace, pub, mesh=mesh, stage_seconds=stages, stage_peaks=peaks)
    return proof, trace.outputs, stages, peaks


def _timed(mesh, fn):
    """(fn's result, its seconds), the card synchronised at both ends."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return out, time.perf_counter() - t0


def _prove(mesh, program, inputs, use_native, via_vm, warmup=False):
    """Prove a program run in mono over the mesh; see :func:`prove_program`.
    With ``warmup``, a first (cold) prove runs before the reported one."""
    trace = None if via_vm else vm.run(program, inputs, use_native)
    prove = lambda: _prove_once(mesh, program, inputs, trace, use_native, via_vm)
    cold = _timed(mesh, prove)[1] if warmup else None
    reset_launches()
    (proof, outputs, stages, peaks), seconds = _timed(mesh, prove)
    return {
        "rank": mesh.rank, "proof": proof.to_wire_bytes(), "program_hash": program.hash, "outputs": outputs,
        "trace_length": proof.trace_length, "seconds": seconds, "cold_seconds": cold,
        "stage_seconds": stages, "stage_peaks": peaks or {}, "launches": kernel_health.launches(),
        "launches_by_shape": kernel_health.launches_by_shape(),
        "plain_calls": kernel_health.plain_calls(), "comm": comm.read_counts(),
        "peak_bytes": max(peaks.values()) if peaks else None,  # each stage resets the peak
    }


def prove_program(mesh, source, tape, secrets=(), key_seed=7, use_native=True, via_vm=False):
    """Prove a program in mono over the mesh (the key from
    ``random.Random(key_seed)``, which encrypts ``secrets``); every rank
    returns its proof bytes, the program hash and outputs, its launches per
    kernel and by shape (counts set to 0 just before the prove, read just
    after), its
    collectives, its seconds (the card synchronised), its stage seconds and
    peaks, and its peak device bytes (on a card).
    ``via_vm``: through ``vm.prove(config=ZkVmConfig().with_mesh(P))``."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(key_seed))
    inputs = vm.ProgramInputs(tuple(tape), tuple(key.encrypt(s) for s in secrets), key)
    return _prove(mesh, vm.Program.compile(source), inputs, use_native, via_vm)


def prove_chain(mesh, n_ops, key_seed=3, warmup=True):
    """The bench's READ/ADD chain (``vm.read_add_chain``), proved as
    :func:`prove_program` does, by default after a warm-up prove (its
    seconds are ``cold_seconds``)."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(key_seed))
    return _prove(mesh, *vm.read_add_chain(n_ops, key), use_native=True, via_vm=False, warmup=warmup)


def comm_ops(mesh):
    """Each collective on small tensors that name their rank: all_to_all,
    all_gather and shift_from_right, as host arrays."""
    x = torch.arange(mesh.size * 3, dtype=torch.int32, device=mesh.device).reshape(1, mesh.size * 3)
    x = x + 100 * mesh.rank
    return {
        "all_to_all": to_numpy(comm.all_to_all(x, mesh, dim=-1)),
        "all_gather": to_numpy(comm.all_gather(x, mesh, dim=0)),
        "shift_from_right": to_numpy(comm.shift_from_right(x, mesh)),
        "replicated": multihost.replicate_to_hosts(x, mesh),
    }


def calls(mesh, todo):
    """Several of this module's programs in one spawn: ``todo`` lists
    (name, args); their results, in order."""
    return [globals()[name](mesh, *args) for name, args in todo]


def join_from_env(env, out_dir):
    """A rank started without ``spawn``: joins the group through ``multihost.initialize``
    from the ZKVM_* variables in ``env``, with LOCAL_RANK unset, and
    writes its rank, its local rank and the device ``make_mesh`` chose to
    ``out_dir/<rank>.json``."""
    os.environ.pop("LOCAL_RANK", None)
    os.environ.update(env)
    multihost.initialize(backend="gloo")
    mesh = make_mesh()
    path = os.path.join(out_dir, f"{mesh.rank}.json")
    with open(path, "w") as f:
        json.dump({"rank": mesh.rank, "local_rank": mesh.local_rank, "device": str(mesh.device)}, f)
    comm.destroy()


def fail_on_rank(mesh, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective for it."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    comm.all_gather(torch.zeros(8, 1, dtype=torch.int32, device=mesh.device), mesh, dim=-1)
    return mesh.rank


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None, help="gloo: every rank's device (default cuda:0)")
    ap.add_argument("--n-ops", type=int, default=vm.BENCH_N_OPS, help="the chain's length (sets T)")
    args = ap.parse_args(argv)
    device = None if args.backend == "nccl" else (args.device or "cuda:0")
    if args.backend == "nccl" or torch.device(device).type == "cuda":
        kernels.build()  # once, before the ranks start
    t0 = time.perf_counter()
    ranks = multihost.spawn(prove_chain, args.world, args.backend, device, args=(args.n_ops,),
                            timeout=900.0)
    wall = time.perf_counter() - t0
    for r in ranks:
        print(json.dumps({k: v for k, v in r.items() if k not in ("proof", "program_hash", "outputs")}),
              flush=True)
    first = ranks[0]
    same = all(r["proof"] == first["proof"] for r in ranks)
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    vm.verify_bytes(first["proof"], first["program_hash"], first["outputs"], key)
    print(json.dumps({"world": args.world, "backend": args.backend, "device": device,
                      "trace_length": first["trace_length"], "ranks_equal": same, "verified": True,
                      "proof_sha256_16": hashlib.sha256(first["proof"]).hexdigest()[:16],
                      "wall_seconds": wall}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
