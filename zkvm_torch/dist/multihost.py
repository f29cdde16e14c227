"""Starting the sharded prover's ranks: one group over several hosts, or
spawned processes on one host.

Port of :mod:`zkvm.dist.multihost`.  The program is SPMD, one process a
rank: every rank joins the same group (:func:`initialize`, from
ZKVM_COORDINATOR, ZKVM_NUM_PROCESSES and ZKVM_PROCESS_ID, as the
reference's), builds the same mesh (``mesh.make_mesh``) and runs the same
prove.  :func:`replicate_to_hosts` gathers a row-sharded tensor to the
host on every rank.

:func:`spawn` runs a function on every rank of a group of processes
spawned on this host (the tests and ``chip_smoke.py`` use it): the group
meets in a ``FileStore`` in a temporary directory (no TCP port to clash
between concurrent runs), every collective has a time limit, and the
parent waits for the ranks with a time limit of its own; a rank that
raises, dies or overruns fails the run and the others are stopped.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch

from zkvm_torch.field.limbs import to_numpy
from . import comm
from .mesh import make_mesh

def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout=comm.DEFAULT_TIMEOUT) -> bool:
    """Join (or create) the process group; idempotent.  Returns whether a
    group is initialised.

    ``coordinator`` is ``host:port`` of rank 0.  The three values default
    to ZKVM_COORDINATOR / ZKVM_NUM_PROCESSES / ZKVM_PROCESS_ID; with none
    of them set it does nothing (one process, no group); with some set it
    raises.  ``backend``: NCCL where there is a card, else gloo."""
    if comm.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("ZKVM_COORDINATOR")
    n = num_processes if num_processes is not None else os.environ.get("ZKVM_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("ZKVM_PROCESS_ID")
    if coordinator is None and n is None and pid is None:
        return False  # one process: no group
    missing = [name for name, val in (("ZKVM_COORDINATOR", coordinator), ("ZKVM_NUM_PROCESSES", n),
                                      ("ZKVM_PROCESS_ID", pid)) if val is None]
    if missing:
        raise ValueError(
            "the process group's configuration is incomplete: missing " + ", ".join(missing)
            + " (set all of ZKVM_COORDINATOR, ZKVM_NUM_PROCESSES, ZKVM_PROCESS_ID, or none for one process)"
        )
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    comm.init_group(backend, int(pid), int(n), init_method=f"tcp://{coordinator}", timeout=timeout)
    return True


def replicate_to_hosts(x: torch.Tensor, mesh, dim: int = -1):
    """This rank's block of a row-sharded tensor -> the whole tensor as a
    host uint32 array, on every rank."""
    return to_numpy(comm.all_gather(x, mesh, dim))


# ---------------------------------------------------------------------------
# ranks spawned on this host
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, backend, device, store_path, group_timeout, target, args, results):
    """One spawned rank: join the group, run ``target(mesh, *args)``, report."""
    try:
        # the ranks of one host talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        comm.init_group(backend, rank, world_size, store=comm.file_store(store_path, world_size),
                        timeout=group_timeout)
        mesh = make_mesh(world_size, device=device)
        out = target(mesh, *args)
        comm.barrier(mesh)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        return
    comm.destroy()


def spawn(target, world_size: int, backend: str = "gloo", device=None, args=(), timeout: float = 300.0) -> list:
    """Run ``target(mesh, *args)`` on each of ``world_size`` spawned ranks
    (``torch.multiprocessing``, spawn method) and return the ranks'
    results in rank order.

    ``target`` must be importable by the children (a function of a module,
    not of ``__main__``) and return something picklable.  ``device``: each
    rank's device (the default is :func:`~.mesh.make_mesh`'s, cuda:rank
    on one host; gloo ranks may share a card, and ``"cpu"`` runs on the
    CPU).  ``timeout``: seconds the
    parent waits for all ranks; each collective's time limit is the
    smaller of ``timeout`` and 300 s.  Raises if a rank raises, dies or
    overruns, after stopping every rank."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="zkvm_dist_")
    limit = datetime.timedelta(seconds=min(timeout, 300.0))
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, world_size, backend, device, os.path.join(tmp, "store"), limit, target, args, results))
        for r in range(world_size)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done = {}
        while len(done) < world_size:
            if not results.empty():
                rank, ok, value = results.get()
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} of {world_size} failed:\n{value}")
                done[rank] = value
                continue
            dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
            if dead and results.empty():
                raise RuntimeError(f"spawn: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                   "without a result")
            if time.monotonic() > deadline:
                late = [r for r in range(world_size) if r not in done]
                raise TimeoutError(f"spawn: ranks {late} of {world_size} did not finish within {timeout} s")
            time.sleep(0.02)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
