"""The collectives of the sharded prover: the one module of the port that
calls :mod:`torch.distributed`.

The JAX package has no counterpart: there XLA inserts the collectives of a
``shard_map``.  Here every exchange is a named function on the limb
tensors of a :class:`zkvm_torch.dist.mesh.Mesh`:

* :func:`all_to_all`: equal chunks along one axis, chunk j to rank j (the
  three exchanges of the four-step NTT);
* :func:`all_gather`: every rank's block, concatenated along one axis in
  rank order;
* :func:`shift_from_right`: rank q receives rank q+1's tensor (mod P), the
  counterpart of the ``ppermute`` i -> i-1 of
  ``zkvm/air/constraints_dist.py:45``;
* :func:`barrier`.

Under NCCL the device tensors go as they are.  Gloo moves host tensors
only, so a CUDA tensor is copied to the host and back in the open, and the
bytes are counted in :data:`host_staged_bytes`.  Each call is counted by
operation (:data:`calls`), with the bytes this rank sends to other ranks
(:data:`bytes_sent`).  Every group is made with a time limit, so a rank
that dies makes the others' collectives fail instead of hanging.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import socket

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

calls = collections.Counter()  # collective calls in this process, by operation
bytes_sent = collections.Counter()  # bytes this rank sent to other ranks, by operation
host_staged_bytes = 0  # bytes copied between the card and the host for gloo (both ways)


def reset_counts() -> None:
    global host_staged_bytes
    calls.clear()
    bytes_sent.clear()
    host_staged_bytes = 0


def read_counts() -> dict:
    return {"calls": dict(calls), "bytes_sent": dict(bytes_sent), "host_staged_bytes": host_staged_bytes}


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def file_store(path: str, world_size: int):
    """A store in a file that every rank of one host opens (no TCP port)."""
    return dist.FileStore(path, world_size)


def init_group(backend: str, rank: int, world_size: int, store=None, init_method=None,
               timeout=DEFAULT_TIMEOUT) -> None:
    """Initialise the default process group, with a time limit on every
    collective."""
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world():
    """(rank, size, backend) of the default group."""
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def host_id() -> int:
    """A 62-bit number naming this host."""
    return int.from_bytes(hashlib.sha256(socket.gethostname().encode()).digest()[:8], "little") >> 2


def gather_host_ints(values, timeout=DEFAULT_TIMEOUT):
    """Every rank's list of ints, over a gloo group made for the call (host
    tensors only, so no NCCL collective runs before the caller has checked
    what the ranks hold); a list of lists in rank order."""
    group = dist.new_group(backend="gloo", timeout=timeout)
    try:
        mine = torch.tensor(list(values), dtype=torch.int64)
        out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(out, mine, group=group)
    finally:
        dist.destroy_process_group(group)
    return [t.tolist() for t in out]


# ---------------------------------------------------------------------------
# collectives on a mesh's tensors
# ---------------------------------------------------------------------------

def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to_backend(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tensor to hand to the backend: a host copy under gloo."""
    global host_staged_bytes
    x = x.contiguous()
    if mesh.backend == "gloo" and x.device.type != "cpu":
        host_staged_bytes += _nbytes(x)
        return x.cpu()
    return x


def _from_backend(y: torch.Tensor, device) -> torch.Tensor:
    global host_staged_bytes
    if y.device != device:
        host_staged_bytes += _nbytes(y)
        return y.to(device)
    return y


def all_to_all(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Split ``x`` along ``dim`` into P equal chunks and send chunk j to rank
    j; the result holds the chunks received, along ``dim`` in source-rank
    order (the shape of ``x``)."""
    p = mesh.size
    if x.shape[dim] % p:
        raise ValueError(f"all_to_all: axis {dim} of {tuple(x.shape)} does not split into {p} chunks")
    y = _to_backend(x.movedim(dim, 0), mesh)
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y)
    calls["all_to_all"] += 1
    bytes_sent["all_to_all"] += _nbytes(y) * (p - 1) // p
    return _from_backend(out, x.device).movedim(0, dim)


def all_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    y = _to_backend(x, mesh)
    out = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(out, y)
    calls["all_gather"] += 1
    bytes_sent["all_gather"] += _nbytes(y) * (mesh.size - 1)
    return _from_backend(torch.cat(out, dim=dim), x.device)


def shift_from_right(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank q's result is rank (q + 1) mod P's ``x`` (same shape on every
    rank): each rank sends to its left neighbour and receives from its
    right one.  With one rank, ``x`` itself."""
    p = mesh.size
    if p == 1:
        return x
    y = _to_backend(x, mesh)
    out = torch.empty_like(y)
    left, right = (mesh.rank - 1) % p, (mesh.rank + 1) % p
    ops = [dist.P2POp(dist.isend, y, left), dist.P2POp(dist.irecv, out, right)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    calls["shift_from_right"] += 1
    bytes_sent["shift_from_right"] += _nbytes(y)
    return _from_backend(out, x.device)


def barrier(mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
