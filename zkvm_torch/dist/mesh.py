"""The mesh of the sharded prover: an initialised process group and the
device of this rank.

Port of :mod:`zkvm.dist.mesh`.  The JAX mesh names devices; here the
program is SPMD, one process a rank, and the mesh is what this process
knows of the group: its rank, the group's size and backend, and the device
its blocks live on.  Rank q owns rows [qL, (q+1)L) of every (..., 8, N)
tensor, L = N / P: :func:`row_block` is the counterpart of
``row_sharding`` (this rank's block of a whole tensor) and
:func:`replicated` that of ``replicated`` (the whole tensor on this rank's
device).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional

import torch

from . import comm


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D row mesh over the default process group.
    ``local_rank``: this rank's place among the group's ranks on its host
    (what picks its card by default)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "row"
    local_rank: int = 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of length n."""
        if n % self.size:
            raise ValueError(f"mesh of {self.size} ranks: {n} rows do not split evenly")
        block = n // self.size
        return slice(self.rank * block, (self.rank + 1) * block)


def local_ranks(host_ids) -> list:
    """Each rank's place among the ranks on its own host, in rank order
    (``host_ids``: one host id a rank, in rank order)."""
    seen = collections.Counter()
    out = []
    for host in host_ids:
        out.append(seen[host])
        seen[host] += 1
    return out


def default_card(backend: str, rank: int, local_rank: int, n_cards: int) -> int:
    """The card a rank takes when none is named: its local rank.  NCCL
    needs one card a rank, so a local rank past the host's cards raises;
    gloo ranks may share a card (the local rank modulo the cards)."""
    if backend == "gloo":
        return local_rank % n_cards
    if local_rank >= n_cards:
        raise ValueError(
            f"make_mesh: rank {rank} is rank {local_rank} on its host, which has {n_cards} card(s); "
            "NCCL needs one card a rank, so ranks that share a card must use backend='gloo'"
        )
    return local_rank


def _device(backend: str, rank: int, local_rank: int, device) -> torch.device:
    """This rank's device: the one named, else a card by
    :func:`default_card`.  No rank moves to the CPU unless the caller names
    it; under gloo without a card the prove then raises."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: backend nccl needs a CUDA card; use backend='gloo' on the CPU")
    if device is None:
        if not torch.cuda.is_available():
            return torch.device("cuda")
        return torch.device("cuda", default_card(backend, rank, local_rank, torch.cuda.device_count()))
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"make_mesh: backend nccl moves CUDA tensors, not {device}; use gloo")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise ValueError(f"make_mesh: rank {rank} names {device}, but this host has "
                             f"{torch.cuda.device_count()} card(s)")
    return device


def check_distinct_devices(placements) -> None:
    """Raise if two ranks hold the same (host, card): NCCL refuses ranks
    that share a card.  ``placements`` is one (host id, card index) a rank,
    in rank order."""
    seen = {}
    for rank, where in enumerate(placements):
        where = tuple(where)
        if where in seen:
            raise ValueError(
                f"make_mesh: ranks {seen[where]} and {rank} share cuda:{where[1]} on one host; "
                "NCCL needs one card a rank, so ranks that share a card must use backend='gloo'"
            )
        seen[where] = rank


def make_mesh(n_devices: Optional[int] = None, axis: str = "row", device=None) -> Mesh:
    """The mesh over the initialised default process group.

    ``n_devices``: the expected group size (raises if it differs).
    ``device``: this rank's device.  By default a card: the rank's place
    among the group's ranks on its host (from every rank's host id, so
    ranks on several hosts need no LOCAL_RANK).  Under NCCL ranks must hold
    distinct cards; under gloo they may share one (``device="cpu"`` for a
    run on the CPU), and the collectives stage a CUDA tensor through the
    host (:mod:`.comm`)."""
    if not comm.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialised; call "
            "zkvm_torch.dist.multihost.initialize() (or run under multihost.spawn) first"
        )
    rank, size, backend = comm.world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the process group has {size} ranks")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r}, expected nccl or gloo")
    local_rank = local_ranks([h for h, in comm.gather_host_ints([comm.host_id()])])[rank]
    device = _device(backend, rank, local_rank, device)
    if backend == "nccl":
        check_distinct_devices(comm.gather_host_ints([comm.host_id(), device.index]))
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(device)
    return Mesh(rank=rank, size=size, device=device, backend=backend, axis=axis, local_rank=local_rank)


def row_block(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last axis of a whole tensor, on its device."""
    return x[..., mesh.rows(x.shape[-1])].to(mesh.device).contiguous()


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor, on this rank's device."""
    return x.to(mesh.device)
