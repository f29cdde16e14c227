"""Merkle heap over BLAKE3 digests, built and kept on the device.

Port of ``blake3_jax.merge`` / ``merkle_flat`` and
``zkvm.hash.merkle.DeviceMerkleTree``.  The reference builds the tree in
XLA, outside any Pallas kernel; here :func:`merkle_flat` is the CUDA
kernel ``csrc/merkle.cu`` for a CUDA tensor (ceil(log2 N / 10) launches a
tree of N leaves, sharing K2's compress) and the plain PyTorch version, one vectorised
BLAKE3 compress per level, for a CPU tensor.

Heap layout (winter-crypto style): nodes[1] = root, children of i at 2i and
2i+1, leaf j at nodes[N + j], nodes[0] unused; digests are 8 little-endian
32-bit words (int32 bits), one row each.

Over a mesh (``zkvm_torch.dist``), :func:`merkle_forest_flat` builds each
rank's subtree and :class:`ShardedMerkleTree` joins the P subtree roots on
the host (``ShardedMerkleTree`` and ``blake3_jax.merkle_forest_flat`` of
the reference), with the root and paths of one tree over all the leaves.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence

import numpy as np
import torch

from zkvm_torch import kernels
from zkvm_torch.dist import comm
from zkvm_torch.hash.blake3 import CHUNK_END, CHUNK_START, IV, ROOT, merge
from zkvm_torch.field.limbs import to_numpy
from .blake3_t import compress, hash_rows_t, M32

_MERGE_FLAGS = CHUNK_START | CHUNK_END | ROOT


def _merge_t(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(8, N) x (8, N) int64 digest words -> (8, N) parent digests."""
    n = left.shape[-1]
    cv = torch.tensor(IV, dtype=torch.int64, device=left.device)[:, None].expand(8, n)
    return compress(cv, torch.cat([left, right], dim=0), 64, _MERGE_FLAGS)


def merge_t(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node of (..., 8) digest pairs: hash of the 64-byte
    concatenation (``blake3_jax.merge``)."""
    shape = left.shape
    l = left.reshape(-1, 8).transpose(0, 1).long() & M32
    r = right.reshape(-1, 8).transpose(0, 1).long() & M32
    return _merge_t(l, r).transpose(0, 1).to(torch.int32).reshape(shape)


def merkle_flat_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain version of the Merkle kernel: (N, 8) leaf digests -> (2N, 8)
    int32 heap (``blake3_jax.merkle_flat``)."""
    cur = leaves.transpose(0, 1).long() & M32  # (8, N)
    levels = [cur]
    while cur.shape[-1] > 1:
        cur = _merge_t(cur[:, 0::2], cur[:, 1::2])
        levels.append(cur)
    zero = cur.new_zeros(8, 1)
    heap = torch.cat([zero] + levels[::-1], dim=1)
    return heap.transpose(0, 1).to(torch.int32).contiguous()


launches = 0  # calls of the CUDA kernel's entry in this process (one a tree)
# by the tree's leaf count: the kernel launches the entry reported, and the trees
launches_by_size = collections.Counter()
trees_by_size = collections.Counter()


def launch_heap(lib, stream, leaves_8n: torch.Tensor):
    """Call the Merkle entry point of ``lib`` on (8, N) leaf digest words
    (N a power of two); returns the (2N, 8) heap and the kernel launches
    the entry made."""
    n = leaves_8n.shape[-1]
    kernels.expect(leaves_8n, (8, n), leaves_8n.device, "leaves")
    if n < 1 or n & (n - 1):
        raise ValueError(f"Merkle heap: {n} leaves, expected a power of two")
    heap = torch.empty((2 * n, 8), dtype=torch.int32, device=leaves_8n.device)
    made = ctypes.c_int(0)
    rc = lib.zk_merkle_heap(kernels.ptr(leaves_8n), kernels.ptr(heap), n, ctypes.byref(made), stream)
    kernels.check(rc, "zk_merkle_heap")
    return heap, made.value


def merkle_flat(leaves: torch.Tensor) -> torch.Tensor:
    """(N, 8) leaf digests (int32 bits) -> (2N, 8) heap
    (``blake3_jax.merkle_flat``).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises).  The provers pass the
    transposed view of (8, N) digests, which the kernel reads as it is."""
    global launches
    if leaves.device.type == "cpu":
        return merkle_flat_plain(leaves)
    if leaves.device.type != "cuda":
        raise ValueError(f"Merkle heap: no kernel for device {leaves.device}")
    leaves_8n = leaves.transpose(0, 1).contiguous()
    heap, made = launch_heap(kernels.lib(), kernels.stream_of(leaves_8n), leaves_8n)
    launches += 1
    n = leaves_8n.shape[-1]
    launches_by_size[n] += made
    trees_by_size[n] += 1
    return heap


class DeviceMerkleTree:
    """Merkle tree kept on the device as a (2N, 8) heap.

    Only the 32-byte root crosses to the host eagerly; :meth:`open_many`
    gathers the requested authentication paths on the device and moves
    just those nodes."""

    def __init__(self, nodes: torch.Tensor):
        self.nodes = nodes
        self.n = int(nodes.shape[0]) // 2
        self._root = None

    @property
    def root(self) -> bytes:
        if self._root is None:
            self._root = to_numpy(self.nodes[1]).astype("<u4").tobytes()
        return self._root

    @property
    def depth(self) -> int:
        return self.n.bit_length() - 1

    def _path_indices(self, position: int) -> List[int]:
        idx = []
        i = position + self.n
        while i > 1:
            idx.append(i ^ 1)
            i >>= 1
        return idx

    def open_many(self, positions: Sequence[int]) -> List[List[bytes]]:
        """Authentication paths (leaf -> root sibling digests)."""
        flat = [i for p in positions for i in self._path_indices(p)]
        index = torch.tensor(flat, dtype=torch.int64, device=self.nodes.device)
        arr = to_numpy(self.nodes.index_select(0, index)).astype("<u4")
        d = self.depth
        return [
            [arr[k * d + t].tobytes() for t in range(d)] for k in range(len(positions))
        ]


def merkle_forest_flat(rows_t: torch.Tensor) -> torch.Tensor:
    """This rank's subtree of a tree over row-sharded leaves: the BLAKE3
    hashes of its (C, 8, L) rows (kernel K2), then the Merkle heap kernel
    over them, (2L, 8).  No collective: a rank's rows are the leaves of one
    subtree of the whole tree (``blake3_jax.merkle_forest_flat``, whose
    forest layout puts rank q's heap at rows [2qL, 2(q+1)L))."""
    return merkle_flat(hash_rows_t(rows_t).transpose(0, 1))


class ShardedMerkleTree:
    """A Merkle tree over row-sharded leaves: each rank keeps the heap of
    its subtree on its device (:func:`merkle_forest_flat`); the P subtree
    roots are gathered and the host builds the top.

    Port of ``zkvm.hash.merkle.ShardedMerkleTree``: the root and the paths
    are those of :class:`DeviceMerkleTree` over the same leaves.  It is
    built and opened by every rank of the mesh at once (SPMD): the
    constructor and :meth:`open_many` are collectives."""

    def __init__(self, nodes: torch.Tensor, mesh):
        self.nodes = nodes  # (2L, 8) this rank's subtree heap
        self.mesh = mesh
        self.local_n = int(nodes.shape[0]) // 2
        self.n = self.local_n * mesh.size
        roots = to_numpy(comm.all_gather(nodes[1:2], mesh, dim=0)).astype("<u4")  # (P, 8)
        self.top = MerkleTree.from_leaves([roots[q].tobytes() for q in range(mesh.size)])

    @property
    def root(self) -> bytes:
        return self.top.root

    @property
    def depth(self) -> int:
        return self.n.bit_length() - 1

    def open_many(self, positions: Sequence[int]) -> List[List[bytes]]:
        """Authentication paths (leaf -> root sibling digests): the owner
        rank's path in its subtree, then the host top's.  Every rank
        gathers the same relative nodes of its heap; the owner's are kept."""
        d_local = self.local_n.bit_length() - 1
        local = [[] for _ in positions]
        if d_local:
            sub = DeviceMerkleTree(self.nodes)
            flat = [i for p in positions for i in sub._path_indices(p % self.local_n)]
            index = torch.tensor(flat, dtype=torch.int64, device=self.nodes.device)
            arr = to_numpy(comm.all_gather(self.nodes.index_select(0, index)[None], self.mesh, dim=0))
            arr = arr.astype("<u4")  # (P, Q d_local, 8)
            for k, p in enumerate(positions):
                rows = arr[p // self.local_n, k * d_local:(k + 1) * d_local]
                local[k] = [row.tobytes() for row in rows]
        return [path + self.top.open(p // self.local_n) for path, p in zip(local, positions)]


# Copy of zkvm/hash/merkle.py:137-186 (the host tree the verifier opens),
# word for word; tests/test_torch_prover.py pins it to the original.
class MerkleTree:
    def __init__(self, levels: List[List[bytes]]):
        self.levels = levels  # levels[0] = leaves ... levels[-1] = [root]

    @staticmethod
    def from_leaves(leaves: Sequence[bytes]) -> "MerkleTree":
        n = len(leaves)
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        levels = [list(leaves)]
        cur = list(leaves)
        while len(cur) > 1:
            cur = [merge(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
            levels.append(cur)
        return MerkleTree(levels)

    @staticmethod
    def from_device_levels(device_levels) -> "MerkleTree":
        """Adopt levels computed by blake3_jax.merkle_levels."""
        levels = []
        for lv in device_levels:
            arr = np.asarray(lv, dtype="<u4")
            levels.append([arr[i].tobytes() for i in range(arr.shape[0])])
        return MerkleTree(levels)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def open(self, index: int) -> List[bytes]:
        """Sibling digests from leaf to root (leaf itself not included)."""
        path = []
        for level in self.levels[:-1]:
            path.append(level[index ^ 1])
            index >>= 1
        return path

    @staticmethod
    def verify(root: bytes, index: int, leaf: bytes, path: List[bytes]) -> bool:
        node = leaf
        for sibling in path:
            if index & 1:
                node = merge(sibling, node)
            else:
                node = merge(node, sibling)
            index >>= 1
        return node == root
