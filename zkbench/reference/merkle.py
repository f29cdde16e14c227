# Frozen copy of MerkleTree.verify from zkvm_torch/hash/merkle.py (the
# benchmark's yardstick: plain host code that imports nothing of the program).
"""Merkle authentication path check over BLAKE3 digests."""

from __future__ import annotations

from typing import List

from zkbench.reference.blake3 import merge


class MerkleTree:
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
