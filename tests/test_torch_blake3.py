"""zkvm_torch BLAKE3 row hash (kernel K2's plain version) and Merkle heap
against the JAX reference: exact equality on inputs from numpy seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm.hash import blake3_jax as b3j
from zkvm.hash import blake3_t as jb3t
from zkvm.hash.blake3 import hash_elements
from zkvm.hash.merkle import MerkleTree
from zkvm_torch.field.limbs import from_numpy, from_t, to_limbs, to_numpy
from zkvm_torch.hash import blake3_t as tb3t
from zkvm_torch.hash import merkle as tmerkle

torch.set_num_threads(1)


def _rand_rows(seed, c, n):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**63, size=(2, c, n), dtype=np.int64)
    ints = [[int(a) << 64 | int(b) for a, b in zip(ra, rb)] for ra, rb in zip(*vals)]
    return np.swapaxes(to_limbs(ints), -1, -2)  # (c, 8, n)


@pytest.mark.parametrize("c", [28, 8])
def test_hash_rows_t_matches_reference(c):
    x = _rand_rows(c, c, 64)
    want = np.asarray(jb3t.hash_rows_t(jnp.asarray(x)))
    got = to_numpy(tb3t.hash_rows_t(from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    # and the golden (spec) hash of one row's 16-byte element encodings
    row = [int(v) for v in from_t(x)[:, 5]]
    assert got[:, 5].astype("<u4").tobytes() == hash_elements(row)


@pytest.mark.parametrize("n", [64, 1, 2])
def test_merkle_heap_matches_reference(n):
    """The CPU merkle_flat (the kernel's plain version, merkle_flat_plain)
    against the JAX heap; N = 1 is [0, leaf]."""
    rng = np.random.default_rng(3)
    leaves = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(b3j.merkle_flat(jnp.asarray(leaves)))
    got = tmerkle.merkle_flat(from_numpy(leaves))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(tmerkle.merkle_flat_plain(from_numpy(leaves))), want)
    if n > 1:
        np.testing.assert_array_equal(
            to_numpy(tmerkle.merge_t(from_numpy(leaves[0::2]), from_numpy(leaves[1::2]))), want[n // 2:n]
        )


def test_open_many_paths_verify():
    rng = np.random.default_rng(4)
    leaves = rng.integers(0, 2**32, size=(32, 8), dtype=np.uint64).astype(np.uint32)
    tree = tmerkle.DeviceMerkleTree(tmerkle.merkle_flat(from_numpy(leaves)))
    host = MerkleTree.from_leaves([leaves[i].astype("<u4").tobytes() for i in range(32)])
    assert tree.root == host.root
    positions = [0, 5, 17, 31]
    for p, path in zip(positions, tree.open_many(positions)):
        assert path == host.open(p)
        assert MerkleTree.verify(tree.root, p, leaves[p].astype("<u4").tobytes(), path)
        assert not MerkleTree.verify(tree.root, p ^ 1, leaves[p].astype("<u4").tobytes(), path)
