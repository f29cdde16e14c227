# Frozen copy of zkvm_torch/hash/blake3.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Pure-Python BLAKE3-256 — golden model for transcripts and Merkle trees.

The reference commits and runs Fiat-Shamir with winterfell's
``Blake3_256`` (prover/src/lib.rs:13,44), i.e. the official BLAKE3 hash
truncated/standard 32-byte output.  Implemented here from the BLAKE3 spec:
single-chunk fast path (all transcript inputs and Merkle nodes are <= 1024
bytes) plus the binary-tree mode for longer inputs.

The batched TPU implementation (row hashing for Merkle commitments) lives in
:mod:`zkvm.hash.blake3_jax` and is tested against this module.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024

_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv, block_words, counter, block_len, flags):
    """The BLAKE3 compression function; returns 16 output words."""
    v = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    for i in range(8):
        v[i] ^= v[i + 8]
        v[i + 8] ^= cv[i]
    return v


def _words(block: bytes):
    return struct.unpack("<16I", block.ljust(BLOCK_LEN, b"\x00"))


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool):
    """Chaining value (or root words) for one <=1024-byte chunk."""
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)] or [b""]
    cv = list(IV)
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        out = compress(cv, _words(block), chunk_counter, len(block), flags)
        cv = out[:8]
    return cv


def _parent_cv(left_cv, right_cv, is_root: bool):
    block = left_cv + right_cv
    flags = PARENT | (ROOT if is_root else 0)
    return compress(list(IV), block, 0, BLOCK_LEN, flags)[:8]


def _tree_cv(data: bytes, chunk_offset: int, is_root: bool):
    if len(data) <= CHUNK_LEN:
        return _chunk_cv(data, chunk_offset, is_root)
    # left subtree gets the largest power-of-two number of chunks < total
    n_chunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    left_chunks = 1 << (n_chunks - 1).bit_length() - 1
    split = left_chunks * CHUNK_LEN
    left = _tree_cv(data[:split], chunk_offset, False)
    right = _tree_cv(data[split:], chunk_offset + left_chunks, False)
    return _parent_cv(left, right, is_root)


def blake3(data: bytes) -> bytes:
    """32-byte BLAKE3 hash of ``data``."""
    cv = _tree_cv(data, 0, True)
    return struct.pack("<8I", *cv)


# ---------------------------------------------------------------------------
# winterfell Hasher-interface helpers (winter-crypto Blake3_256 semantics)
# ---------------------------------------------------------------------------

def hash_elements(elements) -> bytes:
    """hash of the concatenated 16-byte LE element encodings."""
    from zkbench.reference.f128 import elements_to_bytes

    return blake3(elements_to_bytes(elements))


def merge(d1: bytes, d2: bytes) -> bytes:
    """hash of two concatenated 32-byte digests (Merkle node)."""
    return blake3(d1 + d2)


def merge_with_int(digest: bytes, value: int) -> bytes:
    """hash of digest || value as u64 LE (random-coin counter step)."""
    return blake3(digest + struct.pack("<Q", value))
