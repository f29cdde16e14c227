"""Structure-of-arrays BLAKE3-256 row hashing over (C, 8, N) limbs.

Port of :mod:`zkvm.hash.blake3_t` (``hash_rows_t``): lane n's row of C
field elements, as 16-byte little-endian encodings, hashed as one BLAKE3
chunk (winterfell ``Blake3_256::hash_elements``).  :func:`hash_rows_t` is
kernel K2 (``csrc/blake3_rows.cu``) for a CUDA tensor and the plain PyTorch
version below for a CPU tensor.

The plain version keeps the 16-word state as a (16, N) int64 tensor of
32-bit words and runs each G step on four columns (or diagonals) at once,
as ``blake3_jax._compress`` does; adds and rotations mask with 0xFFFFFFFF.
"""

from __future__ import annotations

import torch

from zkvm_torch.hash.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT
from zkvm_torch import kernels

M32 = 0xFFFFFFFF
_PERM = list(MSG_PERMUTATION)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(cv: torch.Tensor, m: torch.Tensor, block_len: int, flags: int) -> torch.Tensor:
    """BLAKE3 compression, counter 0: cv (8, N), m (16, N) int64 words ->
    the new chaining value (8, N) (output words 0..7)."""
    n = cv.shape[-1]
    a, b = cv[0:4], cv[4:8]
    c = torch.tensor(IV[0:4], dtype=torch.int64, device=cv.device)[:, None].expand(4, n)
    d = torch.tensor([0, 0, block_len, flags], dtype=torch.int64, device=cv.device)[:, None].expand(4, n)
    for r in range(7):
        a, b, c, d = _g(a, b, c, d, m[0:8:2], m[1:8:2])
        # diagonals: rotate rows b, c, d left by 1, 2, 3
        b1, c1, d1 = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b1, c1, d1 = _g(a, b1, c1, d1, m[8:16:2], m[9:16:2])
        b, c, d = b1.roll(1, 0), c1.roll(2, 0), d1.roll(3, 0)
        if r < 6:
            m = m[_PERM]
    return torch.cat([a ^ c, b ^ d], dim=0)


def hash_words(words: torch.Tensor) -> torch.Tensor:
    """(W, N) int64 message words per lane -> (8, N) int64 digest words."""
    total, n = words.shape
    nbytes = total * 4
    n_blocks = max(1, (total + 15) // 16)
    pad = n_blocks * 16 - total
    if pad:
        words = torch.cat([words, words.new_zeros(pad, n)], dim=0)
    cv = torch.tensor(IV, dtype=torch.int64, device=words.device)[:, None].expand(8, n)
    for bi in range(n_blocks):
        flags = (CHUNK_START if bi == 0 else 0) | ((CHUNK_END | ROOT) if bi == n_blocks - 1 else 0)
        blen = 64
        if bi == n_blocks - 1 and nbytes % 64:
            blen = nbytes % 64
        cv = compress(cv, words[16 * bi : 16 * (bi + 1)], blen, flags)
    return cv


def hash_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (C, 8, N) limbs -> (8, N) int32 digest words."""
    c, _, n = x.shape
    x = x.long()
    words = (x[:, 0::2, :] | (x[:, 1::2, :] << 16)).reshape(c * 4, n)
    return hash_words(words).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel K2
# ---------------------------------------------------------------------------

def launch_rows(lib, stream, x: torch.Tensor) -> torch.Tensor:
    """Call the K2 entry point of ``lib`` on (C, 8, N) limbs."""
    c, _, n = x.shape
    kernels.expect(x, (c, 8, n), x.device, "x")
    out = torch.empty((8, n), dtype=torch.int32, device=x.device)
    rc = lib.zk_blake3_rows(kernels.ptr(x), kernels.ptr(out), c, n, stream)
    kernels.check(rc, "zk_blake3_rows")
    kernels.count("blake3_rows", C=c, N=n)
    return out


def hash_rows_t(x: torch.Tensor) -> torch.Tensor:
    """K2: transposed rows (C, 8, N) -> (8, N) digest words (int32 bits).

    Equal to blake3_jax.hash_rows of the (N, C, 8) view, transposed.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if x.device.type == "cpu":
        return hash_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row hash: no kernel for device {x.device}")
    return launch_rows(kernels.lib(), kernels.stream_of(x), x.contiguous())
