"""The trace commitment's root, worked out again in plain PyTorch: the
trace's low-degree extension over the coset ``g <w_D>`` (D = blowup T, g
the field's generator, natural order), a BLAKE3 hash of each row's 28
elements (16 bytes each, little-endian), and the binary Merkle tree over
the rows in domain order, each node the BLAKE3 hash of its two children's
digests.  The same definitions as :mod:`zkbench.reference.ntt`,
:mod:`zkbench.reference.blake3` and :mod:`zkbench.reference.merkle`, batched
over whole columns so that the root of a 2^20-row trace takes seconds on a
card instead of hours on the host.

A field element is 8 16-bit limbs, least significant first, each in [0,
2^16), its value below p, held on the first axis of an int64 tensor (8,
...), so that each limb is one contiguous slice.  A product of two limbs is
below 2^32 and a sum of eight below 2^35, so every step is exact in int64.
A 32-bit word of BLAKE3 is an int64 in [0, 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

from zkbench.reference import f128
from zkbench.reference.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT

M16 = 0xFFFF
M32 = 0xFFFFFFFF
# 2^128 = 45 2^40 - 1 (mod p), and 45 2^40 = 11520 2^32: limb 2 and up
FOLD_LIMB, FOLD_MUL = 2, 45 << 8
# columns extended at once (the transform's temporaries are some ten times
# a block's elements)
COLUMN_BLOCK = 4


def const(v: int, device, ndim: int = 1, limbs: int = 8) -> torch.Tensor:
    """(limbs, 1, ...) of ``ndim`` axes: the element v, to broadcast."""
    out = torch.tensor([(v >> (16 * i)) & M16 for i in range(limbs)], dtype=torch.int64, device=device)
    return out.reshape(limbs, *[1] * (ndim - 1))


def _carry(c: torch.Tensor) -> torch.Tensor:
    """The same value with every limb but the last in [0, 2^16); the last
    keeps the rest, signed."""
    out, carry = [], 0
    for i in range(c.shape[0] - 1):
        v = c[i] + carry
        out.append(v & M16)
        carry = v >> 16
    out.append(c[-1] + carry)
    return torch.stack(out)


def _below_p(x: torch.Tensor) -> torch.Tensor:
    """x mod p for 9-limb x in [0, 2p), carried: 8 limbs."""
    d = _carry(x - const(f128.P, x.device, x.dim(), limbs=9))
    return torch.where(d[-1:] < 0, x[:8], d[:8])


def _fold(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """L - H + 11520 2^32 H for x = L + 2^128 H (carried limbs, x >= 0):
    the same value mod p, in ``n_out`` carried limbs."""
    lo, hi = x[:8], x[8:]
    r = torch.zeros(n_out, *x.shape[1:], dtype=torch.int64, device=x.device)
    r[:8] += lo
    r[: hi.shape[0]] -= hi
    r[FOLD_LIMB: FOLD_LIMB + hi.shape[0]] += FOLD_MUL * hi
    return _carry(r)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    prod = torch.zeros(16, *a.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(8):
        prod[i: i + 8] += a[i: i + 1] * b
    x = _carry(prod)  # below p^2 < 2^256: 16 limbs
    x = _fold(x, 11)  # below 2^128 + 45 2^168
    x = _fold(x, 9)  # below 2^128 + 45 2^86
    x = _fold(x, 9)  # below 2^128
    return _below_p(x)


def _pad_limb(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[:1])])


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _below_p(_carry(_pad_limb(a + b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _below_p(_carry(_pad_limb(a - b + const(f128.P, a.device, a.dim()))))


def powers(w: int, n: int, device) -> torch.Tensor:
    """(8, n): w^0 .. w^(n-1)."""
    out = const(1, device, 2)
    while out.shape[1] < n:
        out = torch.cat([out, mul(out, const(pow(w, out.shape[1], f128.P), device, 2))], 1)
    return out[:, :n]


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def ntt(x: torch.Tensor, root: int) -> torch.Tensor:
    """Evaluations over <root> (n = x.shape[-1], natural order) of the
    polynomials whose coefficients are x (8, ..., n)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    table = powers(root, max(n // 2, 1), x.device)
    x = x[..., _bit_reverse(n, x.device)]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h)
        tw = table[:, :: n // (2 * h)][:, :h].reshape(8, *[1] * (len(lead) - 1), 1, h)
        t = mul(x[..., 1, :], tw)
        u = x[..., 0, :]
        x = torch.stack([add(u, t), sub(u, t)], dim=-2).reshape(*lead, n)
        h *= 2
    return x


def lde(values: torch.Tensor, blowup: int) -> torch.Tensor:
    """(8, C, T) values over <w_T> -> (8, C, blowup T) values of the same
    polynomials over g <w_D>."""
    t = values.shape[-1]
    inv_t = const(f128.finv(t), values.device, values.dim())
    coeffs = mul(ntt(values, f128.finv(f128.get_root_of_unity(t))), inv_t)
    coeffs = mul(coeffs, powers(f128.DOMAIN_OFFSET, t, values.device)[:, None, :])
    padded = torch.nn.functional.pad(coeffs, (0, (blowup - 1) * t))
    return ntt(padded, f128.get_root_of_unity(blowup * t))


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv: list, m: list, flags: int) -> list:
    """BLAKE3's compression of full 64-byte blocks at chunk counter 0, each
    word a tensor of the batch (or an int): the 8 words of the output's
    chaining value."""
    like = m[0]
    v = list(cv) + [torch.full_like(like, w) for w in (IV[0], IV[1], IV[2], IV[3], 0, 0, 64, flags)]
    v = [w if torch.is_tensor(w) else torch.full_like(like, w) for w in v]
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
    return [v[i] ^ v[i + 8] for i in range(8)]


def hash_rows(words: torch.Tensor) -> torch.Tensor:
    """(N, 16 k) words, k <= 16 whole blocks a row -> (N, 8): each row's
    BLAKE3 digest (one chunk)."""
    k = words.shape[1] // 16
    cv = list(IV)
    for j in range(k):
        flags = (CHUNK_START if j == 0 else 0) | (CHUNK_END | ROOT if j == k - 1 else 0)
        cv = compress(cv, [words[:, 16 * j + i] for i in range(16)], flags)
    return torch.stack(cv, 1)


def merkle_root(leaves: torch.Tensor) -> bytes:
    """(N, 8) digests of N = 2^k leaves -> the root's 32 bytes."""
    nodes = leaves
    while nodes.shape[0] > 1:
        nodes = hash_rows(nodes.reshape(-1, 16))
    return np.asarray(nodes[0].cpu(), dtype="<u4").tobytes()


def _words(elements: torch.Tensor) -> torch.Tensor:
    """(8, ...) limbs -> (4, ...) 32-bit words."""
    return elements[0::2] | (elements[1::2] << 16)


def trace_root(limbs: np.ndarray, blowup: int, device) -> bytes:
    """The Merkle root of the trace (C, T, 8 limbs) extended by ``blowup``."""
    c, t, _ = limbs.shape
    rows = torch.empty(blowup * t, c, 4, dtype=torch.int64, device=device)
    for c0 in range(0, c, COLUMN_BLOCK):
        block = torch.from_numpy(limbs[c0: c0 + COLUMN_BLOCK].astype(np.int64)).to(device).permute(2, 0, 1)
        rows[:, c0: c0 + block.shape[1]] = _words(lde(block, blowup)).permute(2, 1, 0)
        del block
    return merkle_root(hash_rows(rows.reshape(blowup * t, 4 * c)))
