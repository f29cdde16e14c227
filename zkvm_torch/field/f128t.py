"""f128 arithmetic on int32 limb tensors in the transposed layout (..., 8, N).

Port of :mod:`zkvm.field.jax_f128t` (and ``jax_f128.batch_inverse``) for
p = 2^128 - 45*2^40 + 1.  Inputs and outputs are canonical: int32 tensors
whose 8 limbs (axis -2) hold 16-bit values.  Arithmetic widens to int64:
16x16-bit products and 8-term column sums stay far below 2^63, and carries
ripple limb by limb (arithmetic shifts also propagate borrows).  Reduction
folds the high half with eps = 2^128 mod p = 45*2^40 - 1 (three limbs), as
the reference does; the canonical result is the same bits whatever the
carry scheme.

This is plain PyTorch: it runs on whatever device its inputs are on.  The
CUDA kernels share the same arithmetic in ``csrc/f128.cuh``.  The one
exception is :func:`batch_inverse`, the kernel ``csrc/batch_inverse.cu``
for a CUDA tensor (its plain version is :func:`batch_inverse_plain`).
"""

from __future__ import annotations

import collections

import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128
from .limbs import MASK, NLIMBS

EPS = 45 * 2**40 - 1  # 2^128 mod p
_EPS_LIMBS = [(EPS >> (16 * i)) & MASK for i in range(3)]
_P_LIMBS = [(f128.P >> (16 * i)) & MASK for i in range(NLIMBS)]


def const_col(value: int, device="cpu") -> torch.Tensor:
    """Host int -> (8, 1) int32 limb column."""
    value %= f128.P
    return torch.tensor(
        [[(value >> (16 * i)) & MASK] for i in range(NLIMBS)],
        dtype=torch.int32,
        device=device,
    )


def constant(value: int, n: int, device="cpu") -> torch.Tensor:
    """Host int broadcast to an (8, n) limb tensor."""
    return const_col(value, device).expand(NLIMBS, n).contiguous()


def ones(n: int, device="cpu") -> torch.Tensor:
    return constant(1, n, device)


# ---------------------------------------------------------------------------
# carries (lists of int64 limb tensors, least significant first)
# ---------------------------------------------------------------------------

def _carry(cols):
    """Ripple carries through int64 columns -> (16-bit limbs, carry out).

    Columns may be negative (subtraction): the arithmetic shift carries the
    borrow, and the carry out is then negative."""
    out = []
    c = None
    for v in cols:
        if c is not None:
            v = v + c
        out.append(v & MASK)
        c = v >> 16
    return out, c


def _stack(limbs) -> torch.Tensor:
    return torch.stack(limbs, dim=-2).to(torch.int32)


def _cond_sub_p(l8, hi):
    """Canonical form of l8 + hi*2^128 < 2p (hi in {0, 1}): x - p equals
    x + eps - 2^128, so add eps and keep it where that overflows."""
    t = [l8[i] + _EPS_LIMBS[i] for i in range(3)] + list(l8[3:])
    t, c = _carry(t)
    ge = ((hi | c) != 0).unsqueeze(-2)
    return torch.where(ge, _stack(t), _stack(l8))


# ---------------------------------------------------------------------------
# add / sub / mul
# ---------------------------------------------------------------------------

def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    v = a.long() + b.long()
    l8, c = _carry(list(v.unbind(-2)))
    return _cond_sub_p(l8, c)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    v = a.long() - b.long()
    d, c = _carry(list(v.unbind(-2)))
    dp, _ = _carry([d[i] + _P_LIMBS[i] for i in range(NLIMBS)])
    return torch.where((c < 0).unsqueeze(-2), _stack(dp), _stack(d))


def _mul_cols(x, y):
    """Anti-diagonal column sums of two limb lists (tensors or ints)."""
    cols = [0] * (len(x) + len(y) - 1)
    for i, xi in enumerate(x):
        for j, yj in enumerate(y):
            cols[i + j] = cols[i + j] + xi * yj
    return cols


def _product_cols(a: torch.Tensor, b: torch.Tensor):
    """(..., 8, N) x (..., 8, N) -> the 15 int64 column sums of the 256-bit
    product, by skewing the (8, 8) outer product so anti-diagonals line up
    (row i shifted right by i) and summing rows."""
    prod = a.long().unsqueeze(-2) * b.long().unsqueeze(-3)  # (..., 8, 8, N)
    batch = prod.shape[:-3]
    n = prod.shape[-1]
    padded = torch.nn.functional.pad(prod, (0, 0, 0, NLIMBS))  # (..., 8, 16, N)
    flat = padded.reshape(batch + (2 * NLIMBS * NLIMBS, n))
    skew = flat[..., : NLIMBS * 15, :].reshape(batch + (NLIMBS, 15, n))
    return list(skew.sum(dim=-3).unbind(-2))


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 8x8 limb product + eps folds (the reference's bounds walk:
    256-bit product -> < 2^175 (11 limbs) -> < 2^129 -> two masked eps adds
    -> conditional subtract of p)."""
    a, b = torch.broadcast_tensors(a, b)
    l16, top = _carry(_product_cols(a, b))
    l16.append(top)  # value < p^2 < 2^256: the 16th limb is the last carry
    f1 = _mul_cols(l16[8:16], _EPS_LIMBS)  # 10 columns
    cols = [l16[i] + f1[i] if i < 8 else f1[i] for i in range(10)]
    l11, top = _carry(cols)
    l11.append(top)
    f2 = _mul_cols(l11[8:11], _EPS_LIMBS)  # 5 columns
    cols = [l11[i] + f2[i] if i < 5 else l11[i] for i in range(8)]
    l8, hi = _carry(cols)
    for _ in range(2):
        cols = [l8[i] + hi * _EPS_LIMBS[i] for i in range(3)] + l8[3:]
        l8, hi = _carry(cols)
    return _cond_sub_p(l8, hi)


def fsquare(a: torch.Tensor) -> torch.Tensor:
    return fmul(a, a)


def fsum(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum along a batch axis (axes before the (8, N) tail)."""
    if axis < 0:
        axis += a.dim() - 2
    while a.shape[axis] > 1:
        n = a.shape[axis]
        half = n // 2
        s = fadd(a.narrow(axis, 0, half), a.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, a.narrow(axis, 2 * half, 1)], dim=axis)
        a = s
    return a.squeeze(axis)


def fpow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for a host exponent (square and multiply)."""
    result = None
    for bit in bin(e)[2:]:
        if result is not None:
            result = fsquare(result)
        if bit == "1":
            result = a if result is None else fmul(result, a)
    return result


# ---------------------------------------------------------------------------
# the batch inverse: csrc/batch_inverse.cu
# ---------------------------------------------------------------------------

launches = 0  # launches of the batch-inverse kernel in this process
launches_by_shape = collections.Counter()  # the same, by (R, N)


def batch_inverse_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the batch inverse: elementwise a^(p-2) (Fermat),
    zero -> zero, as ``jax_f128.batch_inverse`` (which uses Montgomery's
    trick; both give the unique canonical inverse)."""
    return fpow_const(a, f128.P - 2)


def launch_batch_inverse(lib, stream, a: torch.Tensor) -> torch.Tensor:
    """Call the batch-inverse entry point of ``lib`` on contiguous int32
    limbs (..., 8, N), not empty; the leading dimensions are one axis R to
    the kernel.  It copies nothing to the device, so it never waits for
    the stream."""
    if a.dim() < 2 or a.shape[-2] != NLIMBS or a.numel() == 0:
        raise ValueError(f"batch_inverse: shape {tuple(a.shape)}, expected (..., 8, N), not empty")
    kernels.expect(a, a.shape, a.device, "a")
    n = a.shape[-1]
    out = torch.empty_like(a)
    rc = lib.zk_batch_inverse(kernels.ptr(a), kernels.ptr(out), a.numel() // (NLIMBS * n), n, stream)
    kernels.check(rc, "zk_batch_inverse")
    return out


def batch_inverse(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (..., 8, N) limbs, zero -> zero
    (``jax_f128.batch_inverse``): the kernel ``csrc/batch_inverse.cu``
    for a CUDA tensor (or it raises), :func:`batch_inverse_plain` for a
    CPU tensor."""
    global launches
    if a.device.type == "cpu":
        return batch_inverse_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"batch_inverse: no kernel for device {a.device}")
    out = launch_batch_inverse(kernels.lib(), kernels.stream_of(a), a.contiguous())
    launches += 1
    launches_by_shape[(a.numel() // (NLIMBS * a.shape[-1]), a.shape[-1])] += 1
    return out
