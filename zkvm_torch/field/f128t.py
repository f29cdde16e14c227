"""f128 arithmetic on int32 limb tensors in the transposed layout (..., 8, N).

Port of :mod:`zkvm.field.jax_f128t` (and ``jax_f128.batch_inverse``) for
p = 2^128 - 45*2^40 + 1.  Inputs and outputs are canonical: int32 tensors
whose 8 limbs (axis -2) hold 16-bit values.

:func:`fadd`, :func:`fsub`, :func:`fmul` and :func:`fsquare` (and
:func:`fsum`, a pairwise tree of :func:`fadd`) dispatch on the device: a
CUDA tensor launches the kernel ``csrc/field_ops.cu`` (one launch a call,
broadcasting through strides; or it raises), a CPU tensor takes the plain
version, any other device raises.  The plain versions (``*_plain``) widen
to int64: 16x16-bit products and 8-term column sums stay far below 2^63,
and carries ripple limb by limb (arithmetic shifts also propagate
borrows).  Reduction folds the high half with eps = 2^128 mod p =
45*2^40 - 1 (three limbs), as the reference does; the canonical result is
the same bits whatever the carry scheme.  The yardsticks that hold the
kernels K1, K3, K4 and the batch inverse on the card call the plain
versions by name, so a fault in the kernels' shared ``zk::mul32`` cannot
hide on both sides of a check.

:func:`batch_inverse` is the kernel ``csrc/batch_inverse.cu`` for a CUDA
tensor (its plain version is :func:`batch_inverse_plain`).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple

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
# add / sub / mul: the plain versions
# ---------------------------------------------------------------------------

def fadd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    v = a.long() + b.long()
    l8, c = _carry(list(v.unbind(-2)))
    return _cond_sub_p(l8, c)


def fsub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


def fmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


def fsquare_plain(a: torch.Tensor) -> torch.Tensor:
    return fmul_plain(a, a)


def _pairwise_sum(add, a: torch.Tensor, axis: int) -> torch.Tensor:
    if axis < 0:
        axis += a.dim() - 2
    while a.shape[axis] > 1:
        n = a.shape[axis]
        half = n // 2
        s = add(a.narrow(axis, 0, half), a.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, a.narrow(axis, 2 * half, 1)], dim=axis)
        a = s
    return a.squeeze(axis)


def fsum_plain(a: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`fsum` by the plain addition."""
    return _pairwise_sum(fadd_plain, a, axis)


def fpow_const_plain(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for a host exponent (square and multiply)."""
    result = None
    for bit in bin(e)[2:]:
        if result is not None:
            result = fsquare_plain(result)
        if bit == "1":
            result = a if result is None else fmul_plain(result, a)
    return result


# ---------------------------------------------------------------------------
# add / sub / mul: the field-op kernel csrc/field_ops.cu
# ---------------------------------------------------------------------------

OPS = {"add": 0, "sub": 1, "mul": 2}  # the C entry's op codes
MAX_DIMS = 8  # element axes the kernel takes, after coalescing
op_launches = collections.Counter()  # launches of the field-op kernel in this process, by op
op_launches_by_shape = collections.Counter()  # the same, by (op, output elements)


@functools.lru_cache(maxsize=4096)
def _geometry(a_shape, a_stride, b_shape, b_stride):
    """(output shape, element axes, sizes, strides) of one kernel call:
    the broadcast shape of two (..., 8, N) operands and the C entry's host
    arrays (see ``zk_field_op``).  Element axes of length 1 are dropped and
    neighbours that every operand walks as one are merged, innermost last."""
    if len(a_shape) < 2 or len(b_shape) < 2 or a_shape[-2] != NLIMBS or b_shape[-2] != NLIMBS:
        raise ValueError(f"field op: shapes {tuple(a_shape)} and {tuple(b_shape)}, expected (..., 8, N)")
    n = max(len(a_shape), len(b_shape))
    shape = []
    for d in range(-n, 0):
        sa = a_shape[d] if -d <= len(a_shape) else 1
        sb = b_shape[d] if -d <= len(b_shape) else 1
        if sa != sb and 1 not in (sa, sb):
            raise ValueError(f"field op: shapes {tuple(a_shape)} and {tuple(b_shape)} do not broadcast")
        shape.append(sb if sa == 1 else sa)
    out_stride, acc = [0] * n, 1
    for d in range(n - 1, -1, -1):
        out_stride[d], acc = acc, acc * shape[d]
    operands = ((a_shape, a_stride), (b_shape, b_stride), (shape, out_stride))
    dims = []  # [size, stride of a, of b, of out]
    for d in (*range(n - 2), n - 1):
        size = shape[d]
        if size == 1:
            continue
        st = [0 if d < n - len(sh) or sh[d - n + len(sh)] == 1 else sd[d - n + len(sh)] for sh, sd in operands]
        if dims and all(p == q * size for p, q in zip(dims[-1][1:], st)):
            dims[-1] = [dims[-1][0] * size, *st]
        else:
            dims.append([size, *st])
    dims = dims or [[1, 0, 0, 0]]
    if len(dims) > MAX_DIMS:
        raise ValueError(f"field op: {len(dims)} element axes after coalescing, at most {MAX_DIMS}")
    nd = len(dims)
    sizes = (ctypes.c_long * nd)(*(d[0] for d in dims))
    strides = (ctypes.c_long * (3 * (nd + 1)))(
        *(v for j, (_, sd) in enumerate(operands) for v in (sd[-2], *(d[1 + j] for d in dims))))
    return torch.Size(shape), nd, sizes, strides


def _checked(a: torch.Tensor, b: torch.Tensor):
    """:func:`_geometry` of a call, after checking that both operands are
    int32 on one device."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"field op: expected int32 limbs, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"field op: operands on {a.device} and {b.device}")
    return _geometry(a.shape, a.stride(), b.shape, b.stride())


def launch_field_op(lib, stream, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Call the field-op entry point of ``lib``: ``op`` ("add", "sub",
    "mul") of int32 limbs a and b, (..., 8, N) each, on one device,
    broadcast against each other through their strides (nothing is
    copied).  Returns the contiguous output; an empty one without a
    launch.  It copies nothing to the device, so it never waits for the
    stream."""
    shape, nd, sizes, strides = _checked(a, b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if out.numel():
        p = kernels.ptr
        rc = lib.zk_field_op(OPS[op], nd, sizes, strides, p(a), p(b), p(out), stream)
        kernels.check(rc, "zk_field_op")
    return out


def _dispatch(op: str, plain, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    kind = a.device.type
    if kind == "cpu":
        _checked(a, b)  # what the kernel would refuse raises on the CPU too
        return plain(a, b)
    if kind != "cuda":
        raise ValueError(f"field op: no kernel for device {a.device}")
    out = launch_field_op(kernels.lib(), kernels.stream_of(a), op, a, b)
    if out.numel():
        op_launches[op] += 1
        op_launches_by_shape[(op, out.numel() // NLIMBS)] += 1
    return out


def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b of broadcast (..., 8, N) limbs: the field-op kernel for a CUDA
    tensor (or it raises), :func:`fadd_plain` for a CPU tensor."""
    return _dispatch("add", fadd_plain, a, b)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, as :func:`fadd` dispatches (:func:`fsub_plain` on the CPU)."""
    return _dispatch("sub", fsub_plain, a, b)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b, as :func:`fadd` dispatches (:func:`fmul_plain` on the CPU)."""
    return _dispatch("mul", fmul_plain, a, b)


def fsquare(a: torch.Tensor) -> torch.Tensor:
    return fmul(a, a)


def fsum(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum along a batch axis (axes before the (8, N) tail): a
    pairwise tree of :func:`fadd` (log2 of the axis's length launches on a
    card)."""
    return _pairwise_sum(fadd, a, axis)


class Arith(NamedTuple):
    """The three operations, for code that a yardstick shares with the
    main path: the yardstick passes :data:`PLAIN`, the main path the
    dispatching :data:`DISPATCH`."""

    fadd: Callable
    fsub: Callable
    fmul: Callable


PLAIN = Arith(fadd_plain, fsub_plain, fmul_plain)
DISPATCH = Arith(fadd, fsub, fmul)


# ---------------------------------------------------------------------------
# the batch inverse: csrc/batch_inverse.cu
# ---------------------------------------------------------------------------

launches = 0  # launches of the batch-inverse kernel in this process
launches_by_shape = collections.Counter()  # the same, by (R, N)


def batch_inverse_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the batch inverse: elementwise a^(p-2) (Fermat),
    zero -> zero, as ``jax_f128.batch_inverse`` (which uses Montgomery's
    trick; both give the unique canonical inverse)."""
    return fpow_const_plain(a, f128.P - 2)


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
