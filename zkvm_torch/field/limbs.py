"""Host <-> limb conversion for f128 (no JAX).

A field element is 8 little-endian 16-bit limbs.  On the host the limbs are
``uint32`` numpy arrays with the limb axis last, exactly like
``zkvm.field.jax_f128.to_limbs``; in the port they are ``torch.int32``
tensors (same bits, values < 2^16), usually in the transposed ``(..., 8, N)``
layout.  :func:`from_numpy` / :func:`to_numpy` carry the JAX package's
arrays across in tests.

:func:`limb_transpose` turns (C, N, 8) limbs, the trace generator's layout,
into (C, 8, N): the kernel ``csrc/limb_transpose.cu`` for a CUDA tensor (or
it raises), its plain version :func:`limb_transpose_plain` for a CPU
tensor.  The prover uploads a trace's limbs as they are with :func:`upload`
(a DMA where the generator left them page-locked) and turns them on the
card with it.
"""

from __future__ import annotations

import numpy as np
import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128

NLIMBS = 8
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
_U64 = (1 << 64) - 1


def to_limbs(vals) -> np.ndarray:
    """Python int / nested list of ints -> uint32 limb array (..., 8).

    Counterpart of ``jax_f128.to_limbs``: values are reduced mod p."""
    obj = lambda a: np.asarray(a, dtype=object)  # 0-d ops return bare ints
    arr = obj(obj(vals) % f128.P)
    lo = obj(arr & _U64).astype(np.uint64)
    hi = obj(arr >> 64).astype(np.uint64)
    out = np.empty(arr.shape + (NLIMBS,), dtype=np.uint32)
    for i in range(4):
        out[..., i] = (lo >> np.uint64(16 * i)) & np.uint64(MASK)
        out[..., 4 + i] = (hi >> np.uint64(16 * i)) & np.uint64(MASK)
    return out


def from_limbs(arr) -> np.ndarray:
    """uint32 limb array (..., 8) -> object ndarray of Python ints.

    A 0-d result comes back as a plain int, as in ``jax_f128.from_limbs``."""
    arr = np.asarray(arr).astype(np.uint64)
    lo = np.zeros(arr.shape[:-1], dtype=np.uint64)
    hi = np.zeros(arr.shape[:-1], dtype=np.uint64)
    for i in range(4):
        lo |= arr[..., i] << np.uint64(16 * i)
        hi |= arr[..., 4 + i] << np.uint64(16 * i)
    out = (hi.astype(object) << 64) | lo.astype(object)
    if np.ndim(out) == 0:  # numpy gives a bare int for a 0-d object result
        return int(out)
    return out


def tlimbs(vals) -> np.ndarray:
    """Python ints -> transposed limb array: (8,) scalar or (8, n...)."""
    arr = to_limbs(vals)
    return np.moveaxis(arr, -1, 0) if arr.ndim > 1 else arr


def from_t(arr) -> np.ndarray:
    """Transposed limb array (..., 8, N) -> object ndarray of ints (..., N)."""
    return from_limbs(np.moveaxis(np.asarray(arr), -2, -1))


def from_numpy(arr, device="cpu") -> torch.Tensor:
    """uint32 limb array (any layout) -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr), dtype=np.uint32).view(np.int32)).to(device)


def upload(arr, device) -> torch.Tensor:
    """:func:`from_numpy` for a trace's limbs, counted in the launch ledger
    (``kernels.launched``) as ``upload`` by host memory kind, ``pinned``
    or ``pageable``.

    A contiguous uint32 array in page-locked memory (the native generator's
    on a machine with a card) is copied by an asynchronous DMA on the current
    stream, so the caller keeps the array alive until the stream has passed
    the copy; any other array by the blocking copy of :func:`from_numpy`."""
    host = from_numpy(arr)  # on the array's own memory where it is contiguous uint32
    kind = "pinned" if host.is_pinned() else "pageable"
    kernels.count("upload", kind=kind)
    return host.to(device, non_blocking=kind == "pinned")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def tensor(vals, device="cpu") -> torch.Tensor:
    """Python ints -> int32 limb tensor, limbs last (..., 8)."""
    return from_numpy(to_limbs(vals), device)


def ttensor(vals, device="cpu") -> torch.Tensor:
    """Python ints -> transposed int32 limb tensor: (8,) or (8, n...)."""
    return from_numpy(tlimbs(vals), device)


# ---------------------------------------------------------------------------
# (C, N, 8) -> (C, 8, N): the kernel csrc/limb_transpose.cu
# ---------------------------------------------------------------------------

def limb_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """(C, N, 8) limbs -> contiguous (C, 8, N): the plain version."""
    return x.transpose(-2, -1).contiguous()


def _transpose_checked(x: torch.Tensor):
    """(C, N) of a transpose, after the checks the kernel's wrapper makes on
    every device: contiguous (C, N, 8) int32 limbs, not empty."""
    if x.dtype != torch.int32:
        raise TypeError(f"limb_transpose: expected int32 limbs, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] != NLIMBS or 0 in x.shape:
        raise ValueError(f"limb_transpose: shape {tuple(x.shape)}, expected (C, N, 8), not empty")
    if not x.is_contiguous():
        raise ValueError("limb_transpose: the limbs must be contiguous")
    return x.shape[0], x.shape[1]


def launch_limb_transpose(lib, stream, x: torch.Tensor) -> torch.Tensor:
    """Call the transpose entry point of ``lib``: contiguous (C, 8, N) of
    contiguous (C, N, 8) int32 limbs that start on a 16-byte boundary.  It
    copies nothing to the device, so it never waits for the stream."""
    c, n = _transpose_checked(x)
    if x.data_ptr() % 16:
        raise ValueError("limb_transpose: the limbs must start on a 16-byte boundary")
    out = torch.empty((c, NLIMBS, n), dtype=torch.int32, device=x.device)
    kernels.check(lib.zk_limb_transpose(kernels.ptr(x), kernels.ptr(out), c, n, stream), "zk_limb_transpose")
    kernels.count("limb_transpose", C=c, N=n)
    return out


def limb_transpose(x: torch.Tensor) -> torch.Tensor:
    """(C, N, 8) limbs -> contiguous (C, 8, N): one launch of the kernel for
    a CUDA tensor (or it raises), :func:`limb_transpose_plain` for a CPU
    tensor."""
    _transpose_checked(x)
    if x.device.type == "cpu":
        return limb_transpose_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"limb_transpose: no kernel for device {x.device}")
    return launch_limb_transpose(kernels.lib(), kernels.stream_of(x), x)
