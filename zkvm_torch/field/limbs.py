"""Host <-> limb conversion for f128 (no JAX).

A field element is 8 little-endian 16-bit limbs.  On the host the limbs are
``uint32`` numpy arrays with the limb axis last, exactly like
``zkvm.field.jax_f128.to_limbs``; in the port they are ``torch.int32``
tensors (same bits, values < 2^16), usually in the transposed ``(..., 8, N)``
layout.  :func:`from_numpy` / :func:`to_numpy` carry the JAX package's
arrays across in tests.
"""

from __future__ import annotations

import numpy as np
import torch

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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def tensor(vals, device="cpu") -> torch.Tensor:
    """Python ints -> int32 limb tensor, limbs last (..., 8)."""
    return from_numpy(to_limbs(vals), device)


def ttensor(vals, device="cpu") -> torch.Tensor:
    """Python ints -> transposed int32 limb tensor: (8,) or (8, n...)."""
    return from_numpy(tlimbs(vals), device)
