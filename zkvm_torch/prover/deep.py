"""The DEEP combination's device work: the weighted column sums and the
quotient.

The reference writes both inside one jit that XLA fuses
(``zkvm/prover/pipeline.py:616 _stage_deep_cls``, ``_stage_deep``):

- :func:`weighted_sum`: out[k] = sum_c w[k][c] cols[c] for K weight sets
  (host ints, the transcript's gammas, deltas, epsilons) over (C, 8, N)
  columns, strided ones included;
- :func:`deep_quotient`: y = sum_k (vals[k] - at[k]) inv[k] over (K, 8, N)
  values and inverses, at[k] host ints.

On a CUDA tensor each is one launch of ``csrc/deep.cu`` (or it raises: no
fallback), its host ints by value, so nothing is copied to the card; on a
CPU tensor each takes its plain version, whose arithmetic is the plain
int64 one by name (``f128t.*_plain``).  The plain sums go in blocks of
:data:`COLUMN_BLOCK` columns: the plain multiply's int64 transients are
~48 bytes an operand byte, so a block holds a seventh of a one-shot
product's over 28 columns.  Field addition is exact and commutative, so
every form gives the same values.
"""

from __future__ import annotations

from typing import Sequence

import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import NLIMBS, tensor

COLUMN_BLOCK = 4  # columns a plain product
MAX_K = 4  # weight sets a sum, terms a quotient (csrc/deep.cu kMaxK)
MAX_WEIGHTS = 128  # K C of a sum (csrc/deep.cu kMaxWeights)


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """t itself where its lanes are contiguous, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


# ---------------------------------------------------------------------------
# the weighted column sums
# ---------------------------------------------------------------------------

def weighted_sum_plain(cols: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """sum_c w[c] cols[c] of (C, 8, N) columns and (C, 8) weights, (8, N),
    in the plain arithmetic, COLUMN_BLOCK columns a product."""
    acc = None
    for c0 in range(0, cols.shape[0], COLUMN_BLOCK):
        blk = slice(c0, c0 + COLUMN_BLOCK)
        part = ft.fsum_plain(ft.fmul_plain(cols[blk], w_t[blk, :, None]), axis=0)
        acc = part if acc is None else ft.fadd_plain(acc, part)
    return acc


def _sum_checked(cols: torch.Tensor, weights, out):
    """(K, C, N) of a sum, after the checks the kernel's wrapper makes on
    every device: (C, 8, N) int32 columns, K <= MAX_K sets of C weights,
    K C <= MAX_WEIGHTS, ``out`` (K, 8, N) contiguous int32 on the columns'
    device where given."""
    if cols.dim() != 3 or cols.shape[1] != NLIMBS or 0 in cols.shape:
        raise ValueError(f"weighted_sum: columns of shape {tuple(cols.shape)}, expected (C, 8, N)")
    if cols.dtype != torch.int32:
        raise TypeError(f"weighted_sum: expected int32 limbs, got {cols.dtype}")
    c, _, n = cols.shape
    k = len(weights)
    if not 1 <= k <= MAX_K or any(len(w) != c for w in weights) or k * c > MAX_WEIGHTS:
        raise ValueError(f"weighted_sum: {[len(w) for w in weights]} weights for {c} columns; at most {MAX_K} "
                         f"sets and {MAX_WEIGHTS} weights")
    if out is not None:
        kernels.expect(out, (k, NLIMBS, n), cols.device, "out")
    return k, c, n


def launch_weighted_sum(lib, stream, cols: torch.Tensor, weights: Sequence[Sequence[int]], out=None):
    """Call the weighted-sum entry point of ``lib``: (K, 8, N) sums of the
    columns (read through their column and limb strides) by K sets of
    canonical host-int weights, into ``out`` where given.  The weights go
    by value, so it copies nothing to the device and never waits for the
    stream."""
    k, c, n = _sum_checked(cols, weights, out)
    cols = _lanes(cols)
    if out is None:
        out = torch.empty((k, NLIMBS, n), dtype=torch.int32, device=cols.device)
    rc = lib.zk_weighted_sum(kernels.ptr(cols), cols.stride(0), cols.stride(1),
                             kernels.words([v for w in weights for v in w]), kernels.ptr(out), k, c, n, stream)
    kernels.check(rc, "zk_weighted_sum")
    kernels.count("weighted_sum", K=k, C=c, N=n)
    return out


def weighted_sum(cols: torch.Tensor, weights: Sequence[Sequence[int]], out=None) -> torch.Tensor:
    """(K, 8, N): sum_c weights[k][c] cols[c] for each of K sets of host-int
    weights over (C, 8, N) columns, into ``out`` where given.  A CUDA
    tensor launches the kernel once (or it raises), a CPU tensor takes
    :func:`weighted_sum_plain` a set."""
    _sum_checked(cols, weights, out)
    if cols.device.type == "cpu":
        sums = torch.stack([weighted_sum_plain(cols, tensor(list(w), cols.device)) for w in weights])
        return sums if out is None else out.copy_(sums)
    if cols.device.type != "cuda":
        raise ValueError(f"weighted_sum: no kernel for device {cols.device}")
    return launch_weighted_sum(kernels.lib(), kernels.stream_of(cols), cols, weights, out)


# ---------------------------------------------------------------------------
# the quotient
# ---------------------------------------------------------------------------

def deep_quotient_plain(vals: torch.Tensor, at_t: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """sum_k (vals[k] - at[k]) inv[k], (8, N), in the plain arithmetic; at_t
    (K, 8) limbs."""
    return ft.fsum_plain(ft.fmul_plain(ft.fsub_plain(vals, at_t[:, :, None]), inv), axis=0)


def _quotient_checked(vals: torch.Tensor, at: Sequence[int], inv: torch.Tensor):
    """(K, N) of a quotient, after the checks the kernel's wrapper makes on
    every device: vals and inv (K, 8, N) int32 on one device, K <= MAX_K
    host values at."""
    k = len(at)
    if vals.dim() != 3 or vals.shape[1] != NLIMBS or vals.shape != inv.shape or vals.shape[0] != k or \
            not 1 <= k <= MAX_K or vals.shape[-1] < 1:
        raise ValueError(f"deep_quotient: values {tuple(vals.shape)}, inverses {tuple(inv.shape)} and {k} points, "
                         f"expected (K, 8, N) each and K <= {MAX_K}")
    if vals.dtype != torch.int32 or inv.dtype != torch.int32 or vals.device != inv.device:
        raise TypeError("deep_quotient: expected int32 limbs on one device")
    return k, vals.shape[-1]


def launch_deep_quotient(lib, stream, vals: torch.Tensor, at: Sequence[int], inv: torch.Tensor) -> torch.Tensor:
    """Call the quotient entry point of ``lib``: the (8, N) sum over K of
    (vals[k] - at[k]) inv[k], vals and inv read through their row and
    limb strides, ``at`` canonical host ints by value; it copies nothing
    to the device and never waits for the stream."""
    k, n = _quotient_checked(vals, at, inv)
    vals, inv = _lanes(vals), _lanes(inv)
    out = torch.empty((NLIMBS, n), dtype=torch.int32, device=vals.device)
    rc = lib.zk_deep_quotient(kernels.ptr(vals), vals.stride(0), vals.stride(1), kernels.ptr(inv), inv.stride(0),
                              inv.stride(1), kernels.words(at), kernels.ptr(out), k, n, stream)
    kernels.check(rc, "zk_deep_quotient")
    kernels.count("deep_quotient", K=k, N=n)
    return out


def deep_quotient(vals: torch.Tensor, at: Sequence[int], inv: torch.Tensor) -> torch.Tensor:
    """sum_k (vals[k] - at[k]) inv[k] of (K, 8, N) values and inverses and K
    host ints at, (8, N): one launch on a CUDA tensor (or it raises),
    :func:`deep_quotient_plain` on a CPU tensor."""
    _quotient_checked(vals, at, inv)
    if vals.device.type == "cpu":
        return deep_quotient_plain(vals, tensor(list(at), vals.device), inv)
    if vals.device.type != "cuda":
        raise ValueError(f"deep_quotient: no kernel for device {vals.device}")
    return launch_deep_quotient(kernels.lib(), kernels.stream_of(vals), vals, at, inv)
