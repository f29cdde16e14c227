"""FRI prover in the transposed layout: degree-8 folds with per-layer
Merkle commitments.

Port of the T-mode half of ``zkvm.prover.fri`` (``_commit_core_t``,
``_fold_core_t``, ``fri_prove_t``, ``gather_groups``) and of its host-only
verifier helpers (``fold_position``, ``fold_group_values``).  A fold group
for position j is the 8 evaluations {j + t*D/8}; each layer's leaf j hashes
its group (kernel K2 at C = 8).  Folding interpolates each group with an
8-point iNTT along the group axis and evaluates it at beta/x_j by Horner:
on a card one launch of ``csrc/fri_fold.cu``'s fold a layer
(:func:`fold_t`; the ladder of the x_j made in its registers from a table
of powers built on the host and passed by value), on the CPU
the plain version (K1's plain version at M = 8, a ladder and 15 plain
field ops).  The remainder's inverse-offset scale is one launch of the
host-constant ladder (``ntt_t.ladder_t_host``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np
import torch

from zkvm_torch import kernels
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_t, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash.merkle import DeviceMerkleTree, merkle_flat
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.utils.profiler import profiler

FOLD = 8


class ProverError(Exception):
    """Internal prover invariant violation (not a verification failure)."""


def _commit_core_t(evals_t: torch.Tensor):
    """evals_t (8, D) -> (Merkle heap, groups (FOLD, 8, D/FOLD)); group j's
    value t sits at [t, :, j] (the evaluation at index t*(D/8) + j)."""
    d = evals_t.shape[-1]
    v = evals_t.reshape(8, FOLD, d // FOLD).transpose(0, 1).contiguous()
    digs = b3t.hash_rows_t(v)  # (8, D/8)
    return merkle_flat(digs.transpose(0, 1)), v


def _fold_core_t_plain(v: torch.Tensor, q_t: torch.Tensor) -> torch.Tensor:
    """The fold's plain version, in the plain arithmetic: iNTT_8 along the
    group axis of the transposed groups v (FOLD, 8, n) (K1's plain
    version), times 1/8, then Horner at q_t = beta/x_j, (8, n).  Returns
    (8, n) evaluations."""
    tw = nt._stage_twiddles_dev(FOLD, True, v.device)
    b = nt.stages_plain(v[None], tw)[0]  # (FOLD, 8, n), coefficient axis -3
    b = ft.fmul_plain(b, ft.const_col(f128.finv(FOLD), v.device))
    acc = b[FOLD - 1]
    for k in range(FOLD - 2, -1, -1):
        acc = ft.fadd_plain(ft.fmul_plain(acc, q_t), b[k])
    return acc


def fold_plain(v: torch.Tensor, scale: int, base: int) -> torch.Tensor:
    """:func:`fold_t`'s plain version: the ladder q_j = scale * base^j
    (``ntt_t.ladder_plain``), then :func:`_fold_core_t_plain`."""
    ops = ft.const_col(base, v.device)[:, 0], ft.const_col(scale, v.device)[:, 0]
    return _fold_core_t_plain(v, nt.ladder_plain(*ops, v.shape[-1]))


_R8 = f128.finv(f128.get_root_of_unity(FOLD))  # the inverse DFT's root
_FOLD_CONSTANTS = [f128.finv(FOLD), _R8, pow(_R8, 2, f128.P), pow(_R8, 3, f128.P)]


@functools.lru_cache(maxsize=64)
def _table_words(base: int):
    squares, powers = nt.power_table(base)
    return tuple(kernels.words([*_FOLD_CONSTANTS, *squares, *powers]))


def fold_scalars(scale: int, base: int):
    """The fold kernel's 5 + 48 + 32 scalars, as a host array of their
    32-bit words: q_0 = scale, 1/8, r, r^2, r^3 for r = w_8^(-1), then the
    ladder's tables base^(2^e) and base^i (``ntt_t.power_table``)."""
    words = (*kernels.words([scale]), *_table_words(base))
    return (ctypes.c_uint32 * len(words))(*words)


def _fold_checked(v: torch.Tensor) -> int:
    """n of the groups v, after checking what the kernel takes: (FOLD, 8, n)
    int32 limbs, n >= 1.  Runs on every device."""
    if v.dim() != 3 or v.shape[:2] != (FOLD, 8) or v.shape[-1] < 1:
        raise ValueError(f"fri fold: groups of shape {tuple(v.shape)}, expected ({FOLD}, 8, n)")
    if v.dtype != torch.int32:
        raise TypeError(f"fri fold: expected int32 limbs, got {v.dtype}")
    return v.shape[-1]


def launch_fold(lib, stream, v: torch.Tensor, scale: int, base: int) -> torch.Tensor:
    """Call the fold entry point of ``lib`` on contiguous groups v (FOLD, 8,
    n): the (8, n) fold at q_j = scale * base^j, one launch.  The scalars
    and the ladder's table go by value, so it copies nothing to the device
    and never waits for the stream."""
    n = _fold_checked(v)
    kernels.expect(v, (FOLD, 8, n), v.device, "v")
    out = torch.empty((8, n), dtype=torch.int32, device=v.device)
    rc = lib.zk_fri_fold(kernels.ptr(v), kernels.ptr(out), n, fold_scalars(scale, base), stream)
    kernels.check(rc, "zk_fri_fold")
    kernels.count("fri_fold", n=n)
    return out


def fold_t(v: torch.Tensor, scale: int, base: int) -> torch.Tensor:
    """Fold transposed groups v (FOLD, 8, n): interpolate each group (an
    8-point iNTT), evaluate it at q_j = scale * base^j (scale = beta /
    offset, base = w_D^(-1)) and return the (8, n) evaluations.  A CUDA
    tensor launches the fold kernel once (or it raises), a CPU tensor
    takes :func:`fold_plain`."""
    _fold_checked(v)
    if v.device.type == "cpu":
        return fold_plain(v, scale, base)
    if v.device.type != "cuda":
        raise ValueError(f"fri fold: no kernel for device {v.device}")
    return launch_fold(kernels.lib(), kernels.stream_of(v), v.contiguous(), scale, base)


class FriProverResult:
    def __init__(self):
        self.trees: List[DeviceMerkleTree] = []
        self.groups: List[torch.Tensor] = []  # (FOLD, 8, D_t/8) per layer
        self.betas: List[int] = []
        self.remainder: List[int] = []


def fri_prove_t(coin, evals_t: torch.Tensor, offset: int, options) -> FriProverResult:
    """Commit and fold until the remainder bound, driving the transcript."""
    res = FriProverResult()
    dev = evals_t.device
    size = evals_t.shape[-1]
    while size > options.max_remainder_size:
        with profiler.phase("fri.layer"):
            nodes, v = _commit_core_t(evals_t)
            tree = DeviceMerkleTree(nodes)
            res.trees.append(tree)
            res.groups.append(v)
            coin.reseed(tree.root)
            beta = coin.draw()
            res.betas.append(beta)
            w_d = f128.get_root_of_unity(size)
            evals_t = fold_t(v, f128.fmul(beta, f128.finv(offset)), f128.finv(w_d))
        offset = pow(offset, FOLD, f128.P)
        size //= FOLD
    with profiler.phase("fri.remainder"):
        coeffs = nt.ladder_t_host(f128.finv(offset), size, device=dev, x=nt.intt_t(evals_t))
        host = from_t(to_numpy(coeffs))
        max_len = size // options.blowup
        res.remainder = [int(v) for v in host[:max_len]]
        if any(int(v) != 0 for v in host[max_len:]):
            raise ProverError("FRI remainder degree overflow")
        coin.reseed_with_elements(res.remainder)
    return res


def gather_groups(res: FriProverResult, layer_idx: int, group_idx) -> np.ndarray:
    """Opened fold groups as a host (K, FOLD, 8) limbs-last array; only the
    requested groups leave the device."""
    g = res.groups[layer_idx]
    idx = torch.as_tensor(list(group_idx), dtype=torch.int64, device=g.device)
    return np.transpose(to_numpy(g.index_select(2, idx)), (2, 0, 1))


def fold_position(position: int, domain_size: int) -> int:
    """Query position in the next (folded) layer."""
    return position % (domain_size // FOLD)


def fold_group_values(group: List[int], position: int, domain_size: int, beta: int, offset: int) -> int:
    """Host-side fold of one opened group — the verifier's counterpart."""
    j = position % (domain_size // FOLD)
    w_d = f128.get_root_of_unity(domain_size)
    x_j = f128.fmul(offset, pow(w_d, j, f128.P))
    w8 = f128.get_root_of_unity(FOLD)
    # b = iNTT_8 of group values
    inv8 = f128.finv(FOLD)
    b = []
    for k in range(FOLD):
        acc = 0
        for t in range(FOLD):
            acc = f128.fadd(acc, f128.fmul(group[t], pow(w8, (-t * k) % FOLD, f128.P)))
        b.append(f128.fmul(acc, inv8))
    q = f128.fmul(beta, f128.finv(x_j))
    acc = b[FOLD - 1]
    for k in range(FOLD - 2, -1, -1):
        acc = f128.fadd(f128.fmul(acc, q), b[k])
    return acc

