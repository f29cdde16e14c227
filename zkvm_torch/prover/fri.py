"""FRI prover in the transposed layout: degree-8 folds with per-layer
Merkle commitments.

Port of the T-mode half of ``zkvm.prover.fri`` (``_commit_core_t``,
``_fold_core_t``, ``fri_prove_t``, ``gather_groups``) and of its host-only
verifier helpers (``fold_position``, ``fold_group_values``).  A fold group
for position j is the 8 evaluations {j + t*D/8}; each layer's leaf j hashes
its group (kernel K2 at C = 8).  Folding interpolates each group with an
8-point iNTT along the group axis (kernel K1 at M = 8) and evaluates it at
beta/x_j by Horner.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_t, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash.merkle import DeviceMerkleTree, merkle_flat
from zkvm_torch.ntt import ntt_t as nt

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


def _fold_core_t(v: torch.Tensor, q_t: torch.Tensor) -> torch.Tensor:
    """Fold transposed groups: iNTT_8 along the group axis, then Horner at
    q_t = beta/x_j, (8, D/8).  Returns (8, D/8) evaluations."""
    b = nt._axis_ntt(v, FOLD, True)  # (FOLD, 8, D/8), coefficient axis -3
    b = ft.fmul(b, ft.const_col(f128.finv(FOLD), v.device))
    acc = b[FOLD - 1]
    for k in range(FOLD - 2, -1, -1):
        acc = ft.fadd(ft.fmul(acc, q_t), b[k])
    return acc


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
        nodes, v = _commit_core_t(evals_t)
        tree = DeviceMerkleTree(nodes)
        res.trees.append(tree)
        res.groups.append(v)
        coin.reseed(tree.root)
        beta = coin.draw()
        res.betas.append(beta)
        w_d = f128.get_root_of_unity(size)
        scale = f128.fmul(beta, f128.finv(offset))
        q_t = nt.ladder_t_host(f128.finv(w_d), size // FOLD, scale, device=dev)
        evals_t = _fold_core_t(v, q_t)
        offset = pow(offset, FOLD, f128.P)
        size //= FOLD
    coeffs = nt.intt_t(evals_t)
    coeffs = ft.fmul(coeffs, nt.ladder_t_host(f128.finv(offset), size, device=dev))
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

