"""The full-LDE ("mono") stages of the STARK prover.

Port of the monolithic half of ``zkvm.prover.pipeline`` (``prove`` with
``ZKVM_CLASS=0``: ``_domain_constants``, ``_stage_trace_lde``,
``_stage_composition``, ``_stage_comp_commit``, ``_stage_deep`` and the
query-row gather).  Unlike T-mode, the whole (28, 8, D) trace LDE and the
(8, 8, D) composition LDE stay on the device, in natural domain order
(position i is the point offset * w_D^i):

1. trace commit: iNTT the 28 columns, one size-D coset NTT (K1), BLAKE3
   row hashes over the D rows (K2), Merkle heap;
2. composition: the merged transition over the full domain (K4, next row
   +blowup, periodic tables of period 16*blowup) times the exemption
   factor and 1/(x^T - 1), plus the two boundary groups;
3. composition commit: size-D iNTT, 8 column polynomials, one size-D coset
   NTT, row hashes (K2), Merkle heap;
4. DEEP: pointwise over D, with one batch inverse of the three
   denominators;
5. queries: the rows gathered from the resident LDEs.

The OOD frame, FRI and the proof assembly are T-mode's (``pipeline.py``).
:func:`zkvm_torch.prover.pipeline.prove` runs these stages for
``mode="mono"``; the proof bytes equal T-mode's.
"""

from __future__ import annotations

import functools

import torch

from zkvm_torch.air import composition as cp
from zkvm_torch.air.layout import NUM_EXEMPTIONS
from zkvm_torch.air.periodic import periodic_table
from zkvm_torch.air.transition import merged_transition
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, from_t, tensor, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash.merkle import merkle_flat
from zkvm_torch.ntt import ntt_t as nt
from .pipeline import comp_columns, weighted_host

# Columns per limb product in the DEEP sums: fmul widens (C, 8, D) limbs to
# int64 partial products 48x the operand's bytes, so 4 columns at D = 2^19
# (~3 GB of temporaries) instead of 28 (~22 GB).
DEEP_COLUMN_BLOCK = 4


@functools.lru_cache(maxsize=None)
def _domain_constants(t_len: int, blowup: int, device):
    """Proof-independent device tensors for one (T, blowup, device): the
    domain points x (8, D), the composition's domain factor
    ee = (x - e1)(x - e2) / (x^T - 1) (1/(x^T - 1) depends on i mod blowup
    only), the boundary factors i0 = 1/(x - 1) and i1 = 1/(x - x_last), the
    inverse-offset ladder and the periodic tables."""
    d = t_len * blowup
    offset = f128.DOMAIN_OFFSET
    g_trace = f128.get_root_of_unity(t_len)
    s_t = pow(offset, t_len, f128.P)
    w_b = f128.get_root_of_unity(blowup)
    inv_xt = [f128.finv(f128.fsub(f128.fmul(s_t, pow(w_b, r, f128.P)), 1)) for r in range(blowup)]
    e1 = pow(g_trace, t_len - 1, f128.P)
    e2 = pow(g_trace, t_len - 2, f128.P)
    x_last = pow(g_trace, t_len - NUM_EXEMPTIONS, f128.P)

    col = lambda v: ft.const_col(v, device)
    x = nt.ladder_t_host(f128.get_root_of_unity(d), d, offset, device)  # (8, D)
    inv_xt_t = tensor(inv_xt, device).transpose(0, 1).repeat(1, t_len)  # (8, D)
    ee = ft.fmul(ft.fmul(ft.fsub(x, col(e1)), ft.fsub(x, col(e2))), inv_xt_t)
    inv = ft.batch_inverse(torch.stack([ft.fsub(x, col(1)), ft.fsub(x, col(x_last))]))
    tab = from_numpy(periodic_table(t_len, blowup), device)  # (9, 8, 16*blowup)
    return dict(
        d=d,
        g_trace=g_trace,
        x=x,
        ee=ee,
        i0=inv[0],
        i1=inv[1],
        inv_off_t=nt.ladder_t_host(f128.finv(offset), d, device=device),
        mask_tab=tab[0],
        ark_tab=tab[1:].contiguous(),
    )


def _commit_rows(lde_t):
    """Merkle heap over the BLAKE3 hashes of the (C, 8, D) LDE's rows."""
    return merkle_flat(b3t.hash_rows_t(lde_t).transpose(0, 1))


def _weighted_columns(lde_t, weights_t):
    """sum_c weights[c] * lde[c] as (8, D); lde (C, 8, D), weights (C, 8)."""
    acc = None
    for c0 in range(0, lde_t.shape[0], DEEP_COLUMN_BLOCK):
        blk = slice(c0, c0 + DEEP_COLUMN_BLOCK)
        part = ft.fsum(ft.fmul(lde_t[blk], weights_t[blk, :, None]), axis=0)
        acc = part if acc is None else ft.fadd(acc, part)
    return acc


def _rows(lde_t, index) -> list:
    """Rows of a (C, 8, D) LDE at the given positions, as host ints [Q][C]."""
    cols = from_t(to_numpy(lde_t.index_select(-1, index)))  # (C, Q)
    return [[int(v) for v in row] for row in cols.T]


class MonoStages:
    """The full-LDE stages for one proof; holds the trace LDE (after
    :meth:`trace_commit`) and the composition LDE (after
    :meth:`comp_commit`) on the device."""

    def __init__(self, t_len, blowup, device):
        self.blowup = blowup
        self.dc = _domain_constants(t_len, blowup, device)
        self.d, self.g_trace = self.dc["d"], self.dc["g_trace"]
        self.lde = self.comp_lde = None

    def trace_commit(self, cols_t):
        """(28, 8, T) trace -> (coefficients, Merkle heap); keeps the LDE."""
        coeffs_t = nt.intt_t(cols_t)
        self.lde = nt.coset_lde_t(coeffs_t, self.blowup)  # (28, 8, D)
        return coeffs_t, _commit_rows(self.lde)

    def composition(self, coeffs_t, alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1):
        """(8, D) composition evaluations over the domain."""
        dc = self.dc
        q = merged_transition(self.lde, dc["mask_tab"], dc["ark_tab"], alphas, delta, self.blowup)
        q = ft.fmul(q, dc["ee"])
        q = ft.fadd(q, ft.fmul(cp.boundary_group(self.lde, bcols0, bv0, bb0), dc["i0"]))
        return ft.fadd(q, ft.fmul(cp.boundary_group(self.lde, bcols1, bv1, bb1), dc["i1"]))

    def comp_commit(self, comp_t):
        """(8, D) evaluations -> (h coefficients (8, 8, T), heap); keeps the
        composition LDE."""
        h_t = comp_columns(comp_t, self.dc["inv_off_t"])
        self.comp_lde = nt.coset_lde_t(h_t, self.blowup)  # (8, 8, D)
        return h_t, _commit_rows(self.comp_lde)

    def deep(self, coeffs_t, h_t, gammas, deltas, epsilons, points, ood):
        """DEEP witness Y over the domain, (8, D): the three quotients
        (A(x) - A(z)) / (x - z) pointwise, one batch inverse for all."""
        dev = self.lde.device
        x = self.dc["x"]
        ood_cur, ood_nxt, ood_comp = ood
        sums = (
            _weighted_columns(self.lde, tensor(gammas, dev)),
            _weighted_columns(self.lde, tensor(deltas, dev)),
            _weighted_columns(self.comp_lde, tensor(epsilons, dev)),
        )
        at_points = (
            weighted_host(gammas, ood_cur),
            weighted_host(deltas, ood_nxt),
            weighted_host(epsilons, ood_comp),
        )
        inv = ft.batch_inverse(torch.stack([ft.fsub(x, ft.const_col(p, dev)) for p in points]))
        y = None
        for k in range(3):
            term = ft.fmul(ft.fsub(sums[k], ft.const_col(at_points[k], dev)), inv[k])
            y = term if y is None else ft.fadd(y, term)
        return y

    def query_rows(self, coeffs_t, h_t, positions):
        """The trace and composition rows at the query positions."""
        index = torch.tensor(positions, dtype=torch.int64, device=self.lde.device)
        return _rows(self.lde, index), _rows(self.comp_lde, index)
