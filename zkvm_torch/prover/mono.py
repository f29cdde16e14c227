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
   denominators, two launches of ``csrc/deep.cu``'s column sums and one of
   its quotient (a row block);
5. queries: the rows gathered from the resident LDEs.

From ``limits.CHUNK_T`` on, the domain constants, the composition's
products and the DEEP run in blocks of ``limits.MONO_ROW_BLOCK`` rows
(:func:`row_blocks`); K4 stays one launch over the domain, as it reads
its next row in place.  So one process proves up to T = 2^20 (D = 2^23).

The OOD frame, FRI and the proof assembly are T-mode's (``pipeline.py``).
:func:`zkvm_torch.prover.pipeline.prove` runs these stages for
``mode="mono"``; the proof bytes equal T-mode's.  Given a mesh, it runs
:class:`ShardedMonoStages`, the same stages on each rank's row block (the
reference's mesh path), with the same bytes.
"""

from __future__ import annotations

import functools

import torch

from zkvm_torch.air import composition as cp
from zkvm_torch.air.constraints_dist import merged_transition_sharded
from zkvm_torch.air.layout import NUM_EXEMPTIONS
from zkvm_torch.air.periodic import periodic_table
from zkvm_torch.air.transition import merged_transition
from zkvm_torch.dist import comm
from zkvm_torch.dist.mesh import row_block
from zkvm_torch.dist.ntt_dist import coset_lde_sharded, intt_sharded
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, from_t, tensor, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash.merkle import merkle_flat, merkle_forest_flat
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.utils.profiler import profiler
from . import deep, limits
from .pipeline import comp_columns, weighted_host

def row_blocks(n_rows: int, t_len: int) -> list:
    """Slices of a domain's rows for mono's pointwise work: one slice below
    ``limits.CHUNK_T``, else blocks of ``limits.MONO_ROW_BLOCK`` rows.
    Every value is pointwise in the row, so the blocks change none."""
    step = n_rows if t_len < limits.CHUNK_T else min(limits.MONO_ROW_BLOCK, n_rows)
    return [slice(i, i + step) for i in range(0, n_rows, step)]


def _ladder_blocks(base: int, scale: int, lo: int, blocks, device) -> torch.Tensor:
    """(8, n) = scale * base^(lo + i) over row blocks: one ladder a block,
    scaled by its host factor (an (8, n) ladder in one piece holds ~12 GiB
    of plain limb-product transients at n = 2^23 on the CPU)."""
    return torch.cat([nt.ladder_t_host(base, blk.stop - blk.start, f128.fmul(scale, pow(base, lo + blk.start, f128.P)),
                                       device) for blk in blocks], dim=-1)


@functools.lru_cache(maxsize=None)
def _domain_constants(t_len: int, blowup: int, device, rank: int = 0, ranks: int = 1):
    """Proof-independent device tensors for one (T, blowup, device): the
    domain points x (8, D), the composition's domain factor
    ee = (x - e1)(x - e2) / (x^T - 1) (1/(x^T - 1) depends on i mod blowup
    only), the boundary factors i0 = 1/(x - 1) and i1 = 1/(x - x_last), the
    inverse-offset ladder and the periodic tables.  With ``ranks`` > 1,
    x, ee, i0, i1 and the ladder are rank ``rank``'s block of D / ranks
    rows, and the tables are whole.  From ``limits.CHUNK_T`` on, all but
    the tables are built in row blocks (:func:`row_blocks`); one batch
    inverse covers every row."""
    d = t_len * blowup
    local = d // ranks
    lo = rank * local
    offset = f128.DOMAIN_OFFSET
    g_trace = f128.get_root_of_unity(t_len)
    s_t = pow(offset, t_len, f128.P)
    w_b = f128.get_root_of_unity(blowup)
    inv_xt = [f128.finv(f128.fsub(f128.fmul(s_t, pow(w_b, r, f128.P)), 1)) for r in range(blowup)]
    e1 = pow(g_trace, t_len - 1, f128.P)
    e2 = pow(g_trace, t_len - 2, f128.P)
    x_last = pow(g_trace, t_len - NUM_EXEMPTIONS, f128.P)

    col = lambda v: ft.const_col(v, device)
    w_d = f128.get_root_of_unity(d)
    blocks = row_blocks(local, t_len)
    x = _ladder_blocks(w_d, offset, lo, blocks, device)  # (8, D / ranks)
    inv_xt_t = tensor(inv_xt, device).transpose(0, 1)  # (8, blowup): 1/(x^T - 1) at i mod blowup
    ee, den = [], []
    for blk in blocks:
        xb = x[:, blk]
        xt = inv_xt_t.repeat(1, (blk.stop - blk.start) // blowup)
        ee.append(ft.fmul(ft.fmul(ft.fsub(xb, col(e1)), ft.fsub(xb, col(e2))), xt))
        den.append(torch.stack([ft.fsub(xb, col(1)), ft.fsub(xb, col(x_last))]))
    inv = ft.batch_inverse(torch.cat(den, dim=-1))
    tab = from_numpy(periodic_table(t_len, blowup), device)  # (9, 8, 16*blowup)
    return dict(
        d=d,
        g_trace=g_trace,
        x=x,
        ee=torch.cat(ee, dim=-1),
        i0=inv[0],
        i1=inv[1],
        inv_off_t=_ladder_blocks(f128.finv(offset), 1, lo, blocks, device),
        mask_tab=tab[0],
        ark_tab=tab[1:].contiguous(),
    )


def _commit_rows(lde_t):
    """Merkle heap over the BLAKE3 hashes of the (C, 8, D) LDE's rows."""
    return merkle_flat(b3t.hash_rows_t(lde_t).transpose(0, 1))


def _rows(lde_t, index) -> list:
    """Rows of a (C, 8, D) LDE at the given positions, as host ints [Q][C]."""
    cols = from_t(to_numpy(lde_t.index_select(-1, index)))  # (C, Q)
    return [[int(v) for v in row] for row in cols.T]


class MonoStages:
    """The full-LDE stages for one proof; holds the trace LDE (after
    :meth:`trace_commit`) and the composition LDE (after
    :meth:`comp_commit`) on the device."""

    def __init__(self, t_len, blowup, device, rank=0, ranks=1):
        self.t_len, self.blowup = t_len, blowup
        self.dc = _domain_constants(t_len, blowup, device, rank, ranks)
        self.d, self.g_trace = self.dc["d"], self.dc["g_trace"]
        self.lde = self.comp_lde = None

    def trace_commit(self, cols_t):
        """(28, 8, T) trace -> (coefficients, Merkle heap); keeps the LDE."""
        coeffs_t = nt.intt_t(cols_t)
        self.lde = nt.coset_lde_t(coeffs_t, self.blowup)  # (28, 8, D)
        return coeffs_t, _commit_rows(self.lde)

    def composition(self, coeffs_t, alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1):
        """(8, D) composition evaluations over the domain: K4 in one launch,
        its products with the domain factors and the boundary groups by row
        block (:func:`row_blocks`)."""
        dc = self.dc
        trans = self._transition(alphas, delta)
        q = []
        for blk in row_blocks(trans.shape[-1], self.t_len):
            cur = self.lde[..., blk]
            qb = ft.fmul(trans[:, blk], dc["ee"][:, blk])
            qb = ft.fadd(qb, ft.fmul(cp.boundary_group(cur, bcols0, bv0, bb0), dc["i0"][:, blk]))
            q.append(ft.fadd(qb, ft.fmul(cp.boundary_group(cur, bcols1, bv1, bb1), dc["i1"][:, blk])))
        return torch.cat(q, dim=-1)

    def _transition(self, alphas, delta):
        dc = self.dc
        return merged_transition(self.lde, dc["mask_tab"], dc["ark_tab"], alphas, delta, self.blowup)

    def comp_commit(self, comp_t):
        """(8, D) evaluations -> (h coefficients (8, 8, T), heap); keeps the
        composition LDE."""
        h_t = comp_columns(comp_t, self.dc["inv_off_t"])
        self.comp_lde = nt.coset_lde_t(h_t, self.blowup)  # (8, 8, D)
        return h_t, _commit_rows(self.comp_lde)

    def deep(self, coeffs_t, h_t, gammas, deltas, epsilons, points, ood):
        """DEEP witness Y over the domain, (8, D): the three quotients
        (A(x) - A(z)) / (x - z) pointwise, one batch inverse for all, the
        sums and quotients by row block (:func:`row_blocks`)."""
        dev = self.lde.device
        x = self.dc["x"]
        blocks = row_blocks(x.shape[-1], self.t_len)
        ood_cur, ood_nxt, ood_comp = ood
        at = [weighted_host(gammas, ood_cur), weighted_host(deltas, ood_nxt), weighted_host(epsilons, ood_comp)]
        pts = [ft.const_col(p, dev) for p in points]
        inv = ft.batch_inverse(torch.cat([torch.stack([ft.fsub(x[:, blk], p) for p in pts]) for blk in blocks],
                                         dim=-1))  # (3, 8, D)
        y = []
        for blk in blocks:
            vals = torch.empty((3, 8, blk.stop - blk.start), dtype=torch.int32, device=dev)
            with profiler.phase("deep.sums"):
                deep.weighted_sum(self.lde[..., blk], [gammas, deltas], out=vals[:2])
                deep.weighted_sum(self.comp_lde[..., blk], [epsilons], out=vals[2:])
            y.append(deep.deep_quotient(vals, at, inv[..., blk]))
        return torch.cat(y, dim=-1)

    def query_rows(self, coeffs_t, h_t, positions):
        """The trace and composition rows at the query positions."""
        index = torch.tensor(positions, dtype=torch.int64, device=self.lde.device)
        return _rows(self.lde, index), _rows(self.comp_lde, index)


class ShardedMonoStages(MonoStages):
    """The full-LDE stages over a mesh (the reference's ``prove(...,
    mesh=...)``): rank q holds rows [qL, (q+1)L) of the trace and
    composition LDEs and of every domain constant, L = D / P, and every
    rank runs the same transcript.

    1. trace commit: its block of the trace rows, the sharded iNTT over T
       and coset LDE (:mod:`zkvm_torch.dist.ntt_dist`, K1), K2 and the
       Merkle heap over its rows (a subtree of
       :class:`~zkvm_torch.hash.merkle.ShardedMerkleTree`);
    2. composition: K4 on its block with a one-period halo
       (:mod:`zkvm_torch.air.constraints_dist`), the boundary groups local;
    3. composition commit: the sharded iNTT over D, the inverse-offset
       ladder and the column split (local, as 8 | L), the sharded coset LDE;
    4. the coefficients of both commitments are gathered whole for the OOD
       frame, which runs as in one process;
    5. DEEP: local and pointwise, one batch inverse a rank; the witness Y is
       gathered whole, and FRI runs on it on every rank (its fold groups
       cross the blocks);
    7. queries: each rank gives the rows it owns, gathered."""

    def __init__(self, t_len, blowup, mesh):
        super().__init__(t_len, blowup, mesh.device, mesh.rank, mesh.size)
        self.mesh = mesh

    def trace_commit(self, cols_t):
        """The whole (28, 8, T) trace -> (the whole coefficients, this
        rank's subtree heap); keeps this rank's block of the LDE."""
        coeffs = intt_sharded(row_block(self.mesh, cols_t), self.mesh)
        self.lde = coset_lde_sharded(coeffs, self.blowup, self.mesh)
        return comm.all_gather(coeffs, self.mesh, dim=-1), merkle_forest_flat(self.lde)

    def _transition(self, alphas, delta):
        dc = self.dc
        return merged_transition_sharded(self.lde, dc["mask_tab"], dc["ark_tab"], alphas, delta,
                                         self.blowup, self.mesh)

    def comp_commit(self, comp_t):
        """This rank's (8, L) evaluations -> (the whole h coefficients
        (8, 8, T), this rank's subtree heap)."""
        h_t = comp_columns(comp_t, self.dc["inv_off_t"], intt=lambda x: intt_sharded(x, self.mesh))
        self.comp_lde = coset_lde_sharded(h_t, self.blowup, self.mesh)
        return comm.all_gather(h_t, self.mesh, dim=-1), merkle_forest_flat(self.comp_lde)

    def deep(self, coeffs_t, h_t, gammas, deltas, epsilons, points, ood):
        """The whole DEEP witness Y (8, D), from every rank's block."""
        return comm.all_gather(super().deep(coeffs_t, h_t, gammas, deltas, epsilons, points, ood),
                               self.mesh, dim=-1)

    def query_rows(self, coeffs_t, h_t, positions):
        """The rows at the query positions, each from the rank that owns it:
        every rank takes the same local rows, the owner's are kept."""
        local = self.lde.shape[-1]
        index = torch.tensor([p % local for p in positions], dtype=torch.int64, device=self.lde.device)
        owners = [p // local for p in positions]
        out = []
        for lde in (self.lde, self.comp_lde):
            rows = comm.all_gather(lde.index_select(-1, index)[None], self.mesh, dim=0)  # (P, C, 8, Q)
            cols = from_t(to_numpy(rows))  # (P, C, Q)
            out.append([[int(v) for v in cols[q, :, k]] for k, q in enumerate(owners)])
        return tuple(out)
