"""The sharded prover step: the device-heavy stages of one proof over a
mesh, with fixed scalars in place of the transcript's.

Port of :mod:`zkvm.dist.sharded` (``sharded_prove_step``,
``zkvm/dist/sharded.py:27-101``): the trace LDE and its row digests, the
merged transition times the domain factor, the composition's column split
(without the inverse-offset ladder, as the reference's step has it) and
its LDE and row digests, a DEEP combination at a fixed point with fixed
coefficients, and one FRI fold of the result with a fixed beta.  Every
D-long tensor is row-sharded; each rank returns the same host arrays.
"""

from __future__ import annotations

import numpy as np

from zkvm_torch.air.constraints_dist import merged_transition_sharded
from zkvm_torch.field import f128
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, tensor, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.prover import deep as dp
from zkvm_torch.prover.fri import FOLD, fold_t
from zkvm_torch.prover.mono import _domain_constants
from zkvm_torch.prover.pipeline import NUM_COMP_COLUMNS
from . import comm
from .mesh import row_block
from .ntt_dist import coset_lde_sharded, intt_sharded

BETA = 12345  # the fold's beta, as the reference's step
Z_POINT = 0xABCDEF  # the DEEP point


def _digests(rows_t, mesh) -> np.ndarray:
    """The whole (D, 8) uint32 row digests of a row-sharded (C, 8, L) LDE."""
    return to_numpy(comm.all_gather(b3t.hash_rows_t(rows_t), mesh, dim=-1)).T.copy()


def sharded_prove_step(mesh, cols_host, delta: int, blowup: int = 8):
    """Run the step over the mesh; returns host arrays on every rank:
    (trace row digests (D, 8), composition row digests (D, 8), the folded
    DEEP evaluations (T, 8) limbs), in the reference's layout.

    ``cols_host``: the (28, T, 8) uint32 limb array of the trace."""
    t_len = cols_host.shape[1]
    d = t_len * blowup
    dev = mesh.device
    dc = _domain_constants(t_len, blowup, dev, mesh.rank, mesh.size)
    cols = row_block(mesh, from_numpy(np.swapaxes(cols_host, 1, 2), dev))  # (28, 8, T/P)

    lde = coset_lde_sharded(intt_sharded(cols, mesh), blowup, mesh)  # (28, 8, L)
    trace_digests = _digests(lde, mesh)

    alphas = tensor(list(range(3, 23)), dev)
    q = merged_transition_sharded(lde, dc["mask_tab"], dc["ark_tab"], alphas, delta, blowup, mesh)
    comp_coeffs = intt_sharded(ft.fmul(q, dc["ee"]), mesh)  # (8, L)
    h = comp_coeffs.reshape(8, -1, NUM_COMP_COLUMNS).permute(2, 0, 1).contiguous()  # (8, 8, L/8)
    comp_lde = coset_lde_sharded(h, blowup, mesh)
    comp_digests = _digests(comp_lde, mesh)

    deep = list(range(5, 41))
    a = dp.weighted_sum(lde, [deep[:28]])[0]
    hsum = dp.weighted_sum(comp_lde, [deep[28:36]])[0]
    den = ft.fsub(dc["x"], ft.const_col(Z_POINT, dev))
    y = ft.fmul(ft.fadd(a, hsum), ft.batch_inverse(den))
    y = comm.all_gather(y, mesh, dim=-1)  # (8, D): the fold groups cross the blocks

    offset = f128.DOMAIN_OFFSET
    groups = y.reshape(8, FOLD, d // FOLD).transpose(0, 1).contiguous()
    scale = f128.fmul(BETA, f128.finv(offset))
    folded = to_numpy(fold_t(groups, scale, f128.finv(f128.get_root_of_unity(d)))).T.copy()  # (T, 8)
    return trace_digests, comp_digests, folded
