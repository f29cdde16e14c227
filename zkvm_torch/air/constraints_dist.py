"""The merged transition over a row-sharded LDE, with one halo exchange.

Port of :mod:`zkvm.air.constraints_dist`.  The constraints read row n and
its next row n + step; on a row-sharded domain a rank's last ``step`` rows
need its right neighbour's first ones.  Kernel K4
(:func:`zkvm_torch.air.transition.merged_transition`) takes no next-row
array: it reads row (n + step) mod N in place and the periodic tables at
n mod P_tab, and needs P_tab | N.  So each rank takes a halo of one table
period (16 * blowup rows, :func:`comm.shift_from_right`, the reference's
``ppermute``), launches K4 unchanged on its (28, 8, L + P_tab) block and
keeps the first L rows: they never wrap, and their table phase is the
global one because P_tab divides L.
"""

from __future__ import annotations

import torch

from zkvm_torch.dist import comm
from .transition import merged_transition


def merged_transition_sharded(lde_t, mask_tab, ark_tab, alphas, delta, step, mesh) -> torch.Tensor:
    """This rank's (8, L) block of the merged transition over the domain,
    from its (28, 8, L) block of the LDE (the arguments of
    :func:`merged_transition`, with the whole periodic tables)."""
    local, period = lde_t.shape[-1], mask_tab.shape[-1]
    if local % period or step > period:
        raise ValueError(f"sharded transition: a block of {local} rows, table period {period}, step {step}: "
                         "the block must be a multiple of the period, and the step at most one period")
    halo = comm.shift_from_right(lde_t[..., :period].contiguous(), mesh)
    block = torch.cat([lde_t, halo], dim=-1)
    return merged_transition(block, mask_tab, ark_tab, alphas, delta, step)[..., :local].contiguous()
