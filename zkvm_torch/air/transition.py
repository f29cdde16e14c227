"""The merged transition value over a domain: kernel K4.

Port of ``zkvm.air.constraints_pallas.merged_transition_pallas`` and its
entry points ``merged_transition_via_pallas`` (the full LDE domain, next row
+blowup) and ``merged_transition_pallas_pair`` (one blowup class, next row
+1).  :func:`merged_transition` is kernel K4 (``csrc/transition.cu``) for a
CUDA tensor and :func:`merged_transition_plain` for a CPU tensor.

Unlike the TPU kernel, it takes no next-row array and no domain-long
periodic arrays: row n's next row is (n + step) mod N, read in place, and
the periodic columns are tables of length P read at n mod P
(:func:`zkvm_torch.air.periodic.periodic_table` over the full domain, the
16-step class patterns for one class).
"""

from __future__ import annotations

import torch

from zkvm_torch import kernels
from .composition import delta_words, mds_dev, mds_pair, merged_transition_t

launches = 0  # launches of the CUDA kernel in this process
MAX_PERIOD = 1024  # the longest periodic table the kernel stages into shared memory


def merged_transition_plain(lde_t, mask_tab, ark_tab, alphas, delta, step) -> torch.Tensor:
    """Plain version of K4 (same arguments as :func:`merged_transition`):
    the next rows by a cyclic roll, the periodic tables tiled to N."""
    n = lde_t.shape[-1]
    reps = n // mask_tab.shape[-1]
    dev = lde_t.device
    return merged_transition_t(
        lde_t, torch.roll(lde_t, -step, dims=-1), mask_tab.repeat(1, reps),
        ark_tab.repeat(1, 1, reps), *mds_pair(dev), alphas, delta,
    )


def launch_transition(lib, stream, lde_t, mask_tab, ark_tab, alphas, delta, step) -> torch.Tensor:
    """Call the K4 entry point of ``lib``; all limb tensors contiguous int32
    on one device.  It copies nothing to the device, so it never waits for
    the stream."""
    dev = lde_t.device
    n, p = lde_t.shape[-1], mask_tab.shape[-1]
    if not 0 < p <= MAX_PERIOD or n % p or not 0 < step < n:
        raise ValueError(f"transition: N={n}, table length {p}, step {step} unsupported")
    for name, tns, shape in [
        ("lde", lde_t, (28, 8, n)), ("mask", mask_tab, (8, p)), ("ark", ark_tab, (8, 8, p)),
        ("alphas", alphas, (20, 8)),
    ]:
        kernels.expect(tns, shape, dev, name)
    out = torch.empty((8, n), dtype=torch.int32, device=dev)
    p_ = kernels.ptr
    rc = lib.zk_transition(
        p_(lde_t), p_(mask_tab), p_(ark_tab), p_(mds_dev(dev)), p_(alphas), *delta_words(delta),
        p_(out), n, p, step, stream,
    )
    kernels.check(rc, "zk_transition")
    return out


def merged_transition(lde_t, mask_tab, ark_tab, alphas, delta, step) -> torch.Tensor:
    """K4: sum_k alpha_k * gate_k * C_k at every row, (8, N).

    lde_t (28, 8, N) trace evaluations, row n's next row at (n + step) mod
    N; mask_tab (8, P) and ark_tab (8, 8, P) periodic tables read at n mod
    P (P divides N); alphas (20, 8); delta a host int.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (or raises)."""
    global launches
    args = (lde_t, mask_tab, ark_tab, alphas)
    if lde_t.device.type == "cpu":
        return merged_transition_plain(*args, delta, step)
    if lde_t.device.type != "cuda":
        raise ValueError(f"transition: no kernel for device {lde_t.device}")
    out = launch_transition(
        kernels.lib(), kernels.stream_of(lde_t), *(a.contiguous() for a in args), delta, step,
    )
    launches += 1
    return out
