"""Kernel-health report: which hand-written kernels ran, and at what shapes.

Port of :mod:`zkvm.utils.kernel_health`.  The reference probes each Pallas
family once per shape and can latch an XLA fallback, so its report says
which families are live.  The port has no probe and no fallback (a CUDA
tensor launches the kernel or raises), so what it reports is what ran:
the launch ledger ``kernels.launched``, to which every ``launch_*``
wrapper adds its launch under its family (``kernels.FAMILIES``) and shape
once the launch has been made.  This module reads and clears that ledger
(``chip_smoke.py`` and ``zkvm_torch.dist.run`` call it).

A family counts kernel launches, but for two: ``merkle`` counts the
launches the Merkle entry reports (one a tree) and ``multi_eval`` calls
of its entry.  A shape is shown as the wrapper's ``name=value`` pairs
joined by spaces, e.g. ``M=256 B=28 NL=256 variant=r1`` for K1 or
``op=mul n=65536`` for the field ops.  Beside the families,
:func:`plain_calls` counts the calls of the plain versions that a prove on
a card must never take (the multi-eval's float64 product).
"""

from __future__ import annotations

from typing import Dict

import torch

from zkvm_torch import kernels

FAMILIES = kernels.FAMILIES


def reset() -> None:
    """Every launch count of every family to 0."""
    kernels.launched.clear()


def _total(family: str) -> int:
    return sum(k for (name, _), k in kernels.launched.items() if name == family)


def launches() -> Dict[str, int]:
    """Launches per family in this process since the last :func:`reset`."""
    return {family: _total(family) for family in FAMILIES}


def launches_by_shape() -> Dict[str, Dict[str, int]]:
    """Launches per family by shape, keyed as readable strings."""
    out = {family: {} for family in FAMILIES}
    for (family, shape), k in sorted(kernels.launched.items()):
        if family in out:
            out[family][" ".join(f"{name}={value}" for name, value in shape)] = k
    return out


def plain_calls() -> Dict[str, int]:
    """Calls of the plain versions that stand in for a kernel, since the
    last :func:`reset`: on a card only a yardstick takes them."""
    return {"multi_eval": _total("multi_eval_plain")}


def report() -> Dict:
    """Snapshot (call after proving): ``backend`` ("cuda" where this
    process sees a card, else "cpu"), ``launches`` and
    ``launches_by_shape`` per family, ``total`` launches, and
    ``plain_calls``."""
    counts = launches()
    return {"backend": "cuda" if torch.cuda.is_available() else "cpu", "launches": counts,
            "launches_by_shape": launches_by_shape(), "total": sum(counts.values()), "plain_calls": plain_calls()}
