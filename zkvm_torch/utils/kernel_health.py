"""Kernel-health report: which hand-written kernels ran, and at what shapes.

Port of :mod:`zkvm.utils.kernel_health`.  The reference probes each Pallas
family once per shape and can latch an XLA fallback, so its report says
which families are live.  The port has no probe and no fallback (a CUDA
tensor launches the kernel or raises), so what it reports is what ran:
the launch counters that each kernel's wrapper keeps, per family.  This
module is the one place that reads and resets them (``chip_smoke.py`` and
``zkvm_torch.dist.run`` call it).

Families: K1 ``ntt_stages`` (counted by (M, B, NL, variant) only), K2
``blake3_rows`` (by (C, N)), ``merkle`` (entry calls, one a tree; by leaf
count the kernel launches the entry reported and the trees), K3
``composition`` (by T), K4 ``transition`` (by (N, step)),
``batch_inverse`` (by (R, N)), ``field_ops``, the elementwise add, sub
and mul of ``f128t`` (by operation and output elements),
``multi_eval`` (entry calls, two launches each; by (C, Q, T)) and
``meval_ladders``, the multi-eval's ladder operands (one launch a point
set; by (Q, T)), and the kernels of ``csrc/fri_fold.cu`` and
``csrc/deep.cu``, a family an entry: ``fri_fold`` (one launch a FRI
layer; by n), ``ladder`` (``ntt_t.ladder_t``, the entry of device bases
and scales: the mid twiddles; by (B, n)), ``ladder_const``
(``ntt_t.ladder_t_host``, the entry of a base and a scale known on the
host: every other ladder; by (B, n)), ``weighted_sum`` (the DEEP's column sums; by (K, C, N)) and
``deep_quotient`` (by (K, N)).  Beside
them, :func:`plain_calls` counts the calls of the plain versions that a
prove on a card must never take (the multi-eval's float64 product).
"""

from __future__ import annotations

from typing import Dict

import torch

from zkvm_torch.air import composition as cp
from zkvm_torch.air import transition as tr
from zkvm_torch.field import f128t as ft
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash import merkle as mk
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.prover import deep as dp
from zkvm_torch.prover import fri
from zkvm_torch.prover import multi_eval as me

FAMILIES = ("ntt_stages", "blake3_rows", "merkle", "composition", "transition", "batch_inverse", "field_ops",
            "multi_eval", "meval_ladders", "fri_fold", "ladder", "ladder_const", "weighted_sum", "deep_quotient")
_COUNTED = {"blake3_rows": b3t, "merkle": mk, "composition": cp, "transition": tr, "batch_inverse": ft,
            "multi_eval": me}


def reset() -> None:
    """Every launch counter of every family to 0."""
    for mod in _COUNTED.values():
        mod.launches = 0
    me.ladder_launches = me.plain_calls = fri.fold_launches = nt.ladder_launches = nt.ladder_const_launches = 0
    dp.sum_launches = dp.quotient_launches = 0
    for counter in (nt.launches, b3t.launches_by_shape, cp.launches_by_shape, tr.launches_by_shape,
                    ft.launches_by_shape, mk.launches_by_size, mk.trees_by_size, ft.op_launches,
                    ft.op_launches_by_shape, me.launches_by_shape, me.ladder_launches_by_shape,
                    fri.fold_launches_by_shape, nt.ladder_launches_by_shape, nt.ladder_const_launches_by_shape,
                    dp.sum_launches_by_shape,
                    dp.quotient_launches_by_shape):
        counter.clear()


def launches() -> Dict[str, int]:
    """Launches per family in this process since the last :func:`reset`
    (the Merkle heap: entry calls, one a tree)."""
    return {"ntt_stages": sum(nt.launches.values()), **{name: mod.launches for name, mod in _COUNTED.items()},
            "field_ops": sum(ft.op_launches.values()), "meval_ladders": me.ladder_launches,
            "fri_fold": fri.fold_launches, "ladder": nt.ladder_launches, "ladder_const": nt.ladder_const_launches,
            "weighted_sum": dp.sum_launches,
            "deep_quotient": dp.quotient_launches}


def launches_by_shape() -> Dict[str, Dict[str, int]]:
    """Launches per family by shape, keyed as readable strings."""
    return {
        "ntt_stages": {f"M={m} B={b} NL={nl} {v}": n for (m, b, nl, v), n in sorted(nt.launches.items())},
        "blake3_rows": {f"C={c} N={n}": k for (c, n), k in sorted(b3t.launches_by_shape.items())},
        "merkle": {f"N={n} trees={mk.trees_by_size[n]}": k for n, k in sorted(mk.launches_by_size.items())},
        "composition": {f"T={t}": k for t, k in sorted(cp.launches_by_shape.items())},
        "transition": {f"N={n} step={st}": k for (n, st), k in sorted(tr.launches_by_shape.items())},
        "batch_inverse": {f"R={r} N={n}": k for (r, n), k in sorted(ft.launches_by_shape.items())},
        "field_ops": {f"{op} n={n}": k for (op, n), k in sorted(ft.op_launches_by_shape.items())},
        "multi_eval": {f"C={c} Q={q} T={t}": k for (c, q, t), k in sorted(me.launches_by_shape.items())},
        "meval_ladders": {f"Q={q} T={t}": k for (q, t), k in sorted(me.ladder_launches_by_shape.items())},
        "fri_fold": {f"n={n}": k for n, k in sorted(fri.fold_launches_by_shape.items())},
        "ladder": {f"B={b} n={n}": k for (b, n), k in sorted(nt.ladder_launches_by_shape.items())},
        "ladder_const": {f"B={b} n={n}": k for (b, n), k in sorted(nt.ladder_const_launches_by_shape.items())},
        "weighted_sum": {f"K={k} C={c} N={n}": m for (k, c, n), m in sorted(dp.sum_launches_by_shape.items())},
        "deep_quotient": {f"K={k} N={n}": m for (k, n), m in sorted(dp.quotient_launches_by_shape.items())},
    }


def plain_calls() -> Dict[str, int]:
    """Calls of the plain versions that stand in for a kernel, since the
    last :func:`reset`: on a card only a yardstick takes them."""
    return {"multi_eval": me.plain_calls}


def report() -> Dict:
    """Snapshot (call after proving): ``backend`` ("cuda" where this
    process sees a card, else "cpu"), ``launches`` and
    ``launches_by_shape`` per family, ``total`` launches, and
    ``plain_calls``."""
    counts = launches()
    return {"backend": "cuda" if torch.cuda.is_available() else "cpu", "launches": counts,
            "launches_by_shape": launches_by_shape(), "total": sum(counts.values()), "plain_calls": plain_calls()}
