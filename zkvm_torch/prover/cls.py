"""The standard-layout class prover ("cls").

Port of the class-decomposed path of ``zkvm.prover.pipeline`` that the
reference takes where T-mode is off (``prove`` with ``ZKVM_CLASS=1
ZKVM_TMODE=0``, its default on the CPU): ``_class_constants``,
``_stage_trace_commit_cls``, ``_stage_composition_cls``,
``_stage_comp_commit_cls``, ``_stage_deep_cls`` and ``_stage_query_rows``,
in the port's transposed (8, N) layout.  Like T-mode it holds one blowup
class of the LDE at a time; unlike T-mode it hoists no inverse out of the
proof: each class inverts its own denominators, as the reference does.

1. trace commit, 3. composition commit, 5. DEEP, 7. query rows: the
   stages it shares with T-mode
   (:class:`~zkvm_torch.prover.pipeline.ClassStages`; the DEEP is
   ``_stage_deep_cls``: the weighted sums in coefficient space, then per
   class one coset NTT of the three combined polynomials (K1) and one
   batch inverse of x - (z, z g, z^8); the sum of (values - OOD values) /
   (x - point));
2. composition, per class r: the class LDE (K1); the merged transition
   with next row +1 and the 16-step periodic patterns (K4); times
   (x - e1)(x - e2) / (x^T - 1); one batch inverse of (x - 1)(x - x_last)
   gives both boundary denominators; plus the two boundary groups.

The OOD frame, FRI and the proof assembly are T-mode's:
:func:`zkvm_torch.prover.pipeline.prove` runs them and these stages for
``mode="cls"``; the proof bytes equal T-mode's and mono's.
"""

from __future__ import annotations

import functools

from zkvm_torch.air import composition as cp
from zkvm_torch.air.transition import merged_transition
from zkvm_torch.field import f128t as ft
from .pipeline import ClassStages, _class_base_t, _class_ntt_blocked, _interleave


@functools.lru_cache(maxsize=None)
def _cls_constants(t_len: int, blowup: int, device):
    """The class constants (each class's domain points x among them) and
    the composition's host constants as device columns (8, 1)."""
    dct = _class_base_t(t_len, blowup, device)
    col = lambda v: ft.const_col(v, device)
    return dict(
        dct,
        inv_xt_cols=[col(v) for v in dct["inv_xt"]],
        one_col=col(1),
        e1_col=col(dct["e1"]),
        e2_col=col(dct["e2"]),
        x_last_col=col(dct["x_last"]),
    )


class ClsStages(ClassStages):
    """The class prover's stages for one proof (per class; no LDE resident,
    every inverse computed in the class that needs it)."""

    def __init__(self, t_len, blowup, device):
        super().__init__(_cls_constants(t_len, blowup, device))

    def composition(self, coeffs_t, alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1):
        """(8, D) composition evaluations, one class at a time."""
        dct = self.dct
        q = []
        for r in range(len(dct["class_scales"])):
            lde = _class_ntt_blocked(coeffs_t, dct, r)
            x = dct["x_cls_t"][r]
            qr = merged_transition(lde, dct["mask_cls_t"][r], dct["ark_cls_t"][r], alphas, delta, 1)
            exempt = ft.fmul(ft.fsub(x, dct["e1_col"]), ft.fsub(x, dct["e2_col"]))
            qr = ft.fmul(qr, ft.fmul(exempt, dct["inv_xt_cols"][r]))
            den0, den1 = ft.fsub(x, dct["one_col"]), ft.fsub(x, dct["x_last_col"])
            inv = ft.batch_inverse(ft.fmul(den0, den1))  # 1 / ((x - 1)(x - x_last))
            qr = ft.fadd(qr, ft.fmul(cp.boundary_group(lde, bcols0, bv0, bb0), ft.fmul(inv, den1)))
            qr = ft.fadd(qr, ft.fmul(cp.boundary_group(lde, bcols1, bv1, bb1), ft.fmul(inv, den0)))
            del lde
            q.append(qr)
        return _interleave(q)
