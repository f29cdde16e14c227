"""The transposed-layout, class-decomposed STARK prover ("T-mode").

Port of ``zkvm.prover.pipeline._prove_t`` and its stages.  The LDE domain
of size D = blowup * T splits into ``blowup`` residue classes (position
i = r + blowup*k); each class is a T-point coset NTT of the trace
coefficients, the AIR's next row is the next index within a class, and the
periodic columns have period 16 within a class — so no stage ever holds
the full (28, 8, D) LDE.  Stages, in proof order:

1. trace commit: iNTT the 28 columns; per class, coset NTT (K1) and BLAKE3
   row hashes (K2); Merkle heap;
2. composition: per class, coset NTT (K1) and the fused composition (K3);
3. composition commit: size-D iNTT, split into 8 columns, per class coset
   NTT (K1) and row hashes (K2); Merkle heap;
4. OOD frame: multi-point evaluation (the kernel ``csrc/multi_eval.cu``);
5. DEEP, the reference's class form (``_stage_deep_cls``; it gives the
   values of its T-mode suffix scan): the weighted column sums in
   coefficient space (two launches of ``csrc/deep.cu``'s sum), then per
   class one coset NTT of the three combined polynomials (K1), one batch
   inverse of x - (z, z g, z^8) and one launch of its quotient;
6. FRI: per layer, group hashes (K2), Merkle heap, one fold launch
   (``csrc/fri_fold.cu``);
7. queries: multi-point evaluation at the query points, Merkle openings.

Transcript and proof bytes are identical to the reference's (exact field
arithmetic).  :func:`prove` also runs the other two layouts, with the same
bytes: the full-LDE prover (:mod:`.mono`) and the standard-layout class
prover (:mod:`.cls`, which shares the commitments, the DEEP and the query
rows of :class:`ClassStages` and inverts per class instead of hoisting
T-mode's domain factors).  All three run up to T = 2^20 in one process
(:mod:`.limits`); from ``limits.CHUNK_T`` on, the stages take the
reference's chunked forms, which change no value.  Over a mesh
(``prove(..., mesh=...)``, :mod:`zkvm_torch.dist`) every rank of a
``torch.distributed`` group runs mono on its row block, with the same bytes.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from zkvm_torch.air.layout import (
    NUM_ASSERTIONS,
    NUM_EXEMPTIONS,
    NUM_TRANSITION_CONSTRAINTS,
    TRACE_WIDTH,
    PublicInputs,
    get_assertions,
)
from zkvm_torch.field import f128
from zkvm_torch.air import composition as cp
from zkvm_torch.air.periodic import periodic_class_patterns
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_limbs, from_numpy, tensor, to_limbs
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash.merkle import DeviceMerkleTree, ShardedMerkleTree, merkle_flat
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.utils.profiler import ROOT, profiler
from . import deep
from . import limits
from . import multi_eval as me
from . import wire
from .fri import FOLD, fri_prove_t, gather_groups
from .options import ProofOptions
from .proof import FriLayerOpening, Proof, QueryOpening
from .transcript import RandomCoin

NUM_COMP_COLUMNS = 8  # ce blowup for max constraint degree 7


@functools.lru_cache(maxsize=None)
def _class_base_t(t_len: int, blowup: int, device):
    """Proof-independent constants of the two class-decomposed provers
    (T-mode and ``cls``) for one (T, blowup, device): the class coset
    bases and their NTT scales, each class's domain points x (``x_cls_t``,
    (B, 8, T): 16 MB at T = 2^16, 256 MB at 2^20, built once instead of a
    ladder each stage), the periodic class patterns, the inverse-offset
    ladder, and the host ints of the composition's domain factors:
    1/(x^T - 1) per class (``inv_xt``), e1, e2 and x_last."""
    d = t_len * blowup
    offset = f128.DOMAIN_OFFSET
    g_trace = f128.get_root_of_unity(t_len)
    w_d = f128.get_root_of_unity(d)
    bases = [f128.fmul(offset, pow(w_d, r, f128.P)) for r in range(blowup)]
    s_t = pow(offset, t_len, f128.P)
    w_b = f128.get_root_of_unity(blowup)
    mask_cls, ark_cls = periodic_class_patterns(t_len, blowup)
    dct = dict(
        d=d,
        g_trace=g_trace,
        w_d=w_d,
        class_bases=bases,
        class_scales=[nt.class_scale(bases[r], t_len, device) for r in range(blowup)],
        mask_cls_t=from_numpy(np.swapaxes(mask_cls, -1, -2), device),  # (B, 8, 16)
        ark_cls_t=from_numpy(np.swapaxes(ark_cls, -1, -2), device),  # (B, 8, 8, 16)
        inv_off_t=nt.ladder_t_host(f128.finv(offset), d, device=device),  # (8, D)
        inv_xt=[f128.finv(f128.fsub(f128.fmul(s_t, pow(w_b, r, f128.P)), 1)) for r in range(blowup)],
        e1=pow(g_trace, t_len - 1, f128.P),
        e2=pow(g_trace, t_len - 2, f128.P),
        x_last=pow(g_trace, t_len - NUM_EXEMPTIONS, f128.P),
    )
    dct["x_cls_t"] = torch.stack([class_points(dct, r, device) for r in range(blowup)])
    return dct


def class_points(dct, r, device):
    """Class r's domain points base_r * g^k, (8, T)."""
    bases = dct["class_bases"]
    return nt.ladder_t_host(dct["g_trace"], dct["d"] // len(bases), bases[r], device)


@functools.lru_cache(maxsize=None)
def _class_constants_t(t_len: int, blowup: int, device):
    """T-mode's constants: the class constants, and the composition's
    domain factors ee = (x-e1)(x-e2)/(x^T-1), i0 = 1/(x-1) and
    i1 = 1/(x-x_last) per class, so T-mode's hot path inverts nothing."""
    dct = _class_base_t(t_len, blowup, device)
    col = lambda v: ft.const_col(v, device)
    ee, den0, den1 = [], [], []
    for r in range(blowup):
        x_r = dct["x_cls_t"][r]
        ex = ft.fmul(ft.fsub(x_r, col(dct["e1"])), ft.fsub(x_r, col(dct["e2"])))
        ee.append(ft.fmul(ex, col(dct["inv_xt"][r])))
        den0.append(ft.fsub(x_r, col(1)))
        den1.append(ft.fsub(x_r, col(dct["x_last"])))
    inv = ft.batch_inverse(torch.stack(den0 + den1))  # (2B, 8, T)
    return dict(dct, ee_cls_t=torch.stack(ee), i0_cls_t=inv[:blowup], i1_cls_t=inv[blowup:])


def _class_ntt(coeffs_t, dct, r):
    return nt.class_ntt_t(coeffs_t, dct["class_bases"][r], dct["class_scales"][r])


def _interleave(per_class):
    """B class tensors (8, T) -> (8, D) in domain order i = r + B*k."""
    return torch.stack(per_class, dim=-1).reshape(8, -1)


def _class_ntt_blocked(coeffs_t, dct, r):
    """Class r's coset NTT of the trace columns; from ``limits.CHUNK_T`` on,
    in ``limits.COLUMN_BLOCKS`` blocks of columns (the reference's
    ``lax.map`` over 4 blocks, pipeline.py:303, :339).  Columns transform
    independently, so the values are the same.  From T = 2^19 the coset
    scale is not fused into K1 (``ntt_t.class_ntt_t`` recurses), and one
    plain limb multiply over all 28 columns allocates ~28 GiB at once at T
    = 2^20; a block needs a quarter of that.  That is the CPU's multiply:
    on a card the field-op kernel allocates its output alone, and the
    trace commit at T = 2^18 peaked at 1.46 GiB in blocks, 1.71 in one
    piece (``chip_smoke.py`` phase g, NVIDIA H100 80GB HBM3)."""
    n_cols, t = coeffs_t.shape[0], coeffs_t.shape[-1]
    blocks = limits.COLUMN_BLOCKS
    if t < limits.CHUNK_T or n_cols % blocks:
        return _class_ntt(coeffs_t, dct, r)
    return torch.cat([_class_ntt(blk, dct, r) for blk in coeffs_t.split(n_cols // blocks)])


def _commit_classes(coeffs_t, dct, class_ntt=_class_ntt):
    """Row hashes of every class's coset evaluations -> Merkle heap over
    the domain-ordered leaves."""
    digs = [b3t.hash_rows_t(class_ntt(coeffs_t, dct, r)) for r in range(len(dct["class_scales"]))]
    return merkle_flat(_interleave(digs).transpose(0, 1))


def _stage_trace_commit_t(cols_t, dct):
    """(28, 8, T) transposed trace -> (coefficients, Merkle heap)."""
    coeffs_t = nt.intt_t(cols_t)
    return coeffs_t, _commit_classes(coeffs_t, dct, _class_ntt_blocked)


def _stage_composition_t(coeffs_t, dct, alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1):
    """Constraint composition per class; returns (8, D) evaluations."""
    q = []
    for r in range(len(dct["class_scales"])):
        lde = _class_ntt_blocked(coeffs_t, dct, r)
        q.append(
            cp.composition_t(
                lde, dct["mask_cls_t"][r], dct["ark_cls_t"][r], dct["ee_cls_t"][r],
                dct["i0_cls_t"][r], dct["i1_cls_t"][r], alphas, bv0, bb0, bv1, bb1,
                delta, bcols0, bcols1,
            )
        )
    return _interleave(q)


def comp_columns(comp_t, inv_off_t, intt=nt.intt_t):
    """(8, D) composition evaluations -> the coefficients of its
    NUM_COMP_COLUMNS column polynomials, (8, 8, T): a size-D iNTT, the
    inverse-offset ladder, and h_k = coeffs[k::8].  Over a mesh, ``intt``
    is the sharded one and the blocks are a rank's: the split is local
    because 8 divides the block (``zkvm/prover/pipeline.py:771-775``)."""
    t = comp_t.shape[-1] // NUM_COMP_COLUMNS
    coeffs = ft.fmul(intt(comp_t), inv_off_t)  # (8, D)
    return coeffs.reshape(8, t, NUM_COMP_COLUMNS).permute(2, 0, 1).contiguous()


def _stage_comp_commit_t(comp_t, dct):
    """(8, D) composition evaluations -> (h coefficients (8, 8, T), heap)."""
    h_t = comp_columns(comp_t, dct["inv_off_t"])
    return h_t, _commit_classes(h_t, dct)


def weighted_host(weights, values) -> int:
    """sum_c weights[c] * values[c] mod p, on the host (the DEEP's
    combined OOD values)."""
    acc = 0
    for w, v in zip(weights, values):
        acc = f128.fadd(acc, f128.fmul(w, v))
    return acc


def _assemble_proof(t_len, options, trace_tree, comp_tree, ood_cur, ood_nxt, ood_comp,
                    fri, nonce, positions, trace_rows, trace_paths, comp_rows, comp_paths, d):
    proof = Proof(
        trace_length=t_len,
        trace_width=TRACE_WIDTH,
        num_queries=options.num_queries,
        blowup=options.blowup,
        grinding_factor=options.grinding_factor,
        fri_folding_factor=options.fri_folding_factor,
        fri_remainder_max_degree=options.fri_remainder_max_degree,
        trace_root=trace_tree.root,
        comp_root=comp_tree.root,
        ood_trace_cur=ood_cur,
        ood_trace_nxt=ood_nxt,
        ood_comp=ood_comp,
        fri_roots=[t.root for t in fri.trees],
        fri_remainder=fri.remainder,
        pow_nonce=nonce,
    )
    for p, trow, tpath, crow, cpath in zip(positions, trace_rows, trace_paths, comp_rows, comp_paths):
        proof.queries.append(
            QueryOpening(position=p, trace_row=trow, trace_path=tpath, comp_row=crow, comp_path=cpath)
        )
    # FRI openings per layer
    size = d
    layer_positions = list(positions)
    for layer_idx, tree in enumerate(fri.trees):
        group_idx = sorted(set(p % (size // FOLD) for p in layer_positions))
        gathered = from_limbs(gather_groups(fri, layer_idx, group_idx))
        groups_host = {j: [int(v) for v in g] for j, g in zip(group_idx, gathered)}
        paths_host = dict(zip(group_idx, tree.open_many(group_idx)))
        layer = []
        folded = []
        for p in layer_positions:
            j = p % (size // FOLD)
            layer.append(FriLayerOpening(group=groups_host[j], path=paths_host[j]))
            folded.append(j)
        proof.fri_openings.append(layer)
        layer_positions = folded
        size //= FOLD
    return proof


def _trace_limbs_t(trace) -> np.ndarray:
    """(28, 8, T) uint32 limbs of an ExecutionTrace, converted from its
    columns once and kept on the trace (as ``ExecutionTrace.as_limbs``
    does, without its JAX import)."""
    if trace.limbs is None:
        trace.limbs = to_limbs(trace.columns)  # (28, T, 8)
    return np.ascontiguousarray(np.swapaxes(np.asarray(trace.limbs), 1, 2))


# The reference's profiler phase of each stage (``zkvm/prover/pipeline.py:
# 1200-1291``); ``stage_seconds`` and ``stage_peaks`` keep the stage names
PROFILE_PHASES = {"constants": "constants", "trace_commit": "trace_lde_commit", "composition": "constraint_eval",
                  "comp_commit": "composition_commit", "ood": "ood_eval", "deep": "deep_composition",
                  "fri": "fri", "queries": "query_assembly"}


class _Stages:
    """The one stage timer of :func:`prove`: each stage is the span
    ``zkvm.<stage>`` of the profiler (:mod:`zkvm_torch.utils.profiler`),
    recorded under its :data:`PROFILE_PHASES` name, with ``rows`` where the
    reference gives them.  When asked for stage seconds or peaks, or while
    the profiler is enabled, the device is synchronised at the end of each
    stage, so a stage's time includes its kernels: ``seconds`` receives
    each stage's wall clock and, on a card, ``peaks`` each stage's peak
    allocated device bytes (the allocator's peak is reset at each stage's
    start)."""

    def __init__(self, seconds, device, peaks=None):
        self.seconds = seconds
        self.device = torch.device(device)
        self.sync = self.device.type == "cuda"
        self.peaks = peaks if self.sync else None
        self.timed = seconds is not None or self.peaks is not None or profiler.enabled

    @contextlib.contextmanager
    def __call__(self, name, rows=None):
        with profiler.phase(name, rows, PROFILE_PHASES[name], self.device):
            if not self.timed:
                yield
                return
            if self.peaks is not None:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            yield
            if self.sync:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if self.seconds is not None:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self.peaks is not None:
                self.peaks[name] = max(self.peaks.get(name, 0), torch.cuda.max_memory_allocated(self.device))


class ClassStages:
    """The stages that T-mode and the class prover share: the two
    commitments (per-class coset NTTs, row hashes, one Merkle heap), the
    DEEP and the query rows, over the class constants ``dct``."""

    def __init__(self, dct):
        self.dct = dct
        self.d, self.g_trace = dct["d"], dct["g_trace"]

    def trace_commit(self, cols_t):
        return _stage_trace_commit_t(cols_t, self.dct)

    def comp_commit(self, comp_t):
        return _stage_comp_commit_t(comp_t, self.dct)

    def deep(self, coeffs_t, h_t, gammas, deltas, epsilons, points, ood):
        """DEEP witness Y over the domain, (8, D): the three combined
        polynomials evaluated per class, each quotient pointwise
        (``_stage_deep_cls``): sum of (values - OOD values) / (x - point)
        over the points z, z g and z^8, with one batch inverse a class."""
        dev = coeffs_t.device
        dct = self.dct
        abc = torch.empty((3, 8, coeffs_t.shape[-1]), dtype=torch.int32, device=dev)  # the combined coefficients
        with profiler.phase("deep.sums"):
            deep.weighted_sum(coeffs_t, [gammas, deltas], out=abc[:2])
            deep.weighted_sum(h_t, [epsilons], out=abc[2:])
        ood_cur, ood_nxt, ood_comp = ood
        at = [weighted_host(gammas, ood_cur), weighted_host(deltas, ood_nxt), weighted_host(epsilons, ood_comp)]
        pts = tensor(list(points), dev)[:, :, None]  # z, z g, z^8: (3, 8, 1)
        y = []
        for r in range(len(dct["class_scales"])):
            with profiler.phase("deep.class"):
                vals = _class_ntt(abc, dct, r)  # (3, 8, T)
                inv = ft.batch_inverse(ft.fsub(dct["x_cls_t"][r], pts))
                y.append(deep.deep_quotient(vals, at, inv))
        return _interleave(y)

    def query_rows(self, coeffs_t, h_t, positions):
        """Evaluate the committed polynomials at the query points (equal
        to the LDE rows there)."""
        x_pts = [f128.fmul(f128.DOMAIN_OFFSET, pow(self.dct["w_d"], p, f128.P)) for p in positions]
        return tuple(me.multi_eval_rows_many((coeffs_t, h_t), x_pts))  # one ladder operand for both


class _TModeStages(ClassStages):
    """The T-mode stages behind :func:`prove` (per class; no LDE resident)."""

    def __init__(self, t_len, blowup, device):
        super().__init__(_class_constants_t(t_len, blowup, device))

    def composition(self, coeffs_t, alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1):
        return _stage_composition_t(coeffs_t, self.dct, alphas, bv0, bb0, bv1, bb1, delta,
                                    bcols0, bcols1)


MODES = ("tmode", "mono", "cls")
MAX_TRACE_LENGTH = {"tmode": limits.TMODE_MAX_TRACE_LENGTH, "mono": limits.MONO_MAX_TRACE_LENGTH,
                    "cls": limits.CLS_MAX_TRACE_LENGTH}


def prove(trace, pub_inputs: PublicInputs, options: ProofOptions = ProofOptions(),
          device=None, stage_seconds=None, mode=None, stage_peaks=None, mesh=None) -> Proof:
    """Prove an execution trace on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``; without a card a CUDA call raises).

    ``mode``: ``"tmode"`` (the default; the class-decomposed prover with
    the domain factors hoisted into its constants), ``"mono"`` (the
    full-LDE prover of :mod:`zkvm_torch.prover.mono`) or ``"cls"`` (the
    standard-layout class prover of :mod:`zkvm_torch.prover.cls`, which
    inverts per class); all three give the same bytes.  ``mesh`` (a
    :class:`zkvm_torch.dist.mesh.Mesh`; every rank of its group calls
    ``prove`` at once) shards mono's stages by rows over the group, as
    the reference's ``prove(..., mesh=...)`` does; the proof bytes are the
    same at every group size, and every rank returns the proof.  A mesh
    means mono (another ``mode`` raises) on the mesh's device.
    ``stage_seconds``: a dict to receive each stage's wall-clock seconds,
    ``stage_peaks`` (on a card) each stage's peak allocated device bytes;
    the device is synchronised per stage only when one is given or the
    profiler (:mod:`zkvm_torch.utils.profiler`) is enabled, which then
    records each stage under the reference's phase name; the whole prove is
    the profiler's root span ``zkvm.prove``.  T-mode, cls and
    mono take T <= 2^20, and mono over P ranks T <= 2^17 P
    (:mod:`.limits`)."""
    with profiler.phase(ROOT):
        return _prove(trace, pub_inputs, options, device, stage_seconds, mode, stage_peaks, mesh)


def _prove(trace, pub_inputs, options, device, stage_seconds, mode, stage_peaks, mesh) -> Proof:
    t_len = trace.length
    ranks = 1
    if mesh is not None:
        if mode not in (None, "mono"):
            raise ValueError(f"mode {mode!r} with a mesh: the sharded prover is mono's layout "
                             "(the reference's mesh path); pass mode='mono' or no mode")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"prove: device {device} differs from the mesh's {mesh.device}")
        mode, device, ranks = "mono", mesh.device, mesh.size
        if ranks & (ranks - 1) or t_len % ranks:
            raise ValueError(f"prove: a mesh of {ranks} ranks; it must be a power of two dividing T = {t_len}")
    mode = mode or "tmode"
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    limit = MAX_TRACE_LENGTH[mode] if mesh is None else limits.MONO_RANK_MAX_TRACE_LENGTH * ranks
    if t_len > limit:
        raise ValueError(f"{mode}: trace length {t_len} > {limit} is not supported")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prove: no CUDA card here; pass device='cpu' to prove on the CPU")
    blowup = options.blowup
    delta = pub_inputs.server_key.parameters.delta
    stage = _Stages(stage_seconds, device, stage_peaks)
    tree = DeviceMerkleTree
    with stage("constants"):
        if mesh is not None:
            from .mono import ShardedMonoStages

            stages = ShardedMonoStages(t_len, blowup, mesh)
            tree = functools.partial(ShardedMerkleTree, mesh=mesh)
        elif mode == "mono":
            from .mono import MonoStages

            stages = MonoStages(t_len, blowup, device)
        elif mode == "cls":
            from .cls import ClsStages

            stages = ClsStages(t_len, blowup, device)
        else:
            stages = _TModeStages(t_len, blowup, device)
    d = stages.d

    assertions = get_assertions(pub_inputs, t_len)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)

    # ---- 1. trace LDE + commitment -----------------------------------
    with stage("trace_commit", rows=d):
        with profiler.phase("trace_commit.transpose"):
            limbs = _trace_limbs_t(trace)
        with profiler.phase("trace_commit.upload"):
            cols_t = from_numpy(limbs, device)
            del limbs
        with profiler.phase("trace_commit.lde"):
            coeffs_t, trace_nodes = stages.trace_commit(cols_t)
        with profiler.phase("trace_commit.tree"):
            trace_tree = tree(trace_nodes)
            del cols_t
            trace_root = trace_tree.root

    # the transcript's draws between the stages run on the host (BLAKE3 in
    # Python), with the card idle: a span of their own
    with profiler.phase("transcript"):
        coin = RandomCoin(wire.coin_seed(t_len, TRACE_WIDTH, options, pub_inputs))
        coin.reseed(trace_root)
        alphas = coin.draw_elements(NUM_TRANSITION_CONSTRAINTS)
        betas = coin.draw_elements(NUM_ASSERTIONS)

    # ---- 2. constraint composition -----------------------------------
    vals0 = [v for (c, s, v) in assertions if s == 0]
    vals1 = [v for (c, s, v) in assertions if s != 0]
    b0 = [b for (c, s, v), b in zip(assertions, betas) if s == 0]
    b1 = [b for (c, s, v), b in zip(assertions, betas) if s != 0]
    with stage("composition", rows=d):
        comp_t = stages.composition(
            coeffs_t, tensor(alphas, device), tensor(vals0, device), tensor(b0, device),
            tensor(vals1, device), tensor(b1, device), delta, bcols0, bcols1,
        )

    # ---- 3. composition commitment -----------------------------------
    with stage("comp_commit", rows=d):
        h_t, comp_nodes = stages.comp_commit(comp_t)
        comp_tree = tree(comp_nodes)
        del comp_t
        comp_root = comp_tree.root

    # ---- 4. OOD frame -------------------------------------------------
    with profiler.phase("transcript"):
        coin.reseed(comp_root)
        z = coin.draw()
        zg = f128.fmul(z, stages.g_trace)
        z_m = pow(z, NUM_COMP_COLUMNS, f128.P)
    with stage("ood"):
        # one ladder operand for z, z g and z^8 (all known before the first
        # reseed): the trace columns at the first two, the composition's at
        # the third
        (ood_cur, ood_nxt), (ood_comp,) = me.multi_eval_rows_many((coeffs_t, h_t), [z, zg, z_m],
                                                                   spans=((0, 2), (2, 3)))
        coin.reseed_with_elements(ood_cur + ood_nxt)
        coin.reseed_with_elements(ood_comp)

    # winterfell 0.9 DEEP coefficients: one per trace column (shared by the
    # z and z*g terms) and one per composition column
    with profiler.phase("transcript"):
        gammas = coin.draw_elements(TRACE_WIDTH)
        deltas = gammas
        epsilons = coin.draw_elements(NUM_COMP_COLUMNS)

    # ---- 5. DEEP ------------------------------------------------------
    with stage("deep", rows=d):
        y_t = stages.deep(coeffs_t, h_t, gammas, deltas, epsilons, (z, zg, z_m),
                          (ood_cur, ood_nxt, ood_comp))

    # ---- 6. FRI -------------------------------------------------------
    with stage("fri", rows=d):
        fri = fri_prove_t(coin, y_t, f128.DOMAIN_OFFSET, options)

    with profiler.phase("transcript"):
        nonce = 0
        while coin.leading_zeros(nonce) < options.grinding_factor:
            nonce += 1
        # winterfell sorts and deduplicates the drawn positions
        positions = sorted(set(coin.draw_integers(options.num_queries, d, nonce)))

    # ---- 7. queries ---------------------------------------------------
    with stage("queries"):
        with profiler.phase("queries.rows"):
            trace_rows, comp_rows = stages.query_rows(coeffs_t, h_t, positions)
        with profiler.phase("queries.paths"):
            trace_paths = trace_tree.open_many(positions)
            comp_paths = comp_tree.open_many(positions)
        with profiler.phase("queries.assemble"):
            proof = _assemble_proof(
                t_len, options, trace_tree, comp_tree, ood_cur, ood_nxt, ood_comp,
                fri, nonce, positions, trace_rows, trace_paths, comp_rows, comp_paths, d,
            )
    return proof
