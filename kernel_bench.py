#!/usr/bin/env python3
"""Time the hand-written kernels K1-K4, the Merkle heap, the batch
inverse, the field-op kernel and the multi-eval kernel on one CUDA card.

    python3 kernel_bench.py [--tree DIR] [--label NAME]
                            [--only K1 K2 K3 K4 Merkle BINV FOPS MEVAL MLAD FRI DEEP] [--large]
    python3 kernel_bench.py --sweep [K1 K2 K3 K4 Merkle BINV FOPS MEVAL MLAD FRI DEEP LT] [--tree DIR] [--label NAME]
    python3 kernel_bench.py --sass [--tree DIR]
    python3 kernel_bench.py --profile [--only Merkle FRI] [--tree DIR] [--label NAME]

The first form times, at the cases of chip_smoke.py's phase (c), the
calls of the ``zkvm_torch`` package found in DIR (default: this checkout)
from the call the prover makes down to the C entry point:

  K1 (zkvm_torch/csrc/ntt_stages.cu), at each launch of the transforms
  of K1_TRANSFORMS, on strided views of the geometry the prover launches
  on (k1_passes; a tree whose K1 takes no strided views cannot run them):
    wrapper  ``ntt_t.pease_stages``,
    launch   ``ntt_t.launch_stages`` (the input checks, the walks and the
             C call);
  K2 (blake3_rows.cu), K3 (composition.cu), K4 (transition.cu), the
  Merkle heap (merkle.cu) and the batch inverse (batch_inverse.cu, BINV):
    wrapper  ``blake3_t.hash_rows_t`` / ``composition.composition_t`` /
             ``transition.merged_transition`` / ``merkle.merkle_flat`` /
             ``f128t.batch_inverse``,
    launch   ``launch_rows`` / ``launch_composition`` /
             ``launch_transition`` / ``launch_heap`` /
             ``launch_batch_inverse`` (the input checks, the constants the
             tree builds per call, the C call),
    entry    the C entry point alone, with the arguments that one launch
             call passed to it, recorded beforehand (see capture_entry).
  the field-op kernel (field_ops.cu, FOPS) at FOP_CASES, the provers'
  operand shapes:
    wrapper  ``f128t.fadd`` / ``fsub`` / ``fmul``,
    launch   ``f128t.launch_field_op`` (the checks, the geometry, the C
             call),
    entry    the C entry alone, as above;
  a tree without the field-op kernel (the parent of its port) times its
  plain-torch ops on the card at the wrapper level alone;
  the multi-eval kernel (multi_eval.cu, MEVAL) at MEVAL_CASES, the OOD
  frame's and the query rows' shapes at T = 2^16 and 2^20:
    rows     ``multi_eval.multi_eval_rows`` (the ladders, the kernel, the
             copy of the result and its ints; host clock, the card
             synchronised at both ends),
    wrapper  ``multi_eval.multi_eval_t`` (the ladders and the kernel),
    ladders  ``multi_eval.launch_ladders`` (the ladder kernel, where the
             tree has it),
    launch   ``multi_eval.launch_multi_eval``,
    entry    the C entry alone, as above,
    plain    ``multi_eval.multi_eval_rows_plain`` (one call);
  a tree without the multi-eval kernel (the parent of its port) times its
  ``multi_eval_rows`` (the float64 product) at the rows level alone; a
  tree whose kernel takes the ladders' limb factors (its parent) builds
  them as its wrapper does (``ladder_factors``).
  the multi-eval's ladder kernel alone (multi_eval.cu, MLAD) at MLAD_CASES
  (the point sets of MEVAL_CASES and the OOD frame's three points):
    ladders  ``multi_eval.launch_ladders``,
    entry    the C entry alone, as above;
  the FRI and DEEP kernels (fri_fold.cu: FRI, the fold at FRI_CASES and
  the ladder at LADDER_CASES through both entries, ``zk_ladder`` of device
  bases and, where the tree has it and B = 1, ``zk_ladder_const`` of host
  ints; deep.cu: DEEP, the column sums at
  DEEP_SUM_CASES and the quotient at DEEP_QUOTIENT_CASES, and a strided
  block of each, DEEP_BLOCK; see fri_deep_cases):
    wrapper  ``fri.fold_t`` / ``ntt_t.ladder_t`` / ``ntt_t.ladder_t_host``
             / ``deep.weighted_sum`` / ``deep.deep_quotient``,
    launch   ``launch_fold`` / ``launch_ladder`` / ``launch_ladder_const``
             / ``launch_weighted_sum`` / ``launch_deep_quotient``,
    entry    the C entry alone, as above,
    plain    the plain version (one call); the tree must have them;
  A tree without the Merkle kernel (the parent of its port) times its
  ``merkle_flat``, plain torch on the card, at the wrapper level alone.
  The Merkle heap's cases are MERKLE_CASES and the sharded path's
  MERKLE_DIST_CASES.
  ``--large`` takes the cases of the 2^20-row path instead: T-mode's and
  cls's (K1_LARGE_TRANSFORMS, K2_LARGE_CASES, K3 and K4's class shape at
  K3_LARGE_T, MERKLE_LARGE_CASES) and mono's over the whole D = 2^23
  domain (K1_MONO_TRANSFORMS, K2_MONO_CASES, K4's mono shape at N = 2^23, step
  8, and the batch inverse's BINV_MONO_CASES); where a tree other than
  this checkout refuses the Merkle heap at 2^23 leaves (the parent of the
  three-level heap), each refused call prints its error; any other error
  is raised.  The batch inverse (``--only BINV``) takes BINV_CASES either
  way: the provers' 2^16 and 2^20 shapes, those of the 2^20-row proves
  included.

For each it prints one JSON line: ``ms``, the card's milliseconds per
call with the calls queued behind a spin (see :func:`cuda_ms`);
``host_ms``, the host's milliseconds to queue one call; and, for K1,
``rate_ms``, three timings of back-to-back calls with no spin (a call
shorter than its host cost is then timed at the host's rate).  So the same
timer runs on two trees (unpack the other one with ``git archive``), in
one process each.  Before the cases it prints the registers and spills
that ptxas reported for each kernel of the tree's library.

``--sweep`` builds one kernel's source (DIR's) alone at each of its other
launch shapes (the ``-D`` defines of SWEEPS; one nvcc each, all started
together, into DIR's ``zkvm_torch/build/sweep``) and prints, for each shape and
case, ptxas's registers, ``ms`` and whether the output equals the plain
version.  The library that the package builds holds only the default
shape.

``--sass`` compiles a probe kernel for each f128 multiply that the tree's
``csrc/f128.cuh`` defines (``zk::mul``, ``zk::mul32``) and prints the
SASS opcode counts of each (cuobjdump), the probe's own loads, stores and
indexing included.

``--profile`` runs torch.profiler (CUPTI) over a few wrapper calls of
each Merkle case (MERKLE_CASES and MERKLE_LARGE_CASES) and each FRI fold
case (FRI_CASES) of DIR's package and prints, per case, the kernels a
call launched, each launch's device time and the gap before it (on the
card's clock; under the profiler it holds the host's cost of a launch,
CUPTI's included), the call's span on the card, and each kernel's
launch record from the trace
(grid, block, registers, shared memory, blocks and warps an SM, the
estimated achieved occupancy).  Stall reasons need ncu, which the card's
machine does not run.

Every form first prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# K1's cases in chip_smoke.py's phase (c): the launches of the main paths'
# transforms, as the prover makes them (each a strided view of the input,
# one intermediate or the output; k1_passes records them): (kind, columns,
# N), kind "ntt", "intt", "class" (a coset scale on the first launch), "lde"
# (the coset LDE of N / 8 coefficients, blowup 8) or "axisP" (the sharded
# NTT's P-point transform along the ranks' axis of an all_to_all's view of
# a (columns, 8, N) block).  At T = 2^16: the 28 trace columns' class NTT
# (256 x 256) and iNTT, the three DEEP columns' class NTT, the size-2^19
# composition iNTT (1024 x 512: pass 1 recurses, 32 x 32), and mono's
# coset LDEs of the 28 trace and the 8 composition columns to D = 2^19
# (the same three passes, the offset ladder on the first)
K1_TRANSFORMS = [("class", 28, 1 << 16), ("intt", 28, 1 << 16), ("class", 3, 1 << 16), ("intt", 1, 1 << 19),
                 ("lde", 28, 1 << 19), ("lde", 8, 1 << 19)]
# the 2^20-row path (zkvm_torch.examples.prove_lr_large): the class NTTs
# recurse (pass 1's 2048 = 32 x 64, then 512 over 2048 lanes), over blocks
# of 7 trace columns, the 8 composition columns, all 28 (the trace iNTT);
# the size-2^23 composition iNTT (128 x 128, then 512 over 2^14 lanes)
K1_LARGE_TRANSFORMS = [("class", 7, 1 << 20), ("class", 8, 1 << 20), ("intt", 28, 1 << 20), ("intt", 1, 1 << 23)]
# the sharded mono path (zkvm_torch.dist.ntt_dist) at T = 2^16: the P-point
# NTTs along the ranks' axis of the trace LDE's 28 columns at P = 2 and 4
# (a rank's block of D / P lanes) and of the composition LDE's 8 at P = 4;
# a rank's local transform with its twiddles as the scale, at P = 2 and 4
K1_DIST_TRANSFORMS = [("axis2", 28, 1 << 18), ("axis4", 28, 1 << 17), ("axis4", 8, 1 << 17),
                      ("class", 28, 1 << 18), ("class", 28, 1 << 17)]
K1_SWEEP_TRANSFORMS = [("class", 28, 1 << 16), ("class", 7, 1 << 20)]
# The other launch shapes of each kernel, as -D defines; the first of each
# list is the shipped default.  K1: (tile, lanes, butterflies per thread).
# K3 / K4: threads per block, the blocks per SM that __launch_bounds__
# asks for (so the register cap: 65536 / (threads x blocks), at most 255)
# and threads per row (2: part A and part B of the body in separate warps).
AIR_SHAPES = [(128, 1, 1), (128, 3, 1), (128, 4, 1), (256, 2, 1), (64, 8, 1),
              (128, 4, 2), (128, 5, 2), (128, 6, 2), (256, 2, 2), (256, 3, 2), (64, 8, 2), (64, 10, 2),
              (64, 12, 2)]
K3_SHAPE, K4_SHAPE = (256, 2, 2), (256, 3, 2)  # the shipped defaults
# K2's cases in chip_smoke.py's phase (c): (C, N), trace rows (C = 28) and
# composition / FRI rows (C = 8), N = 2^16 a class in T-mode, 2^19 the
# whole domain in mono; and the Merkle heap's leaf counts: the trace and
# composition trees (2^19 leaves) and the FRI layers (2^16, 2^13, 2^10)
K2_CASES = [(28, 1 << 16), (8, 1 << 16), (28, 1 << 19), (8, 1 << 19)]
MERKLE_CASES = [1 << 19, 1 << 16, 1 << 13, 1 << 10]
# K2, K3 (T) and the Merkle heap on the 2^20-row path: trace rows and
# composition / FRI rows of 2^20 lanes; the trace and composition trees of
# 2^23 leaves (three launches), the first FRI layer's of 2^20
K2_LARGE_CASES = [(28, 1 << 20), (8, 1 << 20)]
K3_LARGE_T = 1 << 20
MERKLE_LARGE_CASES = [1 << 23, 1 << 20]
# mono at T = 2^20 (D = 2^23): K1 at the launches of the coset LDEs of the
# 28 trace and the 8 composition columns (pass 1 recurses: 128 x 128 with
# the offset ladder on its first launch, then 512 over 2^14 lanes); K2 over the trace (C = 28)
# and composition (C = 8) rows of 2^23 lanes; the batch inverse of the DEEP
# (3, 8, D) and of the constants (2, 8, D); K4's mono shape at MONO_T (N = 8
# MONO_T)
K1_MONO_TRANSFORMS = [("lde", 28, 1 << 23), ("lde", 8, 1 << 23)]
K2_MONO_CASES = [(28, 1 << 23), (8, 1 << 23)]
BINV_MONO_CASES = [(3, 8, 1 << 23), (2, 8, 1 << 23)]
MONO_T = 1 << 20
# K2 and the Merkle heap on the sharded mono path at T = 2^16: a rank's
# block of 2^18 (P = 2) or 2^17 (P = 4) rows
K2_DIST_CASES = [(28, 1 << 18), (8, 1 << 17)]
MERKLE_DIST_CASES = [1 << 18, 1 << 17]
# K2: threads a block, blocks an SM for __launch_bounds__; the first is the
# shipped default
K2_SHAPES = [(256, 2), (128, 1), (64, 1), (256, 1), (128, 4)]
# The batch inverse's cases in chip_smoke.py's phase (c), (..., 8, N): the
# mono DEEP (3, 8, D) at D = 2^19, the T-mode constants' (16, 8, T) at
# 2^16 and 2^20, a class of the DEEP of T-mode and cls (3, 8, T) and of the
# cls composition (8, T) at T = 2^16 and at T = 2^20 (the 2^20-row proves),
# and a rank's block of the sharded mono DEEP (3, 8, D / P) at P = 2 and 4
BINV_CASES = [(3, 8, 1 << 19), (16, 8, 1 << 16), (16, 8, 1 << 20), (3, 8, 1 << 16), (8, 1 << 16),
              (3, 8, 1 << 20), (8, 1 << 20), (3, 8, 1 << 18), (3, 8, 1 << 17)]
# its shapes: elements a thread (K), threads a block (a block's product
# tree has that many leaves); the first is the shipped default
BINV_SHAPES = [(8, 128), (4, 256), (4, 128), (16, 64), (8, 64), (2, 512), (8, 256)]
# The field-op kernel's cases, (op, a's shape, b's shape), at the provers'
# shapes before the DEEP's and FRI's chains became kernels of their own
# (csrc/deep.cu, csrc/fri_fold.cu; several are the kernel's coverage now,
# not the main path's: T-mode still launches the DEEP's x - points and the
# composition's inverse-offset scale, cls and mono their boundary groups):
# the DEEP's weighted columns (T-mode at T = 2^16, C = 28, times a
# weight column) and quotients ((3, 8, T) and the OOD values), FRI's Horner
# step and constants and cls's boundary groups ((8, 2^16)), the
# composition's inverse-offset ladder over D = 2^19, the 2^20 DEEP's
# composition columns (8 columns, a column of weights); then the shapes
# the 2^16 proves launch most (their launches_by_shape): a ladder's
# squarings of one element and doubling steps (8, 32) x (8, 1), and mono's
# DEEP sums over D = 2^19, a block of 4 weighted columns and their adds
FOP_CASES = [("mul", (28, 8, 1 << 16), (28, 8, 1)), ("mul", (3, 8, 1 << 16), (3, 8, 1 << 16)),
             ("sub", (3, 8, 1 << 16), (3, 8, 1)), ("add", (8, 1 << 16), (8, 1 << 16)),
             ("mul", (8, 1 << 16), (8, 1 << 16)), ("mul", (8, 1 << 16), (8, 1)),
             ("mul", (8, 1 << 19), (8, 1 << 19)), ("mul", (8, 8, 1 << 20), (8, 8, 1)),
             ("mul", (8, 1), (8, 1)), ("mul", (8, 32), (8, 1)), ("mul", (4, 8, 1 << 19), (4, 8, 1)),
             ("add", (8, 1 << 19), (8, 1 << 19))]
# its threads a block; the first is the shipped default
FOP_THREADS = [256, 128, 512, 64]
# The multi-eval kernel's cases, (C, Q, T): the OOD frame (28 trace columns
# at z and z g, 8 composition columns at z^8) and the query rows (28 and 8
# columns at 32 points) at T = 2^16 (the bench's chain) and 2^20 (the LR)
MEVAL_CASES = [(28, 2, 1 << 16), (8, 1, 1 << 16), (28, 32, 1 << 16), (8, 32, 1 << 16),
               (28, 2, 1 << 20), (8, 1, 1 << 20), (28, 32, 1 << 20), (8, 32, 1 << 20)]
# its ladder kernel's (Q, T): each point set of MEVAL_CASES and the OOD
# frame's one set of z, z g and z^8 (Q = 3), the provers' since the OOD
# frame reads its two tensors' points from one ladder launch
MLAD_CASES = sorted({(q, t) for _, q, t in MEVAL_CASES} | {(3, 1 << 16), (3, 1 << 20)}, key=lambda qt: (qt[1], qt[0]))
# its launch shapes: threads a block (two warps or more), outputs a
# thread; the first is the shipped default
MLAD_SHAPES = [(64, 2), (64, 1), (64, 4), (32, 2), (32, 4), (32, 8), (64, 8), (128, 2)]
# its tile for 3 points or more: groups (m16 tiles) a warp, warps along the
# groups, points a warp, warps along the points, t a chunk; the first is
# the shipped default (8 groups x 16 points over 8 warps, chunks of 64)
MEVAL_SHAPES = [(2, 4, 8, 2, 64), (2, 4, 8, 2, 32), (4, 2, 4, 2, 64), (2, 4, 8, 1, 64), (2, 4, 4, 2, 64),
                (1, 4, 8, 2, 64)]
# FRI (csrc/fri_fold.cu): the fold's n (groups (8, 8, n)) at every layer
# of a 2^16 prove (D = 2^19: n = 2^16, 2^13, 2^10) and of a 2^20 prove (D
# = 2^23: 2^20 down to 2^8); the ladder's (B, n, x): the FRI remainder's
# scale at 2^16 and 2^20 (x its (8, 1024) and (8, 256) coefficients), and
# the cold constants: a class's points at T = 2^16 and 2^20, a row block of
# mono's domain points (2^19), the mid twiddles of a size-2^19 transform
# (1024 strided bases over 512 lanes, one broadcast scale), and the 2^20
# cold prove's inverse-offset ladder over D = 2^23 (inv_off_t)
FRI_CASES = [1 << 16, 1 << 13, 1 << 10, 1 << 20, 1 << 17, 1 << 14, 1 << 11, 1 << 8]
LADDER_CASES = [(1, 1 << 10, True), (1, 1 << 8, True), (1, 1 << 16, False), (1, 1 << 20, False),
                (1, 1 << 19, False), (1024, 512, False), (1, 1 << 23, False)]
# DEEP (csrc/deep.cu): the column sums (K, C, N) of T-mode and cls (the 28
# trace columns' two weight sets, the 8 composition columns' one, over T
# = 2^16 and 2^20) and of mono at 2^16 (over D = 2^19); the quotient (K, N)
# of a class at T = 2^16 and 2^20 and of mono's 2^19 domain; and mono's
# DEEP at T = 2^20, which reads a row block of 2^19 of its 2^23-lane LDE
# and inverses in place: here a block of (C, 8, 2^21) (DEEP_BLOCK: lanes,
# block)
DEEP_SUM_CASES = [(2, 28, 1 << 16), (1, 8, 1 << 16), (2, 28, 1 << 20), (1, 8, 1 << 20), (2, 28, 1 << 19),
                  (1, 8, 1 << 19)]
DEEP_QUOTIENT_CASES = [(3, 1 << 16), (3, 1 << 20), (3, 1 << 19)]
DEEP_BLOCK = (1 << 21, 1 << 19)
# the fold's field operations an output lane: the inverse 8-point DFT (5
# multiplies, 24 adds or subtracts), Horner (7 and 7), the 1/8 and the
# ladder's step (2 multiplies)
FOLD_MULS, FOLD_ADDS = 14, 31
# the trace's limb transpose, (C, N, 8) -> (C, 8, N): the 2^16 chain's and the
# 2^20 regression's uploaded traces (chip_smoke.py's phase (c), --sweep LT)
LT_CASES = ((28, 1 << 16), (28, 1 << 20))
SWEEPS = {
    "K1": ("ntt_stages.cu", "zk_ntt_stages", [
        {"ZK_K1_TILE": tile, "ZK_K1_LANES": lanes, "ZK_K1_PER_THREAD": k}
        for tile, lanes, k in [(2048, 8, 4)] + [(tile, 8, k) for tile in (1024, 2048, 4096)
                                                for k in (2, 4, 8) if (tile, k) != (2048, 4)]
        + [(tile, 4, k) for tile in (1024, 2048) for k in (2, 4)]]),
    "K2": ("blake3_rows.cu", "zk_blake3_rows", [
        {"ZK_K2_THREADS": th, "ZK_K2_MIN_BLOCKS": mb} for th, mb in K2_SHAPES]),
    # log2 of the nodes a block takes, the sibling units a carry gathers
    # (0: 2^k / 32), threads a block and the blocks an SM must hold
    "Merkle": ("merkle.cu", "zk_merkle_heap", [
        {"ZK_MERKLE_K": k, "ZK_MERKLE_GROUP": g, "ZK_MERKLE_THREADS": th, "ZK_MERKLE_MIN_BLOCKS": mb}
        for k, g, th, mb in [(10, 0, 256, 3), (10, 0, 256, 4), (9, 0, 128, 8), (11, 0, 256, 4), (10, 128, 256, 3),
                             (10, 64, 256, 3)]]),
    "K3": ("composition.cu", "zk_composition", [
        {"ZK_AIR_THREADS": th, "ZK_AIR_MIN_BLOCKS": mb, "ZK_AIR_SPLIT": sp}
        for th, mb, sp in [K3_SHAPE] + [x for x in AIR_SHAPES if x != K3_SHAPE]]),
    "K4": ("transition.cu", "zk_transition", [
        {"ZK_AIR_THREADS": th, "ZK_AIR_MIN_BLOCKS": mb, "ZK_AIR_SPLIT": sp}
        for th, mb, sp in [K4_SHAPE] + [x for x in AIR_SHAPES if x != K4_SHAPE]]),
    "BINV": ("batch_inverse.cu", "zk_batch_inverse", [
        {"ZK_BINV_K": k, "ZK_BINV_THREADS": th} for k, th in BINV_SHAPES]),
    "FOPS": ("field_ops.cu", "zk_field_op", [{"ZK_FOP_THREADS": th} for th in FOP_THREADS]),
    "MEVAL": ("multi_eval.cu", "zk_multi_eval", [
        {"ZK_MEVAL_WM": wm, "ZK_MEVAL_BM": bm, "ZK_MEVAL_WQ": wq, "ZK_MEVAL_BN": bn, "ZK_MEVAL_KC": kc}
        for wm, bm, wq, bn, kc in MEVAL_SHAPES]),
    "MLAD": ("multi_eval.cu", "zk_meval_ladders", [{"ZK_MLAD_THREADS": th, "ZK_MLAD_LANES": ln}
                                                   for th, ln in MLAD_SHAPES]),
    # threads a block, lanes a thread (the fold above its one-lane n and
    # the device-base ladder), the largest n the fold takes at one lane (0:
    # none); the host-constant ladder's lanes above its largest one-lane n
    "FRI": ("fri_fold.cu", "zk_fri_fold", [{"ZK_FOLD_THREADS": th, "ZK_FOLD_LANES": ln, "ZK_FOLD_ONE_LANE_MAX": one,
                                             "ZK_LADDER_LANES": cl, "ZK_LADDER_ONE_LANE_MAX": cone}
                                            for th, ln, one, cl, cone in [
                                                (128, 4, 1 << 17, 8, 1 << 17), (128, 4, 0, 8, 1 << 17),
                                                (64, 4, 1 << 17, 8, 1 << 17), (256, 4, 1 << 17, 8, 1 << 17),
                                                (128, 8, 1 << 17, 8, 1 << 17), (128, 2, 1 << 17, 8, 1 << 17),
                                                (128, 4, 1 << 20, 8, 1 << 17), (32, 4, 1 << 17, 8, 1 << 17),
                                                (128, 4, 1 << 17, 4, 1 << 17), (128, 4, 1 << 17, 16, 1 << 17),
                                                (128, 4, 1 << 17, 32, 1 << 17), (128, 4, 1 << 17, 8, 1 << 15),
                                                (128, 4, 1 << 17, 8, 1 << 19), (128, 4, 1 << 17, 16, 1 << 15),
                                                (128, 4, 1 << 17, 16, 1 << 14), (128, 4, 1 << 17, 16, 1 << 16),
                                                (128, 4, 1 << 17, 32, 1 << 15), (128, 4, 1 << 17, 16, 1 << 13)]]),
    "DEEP": ("deep.cu", "zk_weighted_sum", [{"ZK_DEEP_THREADS": th} for th in (256, 128, 512, 64)]),
    "LT": ("limb_transpose.cu", "zk_limb_transpose", [{"ZK_LT_THREADS": th} for th in (256, 128, 512, 1024, 64)]),
}


def cuda_ms(fn, reps, spin=True):
    """(card ms, host ms) per call, after one warm-up call.

    The card's time is taken by CUDA events around ``reps`` calls.  With
    ``spin`` the card first spins for ~10 ms (torch.cuda._sleep) while the
    host queues the calls, so a call shorter than its host-side launch
    cost is still timed on the card's clock alone, back to back.  The
    host's time is the wall time to queue the calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / reps


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


def _kernel_name(mangled):
    """A readable name of a mangled kernel: its identifier and, for a
    template on one int, that int (ntt_stages_kernel<8>)."""
    if not mangled.startswith("_Z"):  # extern "C"
        return mangled
    i, name = 2 + mangled.startswith("_ZN"), mangled
    while m := re.match(r"\d+", mangled[i:]):
        n = int(m.group())
        name, i = mangled[i + m.end():i + m.end() + n], i + m.end() + n
        if not name.startswith("_GLOBAL__N"):  # skip an anonymous namespace
            break
    arg = re.search(r"ILi(\d+)E", mangled)
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_summary(log):
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads",
    "smem"}} from an ``nvcc -Xptxas -v`` log (the stack frame, spills and
    static shared memory in bytes)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[cur]["smem"] = int(m.group(1))
    return out


def _limbs(rng, shape, dev):
    """Random canonical elements as (..., 8, L) int32 limbs, drawn on
    ``dev`` by torch's generator from a seed that ``rng`` draws (the
    2^23-row cases hold ~1.9e9 limbs)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    limbs = torch.randint(0, 1 << 16, shape, generator=gen, device=dev, dtype=torch.int32)
    limbs[..., 7, :] %= 0xFFFF
    return limbs


def air_cases(limbs, dev, t=1 << 16, k4=("mono", "class"), k3=True):
    """K3 and K4 at the main paths' shapes, one case at a time: (name,
    kind, limb tensors, host arguments).  K3 (with ``k3``) is one class at
    T = 2^16 with the real boundary columns; K4 (the shapes named in
    ``k4``) the mono shape (the full domain D = 8T, next row +8, tables of
    period 128), one class (T, next row +1, 16-step patterns), and the
    sharded mono's halo blocks "halo P=2" and "halo P=4" (D / P + 128 rows,
    next row +8).  ``limbs(shape)`` makes random limbs on ``dev``; a
    smaller ``t`` is for rehearsing on the CPU.  The 2^20-row path
    (T = 2^20) runs K3 (T-mode) and K4's class shape (cls), not its mono
    shape."""
    from zkvm_torch import vm
    from zkvm_torch.air.periodic import periodic_class_patterns, periodic_table
    from zkvm_torch.field.limbs import from_numpy

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    assertions = vm.get_assertions(vm.PublicInputs((1, 2), tuple(range(16)), key), t)
    bcols0 = tuple(c for (c, s, _) in assertions if s == 0)
    bcols1 = tuple(c for (c, s, _) in assertions if s != 0)
    delta = key.parameters.delta
    mask, ark = periodic_class_patterns(t, 8)
    mask_cls = from_numpy(np.ascontiguousarray(mask[3].T), dev)
    ark_cls = from_numpy(np.ascontiguousarray(np.swapaxes(ark[3], -1, -2)), dev)
    rows = lambda k: limbs((8, k)).T.contiguous()  # (k, 8) limbs last
    if k3:
        yield (f"K3 T={t}", "composition",
               [limbs((28, 8, t)), mask_cls, ark_cls, limbs((8, t)), limbs((8, t)), limbs((8, t)), rows(20),
                rows(len(bcols0)), rows(len(bcols0)), rows(len(bcols1)), rows(len(bcols1))],
               (delta, bcols0, bcols1))
    tab = from_numpy(periodic_table(t, 8), dev)
    period = tab.shape[-1]
    for name, n, step, mk, ak in [("mono", 8 * t, 8, tab[0], tab[1:].contiguous()),
                                  ("class", t, 1, mask_cls, ark_cls),
                                  ("halo P=2", 4 * t + period, 8, tab[0], tab[1:].contiguous()),
                                  ("halo P=4", 2 * t + period, 8, tab[0], tab[1:].contiguous())]:
        if name in k4:
            yield f"K4 {name} N={n} step={step}", "transition", [limbs((28, 8, n)), mk, ak, rows(20)], (delta, step)


def binv_name(shape):
    return "BINV " + "x".join(str(n) for n in shape)


def _dims(shape):
    return "(" + ", ".join(f"2^{n.bit_length() - 1}" if n >= 1 << 10 else str(n) for n in shape) + ")"


def fop_name(op, a, b):
    return f"FOPS {op} {_dims(a.shape)} x {_dims(b.shape)}"


def fop_cases(limbs, cases=FOP_CASES):
    """The field-op kernel's cases, one at a time: (name, op, a, b), the
    operands made by ``limbs(shape)``."""
    for op, sa, sb in cases:
        a, b = limbs(sa), limbs(sb)
        yield fop_name(op, a, b), op, a, b


def fop_calls(ft, op):
    """(wrapper, plain version, launch function) of one field op, each
    taking (a, b); a tree without the field-op kernel has no plain names
    and no launch function, and its wrapper is plain torch."""
    wrapper = getattr(ft, f"f{op}")
    if not hasattr(ft, "launch_field_op"):
        return wrapper, wrapper, None
    return wrapper, getattr(ft, f"f{op}_plain"), lambda lib, stream, a, b: ft.launch_field_op(lib, stream, op, a, b)


def meval_name(c, q, t):
    return f"MEVAL C={c} Q={q} T=2^{t.bit_length() - 1}"


def mlad_name(q, t):
    return f"MEVAL ladders Q={q} T=2^{t.bit_length() - 1}"


def meval_points(rng, q):
    """q random points, with 0, 1 and p - 1 among them from q = 4 on."""
    from zkvm_torch.field import f128

    points = [int(rng.integers(0, 2**62)) << 66 | int(rng.integers(0, 2**62)) for _ in range(q)]
    if q >= 4:
        points[1:4] = [0, 1, f128.P - 1]
    return [p % f128.P for p in points]


def meval_plain_t(me, coeffs, points):
    """The plain version's rows as (Q, C, 8) limbs on coeffs' device."""
    from zkvm_torch.field.limbs import from_numpy, to_limbs

    return from_numpy(to_limbs(me.multi_eval_rows_plain(coeffs, points)), coeffs.device)


def meval_operands(me, coeffs, points):
    """The ladder operands of the points as the tree's wrapper makes them,
    the arguments of its ``launch_multi_eval`` after the coefficients: the
    ladder kernel's ``Ladders``, or the parent's limb factors (l1, l2)."""
    from zkvm_torch import kernels
    from zkvm_torch.field.limbs import from_numpy, to_limbs

    bases = from_numpy(to_limbs(points), coeffs.device)
    if hasattr(me, "launch_ladders"):
        return (me.launch_ladders(kernels.lib(), kernels.stream_of(coeffs), bases, coeffs.shape[-1]),)
    return me.ladder_factors(bases, coeffs.shape[-1])


def fri_deep_cases(rng, limbs, only=("FRI", "DEEP")):
    """The cases of the FRI and DEEP kernels, one at a time: dicts of
    ``name``, ``family`` (the kernel-health family), ``wrapper`` and
    ``plain`` (no arguments), ``launch`` (lib, stream), and the work the
    bound counts: ``nbytes`` (each input read once, each output written
    once), ``muls`` and ``adds`` (field operations).  Tensors come from
    ``limbs(shape)`` (canonical limbs on the card), host ints from the
    numpy ``rng``."""
    from zkvm_torch.field import f128
    from zkvm_torch.field.limbs import tensor
    from zkvm_torch.ntt import ntt_t as nt
    from zkvm_torch.prover import deep as dp
    from zkvm_torch.prover import fri

    ints = lambda k: [(int(rng.integers(0, 2**62)) << 66 | int(rng.integers(0, 2**62))) % f128.P for _ in range(k)]
    if "FRI" in only:
        for n in FRI_CASES:
            v, (scale,) = limbs((fri.FOLD, 8, n)), ints(1)
            base = f128.finv(f128.get_root_of_unity(fri.FOLD * n))
            yield dict(name=f"FRI fold n={_dims((n,))[1:-1]}", family="fri_fold",
                       wrapper=lambda v=v, s=scale, b=base: fri.fold_t(v, s, b),
                       plain=lambda v=v, s=scale, b=base: fri.fold_plain(v, s, b),
                       launch=lambda lib, stream, v=v, s=scale, b=base: fri.launch_fold(lib, stream, v, s, b),
                       nbytes=(fri.FOLD + 1) * 32 * n, muls=FOLD_MULS * n, adds=FOLD_ADDS * n)
        for b, n, with_x in LADDER_CASES:
            base = limbs((8, b)).T if b > 1 else limbs((8, 1))[:, 0]  # B strided rows, as the mid twiddles give them
            scale, x = limbs((8, 1))[:, 0], (limbs((8, n)) if with_x else None)
            work = dict(nbytes=(2 if with_x else 1) * 32 * b * n, muls=(2 if with_x else 1) * b * n, adds=0)
            yield dict(name=f"FRI ladder B={b} n={_dims((n,))[1:-1]}" + (" x" if with_x else ""), family="ladder",
                       wrapper=lambda a=(base, scale, n, x): nt.ladder_t(*a),
                       plain=lambda a=(base, scale, n, x): nt.ladder_plain(*a),
                       launch=lambda lib, stream, a=(base, scale, n, x): nt.launch_ladder(lib, stream, *a), **work)
            dev = base.device
            del base, scale
            if b > 1 or not hasattr(nt, "launch_ladder_const"):
                continue
            # the same ladder of a base and a scale that the host knows
            hb, hs = ints(2)
            yield dict(name=f"FRI ladder const B=1 n={_dims((n,))[1:-1]}" + (" x" if with_x else ""),
                       family="ladder_const", wrapper=lambda a=(hb, n, hs, dev, x): nt.ladder_t_host(*a),
                       plain=lambda a=(hb, hs, n, x, dev): nt.ladder_plain(*nt.host_limbs(a[:2], a[4]), *a[2:4]),
                       launch=lambda lib, stream, a=(hb, hs, n, x, dev): nt.launch_ladder_const(lib, stream, *a),
                       **work)
    if "DEEP" not in only:
        return
    lanes, block = DEEP_BLOCK
    sums = [(k, c, n, None) for k, c, n in DEEP_SUM_CASES] + [(2, 28, block, lanes)]
    for k, c, n, whole in sums:
        cols = limbs((c, 8, n)) if whole is None else limbs((c, 8, whole))[:, :, block:2 * block]
        w = [ints(c) for _ in range(k)]
        yield dict(name=f"DEEP sum K={k} C={c} N={_dims((n,))[1:-1]}" + ("" if whole is None else " (a block)"),
                   family="weighted_sum", wrapper=lambda a=(cols, w): dp.weighted_sum(*a),
                   plain=lambda a=(cols, w): torch.stack([dp.weighted_sum_plain(a[0], tensor(wk, a[0].device))
                                                          for wk in a[1]]),
                   launch=lambda lib, stream, a=(cols, w): dp.launch_weighted_sum(lib, stream, *a),
                   nbytes=(c + k) * 32 * n, muls=k * c * n, adds=k * c * n)
    for k, n, whole in [(k, n, None) for k, n in DEEP_QUOTIENT_CASES] + [(3, block, lanes)]:
        vals = limbs((k, 8, n))
        inv = limbs((k, 8, n)) if whole is None else limbs((k, 8, whole))[..., block:2 * block]
        at = ints(k)
        yield dict(name=f"DEEP quotient K={k} N={_dims((n,))[1:-1]}" + ("" if whole is None else " (a block)"),
                   family="deep_quotient", wrapper=lambda a=(vals, at, inv): dp.deep_quotient(*a),
                   plain=lambda a=(vals, at, inv): dp.deep_quotient_plain(a[0], tensor(a[1], a[0].device), a[2]),
                   launch=lambda lib, stream, a=(vals, at, inv): dp.launch_deep_quotient(lib, stream, *a),
                   nbytes=(2 * k + 1) * 32 * n, muls=k * n, adds=2 * k * n)


def clock_ms(fn, reps):
    """Host milliseconds a call, the card synchronised before and after
    the ``reps`` calls (for a call that copies its result to the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def air_calls(kind):
    """(wrapper, plain version, launch function) of K3 or K4."""
    from zkvm_torch.air import composition as cp
    from zkvm_torch.air import transition as tr

    if kind == "composition":
        return cp.composition_t, cp.composition_plain, cp.launch_composition
    return tr.merged_transition, tr.merged_transition_plain, tr.launch_transition


def _words(rng, shape, dev):
    """Random 32-bit words as an int32 tensor (digest words)."""
    return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def hash_cases(rng, dev, k2=K2_CASES, merkle=MERKLE_CASES):
    """K2 and the Merkle heap at the main paths' shapes, one case at a
    time: (name, kind, input tensors): K2 random limbs (C, 8, N), the
    Merkle heap random leaf digests (8, N), as the provers hold them."""
    for c, n in k2:
        yield f"K2 C={c} N={n}", "K2", [_limbs(rng, (c, 8, n), dev)]
    for n in merkle:
        yield f"Merkle N={n}", "Merkle", [_words(rng, (8, n), dev)]


def hash_calls(kind):
    """(wrapper, plain version, launch function) of K2 or the Merkle heap,
    each taking hash_cases' inputs; a tree without the Merkle kernel has
    no launch function, and its wrapper is plain torch."""
    from zkvm_torch.hash import blake3_t as b3t
    from zkvm_torch.hash import merkle as mk

    if kind == "K2":
        return b3t.hash_rows_t, b3t.hash_rows_plain, b3t.launch_rows
    plain = getattr(mk, "merkle_flat_plain", mk.merkle_flat)
    return (lambda l8n: mk.merkle_flat(l8n.T)), (lambda l8n: plain(l8n.T)), getattr(mk, "launch_heap", None)


class _Recorder:
    """A stand-in kernel library whose entry points record their arguments;
    a size query (``*_slices``, ``*_counters``, which the wrapper allocates
    by) answers from the real library."""

    def __init__(self, real):
        self.calls, self.real = [], real

    def __getattr__(self, name):
        if name.endswith(("_slices", "_counters")):
            return getattr(self.real, name)
        return lambda *args: self.calls.append((name, args)) or 0


def capture_entry(kernels, launch, *args):
    """(name, arguments, tensors) of the one C entry call that
    ``launch(lib, stream, *args)`` makes, recorded without launching: the
    tensors whose pointers it passed (the output and any constants it
    built) are returned too, to keep them alive while the entry is timed.
    A launch that holds its operands itself takes ``args`` = (None,) and
    the current stream of the card.  The recorded call adds nothing to the
    tree's launch ledger (``kernels.launched``, where the tree has one)."""
    keep, real_ptr = [], kernels.ptr
    ledger = getattr(kernels, "launched", None)

    def ptr(t):
        keep.append(t)
        return real_ptr(t)

    rec = _Recorder(kernels.lib())
    kernels.ptr = ptr
    if ledger is not None:
        kernels.launched = collections.Counter()
    card = torch.empty(0, device="cuda") if args[0] is None else args[0]
    try:
        launch(rec, kernels.stream_of(card), *(a for a in args if a is not None))
    finally:
        kernels.ptr = real_ptr
        if ledger is not None:
            kernels.launched = ledger
    (name, cargs), = rec.calls
    return name, cargs, keep


def bench_tree(tree, label, only, reps=20, large=False):
    sys.path.insert(0, str(tree))
    from zkvm_torch import kernels
    from zkvm_torch.field import f128t as ft
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    lib, stream = kernels.lib(), kernels.stream_of(torch.empty(1, device=dev))
    _emit({"tree": label, "build_seconds": kernels.build_seconds, "ptxas": ptxas_summary(kernels.build_log)})
    rng = np.random.default_rng(20261017)
    limbs = lambda shape: _limbs(rng, shape, dev)
    if large:
        k1_cases = K1_LARGE_TRANSFORMS + K1_MONO_TRANSFORMS
        hashes = hash_cases(rng, dev, K2_LARGE_CASES + K2_MONO_CASES, MERKLE_LARGE_CASES)
        airs = itertools.chain(air_cases(limbs, dev, K3_LARGE_T, ("class",)),
                               air_cases(limbs, dev, MONO_T, ("mono",), k3=False))
    else:
        k1_cases, airs = K1_TRANSFORMS, air_cases(limbs, dev)
        hashes = hash_cases(rng, dev, merkle=MERKLE_CASES + MERKLE_DIST_CASES)
    for transform in k1_cases if "K1" in only else []:
        for i, rec in enumerate(k1_passes(nt, *transform, dev)):
            name, y, tw, pre, r1, out = k1_case(nt, transform, i, rec, dev, seed=i)
            calls = {"wrapper": lambda: nt.pease_stages(y, tw, pre=pre, r1=r1, out=out),
                     "launch": lambda: nt.launch_stages(lib, stream, y, tw, pre, r1, out)}
            for level, fn in calls.items():
                ms, host_ms = cuda_ms(fn, reps)
                rate = [cuda_ms(fn, reps, spin=False)[0] for _ in range(3)]
                _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms, "rate_ms": rate})
            del y, out, pre, r1
            torch.cuda.empty_cache()
    for name, kind, args in hashes:
        if kind not in only:
            continue
        wrapper, _, launch = hash_calls(kind)
        calls = {"wrapper": lambda: wrapper(*args)}
        if launch is not None:
            cname, cargs, keep = capture_entry(kernels, launch, *args)
            calls["launch"] = lambda: launch(lib, stream, *args)
            calls["entry"] = lambda: kernels.check(getattr(lib, cname)(*cargs), cname)
        # an older tree (the parent of the three-level heap) refuses more
        # than 2^22 leaves: that refusal is printed, any other error raised
        refusable = tree != ROOT and kind == "Merkle" and args[0].shape[-1] > 1 << 22
        for level, fn in calls.items():
            try:
                ms, host_ms = cuda_ms(fn, reps)
            except RuntimeError as err:
                if not refusable:
                    raise
                _emit({"tree": label, "case": name, "level": level, "error": str(err)})
                continue
            _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
        del args, calls
        torch.cuda.empty_cache()
    for shape in (BINV_CASES + (BINV_MONO_CASES if large else [])) if "BINV" in only else []:
        x = _limbs(rng, shape, dev)
        cname, cargs, keep = capture_entry(kernels, ft.launch_batch_inverse, x)
        calls = {
            "wrapper": lambda: ft.batch_inverse(x),
            "launch": lambda: ft.launch_batch_inverse(lib, stream, x),
            "entry": lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        }
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": binv_name(shape), "level": level, "ms": ms, "host_ms": host_ms})
        del x, cargs, keep
        torch.cuda.empty_cache()
    for name, op, a, b in fop_cases(limbs) if "FOPS" in only else []:
        wrapper, _, launch = fop_calls(ft, op)
        calls = {"wrapper": lambda: wrapper(a, b)}
        if launch is not None:
            cname, cargs, keep = capture_entry(kernels, launch, a, b)
            calls["launch"] = lambda: launch(lib, stream, a, b)
            calls["entry"] = lambda: kernels.check(getattr(lib, cname)(*cargs), cname)
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
        del a, b, calls
        torch.cuda.empty_cache()
    for c, q, t in MEVAL_CASES if "MEVAL" in only else []:
        from zkvm_torch.field.limbs import from_numpy, to_limbs
        from zkvm_torch.prover import multi_eval as me

        coeffs, points = _limbs(rng, (c, 8, t), dev), meval_points(rng, q)
        name = meval_name(c, q, t)
        rows_ms = clock_ms(lambda: me.multi_eval_rows(coeffs, points), 3)
        _emit({"tree": label, "case": name, "level": "rows", "ms": rows_ms})
        if hasattr(me, "launch_multi_eval"):
            ops = meval_operands(me, coeffs, points)
            cname, cargs, keep = capture_entry(kernels, me.launch_multi_eval, coeffs, *ops)
            calls = {"wrapper": lambda: me.multi_eval_t(coeffs, points)}
            if hasattr(me, "launch_ladders"):
                bases = from_numpy(to_limbs(points), dev)
                calls["ladders"] = lambda: me.launch_ladders(lib, stream, bases, t)
            calls["launch"] = lambda: me.launch_multi_eval(lib, stream, coeffs, *ops)
            calls["entry"] = lambda: kernels.check(getattr(lib, cname)(*cargs), cname)
            for level, fn in calls.items():
                ms, host_ms = cuda_ms(fn, reps)
                _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
            del ops, cargs, keep, calls
        _emit({"tree": label, "case": name, "level": "plain",
               "ms": cuda_ms(lambda: me.multi_eval_rows_plain(coeffs, points), 1)[0]})
        del coeffs
        torch.cuda.empty_cache()
    for q, t in MLAD_CASES if "MLAD" in only else []:
        from zkvm_torch.field.limbs import from_numpy, to_limbs
        from zkvm_torch.prover import multi_eval as me

        bases = from_numpy(to_limbs(meval_points(rng, q)), dev)
        cname, cargs, keep = capture_entry(kernels, me.launch_ladders, bases, t)
        calls = {"ladders": lambda: me.launch_ladders(lib, stream, bases, t),
                 "entry": lambda: kernels.check(getattr(lib, cname)(*cargs), cname)}
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": mlad_name(q, t), "level": level, "ms": ms, "host_ms": host_ms})
        del bases, cargs, keep, calls
    for case in (fri_deep_cases(rng, limbs, only) if {"FRI", "DEEP"} & set(only) else []):
        cname, cargs, keep = capture_entry(kernels, case["launch"], None)
        calls = {
            "wrapper": case["wrapper"],
            "launch": lambda: case["launch"](lib, stream),
            "entry": lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        }
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": case["name"], "level": level, "ms": ms, "host_ms": host_ms})
        _emit({"tree": label, "case": case["name"], "level": "plain", "ms": cuda_ms(case["plain"], 1)[0]})
        del case, cargs, keep, calls
        torch.cuda.empty_cache()
    for name, kind, args, host in airs:
        if name.split()[0] not in only:
            continue
        wrapper, _, launch = air_calls(kind)
        cname, cargs, keep = capture_entry(kernels, launch, *args, *host)
        calls = {
            "wrapper": lambda: wrapper(*args, *host),
            "launch": lambda: launch(lib, stream, *args, *host),
            "entry": lambda: kernels.check(getattr(lib, cname)(*cargs), cname),
        }
        for level, fn in calls.items():
            ms, host_ms = cuda_ms(fn, reps)
            _emit({"tree": label, "case": name, "level": level, "ms": ms, "host_ms": host_ms})
        del args, cargs, keep
        torch.cuda.empty_cache()


def _geometry(t):
    """(shape, strides, storage offset, storage elements) of a view."""
    return tuple(t.shape), t.stride(), t.storage_offset(), t.untyped_storage().nbytes() // t.element_size()


def k1_passes(nt, kind, cols, n, dev):
    """The K1 launches of one transform (a K1_TRANSFORMS entry) on ``dev``,
    as the tree's wrapper makes them, without running them: (M, y, tw, pre,
    r1, out), y and out as :func:`_geometry` of the views launched on; the
    constants as built."""
    calls = []

    def record(y, tw, pre=None, r1=None, out=None):
        out = torch.empty_like(y) if out is None else out
        calls.append((y.shape[-3], _geometry(y), tw, pre, r1, _geometry(out)))
        return out

    saved = nt.pease_stages
    nt.pease_stages = record
    try:
        x = torch.empty((cols, 8, n // 8 if kind == "lde" else n), dtype=torch.int32, device=dev)
        if kind.startswith("axis"):
            p = int(kind[4:])
            nt._axis_ntt(torch.empty((p, cols, 8, n // p), dtype=torch.int32, device=dev).movedim(0, -3), p, False)
        else:
            {"ntt": nt.ntt_t, "intt": nt.intt_t, "class": lambda v: nt.class_ntt_t(v, 7),
             "lde": lambda v: nt.coset_lde_t(v, 8)}[kind](x)
        del x
    finally:
        nt.pease_stages = saved
    return calls


def _strided(geometry, dev, seed=None):
    """A view of the given geometry over a new buffer: random canonical
    limbs drawn on the card from ``seed``, else empty."""
    shape, stride, offset, size = geometry
    if seed is None:
        buf = torch.empty(size, dtype=torch.int32, device=dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        buf = torch.randint(0, 1 << 16, (size,), generator=gen, device=dev, dtype=torch.int32)
    view = buf.as_strided(shape, stride, offset)
    if seed is not None:
        view[..., 7, :] %= 0xFFFF  # below p
    return view


def k1_case(nt, transform, i, rec, dev, seed=0):
    """(name, y, tw, pre, r1, out) of pass ``i`` of a transform, its input
    drawn from ``seed`` on buffers of the recorded geometry."""
    m, gy, tw, pre, r1, go = rec
    kind, cols, n = transform
    shape = gy[0]
    b = int(np.prod(shape[:-3]))
    variant = "full" if pre is not None else "r1" if r1 is not None else "plain"
    y, out = _strided(gy, dev, seed), _strided(go, dev)
    walk = lambda t: nt._walk(nt._sizes5(t))
    name = (f"K1 {kind} C={cols} N={n} pass {i}: M={m} B={b} NL={shape[-1]} {variant} "
            f"load={walk(y)} store={walk(out)}")
    return name, y, tw, pre, r1, out


def _build_sweep(kernels, kernel):
    """One library of the kernel's source per launch shape of SWEEPS."""
    source, _, shapes = SWEEPS[kernel]
    out = kernels.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    sos, procs = [], []
    for defs in shapes:
        tag = "_".join(str(v) for v in defs.values())
        so = out / f"{kernel}_{tag}_{kernels._digest()}.so"
        flags = [f"-D{k}={v}" for k, v in defs.items()]
        cmd = [nvcc, *kernels.NVCC_FLAGS, *flags, "-shared", "-o", str(so), str(kernels.CSRC / source)]
        sos.append(so)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for so, proc, defs in zip(sos, procs, shapes):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} at {defs}:\n{log[-4000:]}")
        _emit({"sweep_build": kernel, "tree": str(kernels.CSRC.parent.parent), "defines": defs,
               "ptxas": ptxas_summary(log)})
        lib = ctypes.CDLL(str(so))
        for name, args in kernels.SIGNATURES.items():  # the source's entry points
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def sweep(tree, label, kernels_to_sweep, reps=20):
    sys.path.insert(0, str(tree))
    from zkvm_torch import kernels
    from zkvm_torch.ntt import ntt_t as nt

    dev = torch.device("cuda", 0)
    stream = kernels.stream_of(torch.empty(1, device=dev))
    rng = np.random.default_rng(4)
    for kernel in kernels_to_sweep:
        libs = _build_sweep(kernels, kernel)
        shapes = SWEEPS[kernel][2]
        if kernel == "K1":
            cases = []
            for transform in K1_SWEEP_TRANSFORMS:
                for i, rec in enumerate(k1_passes(nt, *transform, dev)):
                    name, y, tw, pre, r1, out = k1_case(nt, transform, i, rec, dev, seed=i)
                    cases.append((name, nt.stages_plain(y, tw, pre, r1),
                                  lambda lib, y=y, tw=tw, pre=pre, r1=r1, out=out:
                                  nt.launch_stages(lib, stream, y, tw, pre, r1, out)))
        elif kernel in ("K2", "Merkle"):
            _, plain, launch = hash_calls(kernel)
            # this tree's Merkle launch returns the heap and the launches it made
            first = lambda out: out[0] if isinstance(out, tuple) else out
            cases = [(name, plain(*args), lambda lib, a=args: first(launch(lib, stream, *a)))
                     for name, kind, args in hash_cases(rng, dev) if kind == kernel]
        elif kernel == "BINV":
            from zkvm_torch.field import f128t as ft

            cases = []
            for shape in BINV_CASES:
                x = _limbs(rng, shape, dev)
                cases.append((binv_name(shape), ft.batch_inverse_plain(x),
                              lambda lib, x=x: ft.launch_batch_inverse(lib, stream, x)))
        elif kernel == "FOPS":
            from zkvm_torch.field import f128t as ft

            cases = []
            for name, op, a, b in fop_cases(lambda shape: _limbs(rng, shape, dev)):
                _, plain, launch = fop_calls(ft, op)
                cases.append((name, plain(a, b), lambda lib, a=a, b=b, f=launch: f(lib, stream, a, b)))
        elif kernel in ("FRI", "DEEP"):
            cases = [(c["name"], c["plain"](), lambda lib, f=c["launch"]: f(lib, stream))
                     for c in fri_deep_cases(rng, lambda shape: _limbs(rng, shape, dev), (kernel,))]
        elif kernel == "LT":
            from zkvm_torch.field import limbs as lm

            cases = []
            for c, n in LT_CASES:
                x = torch.randint(-(1 << 31), 1 << 31, (c, n, 8), device=dev, dtype=torch.int32)
                cases.append((f"LT C={c} N={n}", lm.limb_transpose_plain(x),
                              lambda lib, x=x: lm.launch_limb_transpose(lib, stream, x)))
        elif kernel == "MLAD":
            from zkvm_torch.field.limbs import from_numpy, to_limbs
            from zkvm_torch.prover import multi_eval as me

            flat = lambda lad: torch.cat([lad.digits.flatten().int(), lad.cells.flatten()])
            cases = []
            for q, t in MLAD_CASES:
                bases = from_numpy(to_limbs(meval_points(rng, q)), dev)
                cases.append((mlad_name(q, t), flat(me.ladders_plain(bases, t)),
                              lambda lib, b=bases, t=t: flat(me.launch_ladders(lib, stream, b, t))))
        elif kernel == "MEVAL":
            from zkvm_torch.prover import multi_eval as me

            cases = []
            for c, q, t in MEVAL_CASES:
                coeffs, points = _limbs(rng, (c, 8, t), dev), meval_points(rng, q)
                ops = meval_operands(me, coeffs, points)
                cases.append((meval_name(c, q, t), meval_plain_t(me, coeffs, points),
                              lambda lib, a=coeffs, f=ops: me.launch_multi_eval(lib, stream, a, *f)))
        else:
            cases = []
            for name, kind, args, host in air_cases(lambda shape: _limbs(rng, shape, dev), dev):
                if name.startswith(kernel):
                    _, plain, launch = air_calls(kind)
                    cases.append((name, plain(*args, *host),
                                  lambda lib, a=args, h=host, f=launch: f(lib, stream, *a, *h)))
        for name, want, run in cases:
            for defs, lib in zip(shapes, libs):
                row = {"tree": label, "case": name, **defs}
                try:
                    exact = bool(torch.equal(run(lib), want))
                except RuntimeError as err:  # a shape the card refuses
                    _emit({**row, "error": str(err)})
                    continue
                ms, host_ms = cuda_ms(lambda: run(lib), reps)
                _emit({**row, "exact": exact, "ms": ms, "host_ms": host_ms})
        del cases
        torch.cuda.empty_cache()


_TRACE_SKIP = ("queued", "device", "context", "stream", "correlation", "External id")


def profile(tree, label, only, reps=5):
    """torch.profiler over ``reps`` wrapper calls of each Merkle and FRI
    fold case of the tree's package: per case, the launches of one call
    (each one's mean device time, the mean gap before it, the call's mean
    span on the card) and each kernel's launch record in the trace."""
    sys.path.insert(0, str(tree))
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from zkvm_torch import kernels

    dev = torch.device("cuda", 0)
    kernels.lib()
    rng = np.random.default_rng(20261017)
    cases = []
    if "Merkle" in only:
        wrapper = hash_calls("Merkle")[0]
        cases += [(f"Merkle N={n}", lambda a=_words(rng, (8, n), dev): wrapper(a))
                  for n in MERKLE_CASES + MERKLE_LARGE_CASES]
    if "FRI" in only:
        cases += [(c["name"], c["wrapper"]) for c in fri_deep_cases(rng, lambda shape: _limbs(rng, shape, dev), ("FRI",))
                  if c["family"] == "fri_fold"]
    path = kernels.BUILD / "profile_trace.json"
    for name, fn in cases:
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = sorted((e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"),
                        key=lambda e: e["ts"])
        k = len(events) // reps
        row = {"tree": label, "case": name, "kernels_a_call": k}
        if k and len(events) == k * reps:
            calls = [events[i * k:(i + 1) * k] for i in range(reps)]
            row["launch_us"] = [sum(c[j]["dur"] for c in calls) / reps for j in range(k)]
            row["gap_before_us"] = [sum(c[j]["ts"] - c[j - 1]["ts"] - c[j - 1]["dur"] for c in calls) / reps
                                    for j in range(1, k)]
            row["span_us"] = sum(c[-1]["ts"] + c[-1]["dur"] - c[0]["ts"] for c in calls) / reps
            row["launches"] = [{"name": e["name"], **{a: v for a, v in e.get("args", {}).items()
                                                      if a not in _TRACE_SKIP}} for e in calls[0]]
        else:
            row["kernel_events"] = len(events)
        _emit(row)
    path.unlink(missing_ok=True)


def sass(tree):
    """SASS opcode counts of a probe kernel for each f128 multiply of the
    tree's f128.cuh."""
    sys.path.insert(0, str(ROOT))
    from zkvm_torch import kernels

    header = tree / "zkvm_torch" / "csrc" / "f128.cuh"
    text = header.read_text()
    out = kernels.BUILD / "sass_probe"
    out.mkdir(parents=True, exist_ok=True)
    probes = [f for f in ("mul", "mul32") if re.search(rf"\bfe {f}\(fe a, fe b\)", text)]
    src = [f'#include "{header}"']
    for f in probes:
        src.append(f'extern "C" __global__ void probe_{f}(const zk::fe* a, const zk::fe* b, zk::fe* o, int n) '
                   f"{{ int i = blockIdx.x * blockDim.x + threadIdx.x; if (i < n) o[i] = zk::{f}(a[i], b[i]); }}")
    cu = out / "probe.cu"
    cu.write_text("\n".join(src) + "\n")
    cubin = out / "probe.cubin"
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-o", str(cubin), str(cu)],
                   check=True, capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                      "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    for f in probes:
        ops = sass_opcodes(text, f"probe_{f}")
        _emit({"tree": str(tree), "sass_probe": f"zk::{f}", "total": sum(ops.values()), "opcodes": ops})


def sass_opcodes(sass_text, function):
    """Opcode counts of one function in cuobjdump -sass output."""
    body = sass_text.split(f"Function : {function}\n", 1)[1].split("Function : ", 1)[0]
    ops = {}
    for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)", body):
        ops[op] = ops.get(op, 0) + 1
    return ops


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose zkvm_torch is timed")
    ap.add_argument("--label", default="this", help="name of the tree in the output")
    ap.add_argument("--only", nargs="+", default=["K1", "K2", "K3", "K4", "Merkle", "BINV", "FOPS", "MEVAL", "MLAD",
                                                  "FRI", "DEEP"],
                    choices=["K1", "K2", "K3", "K4", "Merkle", "BINV", "FOPS", "MEVAL", "MLAD", "FRI", "DEEP"],
                    help="kernels to time")
    ap.add_argument("--large", action="store_true", help="the cases of the 2^20-row path")
    ap.add_argument("--sweep", nargs="*", choices=list(SWEEPS), help="time these kernels at each shape of SWEEPS")
    ap.add_argument("--sass", action="store_true", help="SASS counts of the tree's f128 multiplies")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler launches, gaps and occupancy of the Merkle and FRI fold cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: torch.cuda.is_available() is false; this needs a CUDA card")
    _card()
    if args.sweep is not None:
        sweep(args.tree.resolve(), args.label, args.sweep or list(SWEEPS))
    elif args.sass:
        sass(args.tree.resolve())
    elif args.profile:
        profile(args.tree.resolve(), args.label, args.only)
    else:
        bench_tree(args.tree.resolve(), args.label, args.only, large=args.large)


if __name__ == "__main__":
    main(sys.argv[1:])
