# Frozen copy of zkvm_torch/air/constraints_golden.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Per-frame transition constraint evaluation with Python ints.

The golden oracle for :mod:`zkvm.air.constraints_jax` and the evaluator used
at the out-of-domain point during proving/verification (one frame, host).

Mirrors air/src/constrains.rs + air/src/flags.rs: a frame is (current row,
next row), each a 28-element list; ``ark`` is the 8 periodic round constants
and ``hash_flag`` the CYCLE_MASK value at the frame's step.  FHE constraints
inline the LWE ops algebraically (scalar_add touches only the body lane with
delta * scalar; SURVEY.md section 3.5).
"""

from __future__ import annotations

from typing import List, Sequence

from zkbench.reference.f128 import P
from zkbench.reference import rescue
from zkbench.reference.layout import Columns

LWE_SIZE = 5  # k + 1 with the demo k = 4; stack slots per ciphertext


def _bits(cur: Sequence[int]):
    # AIR bit convention (air/src/flags.rs:15-35): b0 = MSB = column 5
    b0, b1, b2, b3, b4 = cur[5], cur[4], cur[3], cur[2], cur[1]
    return b0, b1, b2, b3, b4


def _not(b):
    return (1 - b) % P


def selectors(cur: Sequence[int]) -> dict:
    b0, b1, b2, b3, b4 = _bits(cur)
    n = _not
    return {
        "shr": b0,
        "shl": b1,
        "add": n(b0) * b1 % P * n(b2) % P * n(b3) % P * n(b4) % P,
        "sadd": n(b0) * b1 % P * n(b2) % P * b3 % P * n(b4) % P,
        "add2": n(b0) * b1 % P * n(b2) % P * b3 % P * b4 % P,
        "mul": n(b0) * b1 % P * n(b2) % P * n(b3) % P * b4 % P,
        "smul": n(b0) * b1 % P * b2 % P * n(b3) % P * n(b4) % P,
        "push": b0 * n(b1) % P * n(b2) % P * n(b3) % P * n(b4) % P,
        "read": b0 * n(b1) % P * n(b2) % P * n(b3) % P * b4 % P,
        "read2": b0 * n(b1) % P * n(b2) % P * b3 % P * n(b4) % P,
        "noop": n(b0) * n(b1) % P * n(b2) % P * n(b3) % P * n(b4) % P,
    }


def opcode_to_element(cur: Sequence[int]) -> int:
    b0, b1, b2, b3, b4 = _bits(cur)
    return (b0 * 16 + b1 * 8 + b2 * 4 + b3 * 2 + b4) % P


def evaluate_transition(
    cur: Sequence[int],
    nxt: Sequence[int],
    hash_flag: int,
    ark: Sequence[int],
    delta: int,
) -> List[int]:
    """All 20 constraint values for one frame (air/src/lib.rs:104-168)."""
    s = lambda i: cur[Columns.STACK + i]
    sn = lambda i: nxt[Columns.STACK + i]
    f = selectors(cur)
    res = [0] * 20

    # 0: clk' - (clk + 1)
    res[0] = (nxt[Columns.CLK] - cur[Columns.CLK] - 1) % P
    # 1: d' - d - shr + shl - 4*read2 + 4*add2
    res[1] = (
        nxt[Columns.DEPTH]
        - cur[Columns.DEPTH]
        - f["shr"]
        + f["shl"]
        - f["read2"] * 4
        + f["add2"] * 4
    ) % P
    # 2: shr * shl
    res[2] = f["shr"] * f["shl"] % P
    # 3: add
    res[3] = f["add"] * (sn(0) - (s(0) + s(1))) % P
    # 4: sadd — out = ct + trivial(scalar): lanes 0..3 copy, body += delta*s0
    acc = 0
    for i in range(LWE_SIZE):
        out_i = s(1 + i)
        if i == LWE_SIZE - 1:
            out_i = (out_i + delta * s(0)) % P
        acc = (acc + sn(i) - out_i) % P
    res[4] = f["sadd"] * acc % P
    # 5: add2 — lane-wise sum of two ciphertexts
    acc = 0
    for i in range(LWE_SIZE):
        acc = (acc + sn(i) - (s(i) + s(LWE_SIZE + i))) % P
    res[5] = f["add2"] * acc % P
    # 6: mul
    res[6] = f["mul"] * (sn(0) - s(0) * s(1)) % P
    # 7: smul — lane-wise scalar product
    acc = 0
    for i in range(LWE_SIZE):
        acc = (acc + sn(i) - s(0) * s(1 + i)) % P
    res[7] = f["smul"] * acc % P
    # 8-10: push/read/read2 shift checks
    res[8] = f["push"] * (sn(1) - s(0)) % P
    res[9] = f["read"] * (sn(1) - s(0)) % P
    res[10] = f["read2"] * (sn(LWE_SIZE) - s(0)) % P
    # 11: noop copy
    res[11] = f["noop"] * (sn(0) - s(0)) % P

    # 12-15: hash round (meet in the middle, air/src/constrains.rs:182-209)
    h0 = cur[Columns.HFLAG]
    state = [cur[c] for c in Columns.HASH]
    step0 = rescue.apply_sbox(state)
    step0 = rescue.apply_mds(step0)
    step0 = [(step0[i] + ark[i]) % P for i in range(4)]
    step0[0] = (step0[0] + opcode_to_element(cur)) % P
    step0[1] = (step0[1] + sn(0) * f["push"]) % P

    state_n = [nxt[c] for c in Columns.HASH]
    step1 = [(state_n[i] - ark[4 + i]) % P for i in range(4)]
    step1 = rescue.apply_inv_mds(step1)
    step1 = rescue.apply_sbox(step1)

    for i in range(4):
        res[12 + i] = (step1[i] - step0[i]) * hash_flag % P * h0 % P

    # 16-19: hash copy / capacity reset (constrains.rs:211-216)
    nf = _not(hash_flag)
    res[16] = (nxt[Columns.HASH[0]] - cur[Columns.HASH[0]]) * nf % P * h0 % P
    res[17] = (nxt[Columns.HASH[1]] - cur[Columns.HASH[1]]) * nf % P * h0 % P
    res[18] = nxt[Columns.HASH[2]] * nf % P * h0 % P
    res[19] = nxt[Columns.HASH[3]] * nf % P * h0 % P

    return res
