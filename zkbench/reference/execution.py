"""The 28-column execution trace of a run, worked out from the padded code
and the run's inputs alone, as limbs: the column map of
:mod:`zkbench.reference.layout` filled by the rules of the reference
processor (Encrypt-zkVM vm/src/processor/mod.rs:61-117):

* row ``i`` of the clock is ``i``; rows ``0 .. n-1`` of the decoder bits
  (bit ``b`` of the opcode of op ``i + 1``, column ``1 + b``) and of the
  hash flag (1) describe the ``n`` ops, and are 0 after them;
* row ``i`` of the sponge, depth and stack columns is the state after ``i``
  ops (row 0 all zero), and from row ``n`` on the final state repeats;
* the last row of every column is a random nonzero element, drawn in column
  order from a generator seeded with the processor's randomizer seed.

An element is 8 little-endian 16-bit limbs, its 16 bytes as a leaf hashes
them.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from zkbench.reference import f128
from zkbench.reference.layout import TRACE_WIDTH, Columns
from zkbench.reference.rescue import Rescue128, STATE_WIDTH

# the seed of the randomized last row (``vm.run``'s default, the JAX
# package's ``DEFAULT_SEED``)
RANDOM_ROW_SEED = 0xD15EA5E


def limbs(values: Sequence[int]) -> np.ndarray:
    """(n, 8) uint16 limbs of n field elements."""
    buf = b"".join(int(v).to_bytes(16, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, 8)


def element(row: np.ndarray) -> int:
    """The field element of one (8,) limb row."""
    return int.from_bytes(np.ascontiguousarray(row, dtype="<u2").tobytes(), "little")


def sponge_rows(code) -> np.ndarray:
    """(n + 1, 4, 8) limbs of the Rescue sponge's state before the first op
    and after each op of padded ``code``; the last row's first two lanes are
    the program hash."""
    sponge = Rescue128()
    states = [0] * STATE_WIDTH
    for op in code:
        sponge.update(op.code, op.value)
        states.extend(sponge.state)
    return limbs(states).reshape(len(code) + 1, STATE_WIDTH, 8)


def program_hash(sponge: np.ndarray) -> tuple:
    return element(sponge[-1, 0]), element(sponge[-1, 1])


def trace_limbs(code, sponge: np.ndarray, stack_rows: Sequence[tuple], t_len: int) -> np.ndarray:
    """(28, T, 8) uint16 limbs of the trace of a run: its padded ``code``,
    the sponge's states (:func:`sponge_rows`) and the stack after each op
    (:func:`zkbench.reference.machine.run`'s ``rows``)."""
    n = len(code)
    if len(stack_rows) != n or sponge.shape[0] != n + 1 or t_len <= n + 1:
        raise ValueError(f"{n} ops, {len(stack_rows)} stack rows, {sponge.shape[0]} sponge rows, T = {t_len}")
    out = np.zeros((TRACE_WIDTH, t_len, 8), dtype=np.uint16)
    clk = np.arange(t_len, dtype=np.uint32)
    out[Columns.CLK, :, 0] = clk & 0xFFFF
    out[Columns.CLK, :, 1] = clk >> 16
    codes = np.array([op.code for op in code], dtype=np.uint16)
    for b, col in enumerate(Columns.BITS):
        out[col, :n, 0] = (codes >> b) & 1
    out[Columns.HFLAG, :n, 0] = 1
    for lane, col in enumerate(Columns.HASH):
        out[col, : n + 1] = sponge[:, lane]
        out[col, n + 1:] = sponge[-1, lane]
    depth = np.array([0] + [len(s) for s in stack_rows], dtype=np.uint16)
    out[Columns.DEPTH, : n + 1, 0] = depth
    out[Columns.DEPTH, n + 1:, 0] = depth[-1]
    stack = np.zeros((n + 1, 16, 8), dtype=np.uint16)
    flat = [v for s in stack_rows for v in s]
    cells = limbs(flat)
    counts = depth[1:].astype(np.int64)
    rows = np.repeat(np.arange(1, n + 1), counts)
    slots = np.arange(len(flat)) - np.repeat(np.cumsum(counts) - counts, counts)
    stack[rows, slots] = cells
    out[Columns.STACK:, : n + 1] = stack.transpose(1, 0, 2)
    out[Columns.STACK:, n + 1:] = stack[-1][:, None, :]
    rng = random.Random(RANDOM_ROW_SEED)
    out[:, -1] = limbs([rng.randrange(1, f128.P) for _ in range(TRACE_WIDTH)])
    return out
