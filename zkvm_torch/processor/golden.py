# Copy of zkvm/processor/golden.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Golden (Python-int) trace generator.

Reproduces the reference processor semantics exactly
(vm/src/processor/mod.rs:61-117 and the four sub-state-machines):

* the trace length is ``next_pow2(chiplet_capacity + 1)`` where the chiplet
  capacity starts at 16 and doubles whenever clk reaches it (mod.rs:71-79 —
  capacity, not clk, feeds the power-of-two computation);
* stack/sponge/depth columns pad by repeating their final state; decoder
  bits and the hash flag pad with zeros; the clock keeps incrementing;
* the last row of every column is overwritten with a random nonzero value
  (mod.rs:86-92) — here drawn from a *seeded* generator so transcripts are
  reproducible (any nonzero values satisfy the two exempted transitions).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from zkvm_torch.field import f128
from zkvm_torch.hash.rescue import CYCLE_LENGTH, Rescue128
from zkvm_torch.isa.opcodes import OpCode, Operation
from zkvm_torch.isa.program import Program, ProgramInputs

MIN_TRACE_LENGTH = 16
MAX_STACK_DEPTH = 16
NUM_RAND_ROWS = 1


class ProcessorError(Exception):
    pass


class StackError(ProcessorError):
    @staticmethod
    def stack_underflow(op, clk):
        return StackError(f"stack underflow at step {clk} executing {op}")

    @staticmethod
    def stack_overflow(op, clk):
        return StackError(f"stack overflow at step {clk} executing {op}")

    @staticmethod
    def empty_inputs(op, clk):
        return StackError(f"no more input values at step {clk} executing {op}")


class ChipletsError(ProcessorError):
    @staticmethod
    def invalid_operation(op, clk):
        return ChipletsError(
            f"only noop may execute during hash capacity-reset steps; got {op} at step {clk}"
        )

    @staticmethod
    def invalid_trace_length(clk):
        return ChipletsError(
            f"program length must be a multiple of {CYCLE_LENGTH}, got {clk}"
        )


@dataclass
class ExecutionTrace:
    """28 columns of field ints (or a device-ready limb tensor) + metadata.

    ``columns`` (Python ints) come from the golden generator; the native
    C++ generator fills ``limbs`` (28, T, 8) uint32 directly instead and
    leaves ``columns`` as None.
    """

    columns: Optional[List[List[int]]]  # 28 columns, each trace_length long
    program_hash: tuple
    outputs: tuple  # 16 final stack registers
    limbs: object = None  # optional (28, T, 8) uint32 ndarray

    @property
    def length(self) -> int:
        if self.columns is not None:
            return len(self.columns[0])
        return self.limbs.shape[1]

    @property
    def width(self) -> int:
        return 28

    def as_limbs(self):
        """(28, T, 8) uint32 limb tensor (computing it from columns if needed)."""
        if self.limbs is None:
            from zkvm_torch.field.limbs import to_limbs

            self.limbs = to_limbs(self.columns)
        return self.limbs

    def _materialize_columns(self):
        if self.columns is None:
            from zkvm_torch.field.limbs import from_limbs

            host = from_limbs(self.limbs)
            self.columns = [[int(v) for v in host[c]] for c in range(28)]
        return self.columns

    def row(self, i: int) -> List[int]:
        self._materialize_columns()
        return [col[i] for col in self.columns]


class Processor:
    """Executes a compiled program against inputs; emits the trace."""

    def __init__(self, inputs: ProgramInputs):
        self.clk = 0
        key = inputs.server_key
        self.lwe_size = key.lwe_size
        self.server_key = key
        # input tapes popped in order
        self.tape_a = list(inputs.public)[::-1]
        self.tape_b = [tuple(ct.ciphertext) for ct in inputs.secret][::-1]
        self.depth = 0
        # per-step history (row 0 = initial state)
        self.stack_rows: List[List[int]] = [[0] * MAX_STACK_DEPTH]
        self.depth_rows: List[int] = [0]
        self.sponge_rows: List[List[int]] = [[0, 0, 0, 0]]
        self.op_bits_rows: List[List[int]] = []  # written at clk-1
        self.hflag_rows: List[int] = []  # written at clk-1
        self.sponge = Rescue128()
        # chiplet trace capacity (doubles) — feeds final trace length
        self.capacity = MIN_TRACE_LENGTH

    # ------------------------------------------------------------------
    @staticmethod
    def run(program: Program, inputs: ProgramInputs) -> "Processor":
        proc = Processor(inputs)
        for op in program.code:
            proc.execute_op(op)
        proc.program_hash = program.hash
        return proc

    def execute_op(self, op: Operation):
        self.clk += 1
        if self.clk >= self.capacity:
            self.capacity *= 2

        prev = self.stack_rows[self.clk - 1]
        cur = list(prev)  # default: copy previous (noop keeps depth prefix)

        code = op.op_code
        if code is OpCode.NOOP:
            pass
        elif code is OpCode.PUSH:
            cur = self._shift_right(prev, 0, 1, op)
            cur[0] = op.value % f128.P
        elif code is OpCode.READ:
            cur = self._shift_right(prev, 0, 1, op)
            if not self.tape_a:
                raise StackError.empty_inputs(op, self.clk)
            cur[0] = self.tape_a.pop() % f128.P
        elif code is OpCode.READ2:
            if not self.tape_b:
                raise StackError.empty_inputs(op, self.clk)
            ct = self.tape_b.pop()
            cur = self._shift_right(prev, 0, len(ct), op)
            for i, v in enumerate(ct):
                cur[i] = v % f128.P
        elif code in (OpCode.ADD, OpCode.MUL):
            if self.depth < 2:
                raise StackError.stack_underflow(op, self.clk)
            x, y = prev[0], prev[1]
            cur = self._shift_left(prev, 2, 1, op)
            cur[0] = f128.fadd(x, y) if code is OpCode.ADD else f128.fmul(x, y)
        elif code in (OpCode.SADD, OpCode.SMUL):
            n = self.lwe_size
            if self.depth < n + 1:
                raise StackError.stack_underflow(op, self.clk)
            scalar = prev[0]
            ct = prev[1 : n + 1]
            if code is OpCode.SADD:
                # trivial encryption: only the body lane shifts by delta*scalar
                delta = self.server_key.parameters.delta
                out = list(ct)
                out[n - 1] = f128.fadd(out[n - 1], f128.fmul(delta, scalar))
            else:
                out = [f128.fmul(v, scalar) for v in ct]
            cur = self._shift_left(prev, n + 1, 1, op)
            for i, v in enumerate(out):
                cur[i] = v
        elif code is OpCode.ADD2:
            n = self.lwe_size
            if self.depth < 2 * n:
                raise StackError.stack_underflow(op, self.clk)
            out = [f128.fadd(prev[i], prev[i + n]) for i in range(n)]
            cur = self._shift_left(prev, 2 * n, n, op)
            for i, v in enumerate(out):
                cur[i] = v
        else:  # pragma: no cover
            raise ProcessorError(f"unknown opcode {op}")

        self.stack_rows.append(cur)
        self.depth_rows.append(self.depth)

        # decoder: little-endian bit decomposition at row clk-1
        self.op_bits_rows.append([(op.code >> i) & 1 for i in range(5)])

        # chiplet: only NOOP during capacity-reset steps
        if not self.sponge.is_apply_round() and code is not OpCode.NOOP:
            raise ChipletsError.invalid_operation(op, self.clk)
        self.sponge.update(op.code, op.value)
        self.hflag_rows.append(1)
        self.sponge_rows.append(list(self.sponge.state))

    # ------------------------------------------------------------------
    def _shift_right(self, prev, start, count, op):
        self.depth += count
        if self.depth > MAX_STACK_DEPTH:
            raise StackError.stack_overflow(op, self.clk)
        cur = [0] * MAX_STACK_DEPTH
        for i in range(start, self.depth - count):
            cur[i + count] = prev[i]
        return cur

    def _shift_left(self, prev, start, count, op):
        if self.depth < count:
            raise StackError.stack_underflow(op, self.clk)
        cur = [0] * MAX_STACK_DEPTH
        for i in range(count, start):
            cur[i - count] = prev[i]
        for i in range(start, self.depth):
            cur[i - count] = prev[i]
        self.depth -= count
        return cur

    # ------------------------------------------------------------------
    def output(self) -> tuple:
        return tuple(self.stack_rows[self.clk])

    def trace(self, seed: Optional[int] = 0xD15EA5E) -> ExecutionTrace:
        if self.clk % CYCLE_LENGTH != 0:
            raise ChipletsError.invalid_trace_length(self.clk)

        n = self.capacity + NUM_RAND_ROWS
        trace_length = 1 << (n - 1).bit_length()
        clk = self.clk

        cols: List[List[int]] = []
        # 0: clock
        cols.append(list(range(trace_length)))
        # 1-5: decoder bits (zero-padded past program end)
        for b in range(5):
            col = [self.op_bits_rows[i][b] for i in range(clk)]
            col += [0] * (trace_length - clk)
            cols.append(col)
        # 6: hash flag (zero-padded)
        col = list(self.hflag_rows) + [0] * (trace_length - clk)
        cols.append(col)
        # 7-10: sponge state (final state propagated)
        for lane in range(4):
            col = [self.sponge_rows[i][lane] for i in range(clk + 1)]
            col += [col[clk]] * (trace_length - clk - 1)
            cols.append(col)
        # 11: depth helper (final state propagated)
        col = list(self.depth_rows) + [self.depth_rows[clk]] * (trace_length - clk - 1)
        cols.append(col)
        # 12-27: stack registers (final state propagated)
        for r in range(MAX_STACK_DEPTH):
            col = [self.stack_rows[i][r] for i in range(clk + 1)]
            col += [col[clk]] * (trace_length - clk - 1)
            cols.append(col)

        # randomize the last row (nonzero, seeded for reproducibility)
        rng = random.Random(seed)
        for col in cols:
            col[-1] = rng.randrange(1, f128.P)

        return ExecutionTrace(
            columns=cols,
            program_hash=getattr(self, "program_hash", (0, 0)),
            outputs=self.output(),
        )
