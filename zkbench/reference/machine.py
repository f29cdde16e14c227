"""The stack machine's outputs and trace length, by the plain semantics of
``zkvm_torch/processor/golden.py::Processor.execute_op`` (its stack and
capacity rules; no sponge), and on request its stack rows.

READ pushes the next public input, READ2 the next ciphertext (k mask lanes
and the body); ADD and MUL take the top two; SADD and SMUL a scalar and the
ciphertext under it (SADD adds delta * scalar to the body alone); ADD2 adds
the top two ciphertexts lane by lane.  The outputs are the 16 stack
registers after the last op; the trace has next_pow2(capacity + 1) rows,
where the capacity starts at 16 and doubles each time the clock reaches it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from zkbench.reference import f128
from zkbench.reference.opcodes import OpCode

MIN_TRACE_LENGTH = 16
MAX_STACK_DEPTH = 16
NUM_RAND_ROWS = 1


class MachineError(Exception):
    pass


def run(code, public: Sequence[int], secret: Sequence[Sequence[int]], lwe_k: int,
        delta: int, rows: Optional[list] = None) -> Tuple[tuple, int]:
    """(the 16 output registers, the trace length) of padded ``code`` on
    these inputs; ``rows``, where given, receives the stack (top first, as
    deep as it is) after each op, a tuple a step."""
    n = lwe_k + 1
    tape_a = [v % f128.P for v in reversed(public)]
    tape_b = [tuple(ct) for ct in reversed(secret)]
    stack = []  # top first
    capacity = MIN_TRACE_LENGTH
    for clk, op in enumerate(code, start=1):
        if clk >= capacity:
            capacity *= 2
        code_ = op.op_code
        if code_ is OpCode.NOOP:
            if rows is not None:
                rows.append(tuple(stack))
            continue
        if code_ is OpCode.PUSH:
            push = [op.value % f128.P]
        elif code_ is OpCode.READ:
            if not tape_a:
                raise MachineError(f"no public input left at step {clk}")
            push = [tape_a.pop()]
        elif code_ is OpCode.READ2:
            if not tape_b:
                raise MachineError(f"no ciphertext left at step {clk}")
            push = [v % f128.P for v in tape_b.pop()]
        elif code_ in (OpCode.ADD, OpCode.MUL):
            if len(stack) < 2:
                raise MachineError(f"stack underflow at step {clk}")
            x, y = stack[0], stack[1]
            del stack[:2]
            push = [f128.fadd(x, y) if code_ is OpCode.ADD else f128.fmul(x, y)]
        elif code_ in (OpCode.SADD, OpCode.SMUL):
            if len(stack) < n + 1:
                raise MachineError(f"stack underflow at step {clk}")
            scalar, ct = stack[0], list(stack[1:n + 1])
            del stack[:n + 1]
            if code_ is OpCode.SADD:
                ct[n - 1] = f128.fadd(ct[n - 1], f128.fmul(delta, scalar))
                push = ct
            else:
                push = [f128.fmul(v, scalar) for v in ct]
        elif code_ is OpCode.ADD2:
            if len(stack) < 2 * n:
                raise MachineError(f"stack underflow at step {clk}")
            push = [f128.fadd(stack[i], stack[i + n]) for i in range(n)]
            del stack[:2 * n]
        else:
            raise MachineError(f"unknown opcode {op}")
        stack[:0] = push
        if len(stack) > MAX_STACK_DEPTH:
            raise MachineError(f"stack overflow at step {clk}")
        if rows is not None:
            rows.append(tuple(stack))
    outputs = tuple(stack) + (0,) * (MAX_STACK_DEPTH - len(stack))
    rows = capacity + NUM_RAND_ROWS
    return outputs, 1 << (rows - 1).bit_length()
