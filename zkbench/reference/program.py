# Frozen copy of zkvm_torch/isa/program.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Assembler: parse `.txt` assembly and pad it (the program hash is the
plain sponge's, :func:`zkbench.reference.execution.sponge_rows`).

Reproduces the reference compile pipeline
(Encrypt-zkVM vm/src/program/mod.rs:37-96):

* one op per line; ``#`` starts a comment (full-line or trailing);
* before appending a PUSH, pad with NOOPs so it lands at an index that is a
  multiple of 8 (``PUSH_OP_ALIGNMENT``);
* before appending any op, if the current length modulo 16 is >= 14 (the two
  capacity-reset steps of the Rescue cycle), pad with NOOPs to the next
  multiple of 16 — only NOOPs may execute during those steps;
* finally pad to a multiple of 16; the padded code is hashed with the
  Rescue-Prime sponge.
"""

from __future__ import annotations

from typing import List

from zkbench.reference.rescue import CYCLE_LENGTH, NUM_ROUNDS
from zkbench.reference.opcodes import OpCode, Operation

PUSH_OP_ALIGNMENT = 8

_NO_PARAM_OPS = {
    "read": Operation.read,
    "read2": Operation.read2,
    "add": Operation.add,
    "mul": Operation.mul,
    "sadd": Operation.sadd,
    "smul": Operation.smul,
    "add2": Operation.add2,
}


class ProgramError(Exception):
    """Assembly error; messages mirror vm/src/program/errors.rs."""


def _parse_op(step: int, token: str) -> Operation:
    parts = token.split(".")
    name = parts[0]
    if name == "push":
        if len(parts) == 1:
            raise ProgramError(f"missing parameter for op {parts} at step {step}")
        if len(parts) > 2:
            raise ProgramError(f"extra parameter for op {parts} at step {step}")
        try:
            value = int(parts[1])
            if not 0 <= value <= 255:
                raise ValueError
        except ValueError:
            raise ProgramError(
                f"invalid parameter for op {parts} at step {step}"
            ) from None
        return Operation.push(value)
    if name in _NO_PARAM_OPS:
        if len(parts) > 1:
            raise ProgramError(f"extra parameter for op {parts} at step {step}")
        return _NO_PARAM_OPS[name]()
    raise ProgramError(f"invalid operation {parts} at step {step}")


def _compute_padding(length: int) -> int:
    return length + (CYCLE_LENGTH - (length % CYCLE_LENGTH))


def compile_code(source: str) -> tuple:
    """Padded code of an assembly source (``Program.compile``'s padding,
    without the hash)."""
    tokens: List[str] = []
    for raw_line in source.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        pos = line.find("#")
        if pos >= 0:
            line = line[:pos].strip()
        if line:
            tokens.append(line)

    if not tokens:
        raise ProgramError("a program must contain at least one operation")

    code: List[Operation] = []
    for i, token in enumerate(tokens):
        op = _parse_op(i + 1, token)

        if op.op_code is OpCode.PUSH:
            pad = (PUSH_OP_ALIGNMENT - len(code) % PUSH_OP_ALIGNMENT) % PUSH_OP_ALIGNMENT
            code.extend(Operation.noop() for _ in range(pad))

        if len(code) % CYCLE_LENGTH >= NUM_ROUNDS:
            code.extend(
                Operation.noop() for _ in range(_compute_padding(len(code)) - len(code))
            )

        code.append(op)

    code.extend(Operation.noop() for _ in range(_compute_padding(len(code)) - len(code)))
    return tuple(code)
