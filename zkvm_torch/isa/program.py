# Copy of zkvm/isa/program.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Assembler: parse `.txt` assembly, pad, and compute the program hash.

Reproduces the reference compile pipeline
(/root/reference/vm/src/program/mod.rs:37-96):

* one op per line; ``#`` starts a comment (full-line or trailing);
* before appending a PUSH, pad with NOOPs so it lands at an index that is a
  multiple of 8 (``PUSH_OP_ALIGNMENT``);
* before appending any op, if the current length modulo 16 is >= 14 (the two
  capacity-reset steps of the Rescue cycle), pad with NOOPs to the next
  multiple of 16 — only NOOPs may execute during those steps;
* finally pad to a multiple of 16 and hash the padded code with the
  Rescue-Prime sponge.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

from zkvm_torch.hash.rescue import CYCLE_LENGTH, NUM_ROUNDS, Rescue128
from .opcodes import OpCode, Operation

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


def _hash_code(code) -> tuple:
    """Rescue-Prime program hash; native fast path for large programs."""
    if len(code) >= 256:
        try:
            from zkvm_torch.runtime.native import program_hash

            digest = program_hash(code)
            if digest is not None:
                return digest
        except Exception:
            pass
    sponge = Rescue128()
    for op in code:
        sponge.update(op.code, op.value)
    return sponge.hash()


@dataclass(frozen=True)
class Program:
    """Compiled (padded) code plus its Rescue-Prime hash digest."""

    code: tuple
    hash: tuple  # (elem0, elem1) digest

    @staticmethod
    def compile(source: str) -> "Program":
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

        digest = _hash_code(code)
        return Program(code=tuple(code), hash=digest)

    @staticmethod
    def load(path: os.PathLike) -> "Program":
        try:
            with open(path, "r") as f:
                source = f.read()
        except OSError as err:
            raise ProgramError(str(err).lower()) from None
        return Program.compile(source)

    def __str__(self) -> str:
        return " ".join(str(op) for op in self.code)


@dataclass(frozen=True)
class ProgramInputs:
    """Inputs to a program run (vm/src/program/inputs.rs:4-30).

    ``public``: u8 values consumed by READ (in order);
    ``secret``: LWE ciphertexts (tuples of field ints) consumed by READ2;
    ``server_key``: the :class:`zkvm.fhe.ServerKey` whose parameters define
    ciphertext width on the stack.
    """

    public: Sequence[int]
    secret: Sequence
    server_key: object
