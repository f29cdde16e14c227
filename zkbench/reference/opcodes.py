# Frozen copy of zkvm_torch/isa/opcodes.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Instruction set: 9 opcodes with 5-bit codes.

Codes and shift semantics match the reference
(Encrypt-zkVM vm/src/processor/opcodes.rs:27-43).  Bit 4 (MSB) is the
shift-right flag, bit 3 the shift-left flag; the AIR recomposes the code from
the decoder bit columns (air/src/flags.rs:81-87).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class OpCode(enum.IntEnum):
    NOOP = 0b00000
    PUSH = 0b10000  # shift-right 1, carries a u8 immediate
    READ = 0b10001  # shift-right 1
    READ2 = 0b10010  # shift-right lwe_size (5)
    ADD = 0b01000  # shift-left 1
    MUL = 0b01001  # shift-left 1
    SADD = 0b01010  # shift-left 1
    SMUL = 0b01100  # shift-left 1
    ADD2 = 0b01011  # shift-left lwe_size (5)

    def mnemonic(self) -> str:
        return self.name.lower()


# Chiplet hash-op flag column value (opcodes.rs:1-25): always Round = 1.
HASH_ROUND = 1


@dataclass(frozen=True)
class Operation:
    """An opcode plus its optional u8 immediate (only PUSH carries one)."""

    op_code: OpCode
    op_value: int = 0

    def __post_init__(self):
        if not 0 <= self.op_value <= 0xFF:
            raise ValueError(f"op_value must be a u8, got {self.op_value}")
        if self.op_value and self.op_code is not OpCode.PUSH:
            raise ValueError(f"{self.op_code.mnemonic()} carries no immediate")

    @property
    def code(self) -> int:
        return int(self.op_code)

    @property
    def value(self) -> int:
        return self.op_value

    @staticmethod
    def noop() -> "Operation":
        return Operation(OpCode.NOOP)

    @staticmethod
    def push(value: int) -> "Operation":
        return Operation(OpCode.PUSH, value)

    @staticmethod
    def read() -> "Operation":
        return Operation(OpCode.READ)

    @staticmethod
    def read2() -> "Operation":
        return Operation(OpCode.READ2)

    @staticmethod
    def add() -> "Operation":
        return Operation(OpCode.ADD)

    @staticmethod
    def mul() -> "Operation":
        return Operation(OpCode.MUL)

    @staticmethod
    def sadd() -> "Operation":
        return Operation(OpCode.SADD)

    @staticmethod
    def smul() -> "Operation":
        return Operation(OpCode.SMUL)

    @staticmethod
    def add2() -> "Operation":
        return Operation(OpCode.ADD2)

    def __str__(self) -> str:
        if self.op_code is OpCode.PUSH:
            return f"push({self.op_value})"
        return self.op_code.mnemonic()
