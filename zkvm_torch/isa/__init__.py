# Copy of zkvm/isa/__init__.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""ISA layer: opcode definitions and the assembler (host-side, cheap)."""

from .opcodes import OpCode, Operation
from .program import Program, ProgramError, ProgramInputs

__all__ = ["OpCode", "Operation", "Program", "ProgramError", "ProgramInputs"]
