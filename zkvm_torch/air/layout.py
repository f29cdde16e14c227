# Copy of zkvm/air/layout.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Trace layout, public inputs, and boundary assertions.

Column map (air/src/constrains.rs:13-93): clk=0, decoder bits=1..5 (bit i of
the opcode at column 1+i; the AIR's b0 = MSB = column 5), hash flag=6,
sponge=7..10, depth=11, stack=12..27.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

TRACE_WIDTH = 28
NUM_TRANSITION_CONSTRAINTS = 20
NUM_ASSERTIONS = 22
NUM_EXEMPTIONS = 2  # random last row => 2 exempted transitions (air/src/lib.rs:94)

# periodic mask: 1 on cycle steps 0-13 (hash rounds), 0 on 14-15
# (air/src/lib.rs:208-225)
CYCLE_MASK = [1] * 14 + [0] * 2


class Columns:
    CLK = 0
    BITS = (1, 2, 3, 4, 5)  # bit i of opcode at column 1 + i
    HFLAG = 6
    HASH = (7, 8, 9, 10)
    DEPTH = 11
    STACK = 12  # s0..s15 at columns 12..27


@dataclass(frozen=True)
class PublicInputs:
    """program hash (2), stack outputs (16), LWE server key (air/src/lib.rs:18-47).

    ``to_elements`` absorbs only hash + outputs into the transcript (the key
    is not absorbed), matching the reference.
    """

    program_hash: Tuple[int, int]
    stack_outputs: Tuple[int, ...]
    server_key: object

    def to_elements(self) -> List[int]:
        return list(self.program_hash) + list(self.stack_outputs)


def get_assertions(pub_inputs: PublicInputs, trace_length: int) -> List[Tuple[int, int, int]]:
    """22 boundary assertions as (column, step, value) (air/src/lib.rs:170-195)."""
    last_step = trace_length - NUM_EXEMPTIONS
    out: List[Tuple[int, int, int]] = []
    out.append((Columns.CLK, 0, 0))
    out.append((Columns.DEPTH, 0, 0))
    for i in range(2):
        out.append((Columns.HASH[i], 0, 0))
        out.append((Columns.HASH[i], last_step, pub_inputs.program_hash[i]))
    for i in range(8):
        out.append((Columns.STACK + i, 0, 0))
        out.append((Columns.STACK + i, last_step, pub_inputs.stack_outputs[i]))
    return out
