# Copy of zkvm/processor/__init__.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Processor layer: execute a program and emit the 28-column execution trace.

Two implementations share one semantics (the reference's
vm/src/processor/, see SURVEY.md C5-C9):

* :mod:`zkvm.processor.golden` — Python ints, obviously correct; the oracle
  and the default for small traces;
* :mod:`zkvm.runtime` — native C++ trace generator (bit-identical, ~100x
  faster), used for large traces feeding the TPU prover.

Trace generation is inherently clk-sequential (<1% of prove time at scale,
SURVEY.md section 7 hard part 3), so it runs on host; the trace moves to
device once and stays there.

Column layout (28 columns):

====  ==========================================
 0    system clock (row i holds i)
 1-5  decoder bits: bit j of the opcode at column 1+j, written at row clk-1
 6    chiplet hash flag (1 while the program executes, written at row clk-1)
 7-10 Rescue sponge state, written at row clk
 11   stack depth helper, written at row clk
 12-27 stack registers s0..s15, written at row clk
====  ==========================================
"""

from .golden import ExecutionTrace, Processor, ProcessorError, StackError, ChipletsError

MIN_TRACE_LENGTH = 16
MAX_STACK_DEPTH = 16
NUM_RAND_ROWS = 1
TRACE_WIDTH = 28

__all__ = [
    "ExecutionTrace",
    "Processor",
    "ProcessorError",
    "StackError",
    "ChipletsError",
    "MIN_TRACE_LENGTH",
    "MAX_STACK_DEPTH",
    "NUM_RAND_ROWS",
    "TRACE_WIDTH",
]
