# Copy of zkvm/runtime/__init__.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Native runtime layer: C++ fast paths bound via ctypes.

The trace generator is clk-sequential (stack/sponge recurrences), so it
runs as native host code at ~1-10M ops/s and hands the prover a ready
(28, T, 8) uint32 limb tensor for device upload — the TPU analogue of the
reference's Rust VM runtime (SURVEY.md C5-C9).
"""

from .native import NativeProcessor, native_available

__all__ = ["NativeProcessor", "native_available"]
