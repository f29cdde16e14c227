"""The benchmark's plain reference: frozen copies of the port's host-side
verifier and everything it needs (field, BLAKE3, Rescue, transcript, wire
format, AIR layout and golden constraints, golden NTT), the assembler's
padding and the plain Rescue sponge, a plain stack machine for the outputs
and the trace, and the trace commitment in plain PyTorch.  Nothing here
imports the program (``zkvm_torch``), ``zkvm`` or ``jax``: the yardstick
later changes to the program cannot move."""
