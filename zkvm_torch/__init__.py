"""zkvm_torch: the zkvm T-mode STARK prover on PyTorch and CUDA (Hopper).

A port of the transposed-layout, class-decomposed prover of the JAX package
:mod:`zkvm` (``zkvm/prover/pipeline.py::_prove_t``).  The JAX package stays
the reference: every tensor, Merkle root, transcript draw and proof byte of
this package is equal to the reference's (the field arithmetic is exact).

Layer map (mirrors :mod:`zkvm`):

  field/     f128 limb arithmetic in the transposed (..., 8, N) layout
  ntt/       four-step NTT; the stage network is CUDA kernel K1
  hash/      SoA BLAKE3 row hash (CUDA kernel K2) and the Merkle heap
  air/       periodic columns; the fused composition (CUDA kernel K3)
  prover/    the T-mode pipeline, FRI, multi-point evaluation, and copies
             of the JAX package's host modules (options, proof, transcript,
             wire)
  verifier/  copy of the JAX package's host verifier
  csrc/      the CUDA C++ sources, built with nvcc at first use
  vm.py      prove / verify a program

Limbs are ``torch.int32`` tensors holding 16-bit values, laid out
``(..., 8, N)``: the same bits as the reference's ``uint32`` arrays.  The
package never imports JAX; it imports only those :mod:`zkvm` modules that
load without it (field golden, hashes, ISA, FHE, processor, AIR layout and
golden constraints, golden NTT, serde).
"""

__version__ = "0.1.0"
