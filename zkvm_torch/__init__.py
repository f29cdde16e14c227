"""zkvm_torch: the zkvm STARK prover on PyTorch and CUDA (Hopper).

A port of the JAX package :mod:`zkvm`'s prover in two layouts: the
transposed, class-decomposed "T-mode" (``zkvm/prover/pipeline.py::
_prove_t``) and the full-LDE "mono" prover (``prove`` with
``ZKVM_CLASS=0``).  The JAX package stays the reference: every tensor,
Merkle root, transcript draw and proof byte of this package is equal to the
reference's (the field arithmetic is exact), and both modes give the same
bytes.

Layer map (mirrors :mod:`zkvm`):

  field/     f128 limb arithmetic in the transposed (..., 8, N) layout, and
             the golden field
  ntt/       four-step NTT; the stage network is CUDA kernel K1
  hash/      SoA BLAKE3 row hash (CUDA kernel K2), the Merkle heap, and the
             golden BLAKE3 and Rescue
  air/       layout, golden constraints and periodic columns; the fused
             composition (CUDA kernel K3) and the merged transition (K4)
  prover/    the T-mode, mono and cls pipelines, FRI, multi-point
             evaluation, options, proof, transcript and wire format
  dist/      mono sharded by rows over a torch.distributed group: mesh,
             collectives, four-step NTT, ranks spawned on one host
  verifier/  the host verifier
  isa/, processor/, fhe/  assembler, golden processor, LWE
  utils/     serde, the prover's spans (profiler) and the kernel-health report
             (each kernel's launches, by shape)
  csrc/      the CUDA C++ sources, built with nvcc at first use
  convert.py build the port's trace, key and public inputs from plain data
  config.py  the typed configuration (a copy of zkvm/config.py)
  vm.py      prove / verify a program

Limbs are ``torch.int32`` tensors holding 16-bit values, laid out
``(..., 8, N)``: the same bits as the reference's ``uint32`` arrays.  The
package imports neither JAX nor :mod:`zkvm`: the host modules it shares
with the reference are its own copies, each pinned to its original by
``tests/test_torch_prover.py``.
"""

__version__ = "0.1.0"
