# Copy of zkvm/fhe/__init__.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""FHE layer: symmetric LWE over the STARK field f128.

Scheme semantics follow the reference (/root/reference/fhe/src/):

* parameters ``(p, q, delta=q/p, k, std)`` (parameters.rs:4-22);
* binary secret key of length ``k`` (server_key.rs:20-28);
* ciphertext = ``k`` uniform mask elements plus a body
  ``<a, s> + delta * m +/- round(|N(0, std)|)`` (server_key.rs:41-62);
* homomorphic lane-wise ``add``, ``scalar_add`` (trivial encryption of the
  scalar: only the body lane shifts by ``delta * scalar``), and
  ``scalar_mul`` (lane-wise scalar product) (server_key.rs:89-124).

All ops are defined over *field integers* so the AIR can re-run them
symbolically inside constraints; the batched in-trace versions live in
:mod:`zkvm.processor` / :mod:`zkvm.air` as plain lane-wise limb arithmetic.
"""

from .lwe import FheUInt8, LweParameters, ServerKey

__all__ = ["FheUInt8", "LweParameters", "ServerKey"]
