"""Prover layer: the STARK pipeline on PyTorch and CUDA, in T-mode
(``pipeline.py``), full-LDE mode (``mono.py``, also sharded by rows over a
mesh) or the standard-layout class mode (``cls.py``).

trace commit -> constraint composition -> composition commit -> OOD ->
DEEP -> FRI -> queries, with the host-side Fiat-Shamir transcript of the
JAX package (copied here with options, proof and wire; see each file's
header).
"""

from .options import ProofOptions
from .proof import Proof
from .pipeline import prove

__all__ = ["ProofOptions", "Proof", "prove"]
