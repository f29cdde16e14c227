"""Verifier layer: the JAX package's host verifier, importable without JAX."""

from .verifier import VerificationError, verify, verify_bytes

__all__ = ["VerificationError", "verify", "verify_bytes"]
