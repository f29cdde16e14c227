# Copy of zkvm/prover/options.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""STARK protocol parameters.

The reference preset matches vm/src/lib.rs:20:
``ProofOptions::new(32, 8, 0, FieldExtension::None, 8, 127)``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProofOptions:
    num_queries: int = 32
    blowup: int = 8
    grinding_factor: int = 0
    fri_folding_factor: int = 8
    fri_remainder_max_degree: int = 127

    @property
    def max_remainder_size(self) -> int:
        """Largest evaluation-domain size that stops FRI folding."""
        return (self.fri_remainder_max_degree + 1) * self.blowup

    def num_fri_layers(self, domain_size: int) -> int:
        n = 0
        while domain_size > self.max_remainder_size:
            domain_size //= self.fri_folding_factor
            n += 1
        return n

    def to_elements(self) -> list:
        return [
            self.num_queries,
            self.blowup,
            self.grinding_factor,
            self.fri_folding_factor,
            self.fri_remainder_max_degree,
        ]


REFERENCE_OPTIONS = ProofOptions()
