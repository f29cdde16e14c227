# Frozen copy of zkvm_torch/prover/transcript.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Fiat-Shamir public coin (DefaultRandomCoin<Blake3_256> semantics).

Matches the winterfell random-coin construction the reference relies on
(prover/src/lib.rs:45, SURVEY.md W7):

* seed = hash_elements(seed_elements); counter = 0
* reseed(digest): seed = merge(seed, digest); counter = 0
* next(): counter += 1; merge_with_int(seed, counter)
* draw(): rejection-sample a canonical f128 element from the low 16 bytes
* draw_integers(n, domain, nonce): seed = merge_with_int(seed, nonce),
  counter = 0, then mask the low 8 bytes of successive next() outputs down
  to the power-of-two domain.  Winterfell does NOT deduplicate here — the
  prover/verifier sort + dedup the returned positions
  (winter-crypto/src/random/default.rs draw_integers; winter-prover's
  query_positions.sort_unstable()/dedup()).
* check_leading_zeros(nonce): trailing zeros of the u64 read LE from the
  first 8 bytes of merge_with_int(seed, nonce) — the leading bits of the
  output byte stream.
"""

from __future__ import annotations

from typing import List

from zkbench.reference import f128
from zkbench.reference.blake3 import hash_elements, merge, merge_with_int


class TranscriptError(Exception):
    pass


class RandomCoin:
    def __init__(self, seed_elements: List[int]):
        self.seed = hash_elements(seed_elements)
        self.counter = 0

    def reseed(self, digest: bytes):
        assert len(digest) == 32
        self.seed = merge(self.seed, digest)
        self.counter = 0

    def reseed_with_elements(self, elements: List[int]):
        self.reseed(hash_elements(elements))

    def _next(self) -> bytes:
        self.counter += 1
        return merge_with_int(self.seed, self.counter)

    def draw(self) -> int:
        for _ in range(1000):
            value = int.from_bytes(self._next()[:16], "little")
            if value < f128.P:
                return value
        raise TranscriptError("failed to draw a field element in 1000 tries")

    def draw_elements(self, n: int) -> List[int]:
        return [self.draw() for _ in range(n)]

    def draw_integers(self, n: int, domain_size: int, nonce: int = 0) -> List[int]:
        """Winterfell 0.9 semantics: values may repeat; callers sort+dedup."""
        assert domain_size & (domain_size - 1) == 0
        self.seed = merge_with_int(self.seed, nonce)
        self.counter = 0
        mask = domain_size - 1
        values: List[int] = []
        for _ in range(1000):
            values.append(int.from_bytes(self._next()[:8], "little") & mask)
            if len(values) == n:
                return values
        raise TranscriptError("failed to draw enough query positions")

    def leading_zeros(self, nonce: int) -> int:
        """Grinding check (DefaultRandomCoin::check_leading_zeros): trailing
        zeros of the LE u64 head of merge_with_int(seed, nonce) — i.e. the
        leading zero bits of the hash output stream."""
        value = int.from_bytes(merge_with_int(self.seed, nonce)[:8], "little")
        if value == 0:
            return 64
        return (value & -value).bit_length() - 1
