# Copy of zkvm/fhe/lwe.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""LWE scheme over f128 (client keygen/encrypt/decrypt + homomorphic ops)."""

from __future__ import annotations

import math
import random
import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from zkvm_torch.field import f128
from zkvm_torch.utils.serde import ByteReader, ByteWriter


@dataclass(frozen=True)
class LweParameters:
    """(p, q, delta=q//p, k, std) — fhe/src/parameters.rs:4-22."""

    plaintext_modulus: int
    ciphertext_modulus: int
    k: int
    std: float
    delta: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(
            self, "delta", self.ciphertext_modulus // self.plaintext_modulus
        )

    def write_into(self, w: ByteWriter):
        w.write_u32(self.plaintext_modulus)
        w.write_u32(self.ciphertext_modulus)
        w.write_u32(self.delta)
        w.write_usize(self.k)
        w.write_bytes(struct.pack("<d", self.std))

    @staticmethod
    def read_from(r: ByteReader) -> "LweParameters":
        p = r.read_u32()
        q = r.read_u32()
        delta = r.read_u32()
        k = r.read_usize()
        std = struct.unpack("<d", r.read_bytes(8))[0]
        params = LweParameters(p, q, k, std)
        if params.delta != delta:
            object.__setattr__(params, "delta", delta)
        return params


# Demo parameters used across the reference tests/examples
# (examples/linear_regression/src/main.rs:34-38).
DEMO_PARAMETERS = LweParameters(8, 128, 4, 2.412390240121573e-5)


@dataclass(frozen=True)
class FheUInt8:
    """A ciphertext: k mask lanes + 1 body lane of field ints."""

    ciphertext: Tuple[int, ...]

    def lanes(self) -> Tuple[int, ...]:
        return self.ciphertext

    def write_into(self, w: ByteWriter):
        w.write_usize(len(self.ciphertext))
        for v in self.ciphertext:
            w.write_element(v)

    @staticmethod
    def read_from(r: ByteReader) -> "FheUInt8":
        n = r.read_usize()
        return FheUInt8(tuple(r.read_element() for _ in range(n)))


class ServerKey:
    """Binary LWE secret key + parameters; encrypt/decrypt + homomorphic ops.

    The reference samples from ``thread_rng`` (fhe/src/server_key.rs:20-35);
    here randomness is an injectable seeded PRNG so proofs and tests are
    reproducible.
    """

    def __init__(self, parameters: LweParameters, rng: random.Random | None = None):
        self.parameters = parameters
        self._rng = rng or random.Random()
        self.key: List[int] = [self._rng.randrange(2) for _ in range(parameters.k)]

    @staticmethod
    def from_key(key: Sequence[int], parameters: LweParameters) -> "ServerKey":
        sk = ServerKey.__new__(ServerKey)
        sk.parameters = parameters
        sk._rng = random.Random()
        sk.key = list(key)
        return sk

    @property
    def lwe_size(self) -> int:
        return self.parameters.k + 1

    def _generate_mask(self) -> List[int]:
        return [self._rng.randrange(f128.P) for _ in range(self.parameters.k)]

    def encrypt(self, value: int) -> FheUInt8:
        """body = <a, s> + delta*m +/- round(|N(0, std)|) (server_key.rs:41-62)."""
        mask = self._generate_mask()
        noise = self._rng.gauss(0.0, self.parameters.std)
        scaled_noise = int(round(abs(noise)))
        body = 0
        for a, s in zip(mask, self.key):
            body = f128.fadd(body, f128.fmul(a, s))
        body = f128.fadd(body, f128.fmul(self.parameters.delta, value % f128.P))
        if noise > 0:
            body = f128.fadd(body, scaled_noise)
        else:
            body = f128.fsub(body, scaled_noise)
        return FheUInt8(tuple(mask + [body]))

    def decrypt(self, value: FheUInt8) -> int:
        """Subtract mask, then round by bit log2(delta)-1 (server_key.rs:64-76)."""
        ct = value.ciphertext
        applied = 0
        for i in range(self.parameters.k):
            applied = f128.fadd(applied, f128.fmul(ct[i], self.key[i]))
        msg = f128.fsub(ct[self.parameters.k], applied)
        log2_delta = int(math.log2(self.parameters.delta))
        round_bit = (msg >> (log2_delta - 1)) & 1
        return ((msg >> log2_delta) + round_bit) & 0xFF

    def encrypt_trivial(self, message: int) -> FheUInt8:
        """Zero mask; body = delta * message (server_key.rs:78-83)."""
        body = f128.fmul(self.parameters.delta, message)
        return FheUInt8(tuple([0] * self.parameters.k + [body]))

    def add(self, a: FheUInt8, b: FheUInt8) -> FheUInt8:
        n = self.lwe_size
        return FheUInt8(
            tuple(f128.fadd(x, y) for x, y in zip(a.ciphertext[:n], b.ciphertext[:n]))
        )

    def scalar_add(self, scalar: int, value: FheUInt8) -> FheUInt8:
        return self.add(value, self.encrypt_trivial(scalar))

    def scalar_mul(self, scalar: int, value: FheUInt8) -> FheUInt8:
        n = self.lwe_size
        return FheUInt8(tuple(f128.fmul(x, scalar) for x in value.ciphertext[:n]))

    def write_into(self, w: ByteWriter):
        self.parameters.write_into(w)
        w.write_usize(len(self.key))
        for v in self.key:
            w.write_element(v)

    @staticmethod
    def read_from(r: ByteReader) -> "ServerKey":
        parameters = LweParameters.read_from(r)
        n = r.read_usize()
        key = [r.read_element() for _ in range(n)]
        return ServerKey.from_key(key, parameters)

    def export_to_file(self, path):
        w = ByteWriter()
        self.write_into(w)
        with open(path, "wb") as f:
            f.write(w.to_bytes())

    @staticmethod
    def import_from_file(path) -> "ServerKey":
        with open(path, "rb") as f:
            return ServerKey.read_from(ByteReader(f.read()))
