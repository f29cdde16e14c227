# Copy of examples/linear_regression/protocol.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Client <-> server wire formats for the linear-regression demo.

Byte-level parity with the reference example's ``InputData`` / ``OutputData``
(examples/linear_regression/src/utils.rs:8-128):

* ``InputData``  = server_key || vint(n_secret) || ciphertexts || vint(n_public) || raw u8s
* ``OutputData`` = program_hash (2 field elements) || proof || vint(16) || stack outputs

Integer/element encodings follow winter-utils 0.9 conventions via
:mod:`zkvm.utils.serde` (little-endian fixed ints, 16-byte LE canonical field
elements, vint64 usize).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from zkvm_torch.fhe import FheUInt8, ServerKey
from zkvm_torch.prover.proof import Proof
from zkvm_torch.utils.serde import ByteReader, ByteWriter


@dataclass
class InputData:
    """What the client ships to the proving server."""

    public_inputs: Tuple[int, ...]
    secret_inputs: Tuple[FheUInt8, ...]
    server_key: ServerKey

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        self.server_key.write_into(w)
        w.write_usize(len(self.secret_inputs))
        for ct in self.secret_inputs:
            ct.write_into(w)
        w.write_usize(len(self.public_inputs))
        w.write_bytes(bytes(self.public_inputs))
        return w.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "InputData":
        r = ByteReader(data)
        key = ServerKey.read_from(r)
        n_secret = r.read_usize()
        secret = tuple(FheUInt8.read_from(r) for _ in range(n_secret))
        n_public = r.read_usize()
        public = tuple(r.read_bytes(n_public))
        return InputData(public, secret, key)


@dataclass
class OutputData:
    """What the proving server returns: hash, proof, public stack outputs.

    ``proof_bytes`` is the winterfell 0.9 StarkProof serialization
    (zkvm/prover/wire.py) — the byte shape the reference's client feeds to
    winterfell::verify (main.rs:85).  It is decoded lazily because the
    winterfell layout does not carry query positions; the client re-derives
    them from the transcript during verification.
    """

    program_hash: Tuple[int, int]
    proof_bytes: bytes
    output: Tuple[int, ...]

    @staticmethod
    def from_proof(program_hash, proof: Proof, output) -> "OutputData":
        return OutputData(tuple(program_hash), proof.to_wire_bytes(), tuple(output))

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        w.write_elements(self.program_hash)
        w.write_usize(len(self.proof_bytes))
        w.write_bytes(self.proof_bytes)
        w.write_usize(len(self.output))
        w.write_elements(self.output)
        return w.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "OutputData":
        r = ByteReader(data)
        program_hash = (r.read_element(), r.read_element())
        proof_bytes = r.read_bytes(r.read_usize())
        n_out = r.read_usize()
        output = tuple(r.read_element() for _ in range(n_out))
        if n_out != 16:
            raise ValueError("expected 16 stack output elements")
        return OutputData(program_hash, proof_bytes, output)
