# Copy of zkvm/utils/serde.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Byte-level serialization matching winter-utils 0.9 conventions.

The reference exchanges keys / ciphertexts / proofs with winterfell's
``Serializable``/``Deserializable`` machinery (e.g. fhe/src/server_key.rs:
131-159, examples .../utils.rs:36-128).  Wire conventions reproduced here:

* fixed-width integers are little-endian;
* field elements are 16 LE bytes, canonical (< p);
* ``usize`` is encoded in the vint64 format used by winter-utils: for a
  value needing ``n <= 8`` bytes, write ``(value << n) | (1 << (n - 1))``
  little-endian in ``n`` bytes; values needing more than 56 bits are written
  as a 0x00 marker byte followed by 8 LE bytes.
"""

from __future__ import annotations

import struct

from zkvm_torch.field import f128


class ByteWriter:
    def __init__(self):
        self._buf = bytearray()

    def write_u8(self, v: int):
        self._buf.append(v & 0xFF)

    def write_u16(self, v: int):
        self._buf += struct.pack("<H", v)

    def write_u32(self, v: int):
        self._buf += struct.pack("<I", v)

    def write_u64(self, v: int):
        self._buf += struct.pack("<Q", v)

    def write_usize(self, v: int):
        if v >= (1 << 56):
            self._buf.append(0)
            self._buf += struct.pack("<Q", v)
            return
        n = max(1, (v.bit_length() + 6) // 7)
        encoded = (v << n) | (1 << (n - 1))
        self._buf += encoded.to_bytes(n, "little")

    def write_bytes(self, data: bytes):
        self._buf += data

    def write_element(self, v: int):
        self._buf += f128.to_bytes(v)

    def write_elements(self, vals):
        for v in vals:
            self.write_element(v)

    def to_bytes(self) -> bytes:
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class DeserializationError(Exception):
    pass


class ByteReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read_bytes(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise DeserializationError(
                f"unexpected EOF: need {n} bytes at offset {self._pos}"
            )
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def read_u8(self) -> int:
        return self.read_bytes(1)[0]

    def read_u16(self) -> int:
        return struct.unpack("<H", self.read_bytes(2))[0]

    def read_u32(self) -> int:
        return struct.unpack("<I", self.read_bytes(4))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self.read_bytes(8))[0]

    def read_usize(self) -> int:
        first = self.read_bytes(1)[0]
        if first == 0:
            return struct.unpack("<Q", self.read_bytes(8))[0]
        n = 1
        while not (first >> (n - 1)) & 1:
            n += 1
        rest = self.read_bytes(n - 1)
        encoded = int.from_bytes(bytes([first]) + rest, "little")
        return encoded >> n

    def read_element(self) -> int:
        return f128.from_bytes(self.read_bytes(16))

    def has_more(self) -> bool:
        return self._pos < len(self._data)

    @property
    def position(self) -> int:
        return self._pos
