# Frozen copy of zkvm_torch/prover/proof.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Proof container + byte serializations (W9).

Two wire forms:

* ``to_wire_bytes()`` / ``from_wire_bytes(data, pub_inputs)`` — the
  winterfell 0.9 ``StarkProof`` layout (:mod:`zkvm.prover.wire`): batch-
  Merkle deduped query paths, query positions NOT serialized (re-derived
  from the transcript, which is why decoding needs the public inputs).
  This is the conformance format the reference's verifier consumes
  (vm/src/lib.rs:93-98) and what the example protocol ships.
* ``to_bytes()`` / ``from_bytes(data)`` — a self-contained v1 container
  format (positions + full per-query paths) that round-trips without
  public inputs; used for cloning/tampering in tests and debugging.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from zkbench.reference.serde import ByteReader, ByteWriter


@dataclass
class QueryOpening:
    position: int
    trace_row: List[int]
    trace_path: List[bytes]
    comp_row: List[int]
    comp_path: List[bytes]


@dataclass
class FriLayerOpening:
    """One fold group (folding_factor values) + path, per query position."""

    group: List[int]
    path: List[bytes]


@dataclass
class Proof:
    trace_length: int
    trace_width: int
    num_queries: int
    blowup: int
    grinding_factor: int
    fri_folding_factor: int
    fri_remainder_max_degree: int

    trace_root: bytes = b""
    comp_root: bytes = b""
    ood_trace_cur: List[int] = field(default_factory=list)
    ood_trace_nxt: List[int] = field(default_factory=list)
    ood_comp: List[int] = field(default_factory=list)
    fri_roots: List[bytes] = field(default_factory=list)
    fri_remainder: List[int] = field(default_factory=list)
    pow_nonce: int = 0
    queries: List[QueryOpening] = field(default_factory=list)
    fri_openings: List[List[FriLayerOpening]] = field(default_factory=list)
    # fri_openings[layer][query_index]

    # ------------------------------------------------------------------
    def to_wire_bytes(self) -> bytes:
        """Winterfell 0.9 StarkProof serialization (zkvm/prover/wire.py)."""
        from zkbench.reference import wire

        return wire.encode(self)

    @staticmethod
    def from_wire_bytes(data: bytes, pub_inputs) -> "Proof":
        """Decode winterfell StarkProof bytes (needs public inputs to replay
        the transcript for the query positions, as winterfell's verifier
        does)."""
        from zkbench.reference import wire

        return wire.decode(data, pub_inputs)

    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        w = ByteWriter()
        w.write_u32(self.trace_length)
        w.write_u8(self.trace_width)
        w.write_u8(self.num_queries)
        w.write_u8(self.blowup)
        w.write_u8(self.grinding_factor)
        w.write_u8(self.fri_folding_factor)
        w.write_u16(self.fri_remainder_max_degree)

        w.write_bytes(self.trace_root)
        w.write_bytes(self.comp_root)
        w.write_elements(self.ood_trace_cur)
        w.write_elements(self.ood_trace_nxt)
        w.write_usize(len(self.ood_comp))
        w.write_elements(self.ood_comp)

        w.write_usize(len(self.fri_roots))
        for r in self.fri_roots:
            w.write_bytes(r)
        w.write_usize(len(self.fri_remainder))
        w.write_elements(self.fri_remainder)
        w.write_u64(self.pow_nonce)

        w.write_usize(len(self.queries))
        for q in self.queries:
            w.write_u64(q.position)
            w.write_elements(q.trace_row)
            w.write_usize(len(q.trace_path))
            for d in q.trace_path:
                w.write_bytes(d)
            w.write_usize(len(q.comp_row))
            w.write_elements(q.comp_row)
            w.write_usize(len(q.comp_path))
            for d in q.comp_path:
                w.write_bytes(d)

        w.write_usize(len(self.fri_openings))
        for layer in self.fri_openings:
            w.write_usize(len(layer))
            for op in layer:
                w.write_usize(len(op.group))
                w.write_elements(op.group)
                w.write_usize(len(op.path))
                for d in op.path:
                    w.write_bytes(d)
        return w.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        r = ByteReader(data)
        p = Proof(
            trace_length=r.read_u32(),
            trace_width=r.read_u8(),
            num_queries=r.read_u8(),
            blowup=r.read_u8(),
            grinding_factor=r.read_u8(),
            fri_folding_factor=r.read_u8(),
            fri_remainder_max_degree=r.read_u16(),
        )
        p.trace_root = r.read_bytes(32)
        p.comp_root = r.read_bytes(32)
        p.ood_trace_cur = [r.read_element() for _ in range(p.trace_width)]
        p.ood_trace_nxt = [r.read_element() for _ in range(p.trace_width)]
        p.ood_comp = [r.read_element() for _ in range(r.read_usize())]
        p.fri_roots = [r.read_bytes(32) for _ in range(r.read_usize())]
        p.fri_remainder = [r.read_element() for _ in range(r.read_usize())]
        p.pow_nonce = r.read_u64()
        n_queries = r.read_usize()
        for _ in range(n_queries):
            pos = r.read_u64()
            trace_row = [r.read_element() for _ in range(p.trace_width)]
            trace_path = [r.read_bytes(32) for _ in range(r.read_usize())]
            comp_row = [r.read_element() for _ in range(r.read_usize())]
            comp_path = [r.read_bytes(32) for _ in range(r.read_usize())]
            p.queries.append(
                QueryOpening(pos, trace_row, trace_path, comp_row, comp_path)
            )
        n_layers = r.read_usize()
        for _ in range(n_layers):
            layer = []
            for _ in range(r.read_usize()):
                group = [r.read_element() for _ in range(r.read_usize())]
                path = [r.read_bytes(32) for _ in range(r.read_usize())]
                layer.append(FriLayerOpening(group, path))
            p.fri_openings.append(layer)
        return p

    def security_estimate(self) -> int:
        """Conjectured security bits: min(field, queries * log2(blowup)) - margin."""
        import math

        query_bits = self.num_queries * int(math.log2(self.blowup))
        return min(128, query_bits + self.grinding_factor)
