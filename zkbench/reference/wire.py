# Frozen copy of zkvm_torch/prover/wire.py (the benchmark's yardstick: plain host code that
# imports nothing of the program), its imports pointed at zkbench.reference.
"""Winterfell 0.9 wire format: Context, coin seed, batch-Merkle, StarkProof.

The reference's verification entry is
``winterfell::verify::<ProcessorAir, Blake3_256, DefaultRandomCoin>``
(vm/src/lib.rs:93-98, examples/linear_regression/src/main.rs:85), so the
byte format a conforming proof must travel in is winterfell 0.9's
``StarkProof`` serialization (SURVEY.md W7/W9).  This module implements that
layout field by field, reconstructed from the winterfell 0.9.0 source tree
(winter-air/src/proof/{mod,context,commitments,queries,ood_frame}.rs,
winter-crypto/src/merkle/proofs.rs, winter-fri/src/proof.rs).  The Rust
toolchain is not available in this image, so bit-exactness cannot be proved
here; every encoding below carries a confidence tag and CONFORMANCE.md maps
each tag to the one-line Rust check that adjudicates it.  Golden vectors for
the reference e2e program are committed under ``conformance/``.

Confidence legend (see CONFORMANCE.md):
  [H] high   — structure documented in winterfell docs/changelog
  [M] medium — field order / prefix width from source recollection
  [L] low    — bit-packing reconstructed; adjudicate against Rust first
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Sequence

from zkbench.reference import f128
from zkbench.reference.blake3 import hash_elements, merge
from zkbench.reference.serde import ByteReader, ByteWriter, DeserializationError

# winter-air/src/options.rs: FieldExtension::None = 1
FIELD_EXTENSION_NONE = 1
# winter-math f128: modulus serialized as 16 LE bytes ([H])
MODULUS_BYTES = f128.P.to_bytes(16, "little")
DIGEST_SIZE = 32
ELEMENT_BYTES = 16


# ---------------------------------------------------------------------------
# Context (winter-air/src/proof/context.rs)
# ---------------------------------------------------------------------------

def trace_info_bytes(trace_length: int, width: int) -> bytes:
    """TraceInfo::write_into (winter-air/src/trace_info.rs) [M].

    u8 main_segment_width | u8 aux_segment_width | u8 aux_segment_rands |
    u8 log2(trace_length) | u16 meta_len (=0) | meta bytes.
    """
    w = ByteWriter()
    w.write_u8(width)
    w.write_u8(0)  # aux segment width (no aux segments)
    w.write_u8(0)  # aux segment rand elements
    w.write_u8(trace_length.bit_length() - 1)
    w.write_u16(0)  # trace meta length
    return w.to_bytes()


def options_bytes(options) -> bytes:
    """ProofOptions::write_into (winter-air/src/options.rs) [M].

    u8 num_queries | u8 blowup | u8 grinding | u8 field_extension |
    u8 fri_folding_factor | u8 fri_remainder_max_degree.
    """
    w = ByteWriter()
    w.write_u8(options.num_queries)
    w.write_u8(options.blowup)
    w.write_u8(options.grinding_factor)
    w.write_u8(FIELD_EXTENSION_NONE)
    w.write_u8(options.fri_folding_factor)
    w.write_u8(options.fri_remainder_max_degree)
    return w.to_bytes()


def context_bytes(trace_length: int, width: int, options) -> bytes:
    """Context::write_into (winter-air/src/proof/context.rs) [M].

    trace_info | u8 modulus_byte_len | modulus LE bytes | options.
    """
    w = ByteWriter()
    w.write_bytes(trace_info_bytes(trace_length, width))
    w.write_u8(len(MODULUS_BYTES))
    w.write_bytes(MODULUS_BYTES)
    w.write_bytes(options_bytes(options))
    return w.to_bytes()


def trace_info_elements(trace_length: int, width: int) -> List[int]:
    """TraceInfo::to_elements (winter-air/src/trace_info.rs) [L].

    Element 0 packs (main_width << 8 | num_aux_segments); with no aux
    segments nothing further is packed.  Element 1 is the trace length.
    No trace meta -> no further elements.
    """
    return [(width << 8) | 0, trace_length]


def options_elements(options) -> List[int]:
    """ProofOptions::to_elements (winter-air/src/options.rs) [L].

    Element 0 packs (field_extension << 16 | fri_folding_factor << 8 |
    fri_remainder_max_degree); then grinding factor, blowup, num queries
    as single elements.
    """
    packed = (
        (FIELD_EXTENSION_NONE << 16)
        | (options.fri_folding_factor << 8)
        | options.fri_remainder_max_degree
    )
    return [
        packed,
        options.grinding_factor,
        options.blowup,
        options.num_queries,
    ]


def context_elements(trace_length: int, width: int, options) -> List[int]:
    """Context::to_elements (winter-air/src/proof/context.rs) [L].

    trace_info elements, then the field modulus as two elements (the 16 LE
    modulus bytes split in half, each half read as a LE integer), then the
    proof options elements.
    """
    m1 = int.from_bytes(MODULUS_BYTES[:8], "little")
    m2 = int.from_bytes(MODULUS_BYTES[8:], "little")
    return (
        trace_info_elements(trace_length, width)
        + [m1, m2]
        + options_elements(options)
    )


def coin_seed(trace_length: int, width: int, options, pub_inputs) -> List[int]:
    """Public-coin seed elements: Context::to_elements ++ PublicInputs
    ::to_elements (winter-prover ProverChannel::new; the reference's
    PublicInputs order is program hash then stack outputs,
    air/src/lib.rs:38-47) [H for the concatenation, L for the packings].
    """
    return context_elements(trace_length, width, options) + pub_inputs.to_elements()


# ---------------------------------------------------------------------------
# BatchMerkleProof (winter-crypto/src/merkle/proofs.rs)
# ---------------------------------------------------------------------------

def _owner_map(indexes: Sequence[int], level: int) -> Dict[int, int]:
    """node index at `level` -> first (smallest-index) group that reaches it."""
    owners: Dict[int, int] = {}
    for g, idx in enumerate(indexes):
        v = idx >> level
        if v not in owners:
            owners[v] = g
    return owners


class BatchMerkleProof:
    """Authentication paths for several leaves with shared nodes elided [M].

    ``nodes[g]`` holds, in leaf-to-root level order, the sibling digests on
    group g's path that the verifier cannot compute from other paths in the
    batch: a sibling at level d is transmitted iff it is not itself an
    ancestor of some queried leaf, and it is attributed to the first group
    (in sorted-index order) whose ancestor at level d it neighbours.  The
    leaf digests themselves are NOT serialized — winterfell recomputes them
    by hashing the opened row values (winter-air Queries::parse).
    """

    def __init__(self, depth: int, indexes: List[int], nodes: List[List[bytes]]):
        assert list(indexes) == sorted(set(indexes)), "indexes must be sorted unique"
        self.depth = depth
        self.indexes = list(indexes)
        self.nodes = nodes

    # -- construction from individual sibling paths ---------------------
    @classmethod
    def from_paths(
        cls, indexes: Sequence[int], paths: Sequence[Sequence[bytes]], depth: int
    ) -> "BatchMerkleProof":
        """`paths[g]` = sibling digests leaf->root for sorted-unique `indexes`."""
        nodes: List[List[bytes]] = [[] for _ in indexes]
        for d in range(depth):
            level = {idx >> d for idx in indexes}
            owners = _owner_map(indexes, d)
            for v in sorted(level):
                if v ^ 1 in level:
                    continue  # sibling computable from the batch
                g = owners[v]
                nodes[g].append(bytes(paths[g][d]))
        return cls(depth, list(indexes), nodes)

    # -- wire form -------------------------------------------------------
    def serialize_nodes(self) -> bytes:
        """BatchMerkleProof::serialize_nodes [M]: per group, u8 digest count
        then the digests in level order."""
        w = ByteWriter()
        for vec in self.nodes:
            w.write_u8(len(vec))
            for dgst in vec:
                w.write_bytes(dgst)
        return w.to_bytes()

    @classmethod
    def deserialize_nodes(
        cls, data: bytes, indexes: Sequence[int], depth: int
    ) -> "BatchMerkleProof":
        r = ByteReader(data)
        nodes = []
        for _ in indexes:
            n = r.read_u8()
            nodes.append([r.read_bytes(DIGEST_SIZE) for _ in range(n)])
        if r.has_more():
            raise DeserializationError("trailing bytes in batch Merkle nodes")
        return cls(depth, list(indexes), nodes)

    # -- unbatching ------------------------------------------------------
    def into_paths(self, leaves: Sequence[bytes]) -> List[List[bytes]]:
        """Reconstruct full individual sibling paths (leaf->root) given the
        leaf digests; inverse of :meth:`from_paths`."""
        value: Dict[int, bytes] = {
            idx: bytes(leaf) for idx, leaf in zip(self.indexes, leaves)
        }
        iters = [iter(vec) for vec in self.nodes]
        paths: List[List[bytes]] = [[] for _ in self.indexes]
        for d in range(self.depth):
            level = sorted({idx >> d for idx in self.indexes})
            level_set = set(level)
            owners = _owner_map(self.indexes, d)
            sib: Dict[int, bytes] = {}
            for v in level:
                if v ^ 1 in level_set:
                    continue
                try:
                    sib[v ^ 1] = next(iters[owners[v]])
                except StopIteration:
                    raise DeserializationError("batch Merkle nodes exhausted")
            for g, idx in enumerate(self.indexes):
                v = idx >> d
                s = value.get(v ^ 1) or sib.get(v ^ 1)
                if s is None:
                    raise DeserializationError("missing sibling in batch proof")
                paths[g].append(s)
            nxt: Dict[int, bytes] = {}
            for v in level:
                left = value.get(v if v % 2 == 0 else v ^ 1) or sib.get(
                    v if v % 2 == 0 else v ^ 1
                )
                right = value.get(v | 1) or sib.get(v | 1)
                nxt[v >> 1] = merge(left, right)
            value = nxt
        return paths


# ---------------------------------------------------------------------------
# Queries / OodFrame / Commitments / FriProof (winter-air, winter-fri)
# ---------------------------------------------------------------------------

def queries_blob(
    positions: Sequence[int],
    rows: Sequence[Sequence[int]],
    paths: Sequence[Sequence[bytes]],
    depth: int,
) -> bytes:
    """winter-air Queries::write_into [M]: u32 paths byte-len | batch nodes |
    u32 values byte-len | row elements (16 LE bytes each, row-major)."""
    bmp = BatchMerkleProof.from_paths(positions, paths, depth)
    paths_blob = bmp.serialize_nodes()
    w = ByteWriter()
    w.write_u32(len(paths_blob))
    w.write_bytes(paths_blob)
    values = ByteWriter()
    for row in rows:
        values.write_elements(row)
    vblob = values.to_bytes()
    w.write_u32(len(vblob))
    w.write_bytes(vblob)
    return w.to_bytes()


def read_queries_blob(r: ByteReader) -> tuple:
    paths_blob = r.read_bytes(r.read_u32())
    values_blob = r.read_bytes(r.read_u32())
    return paths_blob, values_blob


def resolve_queries(
    paths_blob: bytes,
    values_blob: bytes,
    positions: Sequence[int],
    depth: int,
    row_width: int,
) -> tuple:
    """-> (rows, paths) at the sorted-unique positions."""
    n = len(positions)
    if len(values_blob) != n * row_width * ELEMENT_BYTES:
        raise DeserializationError("query values length mismatch")
    rows = []
    for g in range(n):
        off = g * row_width * ELEMENT_BYTES
        rows.append(
            [
                int.from_bytes(
                    values_blob[off + i * ELEMENT_BYTES : off + (i + 1) * ELEMENT_BYTES],
                    "little",
                )
                for i in range(row_width)
            ]
        )
    leaves = [hash_elements(row) for row in rows]
    bmp = BatchMerkleProof.deserialize_nodes(paths_blob, positions, depth)
    return rows, bmp.into_paths(leaves)


def ood_frame_bytes(cur: Sequence[int], nxt: Sequence[int], comp: Sequence[int]) -> bytes:
    """winter-air OodFrame::write_into [M]: u16 byte-len + bytes for the
    merged trace states (current row then next row), then u16 byte-len +
    bytes for the constraint evaluations."""
    states = ByteWriter()
    states.write_elements(list(cur) + list(nxt))
    evals = ByteWriter()
    evals.write_elements(comp)
    w = ByteWriter()
    w.write_u16(len(states))
    w.write_bytes(states.to_bytes())
    w.write_u16(len(evals))
    w.write_bytes(evals.to_bytes())
    return w.to_bytes()


def commitments_bytes(roots: Sequence[bytes]) -> bytes:
    """winter-air Commitments::write_into [M]: u16 total byte length then the
    concatenated digests [trace root, constraint root, FRI layer roots...]."""
    w = ByteWriter()
    w.write_u16(DIGEST_SIZE * len(roots))
    for root in roots:
        w.write_bytes(root)
    return w.to_bytes()


def fri_layer_blob(
    positions: Sequence[int],
    groups: Sequence[Sequence[int]],
    paths: Sequence[Sequence[bytes]],
    depth: int,
) -> bytes:
    """winter-fri FriProofLayer::write_into [M]: u32 values byte-len | group
    elements | u32 paths byte-len | batch nodes.  (Field order values-first,
    the reverse of winter-air Queries — mirrors the struct field orders.)"""
    values = ByteWriter()
    for grp in groups:
        values.write_elements(grp)
    vblob = values.to_bytes()
    bmp = BatchMerkleProof.from_paths(positions, paths, depth)
    pblob = bmp.serialize_nodes()
    w = ByteWriter()
    w.write_u32(len(vblob))
    w.write_bytes(vblob)
    w.write_u32(len(pblob))
    w.write_bytes(pblob)
    return w.to_bytes()


# ---------------------------------------------------------------------------
# StarkProof assembly (winter-air/src/proof/mod.rs)
# ---------------------------------------------------------------------------

@dataclass
class WireProof:
    """Structurally parsed winterfell StarkProof (query blobs unresolved)."""

    trace_length: int
    trace_width: int
    options: "object"
    num_unique_queries: int
    trace_root: bytes = b""
    comp_root: bytes = b""
    fri_roots: List[bytes] = dc_field(default_factory=list)
    trace_queries: tuple = (b"", b"")
    constraint_queries: tuple = (b"", b"")
    ood_cur: List[int] = dc_field(default_factory=list)
    ood_nxt: List[int] = dc_field(default_factory=list)
    ood_comp: List[int] = dc_field(default_factory=list)
    fri_layers: List[tuple] = dc_field(default_factory=list)
    fri_remainder: List[int] = dc_field(default_factory=list)
    num_partitions: int = 1
    pow_nonce: int = 0


def encode(proof) -> bytes:
    """Rich :class:`zkvm.prover.proof.Proof` -> winterfell StarkProof bytes.

    Write order (winter-air/src/proof/mod.rs Serializable) [M]:
    context | u8 num_unique_queries | commitments | trace queries |
    constraint queries | ood frame | fri proof | u64 pow nonce.
    """
    from zkbench.reference.options import ProofOptions

    options = ProofOptions(
        num_queries=proof.num_queries,
        blowup=proof.blowup,
        grinding_factor=proof.grinding_factor,
        fri_folding_factor=proof.fri_folding_factor,
        fri_remainder_max_degree=proof.fri_remainder_max_degree,
    )
    d = proof.trace_length * proof.blowup
    depth = d.bit_length() - 1
    positions = [q.position for q in proof.queries]
    assert positions == sorted(set(positions)), "positions must be sorted unique"

    w = ByteWriter()
    w.write_bytes(context_bytes(proof.trace_length, proof.trace_width, options))
    w.write_u8(len(positions))
    w.write_bytes(
        commitments_bytes([proof.trace_root, proof.comp_root] + list(proof.fri_roots))
    )
    w.write_bytes(
        queries_blob(
            positions,
            [q.trace_row for q in proof.queries],
            [q.trace_path for q in proof.queries],
            depth,
        )
    )
    w.write_bytes(
        queries_blob(
            positions,
            [q.comp_row for q in proof.queries],
            [q.comp_path for q in proof.queries],
            depth,
        )
    )
    w.write_bytes(ood_frame_bytes(proof.ood_trace_cur, proof.ood_trace_nxt, proof.ood_comp))

    # FRI proof (winter-fri/src/proof.rs) [M]: u8 layer count | layers |
    # u16 remainder byte-len | remainder poly elements | u8 num_partitions
    fold = proof.fri_folding_factor
    w.write_u8(len(proof.fri_roots))
    size = d
    layer_positions = list(positions)
    for layer_idx in range(len(proof.fri_roots)):
        group_size = size // fold
        folded = sorted({p % group_size for p in layer_positions})
        by_pos = {}
        for q_idx, p in enumerate(layer_positions):
            by_pos[p % group_size] = proof.fri_openings[layer_idx][q_idx]
        groups = [by_pos[j].group for j in folded]
        paths = [by_pos[j].path for j in folded]
        w.write_bytes(fri_layer_blob(folded, groups, paths, group_size.bit_length() - 1))
        # chain NON-deduped positions: fri_openings[layer][q] is indexed by
        # original query order (pipeline.py), matching decode() below
        layer_positions = [p % group_size for p in layer_positions]
        size = group_size
    rem = ByteWriter()
    rem.write_elements(proof.fri_remainder)
    w.write_u16(len(rem))
    w.write_bytes(rem.to_bytes())
    w.write_u8(1)  # num_partitions

    w.write_u64(proof.pow_nonce)
    return w.to_bytes()


def parse(data: bytes) -> WireProof:
    """Structural parse of winterfell StarkProof bytes (no transcript)."""
    from zkbench.reference.options import ProofOptions

    r = ByteReader(data)
    width = r.read_u8()
    aux_w = r.read_u8()
    aux_r = r.read_u8()
    if aux_w or aux_r:
        raise DeserializationError("aux trace segments not supported")
    t_len = 1 << r.read_u8()
    meta_len = r.read_u16()
    r.read_bytes(meta_len)
    mod_len = r.read_u8()
    modulus = r.read_bytes(mod_len)
    if modulus != MODULUS_BYTES:
        raise DeserializationError("field modulus mismatch")
    options = ProofOptions(
        num_queries=r.read_u8(),
        blowup=r.read_u8(),
        grinding_factor=r.read_u8(),
        fri_folding_factor=0,  # placeholder, set below
        fri_remainder_max_degree=0,
    )
    ext = r.read_u8()
    if ext != FIELD_EXTENSION_NONE:
        raise DeserializationError("field extensions not supported")
    options = ProofOptions(
        num_queries=options.num_queries,
        blowup=options.blowup,
        grinding_factor=options.grinding_factor,
        fri_folding_factor=r.read_u8(),
        fri_remainder_max_degree=r.read_u8(),
    )

    num_unique = r.read_u8()
    d = t_len * options.blowup
    num_fri_layers = options.num_fri_layers(d)

    commit_len = r.read_u16()
    expected = DIGEST_SIZE * (2 + num_fri_layers)
    if commit_len != expected:
        raise DeserializationError("commitments length mismatch")
    trace_root = r.read_bytes(DIGEST_SIZE)
    comp_root = r.read_bytes(DIGEST_SIZE)
    fri_roots = [r.read_bytes(DIGEST_SIZE) for _ in range(num_fri_layers)]

    trace_queries = read_queries_blob(r)
    constraint_queries = read_queries_blob(r)

    states_blob = r.read_bytes(r.read_u16())
    evals_blob = r.read_bytes(r.read_u16())
    if len(states_blob) % (2 * ELEMENT_BYTES) != 0:
        raise DeserializationError("bad OOD trace states length")
    n_states = len(states_blob) // ELEMENT_BYTES
    elems = [
        int.from_bytes(states_blob[i * 16 : (i + 1) * 16], "little")
        for i in range(n_states)
    ]
    ood_cur = elems[: n_states // 2]
    ood_nxt = elems[n_states // 2 :]
    ood_comp = [
        int.from_bytes(evals_blob[i * 16 : (i + 1) * 16], "little")
        for i in range(len(evals_blob) // 16)
    ]

    n_layers = r.read_u8()
    if n_layers != num_fri_layers:
        raise DeserializationError("FRI layer count mismatch")
    fri_layers = []
    for _ in range(n_layers):
        vblob = r.read_bytes(r.read_u32())
        pblob = r.read_bytes(r.read_u32())
        fri_layers.append((vblob, pblob))
    rem_blob = r.read_bytes(r.read_u16())
    fri_remainder = [
        int.from_bytes(rem_blob[i * 16 : (i + 1) * 16], "little")
        for i in range(len(rem_blob) // 16)
    ]
    num_partitions = r.read_u8()
    pow_nonce = r.read_u64()
    if r.has_more():
        raise DeserializationError("trailing bytes in proof")

    return WireProof(
        trace_length=t_len,
        trace_width=width,
        options=options,
        num_unique_queries=num_unique,
        trace_root=trace_root,
        comp_root=comp_root,
        fri_roots=fri_roots,
        trace_queries=trace_queries,
        constraint_queries=constraint_queries,
        ood_cur=ood_cur,
        ood_nxt=ood_nxt,
        ood_comp=ood_comp,
        fri_layers=fri_layers,
        fri_remainder=fri_remainder,
        num_partitions=num_partitions,
        pow_nonce=pow_nonce,
    )


def replay_positions(wp: WireProof, pub_inputs) -> List[int]:
    """Re-derive the sorted-unique query positions from the transcript —
    exactly what winterfell's VerifierChannel does before unbatching."""
    from zkbench.reference.layout import NUM_ASSERTIONS, NUM_TRANSITION_CONSTRAINTS, TRACE_WIDTH
    from zkbench.reference.layout import NUM_COMP_COLUMNS
    from zkbench.reference.transcript import RandomCoin

    options = wp.options
    coin = RandomCoin(coin_seed(wp.trace_length, TRACE_WIDTH, options, pub_inputs))
    coin.reseed(wp.trace_root)
    coin.draw_elements(NUM_TRANSITION_CONSTRAINTS)
    coin.draw_elements(NUM_ASSERTIONS)
    coin.reseed(wp.comp_root)
    coin.draw()  # z
    coin.reseed_with_elements(list(wp.ood_cur) + list(wp.ood_nxt))
    coin.reseed_with_elements(list(wp.ood_comp))
    coin.draw_elements(TRACE_WIDTH)
    coin.draw_elements(NUM_COMP_COLUMNS)
    for root in wp.fri_roots:
        coin.reseed(root)
        coin.draw()
    coin.reseed_with_elements(list(wp.fri_remainder))
    d = wp.trace_length * options.blowup
    drawn = coin.draw_integers(options.num_queries, d, wp.pow_nonce)
    return sorted(set(drawn))


def decode(data: bytes, pub_inputs):
    """winterfell StarkProof bytes -> rich :class:`zkvm.prover.proof.Proof`.

    Needs the public inputs to replay the transcript for query positions
    (they are not serialized — winterfell's verifier re-derives them too).
    """
    from zkbench.reference.proof import FriLayerOpening, Proof, QueryOpening

    wp = parse(data)
    positions = replay_positions(wp, pub_inputs)
    if len(positions) != wp.num_unique_queries:
        raise DeserializationError("num_unique_queries mismatch with transcript")
    options = wp.options
    d = wp.trace_length * options.blowup
    depth = d.bit_length() - 1

    trace_rows, trace_paths = resolve_queries(
        wp.trace_queries[0], wp.trace_queries[1], positions, depth, wp.trace_width
    )
    comp_width = len(wp.ood_comp)
    comp_rows, comp_paths = resolve_queries(
        wp.constraint_queries[0], wp.constraint_queries[1], positions, depth, comp_width
    )

    proof = Proof(
        trace_length=wp.trace_length,
        trace_width=wp.trace_width,
        num_queries=options.num_queries,
        blowup=options.blowup,
        grinding_factor=options.grinding_factor,
        fri_folding_factor=options.fri_folding_factor,
        fri_remainder_max_degree=options.fri_remainder_max_degree,
        trace_root=wp.trace_root,
        comp_root=wp.comp_root,
        ood_trace_cur=wp.ood_cur,
        ood_trace_nxt=wp.ood_nxt,
        ood_comp=wp.ood_comp,
        fri_roots=wp.fri_roots,
        fri_remainder=wp.fri_remainder,
        pow_nonce=wp.pow_nonce,
    )
    for p, trow, tpath, crow, cpath in zip(
        positions, trace_rows, trace_paths, comp_rows, comp_paths
    ):
        proof.queries.append(QueryOpening(p, trow, tpath, crow, cpath))

    fold = options.fri_folding_factor
    size = d
    layer_positions = list(positions)
    for vblob, pblob in wp.fri_layers:
        group_size = size // fold
        folded = sorted({p % group_size for p in layer_positions})
        n = len(folded)
        if len(vblob) != n * fold * ELEMENT_BYTES:
            raise DeserializationError("FRI layer values length mismatch")
        groups = []
        for g in range(n):
            off = g * fold * ELEMENT_BYTES
            groups.append(
                [
                    int.from_bytes(vblob[off + i * 16 : off + (i + 1) * 16], "little")
                    for i in range(fold)
                ]
            )
        leaves = [hash_elements(grp) for grp in groups]
        bmp = BatchMerkleProof.deserialize_nodes(
            pblob, folded, group_size.bit_length() - 1
        )
        paths = bmp.into_paths(leaves)
        by_pos = {j: (grp, path) for j, grp, path in zip(folded, groups, paths)}
        layer = [
            FriLayerOpening(*by_pos[p % group_size]) for p in layer_positions
        ]
        proof.fri_openings.append(layer)
        layer_positions = [p % group_size for p in layer_positions]
        size = group_size
    return proof
