# Copy of zkvm/verifier/verifier.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""STARK verifier (host-side, milliseconds) — SURVEY.md W8.

Re-derives the full Fiat-Shamir transcript from the proof and public inputs,
then checks:

1. out-of-domain consistency: the composition value C(z) recomputed from
   the OOD trace frame (transition constraints re-evaluated at z, boundary
   quotients from the public assertions) equals sum_k z^k * h_k(z^8);
2. every Merkle authentication path against the trace / composition / FRI
   layer roots;
3. the DEEP identity at every query position: Y(x) assembled from the
   opened trace/composition rows equals the opened FRI layer-0 value;
4. every FRI fold step, ending with the low-degree remainder polynomial
   evaluated at the final position;
5. proof-of-work (grinding) and structural parameters.

Mirrors the checks winterfell::verify performs for the reference
(vm/src/lib.rs:91-98), implemented independently from this package's prover.
"""

from __future__ import annotations

from typing import List

from zkvm_torch.air.constraints_golden import evaluate_transition
from zkvm_torch.air.layout import (
    NUM_ASSERTIONS,
    NUM_EXEMPTIONS,
    NUM_TRANSITION_CONSTRAINTS,
    TRACE_WIDTH,
    PublicInputs,
    get_assertions,
)
from zkvm_torch.air.periodic import periodic_at
from zkvm_torch.field import f128
from zkvm_torch.hash.blake3 import hash_elements
from zkvm_torch.hash.merkle import MerkleTree
from zkvm_torch.ntt import golden as gntt
from zkvm_torch.prover.fri import FOLD, fold_group_values
from zkvm_torch.prover.options import ProofOptions
from zkvm_torch.prover.pipeline import NUM_COMP_COLUMNS
from zkvm_torch.prover.proof import Proof
from zkvm_torch.prover.transcript import RandomCoin
from zkvm_torch.prover import wire


class VerificationError(Exception):
    pass


def _check(cond: bool, message: str):
    if not cond:
        raise VerificationError(message)


def verify(proof: Proof, pub_inputs: PublicInputs, min_security: int = 95):
    options = ProofOptions(
        num_queries=proof.num_queries,
        blowup=proof.blowup,
        grinding_factor=proof.grinding_factor,
        fri_folding_factor=proof.fri_folding_factor,
        fri_remainder_max_degree=proof.fri_remainder_max_degree,
    )
    _check(proof.trace_width == TRACE_WIDTH, "unexpected trace width")
    _check(proof.security_estimate() >= min_security, "security level too low")
    t_len = proof.trace_length
    _check(t_len >= 16 and t_len & (t_len - 1) == 0, "bad trace length")
    d = t_len * options.blowup
    offset = f128.DOMAIN_OFFSET
    g_trace = f128.get_root_of_unity(t_len)
    w_d = f128.get_root_of_unity(d)
    delta = pub_inputs.server_key.parameters.delta

    # ---- transcript replay -------------------------------------------
    coin = RandomCoin(wire.coin_seed(t_len, TRACE_WIDTH, options, pub_inputs))
    coin.reseed(proof.trace_root)
    alphas = coin.draw_elements(NUM_TRANSITION_CONSTRAINTS)
    betas = coin.draw_elements(NUM_ASSERTIONS)
    coin.reseed(proof.comp_root)
    z = coin.draw()
    _check(len(proof.ood_trace_cur) == TRACE_WIDTH, "bad OOD frame width")
    _check(len(proof.ood_trace_nxt) == TRACE_WIDTH, "bad OOD frame width")
    _check(len(proof.ood_comp) == NUM_COMP_COLUMNS, "bad OOD composition width")
    coin.reseed_with_elements(list(proof.ood_trace_cur) + list(proof.ood_trace_nxt))
    coin.reseed_with_elements(list(proof.ood_comp))
    # winterfell 0.9: one DEEP coefficient per trace column (shared by the
    # z and z*g terms) and one per composition column
    gammas = coin.draw_elements(TRACE_WIDTH)
    deltas = gammas
    epsilons = coin.draw_elements(NUM_COMP_COLUMNS)

    _check(
        len(proof.fri_roots) == options.num_fri_layers(d),
        "unexpected FRI layer count",
    )
    fri_betas = []
    for root in proof.fri_roots:
        coin.reseed(root)
        fri_betas.append(coin.draw())
    rem_size = d // (FOLD ** len(proof.fri_roots))
    _check(
        len(proof.fri_remainder) == rem_size // options.blowup,
        "unexpected FRI remainder length",
    )
    _check(
        len(proof.fri_remainder) <= options.fri_remainder_max_degree + 1,
        "FRI remainder too large",
    )
    coin.reseed_with_elements(list(proof.fri_remainder))

    if options.grinding_factor > 0:
        _check(
            coin.leading_zeros(proof.pow_nonce) >= options.grinding_factor,
            "proof-of-work check failed",
        )
    positions = sorted(set(coin.draw_integers(options.num_queries, d, proof.pow_nonce)))

    # ---- OOD consistency ---------------------------------------------
    mask_z, ark_z = periodic_at(t_len, z)
    cvals = evaluate_transition(
        proof.ood_trace_cur, proof.ood_trace_nxt, mask_z, ark_z, delta
    )
    e1 = pow(g_trace, t_len - 1, f128.P)
    e2 = pow(g_trace, t_len - 2, f128.P)
    z_t = f128.fsub(pow(z, t_len, f128.P), 1)
    zerofier = f128.fdiv(
        z_t, f128.fmul(f128.fsub(z, e1), f128.fsub(z, e2))
    )
    q_t = 0
    for a, c in zip(alphas, cvals):
        q_t = f128.fadd(q_t, f128.fmul(a, c))
    q_t = f128.fdiv(q_t, zerofier)

    last_step = t_len - NUM_EXEMPTIONS
    x_last = pow(g_trace, last_step, f128.P)
    c_z = q_t
    for (col, step, value), beta in zip(get_assertions(pub_inputs, t_len), betas):
        x0 = 1 if step == 0 else x_last
        num = f128.fsub(proof.ood_trace_cur[col], value)
        c_z = f128.fadd(c_z, f128.fmul(beta, f128.fdiv(num, f128.fsub(z, x0))))

    h_combined = 0
    zk = 1
    for k in range(NUM_COMP_COLUMNS):
        h_combined = f128.fadd(h_combined, f128.fmul(zk, proof.ood_comp[k]))
        zk = f128.fmul(zk, z)
    _check(c_z == h_combined, "OOD constraint consistency check failed")

    # ---- DEEP reference values ---------------------------------------
    zg = f128.fmul(z, g_trace)
    z_m = pow(z, NUM_COMP_COLUMNS, f128.P)
    a_z = 0
    b_zg = 0
    for c in range(TRACE_WIDTH):
        a_z = f128.fadd(a_z, f128.fmul(gammas[c], proof.ood_trace_cur[c]))
        b_zg = f128.fadd(b_zg, f128.fmul(deltas[c], proof.ood_trace_nxt[c]))
    h_zm = 0
    for k in range(NUM_COMP_COLUMNS):
        h_zm = f128.fadd(h_zm, f128.fmul(epsilons[k], proof.ood_comp[k]))

    # ---- per-query checks --------------------------------------------
    _check(len(proof.queries) == len(positions), "query count mismatch")
    for qi, (q, p) in enumerate(zip(proof.queries, positions)):
        _check(q.position == p, "query position mismatch")
        _check(len(q.trace_row) == TRACE_WIDTH, "bad trace row width")
        _check(len(q.comp_row) == NUM_COMP_COLUMNS, "bad composition row width")
        _check(
            MerkleTree.verify(
                proof.trace_root, p, hash_elements(q.trace_row), q.trace_path
            ),
            f"trace Merkle path invalid at query {qi}",
        )
        _check(
            MerkleTree.verify(
                proof.comp_root, p, hash_elements(q.comp_row), q.comp_path
            ),
            f"composition Merkle path invalid at query {qi}",
        )

        x = f128.fmul(offset, pow(w_d, p, f128.P))
        a_x = 0
        b_x = 0
        for c in range(TRACE_WIDTH):
            a_x = f128.fadd(a_x, f128.fmul(gammas[c], q.trace_row[c]))
            b_x = f128.fadd(b_x, f128.fmul(deltas[c], q.trace_row[c]))
        h_x = 0
        for k in range(NUM_COMP_COLUMNS):
            h_x = f128.fadd(h_x, f128.fmul(epsilons[k], q.comp_row[k]))
        y = f128.fdiv(f128.fsub(a_x, a_z), f128.fsub(x, z))
        y = f128.fadd(y, f128.fdiv(f128.fsub(b_x, b_zg), f128.fsub(x, zg)))
        y = f128.fadd(y, f128.fdiv(f128.fsub(h_x, h_zm), f128.fsub(x, z_m)))

        # FRI walk
        size = d
        pos = p
        off = offset
        value = y
        for layer_idx, (root, beta) in enumerate(zip(proof.fri_roots, fri_betas)):
            opening = proof.fri_openings[layer_idx][qi]
            group_size = size // FOLD
            j = pos % group_size
            t_idx = pos // group_size
            _check(len(opening.group) == FOLD, "bad FRI group size")
            _check(
                opening.group[t_idx] == value,
                f"FRI layer {layer_idx} group inconsistent with running value",
            )
            _check(
                MerkleTree.verify(
                    root, j, hash_elements(opening.group), opening.path
                ),
                f"FRI layer {layer_idx} Merkle path invalid",
            )
            value = fold_group_values(opening.group, pos, size, beta, off)
            pos = j
            size = group_size
            off = pow(off, FOLD, f128.P)

        # remainder check
        w_fin = f128.get_root_of_unity(size)
        x_fin = f128.fmul(off, pow(w_fin, pos, f128.P))
        _check(
            gntt.eval_poly(list(proof.fri_remainder), x_fin) == value,
            "FRI remainder evaluation mismatch",
        )

def verify_bytes(proof_bytes: bytes, pub_inputs: PublicInputs, min_security: int = 95):
    """Verify a winterfell-wire-format proof (the reference's entry shape:
    winterfell::verify consumes StarkProof bytes + public inputs).  Malformed
    or transcript-inconsistent bytes raise :class:`VerificationError`."""
    from zkvm_torch.prover.proof import Proof
    from zkvm_torch.utils.serde import DeserializationError

    try:
        proof = Proof.from_wire_bytes(proof_bytes, pub_inputs)
    except (DeserializationError, ValueError, AssertionError) as exc:
        raise VerificationError(f"malformed proof bytes: {exc}")
    return verify(proof, pub_inputs, min_security)
