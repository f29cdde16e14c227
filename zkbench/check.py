"""What decides ``correct``: every proof the window produced, judged by the
plain reference (:mod:`zkbench.reference`) against what the reference
works out itself from the benchmark's own inputs.

For each trace the reference pads the program and runs the plain Rescue
sponge over it (the program hash and the sponge columns), runs the plain
stack machine over the trace's inputs (the 16 outputs, the trace length
and the stack columns), and so has the public inputs a proof must be of
and the whole execution trace.  From the trace it works out the trace
commitment's root (:mod:`zkbench.reference.commitment`: the extension,
the row hashes and the Merkle tree, on the run's device), which every
proof of the trace must carry byte for byte.  Every distinct proof is also
parsed from its wire bytes and verified: the options and trace length the
configuration states, the security level, the transcript, the OOD
consistency of the constraints, every Merkle path of the trace,
composition and FRI layers, every FRI fold and the remainder.  A proof of
a trace is a function of the trace and the options alone, so every proof
of one trace must also be the same bytes.

Numbers compared, each with its limit (exact comparisons):

- ``rejected_proofs``: proofs of the window the reference rejects (0);
- ``trace_root_mismatches``: proofs of the window whose trace root is not
  the reference's (0);
- ``extra_proofs_per_trace``: the most distinct byte strings among the
  proofs of one trace, less one (0);
- ``failed_proofs``: proves that raised or never finished (0);

and the window has to have finished at least one proof.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np

from zkbench import traffic as tf
from zkbench.reference import commitment, execution, machine, program, verifier
from zkbench.reference.layout import TRACE_WIDTH, PublicInputs
from zkbench.reference.proof import Proof
from zkbench.reference.serde import DeserializationError

# the reference's sponge states, by the digest of the padded code: the plain
# sponge takes about 0.16 ms an op (some 85 s for the 524,256 ops of the
# 2^20-row program), so the first run of a checkout computes them and the
# later ones read them (34 MB at 2^20)
CACHE = Path(__file__).resolve().parent / ".cache" / "sponge"

LIMITS = {"rejected_proofs": 0, "trace_root_mismatches": 0, "extra_proofs_per_trace": 0, "failed_proofs": 0}


def cached_sponge(code) -> np.ndarray:
    key = hashlib.sha256(json.dumps([[op.code, op.value] for op in code]).encode()).hexdigest()
    path = CACHE / f"{key}.npy"
    if path.is_file():
        return np.load(path)
    rows = execution.sponge_rows(code)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, rows)
    tmp.replace(path)
    return rows


def expected(config: dict, code, sponge, inputs: tf.TraceInputs, device):
    """The reference's public inputs, trace length and trace root of one
    trace."""
    stack = []
    outputs, t_len = machine.run(code, inputs.public, inputs.secret, config["lwe"]["k"], tf.lwe_delta(config),
                                 rows=stack)
    key = SimpleNamespace(parameters=SimpleNamespace(delta=tf.lwe_delta(config)))
    limbs = execution.trace_limbs(code, sponge, stack, t_len)
    del stack
    root = commitment.trace_root(limbs, config["proof"]["blowup"], device)
    return PublicInputs(execution.program_hash(sponge), outputs, key), t_len, root


def judge(config: dict, data: bytes, pub, t_len: int, root: bytes) -> Tuple[str, bool]:
    """('' for a proof the reference accepts, else why it rejects it;
    whether the proof carries the reference's trace root)."""
    try:
        proof = Proof.from_wire_bytes(data, pub)
    except (DeserializationError, ValueError, AssertionError, IndexError) as exc:
        return f"malformed: {exc}", False
    return verdict(config, proof, pub, t_len), proof.trace_root == root


def verdict(config: dict, proof, pub, t_len: int) -> str:
    """'' for a parsed proof the reference accepts, else why it rejects it."""
    opts = config["proof"]
    got = {"num_queries": proof.num_queries, "blowup": proof.blowup, "grinding_factor": proof.grinding_factor,
           "fri_folding_factor": proof.fri_folding_factor,
           "fri_remainder_max_degree": proof.fri_remainder_max_degree}
    for k, v in got.items():
        if v != opts[k]:
            return f"option {k} {v}, the configuration states {opts[k]}"
    if proof.trace_length != t_len or proof.trace_length != config["trace_length"]:
        return f"trace length {proof.trace_length}, the program's is {t_len}"
    if proof.trace_width != TRACE_WIDTH:
        return f"trace width {proof.trace_width}"
    try:
        verifier.verify(proof, pub, opts["min_security"])
    except verifier.VerificationError as exc:
        return str(exc)
    except (ValueError, ZeroDivisionError, IndexError) as exc:
        return f"verifier: {exc!r}"
    return ""


def check(config: dict, pools: List[List[tf.TraceInputs]], records, proofs: Dict[tuple, bytes],
          failed: int, device) -> Tuple[bool, dict, List[str]]:
    """Judge a window: ``records`` are its finished proofs (each with its
    ``key`` = (client, index) and ``digest``), ``proofs`` the bytes of each
    distinct (key, digest), ``failed`` the proves that raised or never
    ended.  The trace roots are worked out on ``device``.  Returns
    (correct, numbers, reasons of the rejections)."""
    code = program.compile_code(tf.program_source(config))
    sponge = cached_sponge(code)
    verdicts: Dict[tuple, str] = {}
    roots_ok: Dict[tuple, bool] = {}
    refs = {}
    for (key, dig), data in sorted(proofs.items()):
        if key not in refs:
            refs[key] = expected(config, code, sponge, pools[key[0]][key[1]], device)
        verdicts[(key, dig)], roots_ok[(key, dig)] = judge(config, data, *refs[key])
    rejected = sum(1 for r in records if verdicts[(r.key, r.digest)])
    mismatched = sum(1 for r in records if not roots_ok[(r.key, r.digest)])
    per_trace: Dict[tuple, set] = {}
    for r in records:
        per_trace.setdefault(r.key, set()).add(r.digest)
    extra = max((len(v) - 1 for v in per_trace.values()), default=0)
    numbers = {"rejected_proofs": rejected, "trace_root_mismatches": mismatched, "extra_proofs_per_trace": extra,
               "failed_proofs": failed}
    correct = bool(records) and all(numbers[k] <= LIMITS[k] for k in LIMITS)
    reasons = sorted({f"trace {k}: {v}" for (k, _), v in verdicts.items() if v}
                     | {f"trace {k}: its trace root is not the reference's" for (k, _), ok in roots_ok.items() if not ok})
    return correct, {"proofs": len(records), **numbers}, reasons


def report(numbers: dict) -> Tuple[dict, List[str]]:
    """The numbers beside their limits: the result line's entry and the
    stderr lines."""
    entry = {"proofs": {"value": numbers["proofs"], "limit": "at least 1"}}
    entry.update({k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS})
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in entry.items()]
    return entry, lines
