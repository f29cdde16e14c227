"""The control and the planted faults that the check has to catch, each a
replacement for the port's ``pipeline.prove`` (``prove(trace, pub,
options, **kw) -> proof``) that breaks it underneath the timed path.  The
benchmark's own runs never use them: ``zkbench.control`` runs them on the
card at a cell's size, ``zkbench/tests`` on the CPU at a small one.

- ``control``: the program with one guarantee the configuration states
  broken, half the queries (16 of 32: 48 bits of conjectured security
  where the configuration states at least 95);
- ``stale``: a prove that returns its state unchanged, the proof it made
  before (of another trace: the warm-up's last, then each one before);
- ``half``: half of the work left out, the trace's second half of rows
  zeroed before it is proved;
- ``altered``: an answer altered where it is produced, one byte of the
  wire bytes flipped in two of every three proofs made (all but the
  2nd, 5th, 8th, ...), as an intermittent fault would: a trace proved more
  than once then has proofs of more than one byte string;
- ``lde_rows``: a kernel fault that is the same on every prove, one bit of
  column 0 flipped in every 8th row of the first of the trace's 8 coset
  classes as they are hashed into the trace commitment (1/64 of its rows),
  the rest of the proof made from the sound extension: each proof is one
  stable byte string, and the verifier sees the fault only where a query
  lands on such a row.

Leaving out the exchange between chips, the fourth kind of fault, has no
place in a one-chip cell.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable


def control(prove: Callable) -> Callable:
    def fn(trace, pub, options, **kw):
        return prove(trace, pub, dataclasses.replace(options, num_queries=options.num_queries // 2), **kw)

    return fn


def stale(prove: Callable) -> Callable:
    last = []
    lock = threading.Lock()

    def fn(trace, pub, options, **kw):
        proof = prove(trace, pub, options, **kw)
        with lock:
            before = last[0] if last else proof
            last[:] = [proof]
        return before

    return fn


def half(prove: Callable) -> Callable:
    def fn(trace, pub, options, **kw):
        limbs = trace.as_limbs().copy()
        limbs[:, limbs.shape[1] // 2:, :] = 0
        return prove(dataclasses.replace(trace, columns=None, limbs=limbs), pub, options, **kw)

    return fn


class _Altered:
    def __init__(self, proof):
        self.proof = proof

    def to_wire_bytes(self) -> bytes:
        data = bytearray(self.proof.to_wire_bytes())
        data[len(data) // 2] ^= 0x01
        return bytes(data)


def altered(prove: Callable) -> Callable:
    made = []
    lock = threading.Lock()

    def fn(trace, pub, options, **kw):
        proof = prove(trace, pub, options, **kw)
        with lock:
            made.append(1)
            spared = len(made) % 3 == 2
        return proof if spared else _Altered(proof)

    return fn


def lde_rows(prove: Callable) -> Callable:
    from zkvm_torch.prover import pipeline as pl

    def class_ntt(coeffs_t, dct, r):
        lde = pl._class_ntt_blocked(coeffs_t, dct, r)
        if r == 0:
            lde = lde.clone()
            lde[0, 0, ::8] ^= 1
        return lde

    def trace_commit(cols_t, dct):
        coeffs_t = pl.nt.intt_t(cols_t)
        return coeffs_t, pl._commit_classes(coeffs_t, dct, class_ntt)

    def fn(trace, pub, options, **kw):
        sound = pl._stage_trace_commit_t
        pl._stage_trace_commit_t = trace_commit
        try:
            return prove(trace, pub, options, **kw)
        finally:
            pl._stage_trace_commit_t = sound

    return fn


VARIANTS = {"control": control, "stale": stale, "half": half, "altered": altered, "lde_rows": lde_rows}
