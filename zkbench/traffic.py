"""The one traffic generator: a configuration's program and each trace's
inputs, drawn from ``--seed``.

A configuration (``configs/<name>.json``) states its program as op blocks,
``head + body * (terms - 1) + tail``, the ranges its inputs are drawn from
(``public_max`` for each READ's byte, ``secret_max`` for each READ2's
plaintext), and its LWE parameters.  A traffic mix (``traffic/<name>.json``)
states how many clients prove in a closed loop and how many distinct traces
each one proves in turn.  The inputs of trace ``i`` of client ``c`` come from
their own generator, seeded by ``(seed, c, i)``, so one seed gives the same
traces, and every seed gives the same program and sizes with other values.

The LWE encryption is the scheme's own formula (``body = <a, s> + delta m
+/- round(|N(0, std)|)`` mod p, with a mask of k field elements), worked out
here so that the program and the reference are handed the same ciphertexts.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

from zkbench.reference import f128

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``zkbench/<kind>/<name>.json``: a configuration or a traffic mix."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT.parent)}")
    return json.loads(path.read_text())


def program_ops(config: dict) -> List[str]:
    prog = config["program"]
    if prog["terms"] < 1:
        raise ValueError(f"{config['name']}: a program needs at least one term")
    return list(prog["head"]) + list(prog["body"]) * (prog["terms"] - 1) + list(prog["tail"])


def program_source(config: dict) -> str:
    return "\n".join(program_ops(config))


def lwe_delta(config: dict) -> int:
    lwe = config["lwe"]
    return lwe["ciphertext_modulus"] // lwe["plaintext_modulus"]


def secret_key(config: dict, seed: int) -> List[int]:
    """The binary LWE secret of a run."""
    rng = random.Random(f"zkbench/{seed}/key")
    return [rng.randrange(2) for _ in range(config["lwe"]["k"])]


def encrypt(rng: random.Random, key: List[int], delta: int, std: float, message: int) -> Tuple[int, ...]:
    mask = [rng.randrange(f128.P) for _ in key]
    noise = rng.gauss(0.0, std)
    scaled = int(round(abs(noise)))
    body = sum(a * s for a, s in zip(mask, key)) + delta * message
    body = body + scaled if noise > 0 else body - scaled
    return tuple(mask) + (body % f128.P,)


@dataclass(frozen=True)
class TraceInputs:
    """What one trace is made from: the READ bytes and the READ2
    ciphertexts, in program order."""

    client: int
    index: int
    public: Tuple[int, ...]
    secret: Tuple[Tuple[int, ...], ...]


def trace_inputs(config: dict, key: List[int], seed: int, client: int, index: int) -> TraceInputs:
    ops = program_ops(config)
    rng = random.Random(f"zkbench/{seed}/{client}/{index}")
    inp = config["inputs"]
    public = tuple(rng.randrange(inp["public_max"]) for _ in range(ops.count("read")))
    std = config["lwe"]["std"]
    delta = lwe_delta(config)
    secret = tuple(encrypt(rng, key, delta, std, rng.randrange(inp["secret_max"]))
                   for _ in range(ops.count("read2")))
    return TraceInputs(client, index, public, secret)


def pools(config: dict, traffic: dict, seed: int) -> Tuple[List[int], List[List[TraceInputs]]]:
    """The run's secret key and each client's pool of trace inputs."""
    key = secret_key(config, seed)
    return key, [[trace_inputs(config, key, seed, c, i) for i in range(traffic["pool"])]
                 for c in range(traffic["clients"])]
