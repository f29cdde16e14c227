"""The zkvm_torch T-mode prover end to end on the CPU (plain versions of
the kernels), held against the JAX reference.

* T = 128: the proof bytes equal the committed conformance vector;
* T = 256 (one FRI layer): the proof is accepted by the JAX package's
  verifier and by the port's copy, and a tampered copy is rejected;
* a process that cannot import JAX proves T = 128 to the same bytes;
* under ``-m slow``: byte equality with ``zkvm.prover.prove`` at T = 2^10
  for the three bench programs (each costs minutes of XLA compilation).
"""

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkvm.air.layout import PublicInputs
from zkvm.fhe import ServerKey
from zkvm.fhe.lwe import DEMO_PARAMETERS
from zkvm.isa import Program, ProgramInputs
from zkvm_torch import vm
from zkvm_torch.vm import read_add_chain

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VECTORS = REPO / "conformance" / "vectors_e2e.json"


def _conformance_run():
    vec = json.loads(VECTORS.read_text())
    key = ServerKey(DEMO_PARAMETERS, random.Random(7))
    program = Program.compile(vec["program_source"])
    inputs = ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    return vec, key, program, inputs


def test_conformance_proof_bytes():
    vec, key, program, inputs = _conformance_run()
    h, out, proof = vm.prove(program, inputs)
    assert proof.trace_length == vec["trace_length"] == 128
    assert proof.trace_root.hex() == vec["trace_root_hex"]
    assert proof.comp_root.hex() == vec["comp_root_hex"]
    assert [str(v) for v in proof.ood_trace_cur] == vec["ood_trace_cur"]
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


def test_t256_proof_verifies_in_both_packages():
    from zkvm.verifier import VerificationError as JaxVerificationError
    from zkvm.verifier import verify_bytes as jax_verify_bytes
    from zkvm_torch.verifier import VerificationError

    key = ServerKey(DEMO_PARAMETERS, random.Random(3))
    program, inputs = read_add_chain(60, key)
    h, out, proof = vm.prove(program, inputs)
    assert proof.trace_length == 256 and len(proof.fri_roots) == 1
    data = proof.to_wire_bytes()
    pub = PublicInputs(h, out, key)
    jax_verify_bytes(data, pub)
    vm.verify_bytes(data, h, out, key)
    vm.verify(proof, h, out, key)
    for at in (len(data) // 3, len(data) // 2, len(data) - 20):
        bad = bytearray(data)
        bad[at] ^= 0x01
        with pytest.raises(JaxVerificationError):
            jax_verify_bytes(bytes(bad), pub)
        with pytest.raises(VerificationError):
            vm.verify_bytes(bytes(bad), h, out, key)


_NO_JAX = r"""
import importlib.abc, json, random, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from zkvm.fhe import ServerKey
from zkvm.fhe.lwe import DEMO_PARAMETERS
from zkvm.isa import Program, ProgramInputs
from zkvm_torch import vm
vec = json.load(open(sys.argv[2]))
key = ServerKey(DEMO_PARAMETERS, random.Random(7))
program = Program.compile(vec["program_source"])
inputs = ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
h, out, proof = vm.prove(program, inputs)
vm.verify(proof, h, out, key)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print(proof.to_wire_bytes().hex())
"""


def test_proves_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(REPO), str(VECTORS)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == json.loads(VECTORS.read_text())["proof_bytes_hex"]


def _bench_program(name, n_ops, key):
    if name == "read_add":
        return read_add_chain(n_ops, key)
    if name == "mul_add":
        ops = ["read", "read"] + ["read", "mul", "read", "add"] * ((n_ops - 2) // 4)
        n_reads = 2 + 2 * ((n_ops - 2) // 4)
        return Program.compile("\n".join(ops)), ProgramInputs(tuple([1] * (n_reads + 4)), (), key)
    block = ["read2", "add2", "push.2", "smul", "push.1", "sadd"]
    reps = max(1, (n_ops - 1) // len(block))
    program = Program.compile("\n".join(["read2"] + block * reps))
    secrets = tuple(key.encrypt((i % 3) + 1) for i in range(reps + 2))
    return program, ProgramInputs((), secrets, key)


@pytest.mark.slow  # the JAX prover's CPU compile costs minutes per program
@pytest.mark.parametrize("name,n_ops", [("read_add", 300), ("mul_add", 300), ("fhe", 120)])
def test_bytes_equal_jax_prover(name, n_ops):
    from zkvm.processor import Processor
    from zkvm.prover import prove as jax_prove

    key = ServerKey(DEMO_PARAMETERS, random.Random(3))
    program, inputs = _bench_program(name, n_ops, key)
    trace = Processor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    assert trace.length == 1 << 10
    pub = PublicInputs(program.hash, trace.outputs, key)
    want = jax_prove(trace, pub).to_wire_bytes()
    _, _, proof = vm.prove(program, inputs)
    assert proof.to_wire_bytes() == want
