"""The zkvm_torch T-mode prover end to end on the CPU (plain versions of
the kernels), held against the JAX reference.

* T = 128: the proof bytes equal the committed conformance vector;
* T = 256 (one FRI layer): the proof is accepted by the JAX package's
  verifier and by the port's copy, and a tampered copy is rejected;
* no module of the port, and nothing in ``chip_smoke.py`` or
  ``kernel_bench.py``, imports ``zkvm`` or ``jax``; a process that can import
  neither proves T = 128 in both modes to the same bytes;
* a trace, key and public inputs of the JAX package, carried across by
  ``zkvm_torch.convert``, prove to the same bytes as the port's own;
* under ``-m slow``: byte equality with ``zkvm.prover.prove`` at T = 2^10
  for the three bench programs (each costs minutes of XLA compilation).
"""

import ast
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import zkvm.fhe.lwe
import zkvm.isa
import zkvm_torch.isa
from zkvm.air.layout import PublicInputs
from zkvm.fhe import ServerKey
from zkvm.fhe.lwe import DEMO_PARAMETERS
from zkvm_torch import convert, vm
from zkvm_torch.prover import prove as port_prove
from zkvm_torch.vm import read_add_chain

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VECTORS = REPO / "conformance" / "vectors_e2e.json"


def _conformance_run(fhe=vm, isa=zkvm_torch.isa):
    """The conformance program, its inputs and key, built from the port's
    types (or, given ``zkvm.fhe`` and ``zkvm.isa``, the JAX package's)."""
    vec = json.loads(VECTORS.read_text())
    key = fhe.ServerKey(fhe.DEMO_PARAMETERS, random.Random(7))
    program = isa.Program.compile(vec["program_source"])
    inputs = isa.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    return vec, key, program, inputs


def test_conformance_proof_bytes():
    vec, key, program, inputs = _conformance_run()
    h, out, proof = vm.prove(program, inputs, device="cpu")
    assert proof.trace_length == vec["trace_length"] == 128
    assert proof.trace_root.hex() == vec["trace_root_hex"]
    assert proof.comp_root.hex() == vec["comp_root_hex"]
    assert [str(v) for v in proof.ood_trace_cur] == vec["ood_trace_cur"]
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


def test_t256_proof_verifies_in_both_packages():
    from zkvm.verifier import VerificationError as JaxVerificationError
    from zkvm.verifier import verify_bytes as jax_verify_bytes
    from zkvm_torch.verifier import VerificationError

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = read_add_chain(60, key)
    h, out, proof = vm.prove(program, inputs, device="cpu")
    assert proof.trace_length == 256 and len(proof.fri_roots) == 1
    data = proof.to_wire_bytes()
    pub = PublicInputs(h, out, ServerKey(DEMO_PARAMETERS, random.Random(3)))
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


def _imported_modules(path):
    """Top-level names of every module that ``path`` imports (absolute)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_port_imports_neither_zkvm_nor_jax():
    build = REPO / "zkvm_torch" / "build"  # kernel builds, unpacked trees: not the package
    files = sorted(p for p in (REPO / "zkvm_torch").rglob("*.py") if build not in p.parents)
    files += [REPO / "chip_smoke.py", REPO / "kernel_bench.py"]
    assert len(files) > 30
    assert {REPO / "zkvm_torch" / "utils" / f for f in ("profiler.py", "kernel_health.py")} <= set(files)
    for path in files:
        bad = _imported_modules(path) & {"zkvm", "jax", "jaxlib"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


_NO_JAX = r"""
import importlib.abc, json, random, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "zkvm"):
            raise ImportError(name + " is blocked in this process")
sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from zkvm_torch import vm
from zkvm_torch.config import RuntimeConfig, ZkVmConfig
from zkvm_torch.utils import kernel_health
from zkvm_torch.utils.profiler import profiler
vec = json.load(open(sys.argv[2]))
key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
program = vm.Program.compile(vec["program_source"])
inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
for mode in ("tmode", "mono"):
    h, out, proof = vm.prove(program, inputs, device="cpu", mode=mode,
                             config=ZkVmConfig(runtime=RuntimeConfig(profile=True)))
    vm.verify(proof, h, out, key)
    print(proof.to_wire_bytes().hex())
assert "fri" in profiler.totals() and kernel_health.report()["total"] == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "zkvm") for m in sys.modules)
"""


def test_proves_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(REPO), str(VECTORS)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(VECTORS.read_text())["proof_bytes_hex"]
    assert res.stdout.split() == [want, want]


def test_convert_carries_a_jax_trace_across():
    """A trace, key and public inputs made by the JAX package, carried into
    the port's types, prove to the bytes of the port's own run."""
    from zkvm.processor import Processor as JaxProcessor

    vec, jax_key, program, inputs = _conformance_run(zkvm.fhe.lwe, zkvm.isa)
    jax_trace = JaxProcessor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    key = convert.server_key(jax_key.parameters, jax_key.key)
    assert type(key) is vm.ServerKey and key.key == jax_key.key
    assert key.parameters == vm.DEMO_PARAMETERS
    pub = convert.public_inputs(program.hash, jax_trace.outputs, jax_key)
    assert type(pub) is vm.PublicInputs and pub.to_elements() == list(program.hash) + list(jax_trace.outputs)
    from_ints = convert.execution_trace(jax_trace.columns, program.hash, jax_trace.outputs)
    from_limbs = convert.execution_trace(jax_trace.as_limbs(), program.hash, jax_trace.outputs)
    for trace in (from_ints, from_limbs):
        proof = port_prove(trace, pub, device="cpu")
        assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]
    with pytest.raises(ValueError):
        convert.execution_trace(jax_trace.columns[:27], program.hash, jax_trace.outputs)


def _bench_program(name, n_ops, key, isa):
    """The three bench programs, built from ``isa`` (``zkvm.isa`` or
    ``zkvm_torch.isa``) for ``key``."""
    if name == "read_add":
        ops = ["read"] + ["read", "add"] * ((n_ops - 1) // 2)
        return isa.Program.compile("\n".join(ops)), isa.ProgramInputs(tuple([1] * (n_ops // 2 + 2)), (), key)
    if name == "mul_add":
        ops = ["read", "read"] + ["read", "mul", "read", "add"] * ((n_ops - 2) // 4)
        n_reads = 2 + 2 * ((n_ops - 2) // 4)
        return isa.Program.compile("\n".join(ops)), isa.ProgramInputs(tuple([1] * (n_reads + 4)), (), key)
    block = ["read2", "add2", "push.2", "smul", "push.1", "sadd"]
    reps = max(1, (n_ops - 1) // len(block))
    program = isa.Program.compile("\n".join(["read2"] + block * reps))
    secrets = tuple(key.encrypt((i % 3) + 1) for i in range(reps + 2))
    return program, isa.ProgramInputs((), secrets, key)


@pytest.mark.slow  # the JAX prover's CPU compile costs minutes per program
@pytest.mark.parametrize("name,n_ops", [("read_add", 300), ("mul_add", 300), ("fhe", 120)])
def test_bytes_equal_jax_prover(name, n_ops):
    from zkvm.processor import Processor
    from zkvm.prover import prove as jax_prove

    key = ServerKey(DEMO_PARAMETERS, random.Random(3))
    program, inputs = _bench_program(name, n_ops, key, zkvm.isa)
    trace = Processor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    assert trace.length == 1 << 10
    pub = PublicInputs(program.hash, trace.outputs, key)
    want = jax_prove(trace, pub).to_wire_bytes()
    port_key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    _, _, proof = vm.prove(*_bench_program(name, n_ops, port_key, zkvm_torch.isa), device="cpu")
    assert proof.to_wire_bytes() == want
