"""The full-LDE ("mono") prover of zkvm_torch end to end on the CPU (plain
versions of the kernels), held against the JAX reference.

* T = 128: the mono proof equals the committed conformance vector;
* T = 256 (one FRI layer): the mono proof is accepted by the JAX package's
  verifier and by the port's, a tampered copy is rejected by both, and the
  T-mode proof has the same bytes;
* ``prove`` takes the card unless told ``device="cpu"`` and raises without
  one;
* the row-blocked forms (``limits.CHUNK_T`` and ``limits.MONO_ROW_BLOCK``
  patched to 2^6, so T = 128 and 256 take them): the domain constants
  (one process and a rank's block) equal the one-shot ones, and the
  proofs equal the conformance vector and the one-shot, T-mode proof;
* under ``-m slow``: byte equality with ``zkvm.prover.prove`` under
  ``ZKVM_CLASS=0`` (the reference's mono path) at T = 2^10 for the three
  bench programs, and for the chain with the row-blocked forms.
"""

import json
import random
from pathlib import Path

import pytest
import torch

from zkvm_torch import vm
from zkvm_torch.prover import limits
from zkvm_torch.prover import mono
from zkvm_torch.prover import pipeline as tpl

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parents[1] / "conformance" / "vectors_e2e.json"


@pytest.fixture
def row_blocks(monkeypatch):
    """A function that patches the chunk threshold and mono's row block to
    2^6 (undone after the test), with the domain constants built anew
    under it."""
    def patch():
        monkeypatch.setattr(limits, "CHUNK_T", 1 << 6)
        monkeypatch.setattr(limits, "MONO_ROW_BLOCK", 1 << 6)
        mono._domain_constants.cache_clear()

    yield patch
    mono._domain_constants.cache_clear()


def _conformance_proof():
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    return vec, vm.prove(program, inputs, device="cpu", mode="mono")


def test_mono_conformance_proof_bytes():
    vec, (h, out, proof) = _conformance_proof()
    assert proof.trace_length == 128
    assert proof.trace_root.hex() == vec["trace_root_hex"]
    assert proof.comp_root.hex() == vec["comp_root_hex"]
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


def test_mono_row_blocks_conformance_proof_bytes(row_blocks):
    """T = 128 in 16 blocks of 2^6 rows: the conformance vector's bytes."""
    row_blocks()
    assert len(mono.row_blocks(1024, 128)) == 16
    vec, (h, out, proof) = _conformance_proof()
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


@pytest.fixture(scope="module")
def t256():
    """The T = 256 READ/ADD chain: (key, trace, public inputs, mono proof)."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    program, inputs = vm.read_add_chain(60, key)
    trace = vm.run(program, inputs)
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    return key, trace, pub, tpl.prove(trace, pub, device="cpu", mode="mono")


def test_mono_t256_verifies_in_both_packages(t256):
    from zkvm.air.layout import PublicInputs as JaxPublicInputs
    from zkvm.fhe import ServerKey as JaxServerKey
    from zkvm.fhe.lwe import DEMO_PARAMETERS as JAX_DEMO_PARAMETERS
    from zkvm.verifier import VerificationError as JaxVerificationError
    from zkvm.verifier import verify_bytes as jax_verify_bytes
    from zkvm_torch.verifier import VerificationError

    key, trace, pub, proof = t256
    assert proof.trace_length == 256 and len(proof.fri_roots) == 1
    data = proof.to_wire_bytes()
    jax_key = JaxServerKey(JAX_DEMO_PARAMETERS, random.Random(3))
    assert jax_key.key == key.key
    jax_pub = JaxPublicInputs(pub.program_hash, pub.stack_outputs, jax_key)
    jax_verify_bytes(data, jax_pub)
    vm.verify_bytes(data, pub.program_hash, pub.stack_outputs, key)
    for at in (len(data) // 3, len(data) // 2, len(data) - 20):
        bad = bytearray(data)
        bad[at] ^= 0x01
        with pytest.raises(JaxVerificationError):
            jax_verify_bytes(bytes(bad), jax_pub)
        with pytest.raises(VerificationError):
            vm.verify_bytes(bytes(bad), pub.program_hash, pub.stack_outputs, key)


def test_mono_equals_tmode_t256(t256):
    key, trace, pub, proof = t256
    tmode = tpl.prove(trace, pub, device="cpu", mode="tmode")
    assert proof.to_wire_bytes() == tmode.to_wire_bytes()


def test_mono_row_blocks_equal_one_shot_t256(t256, row_blocks):
    """At T = 256 in blocks of 2^6 rows (32 blocks of the 2^11-row domain):
    the domain constants, in one process and as rank 1's block of 2, equal
    the one-shot ones, and the proof is the one-shot proof's bytes."""
    key, trace, pub, proof = t256
    cpu = torch.device("cpu")
    want = [mono._domain_constants(256, 8, cpu), mono._domain_constants(256, 8, cpu, 1, 2)]
    row_blocks()
    got = [mono._domain_constants(256, 8, cpu), mono._domain_constants(256, 8, cpu, 1, 2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(g[k], v), k
    blocked = tpl.prove(trace, pub, device="cpu", mode="mono")
    assert blocked.to_wire_bytes() == proof.to_wire_bytes()


def test_prove_takes_the_card_by_default(t256, monkeypatch):
    key, trace, pub, _ = t256
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpl.prove(trace, pub)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vm.prove(*vm.read_add_chain(8, key), mode="mono")
    with pytest.raises(ValueError, match="mode"):
        tpl.prove(trace, pub, device="cpu", mode="class")


@pytest.mark.slow  # the JAX prover's CPU compile costs minutes per program
@pytest.mark.parametrize("name,n_ops", [("read_add", 300), ("mul_add", 300), ("fhe", 120)])
def test_mono_bytes_equal_jax_mono_prover(name, n_ops, monkeypatch):
    import zkvm.isa
    import zkvm_torch.isa
    from test_torch_slice import _bench_program
    from zkvm.air.layout import PublicInputs as JaxPublicInputs
    from zkvm.fhe import ServerKey as JaxServerKey
    from zkvm.fhe.lwe import DEMO_PARAMETERS as JAX_DEMO_PARAMETERS
    from zkvm.processor import Processor as JaxProcessor
    from zkvm.prover import prove as jax_prove

    monkeypatch.setenv("ZKVM_CLASS", "0")
    jax_key = JaxServerKey(JAX_DEMO_PARAMETERS, random.Random(3))
    program, inputs = _bench_program(name, n_ops, jax_key, zkvm.isa)
    trace = JaxProcessor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    assert trace.length == 1 << 10
    want = jax_prove(trace, JaxPublicInputs(program.hash, trace.outputs, jax_key)).to_wire_bytes()
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(3))
    _, _, proof = vm.prove(*_bench_program(name, n_ops, key, zkvm_torch.isa), device="cpu", mode="mono")
    assert proof.to_wire_bytes() == want
    if name == "read_add":  # and in row blocks (32 blocks of 2^8 rows)
        monkeypatch.setattr(limits, "CHUNK_T", 1 << 8)
        monkeypatch.setattr(limits, "MONO_ROW_BLOCK", 1 << 8)
        mono._domain_constants.cache_clear()
        try:
            _, _, proof = vm.prove(*_bench_program(name, n_ops, key, zkvm_torch.isa), device="cpu", mode="mono")
        finally:
            mono._domain_constants.cache_clear()
        assert proof.to_wire_bytes() == want
