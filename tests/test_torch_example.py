"""The linear-regression example on the port (``zkvm_torch.examples.
linear_regression``), end to end on the CPU: the decrypted prediction is the
clear one, the port's verifier and the JAX package's both accept the proof,
a one-byte tamper is rejected, and the wire bytes of ``InputData`` /
``OutputData`` equal those of the original example's protocol."""

import random

import pytest
import torch

import zkvm.fhe
from examples.linear_regression import protocol as jax_protocol
from zkvm.air.layout import PublicInputs as JaxPublicInputs
from zkvm.verifier import VerificationError as JaxVerificationError
from zkvm.verifier import verify_bytes as jax_verify_bytes
from zkvm_torch import vm
from zkvm_torch.examples.linear_regression import main as example
from zkvm_torch.examples.linear_regression import protocol
from zkvm_torch.verifier import VerificationError

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    input_bytes, client_key = example.client_encrypt()
    output_bytes = example.server_prove(input_bytes, device="cpu")
    return input_bytes, client_key, output_bytes


def test_example_runs_end_to_end_on_cpu(run):
    input_bytes, client_key, output_bytes = run
    b0, b1, b2, b3, b4 = example.WEIGHTS
    x1, x2, x3, x4 = example.FEATURES
    assert example.client_verify(output_bytes, client_key) == b0 + b1 * x1 + b2 * x2 + b3 * x3 + b4 * x4


def test_proof_accepted_by_both_verifiers_and_tamper_rejected(run):
    input_bytes, client_key, output_bytes = run
    out = protocol.OutputData.from_bytes(output_bytes)
    jax_key = jax_protocol.InputData.from_bytes(input_bytes).server_key
    jax_pub = JaxPublicInputs(out.program_hash, out.output, jax_key)
    jax_verify_bytes(out.proof_bytes, jax_pub)
    vm.verify_bytes(out.proof_bytes, out.program_hash, out.output, client_key)
    bad = bytearray(out.proof_bytes)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises(VerificationError):
        vm.verify_bytes(bytes(bad), out.program_hash, out.output, client_key)
    with pytest.raises(JaxVerificationError):
        jax_verify_bytes(bytes(bad), jax_pub)


def test_wire_bytes_equal_the_original_protocol(run):
    input_bytes, client_key, output_bytes = run
    # the client's bytes, built from the JAX package's types with the same seeds
    params = zkvm.fhe.LweParameters(8, 128, 4, 2.412390240121573e-5)
    jax_key = zkvm.fhe.ServerKey(params, random.Random(2026))
    cts = tuple(jax_key.encrypt(x) for x in example.FEATURES)
    b0, b1, b2, b3, b4 = example.WEIGHTS
    assert jax_protocol.InputData((b1, b2, b3, b4, b0), cts, jax_key).to_bytes() == input_bytes
    # each side parses the other's bytes and writes them back unchanged
    assert protocol.InputData.from_bytes(input_bytes).to_bytes() == input_bytes
    assert jax_protocol.InputData.from_bytes(input_bytes).to_bytes() == input_bytes
    jax_out = jax_protocol.OutputData.from_bytes(output_bytes)
    assert jax_out.to_bytes() == output_bytes
    port_out = protocol.OutputData.from_bytes(output_bytes)
    assert (port_out.program_hash, port_out.proof_bytes, port_out.output) == \
        (jax_out.program_hash, jax_out.proof_bytes, jax_out.output)
    assert protocol.OutputData(port_out.program_hash, port_out.proof_bytes, port_out.output).to_bytes() \
        == output_bytes
