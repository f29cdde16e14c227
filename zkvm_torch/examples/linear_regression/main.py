# Copy of examples/linear_regression/main.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""Linear-regression-over-encrypted-inputs demo: client -> server -> client.

End-to-end parity with the reference example
(examples/linear_regression/src/main.rs:20-86):

1. the client builds an LWE key, encrypts 4 feature values, and serializes
   ``InputData`` (key + ciphertexts + public weights);
2. the server deserializes, loads ``lr.txt``, executes + proves it, and
   serializes ``OutputData`` (program hash + STARK proof + stack outputs);
3. the client decrypts the first ciphertext on the output stack, checks the
   cleartext model prediction, and verifies the proof at >= 95-bit security.

Run from the repo root:  python -m zkvm_torch.examples.linear_regression.main [cpu]
"""

import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

from zkvm_torch.examples.linear_regression.protocol import InputData, OutputData
from zkvm_torch import vm
from zkvm_torch.fhe import FheUInt8, LweParameters, ServerKey
from zkvm_torch.isa import Program, ProgramInputs

WEIGHTS = (1, 3, 2, 4, 2)  # b0..b4
FEATURES = (2, 3, 3, 2)  # x1..x4


def client_encrypt(seed: int = 2026) -> tuple:
    params = LweParameters(8, 128, 4, 2.412390240121573e-5)
    client_key = ServerKey(params, random.Random(seed))
    cts = tuple(client_key.encrypt(x) for x in FEATURES)
    b0, b1, b2, b3, b4 = WEIGHTS
    data = InputData((b1, b2, b3, b4, b0), cts, client_key)
    return data.to_bytes(), client_key


def server_prove(input_bytes: bytes, device="cuda") -> bytes:
    payload = InputData.from_bytes(input_bytes)
    program = Program.load(os.path.join(os.path.dirname(__file__), "lr.txt"))
    inputs = ProgramInputs(
        payload.public_inputs, payload.secret_inputs, payload.server_key
    )
    hash_, output, proof = vm.prove(program, inputs, device=device)
    return OutputData.from_proof(hash_, proof, output).to_bytes()


def client_verify(output_bytes: bytes, client_key: ServerKey) -> int:
    results = OutputData.from_bytes(output_bytes)
    clear = client_key.decrypt(FheUInt8(results.output[:5]))
    b0, b1, b2, b3, b4 = WEIGHTS
    x1, x2, x3, x4 = FEATURES
    expected = b0 + b1 * x1 + b2 * x2 + b3 * x3 + b4 * x4
    assert clear == expected, f"decrypted {clear}, expected {expected}"
    vm.verify_bytes(
        results.proof_bytes, results.program_hash, results.output, client_key
    )
    return clear


def main(device="cuda"):
    t0 = time.time()
    input_bytes, client_key = client_encrypt()
    print(f"client: encrypted {len(FEATURES)} features "
          f"({len(input_bytes)} bytes) in {time.time() - t0:.3f}s")

    t0 = time.time()
    output_bytes = server_prove(input_bytes, device)
    print(f"server: proved lr.txt ({len(output_bytes)} bytes) "
          f"in {time.time() - t0:.3f}s")

    t0 = time.time()
    result = client_verify(output_bytes, client_key)
    print(f"client: verified proof in {time.time() - t0:.3f}s; "
          f"prediction = {result}")


if __name__ == "__main__":
    main(*sys.argv[1:])
