"""Build the port's host objects from plain data.

A trace, key or public inputs made elsewhere (for instance by the JAX
package's processor) crosses into the port through these functions: they
read plain values and attributes only, and return the port's own
:class:`~zkvm_torch.processor.ExecutionTrace`,
:class:`~zkvm_torch.fhe.ServerKey` and
:class:`~zkvm_torch.air.layout.PublicInputs`.
"""

from __future__ import annotations

import numpy as np

from zkvm_torch.air.layout import PublicInputs
from zkvm_torch.fhe.lwe import LweParameters, ServerKey
from zkvm_torch.processor import ExecutionTrace


def execution_trace(values, program_hash, outputs) -> ExecutionTrace:
    """An ExecutionTrace from its 28 columns: (28, T) field ints, or a
    (28, T, 8) uint32 numpy array of 16-bit limbs."""
    hash_, outs = tuple(int(v) for v in program_hash), tuple(int(v) for v in outputs)
    if isinstance(values, np.ndarray) and values.ndim == 3:
        if values.shape[0] != 28 or values.shape[2] != 8:
            raise ValueError(f"limbs of shape {values.shape}, expected (28, T, 8)")
        return ExecutionTrace(None, hash_, outs, limbs=np.ascontiguousarray(values, dtype=np.uint32))
    columns = [[int(v) for v in col] for col in values]
    if len(columns) != 28 or len({len(c) for c in columns}) != 1:
        raise ValueError("expected 28 columns of one length")
    return ExecutionTrace(columns, hash_, outs)


def server_key(parameters, key) -> ServerKey:
    """A ServerKey from LWE parameters (any object with
    ``plaintext_modulus``, ``ciphertext_modulus``, ``k``, ``std`` and
    ``delta``) and the secret-key ints."""
    params = LweParameters(
        int(parameters.plaintext_modulus), int(parameters.ciphertext_modulus),
        int(parameters.k), float(parameters.std),
    )
    if params.delta != parameters.delta:  # as LweParameters.read_from keeps a stored delta
        object.__setattr__(params, "delta", int(parameters.delta))
    return ServerKey.from_key([int(b) for b in key], params)


def public_inputs(program_hash, stack_outputs, key) -> PublicInputs:
    """PublicInputs from the program hash, the stack outputs and a server
    key (any object with ``parameters`` and ``key``)."""
    return PublicInputs(
        tuple(int(v) for v in program_hash), tuple(int(v) for v in stack_outputs),
        server_key(key.parameters, key.key),
    )
