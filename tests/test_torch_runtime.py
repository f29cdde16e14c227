"""The port's native C++ trace generator (``zkvm_torch.runtime``) against the
port's golden processor and the JAX package's native generator, limb for
limb, on the cases of ``tests/test_native_trace.py``; its error paths; and
the native program hash against the Python Rescue sponge."""

import random

import numpy as np
import pytest

import zkvm.fhe
import zkvm.isa
from zkvm.runtime import NativeProcessor as JaxNativeProcessor
from zkvm_torch import vm
from zkvm_torch.field.limbs import to_limbs
from zkvm_torch.fhe import LweParameters, ServerKey
from zkvm_torch.hash.rescue import Rescue128
from zkvm_torch.isa import Program, ProgramInputs
from zkvm_torch.processor import Processor, StackError
from zkvm_torch.runtime import NativeProcessor, native_available
from zkvm_torch.runtime import native

PARAMS = (8, 128, 4, 2.412390240121573e-5)


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native_available(), "g++ could not build zkvm_torch/runtime/csrc/trace_gen.cpp"


def _keys(seed=7):
    """The same key in the port's and the JAX package's types."""
    return (ServerKey(LweParameters(*PARAMS), random.Random(seed)),
            zkvm.fhe.ServerKey(zkvm.fhe.LweParameters(*PARAMS), random.Random(seed)))


def _fhe_inputs(key, jkey):
    cts = (key.encrypt(2), key.encrypt(3))
    jcts = (jkey.encrypt(2), jkey.encrypt(3))
    assert [c.ciphertext for c in cts] == [c.ciphertext for c in jcts]
    return (3, 4, 1), cts, jcts


@pytest.mark.parametrize("case", ["scalar", "mul_read", "fhe", "larger"])
def test_native_trace_equals_golden_and_jax(case):
    """The port's native trace equals its golden processor's and the JAX
    NativeProcessor's, limb for limb, with the same outputs and hash."""
    key, jkey = _keys()
    public, cts, jcts = (), (), ()
    if case == "scalar":
        source = "push.1\npush.2\nadd"
    elif case == "mul_read":
        source, public = "read\nread\nmul\npush.7\nadd", (3, 5)
    elif case == "fhe":
        source = "read2\nread\nsmul\nread2\nread\nsmul\nadd2\nread\nsadd"
        public, cts, jcts = _fhe_inputs(key, jkey)
    else:
        source, public = "\n".join(["read"] + ["read", "add"] * 40 + ["push.3", "mul"]), tuple([1] * 60)
    program = Program.compile(source)
    inputs = ProgramInputs(public, cts, key)
    golden = Processor.run(program, inputs).trace(seed=vm.DEFAULT_SEED)
    port = NativeProcessor.run(program, inputs, seed=vm.DEFAULT_SEED)
    jax = JaxNativeProcessor.run(zkvm.isa.Program.compile(source), zkvm.isa.ProgramInputs(public, jcts, jkey),
                                 seed=vm.DEFAULT_SEED)
    assert port.length == golden.length == jax.length
    np.testing.assert_array_equal(port.as_limbs(), to_limbs(golden.columns))
    np.testing.assert_array_equal(port.as_limbs(), np.asarray(jax.as_limbs()))
    assert port.outputs == golden.outputs == jax.outputs
    assert port.program_hash == golden.program_hash == jax.program_hash
    # the entry point's native trace is the same trace
    np.testing.assert_array_equal(vm.run(program, inputs, use_native=True).as_limbs(), port.as_limbs())


def test_native_error_paths():
    key, _ = _keys()
    with pytest.raises(StackError):
        NativeProcessor.run(Program.compile("read"), ProgramInputs((), (), key))
    with pytest.raises(StackError):
        NativeProcessor.run(Program.compile("add"), ProgramInputs((), (), key))


@pytest.mark.parametrize("n_pairs", [128, 700])
def test_native_program_hash_equals_python_sponge(n_pairs):
    """Programs of 256 ops and more hash natively; the digest is the
    Python Rescue sponge's and the JAX package's."""
    source = "\n".join(["push.1"] + ["push.2", "add"] * n_pairs)
    program = Program.compile(source)
    assert len(program.code) >= 256
    sponge = Rescue128()
    for op in program.code:
        sponge.update(op.code, op.value)
    assert native.program_hash(program.code) == sponge.hash() == program.hash
    assert program.hash == zkvm.isa.Program.compile(source).hash
