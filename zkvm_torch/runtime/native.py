# Copy of zkvm/runtime/native.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""ctypes binding + build-on-demand for the C++ trace generator."""

from __future__ import annotations

import ctypes
import os
import random
import subprocess
from typing import Optional

import numpy as np

from zkvm_torch.field import f128
from zkvm_torch.field.limbs import to_limbs
from zkvm_torch.hash import rescue
from zkvm_torch.processor.golden import (
    ChipletsError,
    ExecutionTrace,
    MIN_TRACE_LENGTH,
    NUM_RAND_ROWS,
    ProcessorError,
    StackError,
)

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "trace_gen.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")
_SO = os.path.join(_BUILD_DIR, "libtrace_gen.so")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_ERRORS = {
    1: lambda: StackError("stack underflow"),
    2: lambda: StackError("stack overflow"),
    3: lambda: StackError("no more input values"),
    4: lambda: ProcessorError("bad opcode"),
    5: lambda: ChipletsError(
        "only noop may execute during hash capacity-reset steps"
    ),
    6: lambda: ProcessorError("native constants not loaded"),
}


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", _CSRC, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_CSRC):
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _load_failed = True
        return None

    lib.zkvm_load_constants.argtypes = [ctypes.c_void_p] * 4
    lib.zkvm_program_hash.restype = ctypes.c_int
    lib.zkvm_program_hash.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p
    ]
    lib.zkvm_run_trace.restype = ctypes.c_int
    lib.zkvm_run_trace.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,  # ops
        ctypes.c_void_p, ctypes.c_uint64,                    # pub tape
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,   # secret tape
        ctypes.c_uint64,                                     # delta
        ctypes.c_uint64,                                     # trace length
        ctypes.c_void_p, ctypes.c_void_p,                    # out, outputs
    ]

    mds = np.ascontiguousarray(to_limbs(rescue.MDS), dtype=np.uint32)
    inv_mds = np.ascontiguousarray(to_limbs(rescue.INV_MDS), dtype=np.uint32)
    ark = np.ascontiguousarray(to_limbs([v for row in rescue.ARK for v in row]), dtype=np.uint32)
    inv_alpha = np.ascontiguousarray(to_limbs(f128.INV_ALPHA), dtype=np.uint32)
    lib.zkvm_load_constants(
        mds.ctypes.data, inv_mds.ctypes.data, ark.ctypes.data, inv_alpha.ctypes.data
    )
    _lib = lib
    return lib


def native_available() -> bool:
    # hard kill-switch: ZKVM_NATIVE=0 disables the in-process C++ library
    # everywhere, including callers that never consult config.from_env()
    if os.environ.get("ZKVM_NATIVE", "") == "0":
        return False
    return _load() is not None


def program_hash(ops) -> Optional[tuple]:
    """Native Rescue-Prime program hash, or None when the lib is missing."""
    lib = _load()
    if lib is None:
        return None
    code = np.asarray([op.code for op in ops], dtype=np.uint8)
    values = np.asarray([op.value for op in ops], dtype=np.uint8)
    digest = np.zeros((2, 8), dtype=np.uint32)
    rc = lib.zkvm_program_hash(
        code.ctypes.data, values.ctypes.data, len(code), digest.ctypes.data
    )
    if rc != 0:
        return None
    return tuple(
        int(sum(int(digest[i, l]) << (16 * l) for l in range(8))) for i in range(2)
    )


def _trace_length(n_ops: int) -> int:
    capacity = MIN_TRACE_LENGTH
    for clk in range(1, n_ops + 1):
        if clk >= capacity:
            capacity *= 2
    n = capacity + NUM_RAND_ROWS
    return 1 << (n - 1).bit_length()


class NativeProcessor:
    """Drop-in for golden.Processor with a (28, T, 8) uint32 limb result.

    ``run()`` returns an :class:`ExecutionTrace` whose ``limbs`` attribute
    carries the device-ready array; ``columns`` (Python ints) are
    materialized lazily only if accessed.
    """

    @staticmethod
    def run(program, inputs, seed: int = 0xD15EA5E) -> ExecutionTrace:
        lib = _load()
        if lib is None:
            raise RuntimeError("native trace generator unavailable (g++ build failed)")

        code = np.asarray([op.code for op in program.code], dtype=np.uint8)
        values = np.asarray([op.value for op in program.code], dtype=np.uint8)
        n_ops = len(code)
        t_len = _trace_length(n_ops)

        pub = np.asarray(list(inputs.public), dtype=np.uint8)
        key = inputs.server_key
        lwe_size = key.lwe_size
        secret = np.zeros((max(1, len(inputs.secret)), lwe_size, 8), dtype=np.uint32)
        for i, ct in enumerate(inputs.secret):
            secret[i] = to_limbs(list(ct.ciphertext))

        out = np.zeros((28, t_len, 8), dtype=np.uint32)
        outputs = np.zeros((16, 8), dtype=np.uint32)
        rc = lib.zkvm_run_trace(
            code.ctypes.data, values.ctypes.data, n_ops,
            pub.ctypes.data, len(pub),
            secret.ctypes.data, len(inputs.secret), lwe_size,
            key.parameters.delta,
            t_len,
            out.ctypes.data, outputs.ctypes.data,
        )
        if rc != 0:
            raise _ERRORS.get(rc, lambda: ProcessorError(f"native error {rc}"))()

        # randomize the last row (nonzero, seeded — golden.Processor semantics)
        rng = random.Random(seed)
        last = to_limbs([rng.randrange(1, f128.P) for _ in range(28)])
        out[:, t_len - 1, :] = last

        out_ints = tuple(
            int(sum(int(outputs[r, l]) << (16 * l) for l in range(8)))
            for r in range(16)
        )
        return ExecutionTrace(
            columns=None,
            program_hash=program.hash,
            outputs=out_ints,
            limbs=out,
        )
