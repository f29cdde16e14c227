"""Top-level API: run, prove and verify a program on PyTorch / CUDA.

Port of ``zkvm.vm``: ``prove(program, inputs)`` executes the program with
the native C++ trace generator (:mod:`zkvm_torch.runtime`, built with g++
into ``zkvm_torch/build/`` at first use; the golden Python processor where
it cannot be built, or with ``use_native=False``), builds the 28-column
trace and proves it on the CUDA card (``device="cpu"`` proves on the
CPU), with the T-mode pipeline, or for ``mode="mono"`` the full-LDE one,
or for ``mode="cls"`` the standard-layout class prover (each up to
T = 2^20); all three give the same bytes.  With a
``config`` whose mesh has more than one row, every rank of an initialised
``torch.distributed`` group proves mono sharded by rows (:mod:`zkvm_torch.
dist`), with the same bytes.  It uses the reference parameter preset by
default (32 queries, blowup 8, grinding 0, FRI fold 8, remainder degree
<= 127), or the config's.

The host-side types a caller builds its inputs from (program, inputs, FHE
key and parameters, public inputs and the AIR's assertions) come from the
port's own copies of the JAX package's host modules and are re-exported
here, so a caller needs to import nothing but :mod:`zkvm_torch`.
"""

from __future__ import annotations

from typing import Optional, Tuple

from zkvm_torch.air.layout import PublicInputs, get_assertions
from zkvm_torch.config import ZkVmConfig
from zkvm_torch.dist.mesh import make_mesh
from zkvm_torch.fhe import ServerKey
from zkvm_torch.fhe.lwe import DEMO_PARAMETERS
from zkvm_torch.isa import Program, ProgramInputs
from zkvm_torch.processor import Processor
from zkvm_torch.prover import Proof, ProofOptions
from zkvm_torch.prover.pipeline import prove as stark_prove
from zkvm_torch.runtime import NativeProcessor, native_available
from zkvm_torch.utils.profiler import profiler
from zkvm_torch.verifier import verify as stark_verify
from zkvm_torch.verifier import verify_bytes as stark_verify_bytes

DEFAULT_SEED = 0xD15EA5E  # randomizer-row seed, as the JAX package's default
BENCH_N_OPS = 20000  # the bench's primary configuration: T = 2^16


def read_add_chain(n_ops: int, key) -> Tuple[Program, ProgramInputs]:
    """The bench's primary program (``bench.py::_read_add_trace``): READ
    public inputs and an ADD chain; n_ops = 20000 gives T = 2^16."""
    ops = ["read"] + ["read", "add"] * ((n_ops - 1) // 2)
    return Program.compile("\n".join(ops)), ProgramInputs(tuple([1] * (n_ops // 2 + 2)), (), key)


def run(program: Program, inputs: ProgramInputs, use_native: bool = True, seed: int = DEFAULT_SEED):
    """Execute a program; returns its ExecutionTrace: by the native trace
    generator when it is available and ``use_native`` is true, else by the
    golden processor (the same trace).  ``seed``: the randomizer rows'.
    The run is the profiler's span ``zkvm.trace_gen``
    (:mod:`zkvm_torch.utils.profiler`)."""
    with profiler.phase("trace_gen"):
        if use_native and native_available():
            return NativeProcessor.run(program, inputs, seed=seed)
        return Processor.run(program, inputs).trace(seed=seed)


def prove(
    program: Program,
    inputs: ProgramInputs,
    options: Optional[ProofOptions] = None,
    device=None,
    mode=None,
    use_native: Optional[bool] = None,
    config: Optional[ZkVmConfig] = None,
) -> Tuple[tuple, tuple, Proof]:
    """Prove a program run; returns (program_hash, stack_outputs, proof).

    ``mode``: ``"tmode"`` (the default), ``"mono"`` or ``"cls"`` (see
    :func:`prover.pipeline.prove`); ``use_native``: trace with the native
    generator when it is available (see :func:`run`).  ``config``
    (:class:`zkvm_torch.config.ZkVmConfig`, as ``zkvm/vm.py:29-62`` reads
    it): the options, ``use_native`` and the randomizer seed where they are
    not given; ``config.runtime.profile`` enables the process-wide
    profiler (:mod:`zkvm_torch.utils.profiler`), which records
    ``trace_gen`` (:func:`run`) and the prover's spans; ``config.mesh.rows > 1``
    proves mono sharded over the initialised process group (every rank
    calls ``prove``; it raises if no group is initialised or its size
    differs).  T-mode, mono and cls take T <= 2^20 in one process."""
    cfg = config or ZkVmConfig()
    if options is None:
        options = cfg.proof
    if use_native is None:
        use_native = cfg.runtime.use_native_trace
    seed = cfg.runtime.seed if cfg.runtime.seed is not None else DEFAULT_SEED
    if cfg.runtime.profile:
        profiler.enable()
    mesh = None
    if cfg.mesh.rows > 1:
        mesh = make_mesh(cfg.mesh.rows, axis=cfg.mesh.axis_name, device=device)
        device = None
    trace = run(program, inputs, use_native, seed)
    pub = PublicInputs(program.hash, trace.outputs, inputs.server_key)
    proof = stark_prove(trace, pub, options, device=device, mode=mode, mesh=mesh)
    return program.hash, trace.outputs, proof


def verify(proof: Proof, program_hash: tuple, stack_outputs: tuple, server_key,
           min_security: Optional[int] = None, config: Optional[ZkVmConfig] = None):
    """Raises VerificationError when the proof does not check out;
    ``min_security`` defaults to the config's (95 bits by default)."""
    if min_security is None:
        min_security = (config or ZkVmConfig()).min_security
    pub = PublicInputs(tuple(program_hash), tuple(stack_outputs), server_key)
    stark_verify(proof, pub, min_security)


def verify_bytes(proof_bytes: bytes, program_hash: tuple, stack_outputs: tuple, server_key,
                 min_security: Optional[int] = None, config: Optional[ZkVmConfig] = None):
    """Verify a proof in the winterfell wire format; ``min_security`` as
    :func:`verify`."""
    if min_security is None:
        min_security = (config or ZkVmConfig()).min_security
    pub = PublicInputs(tuple(program_hash), tuple(stack_outputs), server_key)
    stark_verify_bytes(proof_bytes, pub, min_security)
