# Copy of zkvm/config.py, with its imports of zkvm pointed at the zkvm_torch
# copies: the port needs nothing of the JAX package at run time.
# tests/test_torch_prover.py pins it to the original.
"""One typed configuration for the whole stack (SURVEY.md section 5).

The reference hardcodes every parameter at its call site (STARK options at
vm/src/lib.rs:20, LWE parameters at examples/linear_regression/src/main.rs:34-38,
the security floor at main.rs:81).  Here they are gathered into a single
``ZkVmConfig`` with the reference values as the conformance preset, plus the
TPU-deployment knobs (mesh shape, native trace generator, profiling) that
have no reference analogue.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

from zkvm_torch.fhe import LweParameters
from zkvm_torch.prover.options import ProofOptions


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded prover (SURVEY.md section 2.3).

    ``rows`` devices shard the LDE-domain axis; 1 means single-chip.  The
    axis name matches :func:`zkvm.dist.make_mesh`.
    """

    rows: int = 1
    axis_name: str = "row"


@dataclass(frozen=True)
class RuntimeConfig:
    """Host-runtime knobs: native trace generation and instrumentation."""

    use_native_trace: bool = True  # C++ trace generator when available
    profile: bool = False  # per-phase wall-clock + rows/sec counters
    seed: int | None = None  # randomizer-row seed; None -> nondeterministic


@dataclass(frozen=True)
class ZkVmConfig:
    proof: ProofOptions = field(default_factory=ProofOptions)
    lwe: LweParameters = field(
        default_factory=lambda: LweParameters(8, 128, 4, 2.412390240121573e-5)
    )
    min_security: int = 95  # AcceptableOptions::MinConjecturedSecurity(95)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def with_mesh(self, rows: int) -> "ZkVmConfig":
        return replace(self, mesh=MeshConfig(rows=rows))


# The conformance preset: exactly the reference's constants (BASELINE.md).
REFERENCE_CONFIG = ZkVmConfig()


def from_env(base: ZkVmConfig = REFERENCE_CONFIG) -> ZkVmConfig:
    """Apply ZKVM_* environment overrides (deployment convenience)."""
    runtime = replace(
        base.runtime,
        profile=os.environ.get("ZKVM_PROFILE", "") not in ("", "0"),
        use_native_trace=os.environ.get("ZKVM_NATIVE", "1") not in ("0",),
    )
    mesh = base.mesh
    if "ZKVM_MESH_ROWS" in os.environ:
        mesh = MeshConfig(rows=int(os.environ["ZKVM_MESH_ROWS"]))
    return replace(base, runtime=runtime, mesh=mesh)
