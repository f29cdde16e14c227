"""The dispatch of ``zkvm_torch.field.f128t``'s field ops, and the
yardsticks' independence from them.

On a card ``fadd`` / ``fsub`` / ``fmul`` launch the field-op kernel
(``csrc/field_ops.cu``); the plain versions that hold K1, K3, K4 and the
batch inverse on the card must not reach it, or a fault in the kernels'
shared ``zk::mul32`` would hide on both sides of a check.  Here each
yardstick runs with the dispatching ops patched to raise and still equals
its JAX counterpart.  The provers' own calls of the ops, at every shape
the T = 128 proves give them, run through the kernel's host emulation and
give the conformance vector's bytes in every mode.
"""

import collections
import ctypes
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.air import constraints_pallas as jcp
from zkvm.field import jax_f128 as jf
from zkvm.ntt import ntt_t as jnt
from zkvm_torch import kernels, vm
from zkvm_torch.air import composition as tcp
from zkvm_torch.air import transition as ttr
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent.parent / "conformance" / "vectors_e2e.json"


@pytest.fixture
def no_dispatch(monkeypatch):
    """The dispatching field ops (and everything that reaches them, the
    boundary groups' default arithmetic included) raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("a yardstick called a dispatching field op")

    for name in ("fadd", "fsub", "fmul", "_dispatch"):
        monkeypatch.setattr(ft, name, refuse)


def test_k1_plain_version_needs_no_dispatching_op(no_dispatch):
    """``stages_plain`` (through ``pease_stages_plain`` and ``_apply_pre``),
    with each premultiplier variant, against the JAX ``_axis_ntt``."""
    from test_torch_ntt_stages import _ORACLE, rand_limbs

    rng = np.random.default_rng(12)
    m, nl = 8, 4
    y = rand_limbs(rng, (3, m, 8, nl))
    pre = rand_limbs(rng, (m, 8, nl))
    r1 = (rand_limbs(rng, (8, m)), rand_limbs(rng, (8, nl)))
    tw = tnt._stage_twiddles_dev(m, True, torch.device("cpu"))
    for p, r in ((None, None), (pre, None), (None, r1)):
        want = _ORACLE(jnp.asarray(y), m, True, None if p is None else jnp.asarray(p),
                       None if r is None else tuple(jnp.asarray(a) for a in r))
        got = tnt.stages_plain(from_numpy(y), tw, None if p is None else tnt.pack_t(from_numpy(p)),
                               None if r is None else tuple(from_numpy(a) for a in r))
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_k3_plain_version_needs_no_dispatching_op(no_dispatch):
    """``composition_plain`` (through ``composition_body_t`` and the
    boundary groups in the plain arithmetic) against the JAX
    ``composition_t``."""
    from test_torch_composition import T, _ORDER, composition_inputs

    arrays, delta, bcols0, bcols1 = composition_inputs(5)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = jcp.composition_t(
        j["cur"], jnp.tile(j["mask"], (1, T // 16)), jnp.tile(j["ark"], (1, 1, T // 16)),
        j["ee"], j["i0"], j["i1"], j["alphas"], j["bv0"], j["bb0"], j["bv1"], j["bb1"],
        delta, bcols0, bcols1,
    )
    got = tcp.composition_plain(*(from_numpy(arrays[k]) for k in _ORDER), delta, bcols0, bcols1)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_k4_plain_version_needs_no_dispatching_op(no_dispatch):
    """``merged_transition_plain`` (through ``merged_transition_t``) over
    one class, against the JAX ``merged_transition_t`` on the same rows
    (the next row the next lane, cyclic; the 16-step patterns tiled)."""
    from test_torch_composition import T, composition_inputs
    from zkvm.hash import rescue_jax as rj

    arrays, delta, _, _ = composition_inputs(5)
    cur, mask, ark, alphas = (jnp.asarray(arrays[k]) for k in ("cur", "mask", "ark", "alphas"))
    want = jcp.merged_transition_t(cur, jnp.roll(cur, -1, axis=-1), jnp.tile(mask, (1, T // 16)),
                                   jnp.tile(ark, (1, 1, T // 16)), rj.mds_limbs(), rj.inv_mds_limbs(),
                                   alphas, delta)
    got = ttr.merged_transition_plain(*(from_numpy(arrays[k]) for k in ("cur", "mask", "ark", "alphas")),
                                      delta, 1)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_batch_inverse_plain_version_needs_no_dispatching_op(no_dispatch):
    """``batch_inverse_plain`` (through ``fpow_const_plain``) against the
    JAX batch inverse, zeros and edge values included."""
    from test_torch_field import EDGES, _values
    from zkvm_torch.field.limbs import to_limbs

    vals = _values(4, 50) + EDGES
    std = to_limbs(vals)  # (n, 8)
    want = np.asarray(jax.jit(jf.batch_inverse)(jnp.asarray(std)))
    got = ft.batch_inverse_plain(from_numpy(np.ascontiguousarray(std.T)))
    np.testing.assert_array_equal(to_numpy(got).T, want)


def _limbs(shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("op", [ft.fadd, ft.fsub, ft.fmul])
def test_dispatching_ops_refuse_what_the_kernel_cannot_take(op):
    """A non-int32 operand, a limb axis other than 8, shapes that do not
    broadcast, operands on two devices, and a device with no kernel raise
    before any launch; nothing is counted."""
    before = sum(ft.op_launches.values())
    with pytest.raises(TypeError, match="int32"):
        op(_limbs((8, 4)).long(), _limbs((8, 4)))
    with pytest.raises(ValueError, match=r"\(\.\.\., 8, N\)"):
        op(_limbs((4, 4)), _limbs((4, 4)))
    with pytest.raises(ValueError, match=r"\(\.\.\., 8, N\)"):
        op(_limbs((8,)), _limbs((8, 4)))
    with pytest.raises(ValueError, match="broadcast"):
        op(_limbs((3, 8, 4)), _limbs((2, 8, 4)))
    with pytest.raises(ValueError, match="no kernel"):
        op(_limbs((8, 4)).to("meta"), _limbs((8, 4)).to("meta"))
    with pytest.raises(ValueError, match="operands on"):
        op(_limbs((8, 4)), _limbs((8, 4)).to("meta"))
    assert sum(ft.op_launches.values()) == before


def test_boundary_group_plain_equals_the_default():
    """The boundary group in the plain arithmetic (K3's plain version)
    equals it in the default, dispatching one (the provers'), on the CPU."""
    from test_torch_composition import composition_inputs

    arrays, _, bcols0, _ = composition_inputs(9, t=32)
    cur, bv, bb = (from_numpy(arrays[k]) for k in ("cur", "bv0", "bb0"))
    want = tcp.boundary_group(cur, bcols0, bv, bb)
    np.testing.assert_array_equal(to_numpy(tcp.boundary_group(cur, bcols0, bv, bb, ft.PLAIN)), to_numpy(want))


@pytest.fixture(scope="module")
def emu_field_ops(tmp_path_factory):
    """The field-op kernel's host emulation with 4 threads and one block a
    launch, so every launch walks its elements by the grid stride."""
    from test_torch_csrc_emu import _build_emu

    so = _build_emu(tmp_path_factory.mktemp("fop"), ["field_ops.cu"], ("ZK_FOP_THREADS=4", "ZK_FOP_MAX_BLOCKS=1"))
    lib = ctypes.CDLL(str(so))
    lib.zk_field_op.argtypes = list(kernels.SIGNATURES["zk_field_op"])
    lib.zk_field_op.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("mode", ["tmode", "mono", "cls"])
def test_provers_through_the_emulated_field_kernel(emu_field_ops, monkeypatch, mode):
    """Every call the prover makes of the dispatching ops (``fadd``,
    ``fsub``, ``fmul``, ``fsquare``, ``fsum`` and the boundary groups'
    default arithmetic) goes through the kernel's host emulation, as the
    card would launch it on the same operands: the T = 128 proof equals
    the conformance vector's bytes."""
    calls = collections.Counter()

    def through_kernel(op, plain, a, b):
        calls[op] += 1
        return ft.launch_field_op(emu_field_ops, 0, op, a, b)

    monkeypatch.setattr(ft, "_dispatch", through_kernel)
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    _, _, proof = vm.prove(program, inputs, device="cpu", mode=mode)
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]
    # T-mode's adds are inside the FRI and DEEP kernels now: its field ops
    # are the DEEP's x - points and the composition's inverse-offset scale
    ops = ("sub", "mul") if mode == "tmode" else ("add", "sub", "mul")
    assert min(calls[op] for op in ops) > 0, calls
