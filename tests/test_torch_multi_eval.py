"""The multi-eval kernel ``csrc/multi_eval.cu``, run on the CPU through its
host emulation (``csrc/host_emu.h``), against the plain version
``multi_eval_rows_plain`` and the JAX ``zkvm.prover.eval_mxu.
multi_eval_rows``, limb for limb.

The kernel is built twice: at its shipped launch shape (128 threads a
block, one slice of t up to T = 128, eight at T = 1024) and with 4
threads and 24 blocks a launch (``-DZK_MEVAL_THREADS=4
-DZK_MEVAL_BLOCKS=24``), so that tiles and slices cross at every
shape and the last slice of t is short.  The T = 128 conformance proves
in T-mode and cls run with every multi-eval call through the emulated
kernel.  On the card, ``chip_smoke.py`` phase (c) holds the nvcc build
against the plain version at the provers' shapes.
"""

import ctypes
import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm.prover import eval_mxu as jme
from zkvm_torch import kernels, vm
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_limbs, from_numpy, to_limbs, to_numpy
from zkvm_torch.prover import limits
from zkvm_torch.prover import multi_eval as me

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent.parent / "conformance" / "vectors_e2e.json"
SMALL = ("ZK_MEVAL_THREADS=4", "ZK_MEVAL_BLOCKS=24")  # the second build's launch shape
# coefficient edge values: 0, 1, p - 1, low limbs all 0xFFFF (4 and 7 of
# them), eps; the points' edge values 0, 1, p - 1 sit among random ones
EDGES = (0, 1, f128.P - 1, 2**64 - 1, 2**112 - 1, 45 * 2**40 - 1)
POINTS = 32
COLUMNS = 28


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """{"shipped": ..., "small": ...}: the kernel's host emulation at its
    shipped launch shape and at SMALL."""
    from test_torch_csrc_emu import _build_emu

    out, libs = tmp_path_factory.mktemp("meval"), {}
    for name, defines in (("shipped", ()), ("small", SMALL)):
        lib = ctypes.CDLL(str(_build_emu(out, ["multi_eval.cu"], defines)))
        for entry in ("zk_multi_eval", "zk_multi_eval_slices"):
            getattr(lib, entry).argtypes = list(kernels.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _rand(rng, shape):
    """Random canonical elements (object ints) of ``shape``."""
    hi, lo = rng.integers(0, 2**63, size=(2,) + tuple(shape), dtype=np.int64)
    return (hi.astype(object) << 65 | lo.astype(object) << 1 | (lo.astype(object) & 1)) % f128.P


def _t(vals):
    """(..., n) ints -> (..., 8, n) int32 limb tensor."""
    return from_numpy(np.swapaxes(to_limbs(vals), -1, -2))


def _inputs(t):
    """(COLUMNS, t) coefficients and POINTS points from a seed: column 0
    all p - 1, the others random with the edge values at every s-th t,
    s = max(1, t // 8) (shifted by one a column); the points random, with
    0, p - 1 and 1 at places 1, 2 and 5 (so Q = 2 and 3 meet 0 and p - 1)."""
    rng = np.random.default_rng(t)
    vals = _rand(rng, (COLUMNS, t))
    vals[0] = f128.P - 1
    step = max(1, t // 8)
    for c in range(1, COLUMNS):
        for k, i in enumerate(range(0, t, step)):
            vals[c, i] = EDGES[(k + c) % len(EDGES)]
    points = [int(v) for v in _rand(rng, (POINTS,))]
    points[1], points[2], points[5] = 0, f128.P - 1, 1
    return vals, points


@pytest.fixture(scope="module")
def jax_rows():
    """JAX's rows of all COLUMNS at all POINTS, one call a T (the rows of
    fewer columns and points are a corner of them)."""
    cache = {}

    def get(t):
        if t not in cache:
            vals, points = _inputs(t)
            cache[t] = jme.multi_eval_rows(jnp.asarray(np.swapaxes(to_limbs(vals), -1, -2)), points)
        return cache[t]

    return get


def _launch(lib, coeffs_t, points):
    """The kernel on the CPU: the points' ladder factors as the wrapper
    builds them on a card (``ladder_factors``, here in the plain
    arithmetic), then one call of the emulated entry; (Q, C, 8) limbs."""
    factors = me.ladder_factors(from_numpy(to_limbs(list(points))), coeffs_t.shape[-1])
    return me.launch_multi_eval(lib, None, coeffs_t, *factors)


@pytest.mark.parametrize("t", [16, 128, 1024])
@pytest.mark.parametrize("q", [1, 2, 3, 31, 32])
@pytest.mark.parametrize("c", [1, 8, 28])
def test_multi_eval_kernel_emulated(emu, jax_rows, c, q, t):
    """Both builds equal the plain version and JAX's eval_mxu, limb for
    limb (so every output is canonical), at C columns, Q points and T
    coefficients."""
    vals, points = _inputs(t)
    coeffs_t = _t(vals[:c])
    want = to_limbs(me.multi_eval_rows_plain(coeffs_t, points[:q]))  # (Q, C, 8)
    np.testing.assert_array_equal(want, to_limbs([row[:c] for row in jax_rows(t)[:q]]))
    for name, lib in emu.items():
        np.testing.assert_array_equal(to_numpy(_launch(lib, coeffs_t, points[:q])), want, err_msg=name)


@pytest.mark.parametrize("pairs", [False, True])
def test_multi_eval_plain_version_needs_no_dispatching_op(monkeypatch, jax_rows, pairs):
    """The kernel's yardstick reaches no kernel: with the dispatching field
    ops patched to raise, ``multi_eval_rows_plain`` (its ladders in the
    plain arithmetic, in one piece and, with ``CHUNK_T`` patched below T,
    in point pairs) still equals JAX's rows at 28 columns, 31 points and
    T = 1024."""
    if pairs:
        monkeypatch.setattr(limits, "CHUNK_T", 128)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain multi-eval called a dispatching field op")

    for name in ("fadd", "fsub", "fmul", "_dispatch"):
        monkeypatch.setattr(ft, name, refuse)
    vals, points = _inputs(1024)
    got = me.multi_eval_rows_plain(_t(vals), points[:31])
    assert got == [list(row) for row in jax_rows(1024)[:31]]


@pytest.mark.parametrize("c,q,t,s,n2", [(3, 5, 1, 1, 1), (2, 3, 5, 2, 3), (5, 2, 100, 8, 13), (9, 1, 300, 16, 19),
                                        (4, 4, 515, 32, 17)])
def test_multi_eval_kernel_takes_any_length_and_factors(emu, c, q, t, s, n2):
    """The kernel's contract: sum_t a[c][t] l1[q][t mod S] l2[q][t div S]
    for any factors (Q, 8, S) and (Q, 8, N2) with S N2 >= T, T not a
    power of two included: random rows with p - 1 and the edge values
    everywhere, against the sums in host ints."""
    rng = np.random.default_rng(100 * c + t)
    a, l1, l2 = _rand(rng, (c, t)), _rand(rng, (q, s)), _rand(rng, (q, n2))
    a[:, ::3], l1[:, 1::3], l2[:, ::4] = f128.P - 1, f128.P - 1, f128.P - 1
    a[:, 1::7] = EDGES[3]
    l1[:, ::5] = EDGES[4]
    want = to_limbs([[sum(a[ci, i] * l1[qi, i % s] * l2[qi, i // s] for i in range(t)) % f128.P for ci in range(c)]
                     for qi in range(q)])
    for name, lib in emu.items():
        got = me.launch_multi_eval(lib, None, _t(a), _t(l1), _t(l2))
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=name)


@pytest.mark.parametrize("c,q,t", [(28, 32, 1 << 20), (28, 2, 1 << 20), (8, 1, 1 << 16), (28, 32, 16),
                                   (1, 1, 1), (3, 3, 100)])
def test_multi_eval_slices_cover_t(emu, c, q, t):
    """The work buffer's slices: at least one, at most one a block's width
    of t and at most the launch's target blocks; the entry refuses a
    buffer of fewer slices before any launch.  The shipped shape splits
    the provers' 2^20 shapes into many slices (fills the card) and takes
    T = 16 in one."""
    for name, lib in emu.items():
        threads, blocks = (4, 24) if name == "small" else (128, 4096)
        s = lib.zk_multi_eval_slices(c, q, t)
        assert 1 <= s <= min(blocks, -(-t // threads)), (name, s)
        assert lib.zk_multi_eval(None, None, None, None, s - 1, None, c, q, t, 1 << 20, 1, None) == -1
    # ladder factors that do not cover T, or an S not a power of two
    assert emu["shipped"].zk_multi_eval(None, None, None, None, 8, None, 2, 2, 16, 4, 3, None) == -1
    assert emu["shipped"].zk_multi_eval(None, None, None, None, 8, None, 2, 2, 16, 6, 4, None) == -1
    assert emu["shipped"].zk_multi_eval_slices(28, 32, 1 << 20) >= 64
    assert emu["shipped"].zk_multi_eval_slices(8, 1, 1 << 20) >= 1024
    assert emu["shipped"].zk_multi_eval_slices(28, 32, 16) == 1
    assert emu["shipped"].zk_multi_eval_slices(0, 1, 16) == 0


@pytest.mark.parametrize("mode", ["tmode", "cls"])
def test_provers_through_the_emulated_multi_eval_kernel(emu, monkeypatch, mode):
    """Every multi-eval call of a T = 128 prove (the OOD frame's two and the
    query rows' two) through the kernel's emulation at the small launch
    shape: the proof equals the conformance vector's bytes."""
    calls = []

    def through_kernel(coeffs_t, points):
        calls.append((coeffs_t.shape[0], len(points)))
        me._checked(coeffs_t, points)
        return [[int(v) for v in row] for row in from_limbs(to_numpy(_launch(emu["small"], coeffs_t, points)))]

    monkeypatch.setattr(me, "multi_eval_rows", through_kernel)
    before = me.plain_calls
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    _, _, proof = vm.prove(program, inputs, device="cpu", mode=mode)
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]
    assert [cq[:1] + (cq[1] > 1,) for cq in calls] == [(28, True), (8, False), (28, True), (8, True)], calls
    assert me.plain_calls == before


class _FailingLib:
    """A kernel library whose multi-eval entry reports a failed launch."""

    def zk_multi_eval_slices(self, c, q, t):
        return 1

    def zk_multi_eval(self, *args):
        return 700  # cudaErrorIllegalAddress


def test_multi_eval_refuses_and_never_falls_back(monkeypatch):
    """A launch that fails raises; a device with no kernel raises before
    any launch; coefficients that are not contiguous int32 (C, 8, T), or no
    points, raise on the CPU too (as the card would refuse them).  None of
    these reaches the plain version or counts a launch."""
    coeffs = torch.zeros((2, 8, 16), dtype=torch.int32)
    l1, l2 = torch.zeros((3, 8, 4), dtype=torch.int32), torch.zeros((3, 8, 4), dtype=torch.int32)
    before = (me.plain_calls, me.launches)
    with pytest.raises(RuntimeError, match="zk_multi_eval: CUDA launch failed with error 700"):
        me.launch_multi_eval(_FailingLib(), None, coeffs, l1, l2)
    monkeypatch.setattr(kernels, "lib", lambda: _FailingLib())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        me.multi_eval_rows(coeffs.to("meta"), [1, 2])
    with pytest.raises(ValueError, match="contiguous"):
        me.multi_eval_rows(torch.zeros((2, 16, 8), dtype=torch.int32).transpose(1, 2), [1])
    with pytest.raises(TypeError, match="int32"):
        me.multi_eval_rows(coeffs.long(), [1])
    with pytest.raises(ValueError, match=r"\(C, 8, T\)"):
        me.multi_eval_rows(coeffs[0], [1])
    with pytest.raises(ValueError, match="no points"):
        me.multi_eval_rows(coeffs, [])
    with pytest.raises(ValueError, match="ladder factors of 4 x 2 lanes for T = 16"):
        me.launch_multi_eval(_FailingLib(), None, coeffs, l1, l2[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="ladder factors of 3 x 8 lanes"):
        me.launch_multi_eval(_FailingLib(), None, coeffs, l1[:, :, :3].contiguous(), torch.zeros((3, 8, 8),
                                                                                             dtype=torch.int32))
    with pytest.raises(ValueError, match="l2: shape"):
        me.launch_multi_eval(_FailingLib(), None, coeffs, l1, l2[:2].contiguous())
    with pytest.raises(ValueError, match="power of two"):
        me.multi_eval_rows(torch.zeros((2, 8, 12), dtype=torch.int32), [1])
    assert (me.plain_calls, me.launches) == before
