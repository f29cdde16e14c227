"""The multi-eval kernels ``csrc/multi_eval.cu`` (the u8 ``mma``
contraction and the ladder operands), run on the CPU through their host
emulation (``csrc/host_emu.h``, which emulates the m16n8k32 u8
``mma.sync`` in the PTX ISA's fragment layout), against the plain versions
``multi_eval_rows_plain`` / ``ladders_plain`` and the JAX
``zkvm.prover.eval_mxu.multi_eval_rows``, limb for limb.

The kernel is built twice: at its shipped tile (8 groups of one column a
block; 16 points for Q >= 3 over 8 warps, 1 or 2 points for the OOD's Q;
chunks of 64 t, 3 in flight; the ladders' warp of four outputs a
thread, 128 a block) and at a small one (``SMALL``: one group a block, 2
points over 2 warps, chunks of 32 t; the ladders' two warps of one
output a thread, 64 a block),
so that point tiles and slices cross and S < 32 leaves the one chunk
partial; the contract cases add
odd T, S of 1-256 (several chunks, T ending inside a chunk) and S = 2^12
with every digit 0xFF where the byte products are largest.  The T = 128
conformance proves in T-mode and cls run with every multi-eval call
through the emulated kernels at the shipped tile.  On the card, ``chip_smoke.py`` phase (c)
holds the nvcc build against the plain versions at the provers' shapes.
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
from zkvm_torch.utils import kernel_health

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent.parent / "conformance" / "vectors_e2e.json"
SMALL = ("ZK_MEVAL_WM=1", "ZK_MEVAL_BM=1", "ZK_MEVAL_WQ=1", "ZK_MEVAL_BN=2", "ZK_MEVAL_KC=32",  # the second tile
         "ZK_MLAD_THREADS=64", "ZK_MLAD_LANES=1")
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
        for entry in ("zk_multi_eval", "zk_multi_eval_slices", "zk_meval_ladders", "zk_multi_eval_smem"):
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
    """The kernels on the CPU as the wrapper runs them on a card
    (``evaluate``): the emulated ladder entry for the points, then the
    emulated multi-eval entry; (Q, C, 8) limbs."""
    return me.evaluate(lib, None, [coeffs_t], from_numpy(to_limbs(list(points))))[0]


@pytest.mark.parametrize("t", [16, 128, 512])
@pytest.mark.parametrize("q", [1, 2, 3, 31, 32])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_multi_eval_kernel_emulated(emu, jax_rows, c, q, t):
    """Both builds equal the plain version and JAX's eval_mxu, limb for
    limb (so every output is canonical), at C columns, Q points and T
    coefficients.  The emulation's time grows with the blocks, C x the
    point tiles x the slices: the tile edges (Q = 31, 32) and several
    slices (T = 512: S = 32, N2 = 16) at up to 8 columns, the provers'
    28 columns in the T = 128 proves below."""
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
    T = 512."""
    if pairs:
        monkeypatch.setattr(limits, "CHUNK_T", 128)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain multi-eval called a dispatching field op")

    for name in ("fadd", "fsub", "fmul", "_dispatch"):
        monkeypatch.setattr(ft, name, refuse)
    vals, points = _inputs(512)
    got = me.multi_eval_rows_plain(_t(vals), points[:31])
    assert got == [list(row) for row in jax_rows(512)[:31]]


@pytest.mark.parametrize("c,q,t,s,n2", [(3, 5, 1, 1, 1), (2, 3, 5, 2, 3), (5, 2, 100, 8, 13), (9, 1, 300, 16, 19),
                                        (4, 4, 515, 32, 17), (2, 3, 1000, 256, 4)])
def test_multi_eval_kernel_takes_any_length_and_factors(emu, c, q, t, s, n2):
    """The kernel's contract: sum_t a[c][t] l1[q][t mod S] l2[q][t div S]
    for any factors (Q, 8, S) and (Q, 8, N2) with S N2 >= T (as the
    operands ``ladders_from`` makes of them), T not a power of two
    included, and S = 256 over several chunks with T ending inside one:
    random rows with p - 1 and the edge values everywhere, against the
    sums in host ints."""
    rng = np.random.default_rng(100 * c + t)
    a, l1, l2 = _rand(rng, (c, t)), _rand(rng, (q, s)), _rand(rng, (q, n2))
    a[:, ::3], l1[:, 1::3], l2[:, ::4] = f128.P - 1, f128.P - 1, f128.P - 1
    a[:, 1::7] = EDGES[3]
    l1[:, ::5] = EDGES[4]
    want = to_limbs([[sum(a[ci, i] * l1[qi, i % s] * l2[qi, i // s] for i in range(t)) % f128.P for ci in range(c)]
                     for qi in range(q)])
    for name, lib in emu.items():
        got = me.launch_multi_eval(lib, None, _t(a), me.ladders_from(_t(l1), _t(l2)))
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=name)


@pytest.mark.parametrize("c,q", [(1, 1), (2, 3)])
def test_multi_eval_kernel_holds_all_ones_digits_at_s_4096(emu, c, q):
    """The largest sums: S = 2^12 (4,096 products of two bytes a sum, past
    2^31 once 16 of them share a bucket, so the buckets take 64 bits),
    every coefficient and l1 element 2^112 - 1 (14 bytes 0xFF) or p - 1,
    l2 p - 1 or 2^112 - 1; T = 2 S, so two groups of one slice."""
    s, n2 = 1 << 12, 2
    t = s * n2
    top = EDGES[4]  # 2^112 - 1
    a = np.full((c, t), top, dtype=object)
    a[-1, ::2] = f128.P - 1
    l1 = np.full((q, s), top, dtype=object)
    l1[0, 1::2] = f128.P - 1
    l2 = np.full((q, n2), f128.P - 1, dtype=object)
    l2[-1, -1] = top
    want = to_limbs([[sum(l2[qi, hi] * sum(a[ci, hi * s + lo] * l1[qi, lo] for lo in range(s)) for hi in range(n2))
                      % f128.P for ci in range(c)] for qi in range(q)])
    for name, lib in emu.items():
        got = me.launch_multi_eval(lib, None, _t(a), me.ladders_from(_t(l1), _t(l2)))
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=name)


@pytest.mark.parametrize("q,t", [(1, 1), (2, 16), (3, 128), (32, 1024), (2, 1 << 14), (3, 1 << 16), (2, 1 << 15),
                                 (1, 1 << 13)])
def test_ladder_kernel_equals_ladders_split(emu, q, t):
    """The ladder entry (``launch_ladders``) equals ``ladders_split`` in the
    plain arithmetic taken to bytes (``ladders_plain``), byte for byte and
    limb for limb, with the points 0, 1 and p - 1 among random ones: a
    point's factor in one block and across several (T = 2^14-2^16: 2 to 4
    tiles of a factor at 64 outputs a block, 2 at 128), and tiles that the
    factor fills only in part (N2 = 64 of T = 2^13 at the shipped 128
    outputs a block)."""
    rng = np.random.default_rng(q + t)
    points = [int(v) for v in _rand(rng, (q,))]
    points[: min(q, 3)] = [0, f128.P - 1, 1][: min(q, 3)]
    bases = from_numpy(to_limbs(points))
    want = me.ladders_plain(bases, t)
    assert want.s == me.split(t)[0] and want.digits.shape[-1] % me.LADDER_ALIGN == 0
    for name, lib in emu.items():
        got = me.launch_ladders(lib, None, bases, t)
        assert got.s == want.s, name
        assert torch.equal(got.digits, want.digits), name
        assert torch.equal(got.cells, want.cells), name


@pytest.mark.parametrize("q,s,n2,ldb", [(3, 64, 100, 128), (2, 1, 1, 64), (1, 8, 70, 64), (2, 256, 129, 320),
                                         (1, 32, 65, 192)])
def test_ladder_kernel_takes_any_factors(emu, q, s, n2, ldb):
    """The ladder entry at factors no power-of-two T gives: N2 not a
    multiple of a block's outputs (its last tile partial) and byte rows
    longer than S (whole tiles of zeros past S), against the powers in host
    ints, at the points 0, p - 1 and 1 and random ones."""
    rng = np.random.default_rng(q * s + n2)
    points = [int(v) for v in _rand(rng, (q,))]
    points[: min(q, 3)] = [0, f128.P - 1, 1][: min(q, 3)]
    want_digits = np.zeros((q, 16, ldb), dtype=np.uint8)
    for qi, b in enumerate(points):
        for lo in range(s):
            want_digits[qi, :, lo] = list(pow(b, lo, f128.P).to_bytes(16, "little"))
    want_cells = to_limbs([[pow(b, s * hi, f128.P) for hi in range(n2)] for b in points])  # (Q, N2, 8)
    want_cells = (want_cells[..., 0::2] | want_cells[..., 1::2] << 16).view(np.int32)
    bases = from_numpy(to_limbs(points))
    for name, lib in emu.items():
        digits = torch.full((q * 16, ldb), 0xAB, dtype=torch.uint8)
        cells = torch.zeros((q, n2, 4), dtype=torch.int32)
        p = kernels.ptr
        assert lib.zk_meval_ladders(p(bases), p(digits), ldb, p(cells), q, s, n2, None) == 0, name
        np.testing.assert_array_equal(digits.numpy().reshape(q, 16, ldb), want_digits, err_msg=name)
        np.testing.assert_array_equal(cells.numpy(), want_cells, err_msg=name)


def _launches():
    """The ledger's (ladder, multi-eval) launches so far."""
    counts = kernel_health.launches()
    return counts["meval_ladders"], counts["multi_eval"]


def test_multi_eval_evaluates_tensors_at_one_point_set(emu):
    """One ``evaluate`` of two coefficient tensors (28 and 8 columns, the
    query rows' trace and composition columns) at one point set makes one
    ladder launch and equals two calls of one tensor each."""
    vals, points = _inputs(128)
    a, b = _t(vals), _t(vals[3:11][::-1].copy())
    bases = from_numpy(to_limbs(points))
    before = _launches()
    both = me.evaluate(emu["shipped"], None, [a, b], bases)
    assert tuple(x - y for x, y in zip(_launches(), before)) == (1, 2)
    for got, x in zip(both, (a, b)):
        assert torch.equal(got, me.evaluate(emu["shipped"], None, [x], bases)[0])
    rows_a, rows_b = me.multi_eval_rows_many([a, b], points)  # the plain version, on the CPU
    assert rows_a == me.multi_eval_rows_plain(a, points) and rows_b == me.multi_eval_rows_plain(b, points)
    assert [[int(v) for v in row] for row in from_limbs(to_numpy(both[1]))] == rows_b


def test_ood_ladders_in_one_launch(emu):
    """The OOD frame's shape: the trace columns at z and z g and the
    composition columns at z^8 from one ladder launch of the three points,
    each tensor reading its span's rows of the one ``Ladders``; the rows
    equal those of one point set a tensor (the two ladder launches before),
    and on the CPU ``multi_eval_rows_many`` with the spans equals the plain
    version at each span's points."""
    vals, points = _inputs(128)
    trace, comp = _t(vals), _t(vals[5:13].copy())
    pts = [points[0], f128.fmul(points[0], 7), pow(points[0], 8, f128.P)]
    bases = from_numpy(to_limbs(pts))
    spans = ((0, 2), (2, 3))
    for name, lib in emu.items():
        before = _launches()
        cur, at_zm = me.evaluate(lib, None, [trace, comp], bases, spans)
        assert tuple(x - y for x, y in zip(_launches(), before)) == (1, 2), name
        assert torch.equal(cur, me.evaluate(lib, None, [trace], bases[:2])[0]), name
        assert torch.equal(at_zm, me.evaluate(lib, None, [comp], bases[2:])[0]), name
    rows = me.multi_eval_rows_many([trace, comp], pts, spans=spans)  # the plain version, on the CPU
    assert rows == [me.multi_eval_rows_plain(trace, pts[:2]), me.multi_eval_rows_plain(comp, pts[2:])]
    for bad in (((0, 2),), ((0, 2), (2, 4)), ((1, 1), (0, 3))):
        with pytest.raises(ValueError, match="point spans"):
            me.multi_eval_rows_many([trace, comp], pts, spans=bad)


@pytest.mark.parametrize("c,q,t", [(28, 32, 1 << 20), (28, 2, 1 << 20), (8, 1, 1 << 16), (28, 32, 16),
                                   (1, 1, 1), (3, 3, 100)])
def test_multi_eval_slices_cover_t(emu, c, q, t):
    """The work buffer's slices: one a block's groups (8 hi in the shipped
    tile, 1 in the small one) of the ceil(T / S) groups that hold a t; the
    entry refuses a buffer of fewer slices, factors that do not cover T,
    an S that is not a power of two or above 2^15, and ladder rows that
    are not a multiple of 64 bytes or shorter than S, all before any
    launch."""
    s, n2 = me.split(t)
    for name, lib in emu.items():
        groups = 1 if name == "small" else 8
        k = lib.zk_multi_eval_slices(c, q, t, s)
        assert k == -(-(-(-t // s)) // groups), (name, k)
        ldb = -(-s // 64) * 64
        assert lib.zk_multi_eval(None, None, ldb, None, None, k - 1, None, c, q, t, s, n2, None) == -1
    lib = emu["shipped"]
    refused = [(16, 4, 3, 64), (16, 6, 4, 64), (1 << 17, 1 << 16, 2, 1 << 16), (16, 4, 4, 32), (128, 128, 1, 64)]
    for t, s, n2, ldb in refused:
        assert lib.zk_multi_eval(None, None, ldb, None, None, 1 << 20, None, 2, 2, t, s, n2, None) == -1, (t, s)
    assert lib.zk_meval_ladders(None, None, 32, None, 2, 16, 4, None) == -1
    assert lib.zk_meval_ladders(None, None, 64, None, 2, 12, 4, None) == -1
    assert lib.zk_multi_eval_slices(28, 32, 1 << 20, 1 << 10) == 128
    assert lib.zk_multi_eval_slices(0, 1, 16, 4) == 0
    assert lib.zk_multi_eval_smem(32) >= lib.zk_multi_eval_smem(2) > 0


@pytest.mark.parametrize("mode", ["tmode", "cls", "mono"])
def test_provers_through_the_emulated_multi_eval_kernel(emu, monkeypatch, mode):
    """Every multi-eval call of a T = 128 prove (the OOD frame's two and, in
    T-mode and cls, the query rows' two) through the kernel's emulation at
    the shipped launch shape, the card's (the small one is the grid's
    above; its thousands of 64-thread blocks a call, each ending in a
    barrier, made this test the suite's slowest on a loaded host): the
    proof equals the conformance vector's bytes, and the OOD frame's three
    points take one ladder launch."""
    calls = []

    def through_kernel(coeffs_ts, points, spans=None):
        calls.append((tuple(x.shape[0] for x in coeffs_ts), len(points), spans))
        for x in coeffs_ts:
            me._checked(x, points)
        outs = me.evaluate(emu["shipped"], None, coeffs_ts, from_numpy(to_limbs(list(points))), spans)
        return [[[int(v) for v in row] for row in from_limbs(to_numpy(out))] for out in outs]

    monkeypatch.setattr(me, "multi_eval_rows_many", through_kernel)
    before = kernel_health.plain_calls()["multi_eval"], _launches()[0]
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    _, _, proof = vm.prove(program, inputs, device="cpu", mode=mode)
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]
    # the OOD frame's one point set (z, z g for the trace, z^8 for the
    # composition), then the query rows' one for both tensors
    ood = ((28, 8), 3, ((0, 2), (2, 3)))
    if mode == "mono":
        assert calls == [ood], calls
    else:
        assert calls[0] == ood and calls[1][0] == (28, 8) and calls[1][1] > 3 and len(calls) == 2, calls
    assert (kernel_health.plain_calls()["multi_eval"], _launches()[0] - before[1]) == (before[0], len(calls))


class _FailingLib:
    """A kernel library whose multi-eval and ladder entries report a failed
    launch; it counts the entry calls."""

    def __init__(self):
        self.calls = 0

    def zk_multi_eval_slices(self, c, q, t, s):
        return 1

    def zk_multi_eval(self, *args):
        self.calls += 1
        return 700  # cudaErrorIllegalAddress

    zk_meval_ladders = zk_multi_eval


def test_multi_eval_refuses_and_never_falls_back(monkeypatch):
    """A launch of either kernel that fails raises; a device with no kernel
    raises before any launch; coefficients that are not contiguous int32
    (C, 8, T), or no points, raise on the CPU too (as the card would refuse
    them), and so do ladder operands that do not cover T, an S above
    2^15 and ladder rows that are not bytes of a multiple of 64.  None of
    these reaches the plain version or counts a launch."""
    coeffs = torch.zeros((2, 8, 16), dtype=torch.int32)
    lad = me.ladders_from(torch.zeros((3, 8, 4), dtype=torch.int32), torch.zeros((3, 8, 4), dtype=torch.int32))
    before = kernels.launched.copy()
    failing = _FailingLib()
    with pytest.raises(RuntimeError, match="zk_multi_eval: CUDA launch failed with error 700"):
        me.launch_multi_eval(failing, None, coeffs, lad)
    with pytest.raises(RuntimeError, match="zk_meval_ladders: CUDA launch failed with error 700"):
        me.launch_ladders(failing, None, torch.zeros((3, 8), dtype=torch.int32), 16)
    with pytest.raises(RuntimeError, match="zk_meval_ladders: CUDA launch failed with error 700"):
        me.evaluate(failing, None, [coeffs], torch.zeros((3, 8), dtype=torch.int32))
    assert failing.calls == 3
    monkeypatch.setattr(kernels, "lib", lambda: failing)
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
    with pytest.raises(ValueError, match="one length on one device"):
        me.multi_eval_rows_many([coeffs, torch.zeros((2, 8, 32), dtype=torch.int32).to("meta")], [1])
    with pytest.raises(ValueError, match="ladder factors of 4 x 2 lanes for T = 16"):
        me.launch_multi_eval(failing, None, coeffs, lad._replace(cells=lad.cells[:, :2].contiguous()))
    with pytest.raises(ValueError, match="ladder factors of 3 x 4 lanes"):
        me.launch_multi_eval(failing, None, coeffs, lad._replace(s=3))
    with pytest.raises(ValueError, match="digits: shape"):
        me.launch_multi_eval(failing, None, coeffs, lad._replace(digits=lad.digits[:32].contiguous()))
    with pytest.raises(TypeError, match="digits: expected torch.uint8"):
        me.launch_multi_eval(failing, None, coeffs, lad._replace(digits=lad.digits.int()))
    with pytest.raises(ValueError, match="ladder rows of 48 bytes"):
        me.launch_multi_eval(failing, None, coeffs, lad._replace(digits=lad.digits[:, :48].contiguous()))
    wide = torch.zeros((16, 1 << 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="above 32768 the s32 sums"):
        me.launch_multi_eval(failing, None, torch.zeros((1, 8, 1 << 17), dtype=torch.int32),
                             me.Ladders(wide, torch.zeros((1, 2, 4), dtype=torch.int32), 1 << 16))
    with pytest.raises(ValueError, match="above 32768 the s32 sums"):
        me.split(1 << 31)
    assert me.split(1 << 30) == (1 << 15, 1 << 15)
    with pytest.raises(ValueError, match="power of two"):
        me.multi_eval_rows(torch.zeros((2, 8, 12), dtype=torch.int32), [1])
    assert failing.calls == 3
    assert kernels.launched == before
