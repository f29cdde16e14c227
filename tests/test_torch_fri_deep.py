"""The FRI fold, ladder and DEEP kernels (``csrc/fri_fold.cu``,
``csrc/deep.cu``) run on the CPU through their host emulation
(``csrc/host_emu.h``), limb for limb against their plain versions and,
for the fold, the JAX ``zkvm.prover.fri._fold_core_t`` at the ladder of
``zkvm.ntt.ntt_t.ladder_t_host``.

Each source is built twice: at its shipped launch shape and at a small
one (``SMALL``: 4 threads a block and 2 lanes a thread, the fold at one
lane a thread up to n = 2^10 only, the host-constant ladder at 3 lanes a
thread from n = 128 on), so that small inputs cross blocks, partial
blocks, the ladders' step between a thread's lanes and both instances of
the fold and of the host-constant ladder.  The plain versions launch nothing (the dispatching field
ops and K1 patched to raise); the T = 128 conformance proves in the three
modes, and FRI over two layers, run with every call of the four entries
through the emulation; a failing launch raises and nothing falls back.
On the card, ``chip_smoke.py`` phase (c) holds the nvcc build against the
plain versions at the provers' shapes.
"""

import concurrent.futures as cf
import ctypes
import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm.ntt import ntt_t as jnt
from zkvm.prover import fri as jfri
from zkvm_torch import kernels, vm
from zkvm_torch.field import f128t as ft
from zkvm_torch.field.limbs import from_numpy, tensor, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.prover import deep as dp
from zkvm_torch.prover import fri
from zkvm_torch.prover.options import ProofOptions
from zkvm_torch.utils import kernel_health
from zkvm_torch.prover.transcript import RandomCoin

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parent.parent / "conformance" / "vectors_e2e.json"
SMALL = ("ZK_FOLD_THREADS=4", "ZK_FOLD_LANES=2", "ZK_FOLD_ONE_LANE_MAX=1024", "ZK_LADDER_LANES=3",
         "ZK_LADDER_ONE_LANE_MAX=64", "ZK_DEEP_THREADS=4")
ENTRIES = ("zk_fri_fold", "zk_ladder", "zk_ladder_const", "zk_weighted_sum", "zk_deep_quotient")
EDGES = (0, 1, f128.P - 1, 2**64 - 1, 2**112 - 1, 45 * 2**40 - 1, 2**127)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """{"shipped": lib, "small": lib}: both sources' host emulation at the
    shipped launch shapes and at SMALL, built at once."""
    from test_torch_csrc_emu import _build_emu

    out = tmp_path_factory.mktemp("fri_deep")
    sources = ["fri_fold.cu", "deep.cu"]
    builds = {name: defines for name, defines in (("shipped", ()), ("small", SMALL))}
    libs = {}
    with cf.ThreadPoolExecutor(len(builds)) as pool:
        paths = {name: pool.submit(_build_emu, out, sources, d) for name, d in builds.items()}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path.result()))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = list(kernels.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _rand(rng, shape):
    """Random canonical elements (object ints) of ``shape``, the edge values
    at every 5th place."""
    hi, lo = rng.integers(0, 2**63, size=(2,) + tuple(shape), dtype=np.int64)
    vals = (hi.astype(object) << 65 | lo.astype(object) << 1 | (lo.astype(object) & 1)) % f128.P
    flat = vals.reshape(-1)
    flat[::5] = [EDGES[i % len(EDGES)] for i in range(len(flat[::5]))]
    return vals


def _t(vals):
    """(..., n) ints -> (..., 8, n) int32 limb tensor."""
    return from_numpy(np.ascontiguousarray(np.swapaxes(to_limbs(vals), -1, -2)))


FOLD_LANES = (1, 8, 1024, 2048)


def _fold_inputs(n):
    """Groups (FOLD, 8, n) and a random (scale = beta / offset, base =
    w_D^(-1)) from a seed."""
    rng = np.random.default_rng(n)
    v = _t(_rand(rng, (fri.FOLD, n)))
    beta, offset = (int(x) for x in _rand(rng, (2,)))
    return v, f128.fmul(beta, f128.finv(offset)), f128.finv(f128.get_root_of_unity(8 * n))


@pytest.fixture(scope="module")
def jax_folds():
    """{n: the JAX ``_fold_core_t`` of ``_fold_inputs(n)``} for every n of
    FOLD_LANES, from one call over their lanes side by side (the fold is
    lane by lane), q_t from JAX's ``ladder_t_host`` in pieces of 8 lanes
    (scale base^(8 i) times base^j): one compile of each, not three."""
    vs, qs = [], []
    for n in FOLD_LANES:
        v, scale, base = _fold_inputs(n)
        vs.append(to_numpy(v))
        qs += [jnt.ladder_t_host(base, 8, f128.fmul(scale, pow(base, i, f128.P)))[:, :min(8, n - i)]
               for i in range(0, n, 8)]
    out = np.asarray(jfri._fold_core_t(jnp.asarray(np.concatenate(vs, axis=-1)), jnp.concatenate(qs, axis=-1)))
    return dict(zip(FOLD_LANES, np.split(out, np.cumsum(FOLD_LANES)[:-1], axis=-1)))


@pytest.mark.parametrize("n", FOLD_LANES)
def test_fri_fold_kernel_emulated(emu, jax_folds, n):
    """The fold entry in both builds equals its plain version and the JAX
    ``_fold_core_t`` at q_t = scale w_D^(-j) (JAX's ``ladder_t_host``),
    for a random beta and offset: in the shipped build every n at one lane
    a thread, in the small one n <= 2^10 at one lane and 2^11, across its
    threshold, at two."""
    v, scale, base = _fold_inputs(n)
    want = jax_folds[n]
    np.testing.assert_array_equal(to_numpy(fri.fold_plain(v, scale, base)), want)
    for name, lib in emu.items():
        np.testing.assert_array_equal(to_numpy(fri.launch_fold(lib, None, v, scale, base)), want, err_msg=name)


def test_fold_power_table():
    """The fold's ladder tables, built on the host once a base, are
    base^(2^e) mod p for every e < 48 and base^i mod p for every i < 32,
    and the kernel's scalars carry them after scale, 1/8 and r, r^2, r^3,
    four words an element."""
    rng = np.random.default_rng(50)
    for base in [int(x) for x in _rand(rng, (3,))] + [f128.finv(f128.get_root_of_unity(1 << 19))]:
        squares, powers = nt.power_table(base)
        assert len(squares) == nt.LADDER_LEVELS == 48 and len(powers) == nt.WARP_POWERS == 32
        assert list(squares) == [pow(base, 2**e, f128.P) for e in range(48)]
        assert list(powers) == [pow(base, i, f128.P) for i in range(32)]
        words = list(fri.fold_scalars(7, base))
        assert len(words) == 4 * (5 + 48 + 32)
        assert words[:4] == list(kernels.words([7]))
        assert words[20:4 * 53] == list(kernels.words(squares))
        assert words[4 * 53:] == list(kernels.words(powers))


def test_fold_launch_builds_no_tensor_from_host_data(emu, monkeypatch):
    """The fold's launch function builds no tensor from host data (on a
    card each such copy waits for the stream): its scalars and table go
    by value."""
    built = []
    for name in ("tensor", "from_numpy", "as_tensor"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _n=name, _f=fn, **k: built.append(_n) or _f(*a, **k))
    v = torch.zeros((fri.FOLD, 8, 64), dtype=torch.int32)
    for lib in emu.values():
        fri.launch_fold(lib, None, v, 3, 5)
    assert built == [], f"the fold's launch built {built}"


def test_ladder_const_launch_builds_no_tensor_from_host_data(emu, monkeypatch):
    """The host-constant ladder's launch (``ladder_t_host`` on a card)
    builds no tensor from host data, so nothing is copied to the card, and
    a second call of a (base, scale) reuses the cached table: its table is
    ``ladder_table``, the scale and ``power_table`` of the base, four
    words an element."""
    base, scale = 0xC0FFEE, f128.P - 1
    table = nt.ladder_table(base, scale)
    squares, powers = nt.power_table(base)
    assert list(table) == list(kernels.words([scale, *squares, *powers]))
    built = []
    for name in ("tensor", "from_numpy", "as_tensor"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _n=name, _f=fn, **k: built.append(_n) or _f(*a, **k))
    x = torch.zeros((2, 8, 64), dtype=torch.int32)
    hits = nt.ladder_table.cache_info().hits
    for lib in emu.values():
        nt.launch_ladder_const(lib, None, base, scale, 64, device="cpu")
        nt.launch_ladder_const(lib, None, base, scale, 64, x=x)
    assert built == [], f"the ladder's launch built {built}"
    assert nt.ladder_table.cache_info().hits - hits == 4 and nt.ladder_table(base, scale) is table


def test_ladder_kernel_emulated(emu):
    """The ladder entry in both builds equals the doubling (``ladder_plain``)
    for n = 1 .. 2^12, with and without x, and over rows: (B, 8) bases
    given transposed (limb stride B), a broadcast scale and x of B rows."""
    rng = np.random.default_rng(3)
    for k in range(13):
        n = 1 << k
        base, scale = _t(_rand(rng, (1, 2)))[0].transpose(0, 1)  # (8,) each
        x = _t(_rand(rng, (3, n)))
        for xs in (None, x[1], x):
            want = nt.ladder_plain(base, scale, n, xs)
            for name, lib in emu.items():
                got = nt.launch_ladder(lib, None, base, scale, n, xs)
                np.testing.assert_array_equal(to_numpy(got), to_numpy(want), err_msg=f"{name} n={n}")
    bases = _t(_rand(rng, (3, 3)))[:, :, 0]  # (3, 8) rows, limbs 3 apart
    for n, xs in ((16, None), (64, _t(_rand(rng, (3, 64)))), (1, None)):
        want = nt.ladder_plain(bases, scale, n, xs)
        assert want.shape == (3, 8, n)
        for name, lib in emu.items():
            got = nt.launch_ladder(lib, None, bases, scale, n, xs)
            np.testing.assert_array_equal(to_numpy(got), to_numpy(want), err_msg=f"{name} rows n={n}")


@pytest.mark.parametrize("base", [0, 1, f128.P - 1, 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321])
@pytest.mark.parametrize("n", [1, 2, 32, 64, 1 << 10, 1 << 12])
def test_ladder_const_kernel_emulated(emu, n, base):
    """The host-constant ladder entry (``launch_ladder_const``) in both
    builds equals ``ladder_plain`` on the same base and scale as limbs,
    without x, with one row of x and with 3 rows (the sharded coset LDE's
    columns), at bases 0, 1, p - 1 and a random one."""
    rng = np.random.default_rng(n + base % 1000)
    scale = int(_rand(rng, (1,))[0])
    ops = tensor([base, scale])  # (2, 8)
    x = _t(_rand(rng, (3, n)))
    for xs in (None, x[1], x):
        want = nt.ladder_plain(ops[0], ops[1], n, xs)
        for name, lib in emu.items():
            got = nt.launch_ladder_const(lib, None, base, scale, n, xs, device="cpu")
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(to_numpy(got), to_numpy(want), err_msg=f"{name} n={n}")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_weighted_sum_kernel_emulated(emu, k):
    """The weighted-sum entry in both builds equals the plain sums, a set at
    a time, on strided columns (a column and lane block of a larger
    tensor, as mono's row blocks read the LDE) and on contiguous ones,
    into a view of a larger output."""
    rng = np.random.default_rng(10 + k)
    big = _t(_rand(rng, (12, 96)))
    cols = big[2:11, :, 5:5 + 67]  # (9, 8, 67): column stride 8 * 96, limb stride 96
    weights = [[int(v) for v in row] for row in _rand(rng, (k, 9))]
    want = torch.stack([dp.weighted_sum_plain(cols, tensor(w)) for w in weights])
    for name, lib in emu.items():
        got = dp.launch_weighted_sum(lib, None, cols, weights)
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want), err_msg=name)
        out = torch.zeros((k + 1, 8, 67), dtype=torch.int32)
        dp.launch_weighted_sum(lib, None, cols.contiguous(), weights, out=out[1:])
        np.testing.assert_array_equal(to_numpy(out[1:]), to_numpy(want), err_msg=name)
        assert not out[0].any()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_deep_quotient_kernel_emulated(emu, k):
    """The quotient entry in both builds equals the plain chain on strided
    values and inverses (a lane block of (K, 8, N) tensors, as mono reads
    its inverses) and at the edge values."""
    rng = np.random.default_rng(20 + k)
    vals = _t(_rand(rng, (k, 80)))[..., 7:7 + 50]
    inv = _t(_rand(rng, (k + 1, 64)))[1:, :, :50]
    at = [int(v) for v in _rand(rng, (k,))]
    want = dp.deep_quotient_plain(vals, tensor(at), inv)
    for name, lib in emu.items():
        got = dp.launch_deep_quotient(lib, None, vals, at, inv)
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want), err_msg=name)


def test_plain_versions_launch_nothing(monkeypatch, emu):
    """The yardsticks launch no kernel: with the dispatching field ops and
    K1 patched to raise, ``fold_plain``, ``ladder_plain`` (one row and
    rows), ``weighted_sum_plain`` and ``deep_quotient_plain`` still equal
    the emulated kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version called a dispatching op")

    for name in ("fadd", "fsub", "fmul", "fsquare", "fsum", "_dispatch"):
        monkeypatch.setattr(ft, name, refuse)
    monkeypatch.setattr(nt, "pease_stages", refuse)
    lib = emu["small"]
    rng = np.random.default_rng(30)
    v = _t(_rand(rng, (fri.FOLD, 32)))
    np.testing.assert_array_equal(to_numpy(fri.fold_plain(v, 5, 7)), to_numpy(fri.launch_fold(lib, None, v, 5, 7)))
    base, scale = _t(_rand(rng, (2, 1)))[:, :, 0]
    for b in (base, torch.stack([base, scale])):
        np.testing.assert_array_equal(to_numpy(nt.ladder_plain(b, scale, 512)),
                                      to_numpy(nt.launch_ladder(lib, None, b, scale, 512)))
    cols, w = _t(_rand(rng, (6, 40))), [int(x) for x in _rand(rng, (6,))]
    np.testing.assert_array_equal(to_numpy(dp.weighted_sum_plain(cols, tensor(w))),
                                  to_numpy(dp.launch_weighted_sum(lib, None, cols, [w])[0]))
    vals, inv = _t(_rand(rng, (3, 40))), _t(_rand(rng, (3, 40)))
    np.testing.assert_array_equal(to_numpy(dp.deep_quotient_plain(vals, tensor([1, 2, 3]), inv)),
                                  to_numpy(dp.launch_deep_quotient(lib, None, vals, [1, 2, 3], inv)))


def _fri_deep_launches():
    """The ledger's launches of the fold, the two ladders, the sums and the
    quotients, in that order."""
    counts = kernel_health.launches()
    return tuple(counts[f] for f in ("fri_fold", "ladder", "ladder_const", "weighted_sum", "deep_quotient"))


@pytest.fixture
def through_emu(emu, monkeypatch):
    """Route every call of the four entries' dispatchers through the small
    build's emulation; returns the launches the ledger counts for the five
    families so far."""
    lib = emu["small"]

    def ladder(base, scale, n, x=None):
        return nt.launch_ladder(lib, None, base, scale, n, x)

    def ladder_host(base, n, scale=1, device="cpu", x=None):
        return nt.launch_ladder_const(lib, None, base, scale, n, x, torch.device(device))

    monkeypatch.setattr(nt, "ladder_t", ladder)
    monkeypatch.setattr(nt, "ladder_t_host", ladder_host)
    monkeypatch.setattr(fri, "fold_t", lambda v, scale, base: fri.launch_fold(lib, None, v.contiguous(), scale,
                                                                               base))
    monkeypatch.setattr(dp, "weighted_sum", lambda c, w, out=None: dp.launch_weighted_sum(lib, None, c, w, out))
    monkeypatch.setattr(dp, "deep_quotient", lambda v, at, inv: dp.launch_deep_quotient(lib, None, v, at, inv))
    return _fri_deep_launches


@pytest.mark.parametrize("mode", ["tmode", "mono", "cls"])
def test_provers_through_the_emulated_fri_deep_kernels(through_emu, mode):
    """Every ladder, DEEP sum and quotient of a T = 128 prove through the
    emulated kernels (T = 128 folds no FRI layer: D = 1024 is the
    remainder): the proof equals the conformance vector's bytes."""
    before = through_emu()
    vec = json.loads(VECTORS.read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    _, _, proof = vm.prove(program, inputs, device="cpu", mode=mode)
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]
    fold, ladder, ladder_const, sums, quotients = (a - b for a, b in zip(through_emu(), before))
    # the DEEP: two sums and a quotient a class (T-mode, cls) or a row block
    # (mono, one block at T = 128); the remainder's scale a host-constant
    # ladder (and the constants' ladders, where not cached yet)
    assert (fold, sums, quotients) == (0, 2, 1 if mode == "mono" else 8)
    assert ladder_const >= 1


def test_fri_through_the_emulated_kernels(through_emu):
    """FRI over two layers (D = 2^14: folds of n = 2^11 and 2^8, then the
    remainder of 256) through the emulated fold and ladder equals FRI in
    the plain versions: the same roots, betas, groups and remainder."""
    rng = np.random.default_rng(40)
    evals = nt.coset_lde_t(_t(_rand(rng, (1 << 11,))), 8)  # degree < D / 8 on the coset
    options = ProofOptions()

    def run():
        coin = RandomCoin([3, 1, 4])
        res = fri.fri_prove_t(coin, evals, f128.DOMAIN_OFFSET, options)
        return [t.root for t in res.trees], res.betas, [to_numpy(g) for g in res.groups], res.remainder

    before = through_emu()
    got = run()
    fold, _, ladder_const = [a - b for a, b in zip(through_emu(), before)][:3]
    assert fold == 2 and ladder_const >= 1  # and the remainder iNTT's twiddles where not cached yet

    def ladder_host_plain(base, n, scale=1, device="cpu", x=None):
        ops = nt.host_limbs([base, scale], device if x is None else x.device)
        return nt.ladder_plain(ops[0], ops[1], n, x)

    torch_fold, torch_ladder, torch_ladder_host = fri.fold_t, nt.ladder_t, nt.ladder_t_host
    try:
        fri.fold_t, nt.ladder_t, nt.ladder_t_host = fri.fold_plain, nt.ladder_plain, ladder_host_plain
        want = run()
    finally:
        fri.fold_t, nt.ladder_t, nt.ladder_t_host = torch_fold, torch_ladder, torch_ladder_host
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


class _FailingLib:
    """A kernel library whose five entries report a failed launch."""

    def __init__(self):
        self.calls = 0

    def _fail(self, *args):
        self.calls += 1
        return 700  # cudaErrorIllegalAddress

    zk_fri_fold = zk_ladder = zk_ladder_const = zk_weighted_sum = zk_deep_quotient = _fail


def test_fri_deep_kernels_refuse_and_never_fall_back(monkeypatch, emu):
    """A failing launch of any of the five entries raises, through the
    wrapper the prover calls, and reaches no plain version; the entries
    refuse what they cannot take (-1, no launch), and the wrappers refuse
    bad operands on the CPU too and a device with no kernel."""
    failing = _FailingLib()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran after a failed launch")

    for mod, name in ((fri, "fold_plain"), (nt, "ladder_plain"), (dp, "weighted_sum_plain"),
                      (dp, "deep_quotient_plain")):
        monkeypatch.setattr(mod, name, refuse)
    v = torch.zeros((fri.FOLD, 8, 16), dtype=torch.int32)
    one = torch.zeros(8, dtype=torch.int32)
    cols = torch.zeros((3, 8, 16), dtype=torch.int32)
    calls = [("zk_fri_fold", lambda: fri.launch_fold(failing, None, v, 1, 2)),
             ("zk_ladder", lambda: nt.launch_ladder(failing, None, one, one, 16)),
             ("zk_ladder_const", lambda: nt.launch_ladder_const(failing, None, 3, 5, 16, device="cpu")),
             ("zk_weighted_sum", lambda: dp.launch_weighted_sum(failing, None, cols, [[1, 2, 3]])),
             ("zk_deep_quotient", lambda: dp.launch_deep_quotient(failing, None, cols, [1, 2, 3], cols))]
    before = _fri_deep_launches()
    for entry, call in calls:
        with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed with error 700"):
            call()
    assert failing.calls == 5
    assert _fri_deep_launches() == before
    meta = torch.zeros((fri.FOLD, 8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fri.fold_t(meta, 1, 2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nt.ladder_t(one.to("meta"), one.to("meta"), 16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nt.ladder_t_host(3, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dp.weighted_sum(cols.to("meta"), [[1, 2, 3]])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dp.deep_quotient(cols.to("meta"), [1, 2, 3], cols.to("meta"))
    with pytest.raises(ValueError, match="expected \\(8, 8, n\\)"):
        fri.fold_t(v[:4], 1, 2)
    with pytest.raises(ValueError, match="power of two"):
        nt.ladder_t(one, one, 12)
    with pytest.raises(ValueError, match="power of two"):
        nt.ladder_t_host(3, 12)
    with pytest.raises(ValueError, match="expected int32 \\(..., 8, 16\\)"):
        nt.ladder_t_host(3, 16, x=cols.long())
    with pytest.raises(ValueError, match="do not broadcast"):
        nt.ladder_t(torch.zeros((2, 8), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="weights for 3 columns"):
        dp.weighted_sum(cols, [[1, 2]])
    with pytest.raises(ValueError, match="weights for 3 columns"):
        dp.weighted_sum(cols, [[1, 2, 3]] * 5)
    with pytest.raises(ValueError, match="and 3 points"):
        dp.deep_quotient(cols, [1, 2, 3], cols[:2])
    with pytest.raises(TypeError, match="int32"):
        dp.weighted_sum(cols.long(), [[1, 2, 3]])
    lib = emu["shipped"]
    p = None
    assert lib.zk_fri_fold(p, p, 0, kernels.words([0] * 85), p) == -1
    assert lib.zk_ladder(p, 0, 0, p, 0, 1, p, 0, 1, p, 0, 16, p) == -1
    assert lib.zk_ladder(p, 0, 0, p, 0, 1, p, 0, 1, p, 65536, 16, p) == -1
    table = nt.ladder_table(3, 5)
    assert lib.zk_ladder_const(p, 0, 0, table, p, 0, 16, p) == -1
    assert lib.zk_ladder_const(p, 0, 0, table, p, 65536, 16, p) == -1
    assert lib.zk_ladder_const(p, 0, 0, table, p, 1, 0, p) == -1
    assert lib.zk_weighted_sum(p, 0, 1, kernels.words([0] * 5), p, 5, 1, 16, p) == -1
    assert lib.zk_weighted_sum(p, 0, 1, kernels.words([0] * 129), p, 1, 129, 16, p) == -1
    assert lib.zk_deep_quotient(p, 0, 1, p, 0, 1, kernels.words([0]), p, 0, 16, p) == -1
    assert lib.zk_deep_quotient(p, 0, 1, p, 0, 1, kernels.words([0]), p, 1, 0, p) == -1
