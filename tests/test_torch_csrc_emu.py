"""The CUDA kernels' sources, run on the CPU through a host emulation.

``zkvm_torch/csrc`` compiles as plain C++ against ``csrc/host_emu.h``, which
runs each CUDA thread of a block as a host thread (a std::barrier stands in
for __syncthreads()).  That checks the kernels' index, carry and
shared-memory logic without a card: each emulated kernel must equal its
plain PyTorch version exactly.  The kernels themselves, as nvcc builds them
for sm_90a, are checked on the card by chip_smoke.py.
"""

import collections
import ctypes
import json
import random
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm_torch import kernels, vm
from zkvm_torch.field import f128t as tft
from zkvm_torch.field import limbs as lm
from zkvm_torch.field.limbs import from_numpy, from_t, tlimbs, to_limbs, to_numpy
from zkvm.hash import blake3_jax as b3j
from zkvm.hash import blake3_t as jb3t
from zkvm_torch.hash import blake3_t as tb3t
from zkvm_torch.hash import merkle as tmerkle
from zkvm_torch.ntt import ntt_t as tnt
from zkvm_torch.prover import pipeline as tpl
from zkvm_torch.utils import kernel_health

torch.set_num_threads(1)


def _build_emu(out_dir, sources, defines=()):
    """The host emulation of ``sources`` (with ``-D`` defines) as one
    shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA sources")
    tag = "_".join(d.split("=")[-1] for d in defines) or "default"
    so = out_dir / f"libzkvm_emu_{tag}.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-x", "c++", "-o", str(so)]
    cmd += [f"-D{d}" for d in defines] + [str(kernels.CSRC / s) for s in sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return so


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return kernels.bind(_build_emu(tmp_path_factory.mktemp("emu"), kernels.SOURCES))


@pytest.fixture(scope="module")
def emu_shape(tmp_path_factory):
    """One source's host emulation at other launch shapes (its -D defines),
    built once a shape, with every entry point of the source declared
    (``entry`` must be one)."""
    out, built = tmp_path_factory.mktemp("emu_shapes"), {}

    def get(source, entry, defines):
        if (source, defines) not in built:
            lib = ctypes.CDLL(str(_build_emu(out, [source], defines)))
            for name, args in kernels.SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = list(args)
                    fn.restype = ctypes.c_int
            getattr(lib, entry)
            built[(source, defines)] = lib
        return built[(source, defines)]

    return get


def rand_limbs(rng, shape):
    """(..., 8, L) limbs of random canonical elements (edges mixed in)."""
    n = int(np.prod(shape)) // 8
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
    edges = [0, 1, f128.P - 1, 45 * 2**40 - 1, 2**127]
    vals[: len(edges)] = edges[:n]
    return np.swapaxes(to_limbs(vals).reshape(shape[:-2] + (shape[-1], 8)), -1, -2)


@pytest.mark.parametrize(
    "m,nl,variant,inverse",
    [
        (8, 64, "plain", False), (4, 8, "full", True), (16, 2, "r1", True),
        (512, 4, "full", False), (2, 2, "r1", False), (2, 4, "full", True),
        (512, 1, "plain", True), (512, 1, "r1", False), (32, 128, "full", False),
    ],
)
def test_ntt_stages_emulated(emu, m, nl, variant, inverse):
    """K1 in natural row order, as the card runs it, against its plain
    version.  NL = 1 and 2 run lane tiles of one and two (the one- and
    two-lane accesses), M = 2 with NL = 2 a thread with idle butterflies,
    M = 32 with NL = 128 two blocks along the lanes."""
    rng = np.random.default_rng(m + nl)
    y = from_numpy(rand_limbs(rng, (2, m, 8, nl)))
    tw = tnt._stage_twiddles_dev(m, inverse, torch.device("cpu"))
    pre = tnt.pack_t(from_numpy(rand_limbs(rng, (m, 8, nl)))) if variant == "full" else None
    r1 = (from_numpy(rand_limbs(rng, (8, m))), from_numpy(rand_limbs(rng, (8, nl)))) if variant == "r1" else None
    got = tnt.launch_stages(emu, 0, y, tw, pre=pre, r1=r1)
    want = tnt.pease_stages(y, tw, pre=pre, r1=r1)  # CPU tensors: the plain version
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


def _laid_out(vals, order, offset=0):
    """A view equal to ``vals`` (B1, B2, M, 8, NL) whose buffer holds its
    axes in ``order`` (the last unit-stride), starting ``offset`` elements
    into the buffer (an offset of 1 or 2 takes the kernel's 4- and 8-byte
    accesses)."""
    buf = torch.zeros(offset + vals.numel(), dtype=torch.int32)[offset:]
    view = buf.view([vals.shape[i] for i in order]).permute(*np.argsort(order).tolist())
    return view.copy_(vals)


_ROWS_LAST, _LANES_LAST = (0, 3, 4, 1, 2), (1, 3, 2, 0, 4)  # memory orders: rows or lanes unit-stride
# (M, B1, B2, NL, load, store, premultiplier, offset): every S from 1 to 9;
# rows and lanes unit-stride on each side; two batch axes; the full
# premultiplier by (row, lane) and by (row, batch), the rank-1 one; aligned
# and unaligned pointers; fewer lanes than a quarter-warp
_STRIDED = [
    (2, 3, 1, 8, "rows", "lanes", "plain", 0), (4, 1, 3, 16, "lanes", "rows", "row_lane", 0),
    (8, 2, 2, 4, "rows", "rows", "r1", 0), (16, 2, 3, 8, "lanes", "lanes", "row_batch", 1),
    (32, 1, 2, 64, "rows", "lanes", "row_batch", 0), (64, 2, 1, 32, "rows", "rows", "row_lane", 2),
    (128, 1, 1, 16, "lanes", "rows", "r1", 0), (256, 1, 2, 8, "rows", "lanes", "row_lane", 0),
    (512, 1, 1, 8, "rows", "lanes", "row_lane", 0), (512, 2, 1, 1, "rows", "rows", "plain", 0),
    (4, 1, 1, 2, "rows", "lanes", "plain", 1), (32, 2, 3, 2, "lanes", "rows", "row_batch", 0),
    (8, 3, 2, 16, "rows", "rows", "row_batch", 2), (64, 1, 2, 16, "lanes", "rows", "plain", 1),
]


@pytest.mark.parametrize("m,b1,b2,nl,load,store,pre_by,offset", _STRIDED)
def test_ntt_stages_strided_emulated(emu, monkeypatch, m, b1, b2, nl, load, store, pre_by, offset):
    """K1 reading and writing strided views, each side walking its
    unit-stride axis, equals its plain version on the same views exactly,
    counts the walks in the ledger and copies nothing."""
    ledger = collections.Counter()
    monkeypatch.setattr(kernels, "launched", ledger)
    rng = np.random.default_rng(m * 7 + nl + b2)
    order = {"rows": _ROWS_LAST, "lanes": _LANES_LAST}
    vals = from_numpy(rand_limbs(rng, (b1, b2, m, 8, nl)))
    y = _laid_out(vals, order[load], offset)
    tw = tnt._stage_twiddles_dev(m, m % 3 == 1, torch.device("cpu"))
    pre = r1 = None
    if pre_by == "row_lane":
        pre = tnt.pack_t(from_numpy(rand_limbs(rng, (m, 8, nl))))  # (M, NL, 4)
    elif pre_by == "row_batch":
        pre = tnt.pack_t(from_numpy(rand_limbs(rng, (b2, 8, m))))[None, :, :, None]  # (1, B2, M, 1, 4)
    elif pre_by == "r1":
        r1 = (from_numpy(rand_limbs(rng, (8, m))), from_numpy(rand_limbs(rng, (8, nl))))
    out = _laid_out(torch.zeros_like(vals), order[store], offset)
    got = tnt.launch_stages(emu, 0, y, tw, pre=pre, r1=r1, out=out)
    assert got is out
    want = tnt.stages_plain(vals, tw, pre, r1)
    np.testing.assert_array_equal(to_numpy(out), to_numpy(want))
    variant = {"plain": "plain", "r1": "r1"}.get(pre_by, "full")
    walk = lambda side: "lanes" if nl == 1 and side == "lanes" else side
    assert ledger == {("ntt_stages", (("M", m), ("B", b1 * b2), ("NL", nl), ("variant", variant),
                                      ("load", walk(load)), ("store", walk(store)))): 1}


@pytest.mark.parametrize("side", ["y", "out", "pre"])
def test_ntt_stages_refuses_a_block_past_32_bit_offsets(emu, side):
    """K1's offsets inside a tile are 32-bit: the entry refuses a batch's
    block of y, out or pre that spans 2^31 elements, before any launch,
    and takes the same block one row shorter."""
    m, nl = 4, 8
    y, out = torch.zeros((m, 8, nl), dtype=torch.int32), torch.zeros((m, 8, nl), dtype=torch.int32)
    tw = tnt._stage_twiddles_dev(m, False, torch.device("cpu"))
    pre = tnt.pack_t(torch.zeros((m, 8, nl), dtype=torch.int32))
    longs = lambda v: (ctypes.c_long * len(v))(*v)

    def call(row):  # the row stride of one side; the launch reads nothing past (M, 8, NL) otherwise
        ys, os_, ps = [0, 0, 8 * nl, nl, 1], [0, 0, 8 * nl, nl, 1], [0, 0, nl, 1]
        {"y": ys, "out": os_, "pre": ps}[side][2] = row
        return emu.zk_ntt_stages(kernels.ptr(y), longs(ys), kernels.ptr(out), longs(os_), kernels.ptr(tw),
                                 kernels.ptr(pre), longs(ps), None, None, 1, 1, m, nl, 2, 1, 0, None)

    limit = 1 << 31
    assert call(-(-limit // (m - 1))) == -1  # (M - 1) rows reach 2^31
    assert call(8 * nl if side != "pre" else nl) == 0


@pytest.mark.parametrize("operand", ["y", "out", "pre", "x", "x_out", "r1"])
def test_ntt_stages_refuses_what_it_cannot_walk(emu, monkeypatch, operand):
    """An operand K1 cannot take as it is raises and launches nothing: y or
    out with neither unit-stride rows nor lanes, a premultiplier whose
    cells are not unit-stride, a transform's input or output with no (B, 8,
    N) view of unit-stride lanes, and a coset scale shaped for another
    split than the first launch's."""
    ledger = collections.Counter()
    monkeypatch.setattr(kernels, "launched", ledger)
    monkeypatch.setattr(tnt, "pease_stages", lambda y, tw, pre=None, r1=None, out=None:
                        tnt.launch_stages(emu, 0, y, tw, pre, r1, out))
    rng = np.random.default_rng(3)
    vals = from_numpy(rand_limbs(rng, (2, 1, 8, 8, 4)))
    neither = (2, 4, 0, 1, 3)  # limbs unit-stride
    tw = tnt._stage_twiddles_dev(8, False, torch.device("cpu"))
    x = from_numpy(rand_limbs(rng, (3, 8, 64)))
    scale = tnt.premultiplier(7, 64, "cpu")  # for the first launch at the shipped MAX_AXIS: 8 x 8
    cells = torch.zeros(8, 4, 4, dtype=torch.int32).transpose(-1, -2)
    calls = {
        "y": lambda: tnt.launch_stages(emu, 0, _laid_out(vals, neither), tw),
        "out": lambda: tnt.launch_stages(emu, 0, vals, tw, out=_laid_out(torch.zeros_like(vals), neither)),
        "pre": lambda: tnt.launch_stages(emu, 0, vals, tw, pre=cells),
        "x": lambda: tnt.ntt_t(x.transpose(0, 1)),
        "x_out": lambda: tnt.class_ntt_t(x, 7, out=torch.zeros(3, 64, 8, dtype=torch.int32).transpose(-1, -2)),
        "r1": lambda: tnt.class_ntt_t(x, 7, scale),
    }
    if operand == "r1":
        monkeypatch.setattr(tnt, "MAX_AXIS", 4)  # the first launch 4 rows over 16 lanes
    with pytest.raises(ValueError):
        calls[operand]()
    assert not ledger


@pytest.mark.parametrize("max_axis,n", [(tnt.MAX_AXIS, 256), (8, 512), (4, 64), (2, 32)],
                         ids=["one_pass", "recursing", "nested", "nested2"])
def test_transforms_through_emulated_k1(emu, monkeypatch, max_axis, n):
    """``ntt_t``, ``intt_t``, ``class_ntt_t`` (also into a slice of a
    larger output, as the column blocks write theirs) and ``coset_lde_t``
    with K1 emulated equal the plain path, with MAX_AXIS patched down so
    pass 1 recurses once or more: every pass a strided view, the last
    walking its input's rows."""
    ledger = collections.Counter()
    monkeypatch.setattr(kernels, "launched", ledger)
    monkeypatch.setattr(tnt, "MAX_AXIS", max_axis)
    rng = np.random.default_rng(n + max_axis)
    x = from_numpy(rand_limbs(rng, (3, 8, n)))
    coeffs = x[..., : n // 8]
    base = 0xC0FFEE + n
    calls = {"ntt": lambda: tnt.ntt_t(x), "intt": lambda: tnt.intt_t(x), "class": lambda: tnt.class_ntt_t(x, base),
             "lde": lambda: tnt.coset_lde_t(coeffs, 8)}
    want = {name: to_numpy(f()) for name, f in calls.items()}
    monkeypatch.setattr(tnt, "pease_stages", lambda y, tw, pre=None, r1=None, out=None:
                        tnt.launch_stages(emu, 0, y, tw, pre, r1, out))
    for name, f in calls.items():
        np.testing.assert_array_equal(to_numpy(f()), want[name], err_msg=name)
    whole = torch.full((5, 8, n), 7, dtype=torch.int32)
    tnt.class_ntt_t(x[1:], base, tnt.premultiplier(base, n, "cpu"), out=whole[2:4])
    np.testing.assert_array_equal(to_numpy(whole[2:4]), want["class"][1:])
    assert (whole[:2] == 7).all() and (whole[4:] == 7).all()
    walks = collections.Counter((dict(k[1])["load"], dict(k[1])["store"]) for k in ledger if k[0] == "ntt_stages")
    assert walks[("rows", "lanes")] > 0 and set(walks) <= {("rows", "lanes"), ("lanes", "lanes")}


def test_mul32_emulated(emu):
    """zk::mul32, K1's multiply, alone (its probe kernel) against the
    golden f128.fmul on every pair of edge values and on random pairs."""
    edges = [0, 1, 2, f128.P - 1, f128.P - 2, 45 * 2**40 - 1, 45 * 2**40, 2**127, 2**64 - 1, 2**64,
             2**96 + 2**32 - 1, f128.P - 2**64]
    rng = np.random.default_rng(128)
    rand = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, 500), dtype=np.int64))]
    rand = [(v << 1 | (v & 1)) % f128.P for v in rand]  # top bit set too
    a = [x for x in edges for _ in edges] + rand
    b = [y for _ in edges for y in edges] + rand[::-1]
    words = lambda vals: np.array([[v & (2**64 - 1), v >> 64] for v in vals], dtype=np.uint64)
    xa, xb = words(a), words(b)
    out = np.zeros_like(xa)
    assert emu.zk_mul32(xa.ctypes.data, xb.ctypes.data, out.ctypes.data, len(a), None) == 0
    got = [int(hi) << 64 | int(lo) for lo, hi in out]
    assert got == [f128.fmul(x, y) for x, y in zip(a, b)]


def test_sqr32_emulated(emu):
    """zk::sqr32, the ladders' squaring from 10 limb products, alone (its
    probe kernel) against the golden f128.fmul(a, a) on the edge values
    (words of all ones or zeros, each word's top bit, p - 1, eps) and on
    random elements."""
    edges = [0, 1, 2, 2**32 - 1, 2**32, 2**64 - 1, 2**64, 2**96 - 1, 2**127, f128.P - 2**32, f128.P - 1, f128.P - 2,
             45 * 2**40 - 1, 45 * 2**40, 2**96 + 2**32 - 1, f128.P - 2**64, sum(2**(32 * i + 31) for i in range(4))]
    rng = np.random.default_rng(129)
    rand = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, 500), dtype=np.int64))]
    a = edges + [(v << 1 | (v & 1)) % f128.P for v in rand]
    xa = np.array([[v & (2**64 - 1), v >> 64] for v in a], dtype=np.uint64)
    out = np.zeros_like(xa)
    assert emu.zk_sqr32(xa.ctypes.data, out.ctypes.data, len(a), None) == 0
    assert [int(hi) << 64 | int(lo) for lo, hi in out] == [f128.fmul(x, x) for x in a]


@pytest.mark.parametrize("c,n", [(28, 300), (8, 64), (1, 5), (8, 256), (28, 1), (1, 600)])
def test_blake3_rows_emulated(emu, c, n):
    """K2 at its shipped launch shape (256 threads a block): one full block
    (N = 256), one partial block (64, 5, 1), several blocks ending in a
    partial one (300, 600)."""
    x = from_numpy(rand_limbs(np.random.default_rng(c), (c, 8, n)))
    got = tb3t.launch_rows(emu, 0, x)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(tb3t.hash_rows_t(x)))


@pytest.mark.parametrize("threads", [32, 64, 128])
@pytest.mark.parametrize("c,n", [(28, 37), (8, 300), (1, 7)])
def test_blake3_rows_shapes_emulated(emu_shape, threads, c, n):
    """K2 built at other block sizes (-DZK_K2_THREADS): N = 37, 300, 7 end
    in a partial block, and N = 300 spans several blocks at every size.
    Exact against the plain version and the JAX hash_rows_t."""
    lib = emu_shape("blake3_rows.cu", "zk_blake3_rows", (f"ZK_K2_THREADS={threads}",))
    xs = rand_limbs(np.random.default_rng(c + n), (c, 8, n))
    x = from_numpy(xs)
    got = to_numpy(tb3t.launch_rows(lib, 0, x))
    np.testing.assert_array_equal(got, to_numpy(tb3t.hash_rows_plain(x)))
    np.testing.assert_array_equal(got, np.asarray(jb3t.hash_rows_t(jnp.asarray(xs))))


def _merkle_leaves(seed, n):
    """(N, 8) random leaf digests: the numpy words and the torch tensor."""
    words = np.random.default_rng(seed).integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    return words, from_numpy(words)


@pytest.mark.parametrize("k,n", [(3, 1), (3, 2), (3, 4), (3, 8), (3, 16), (3, 64), (None, 8), (None, 2048)])
def test_merkle_heap_emulated(emu, emu_shape, k, n):
    """The Merkle kernel at 2^k leaves a block (k = 3, or the shipped k
    where None): N = 1 ([0, leaf]), 2, 2^(k-1) and 2^k in one block, 2^(k+1)
    and 2^(k+3) over blocks that meet at their group's counter; one launch
    at every N.  Exact against the plain version and the JAX merkle_flat."""
    lib = emu if k is None else emu_shape("merkle.cu", "zk_merkle_heap", (f"ZK_MERKLE_K={k}",))
    words, leaves = _merkle_leaves(n, n)
    heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
    assert made == 1
    got = to_numpy(heap)
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


@pytest.mark.parametrize("reverse", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("n,units", [(64, 1), (128, 2 + 1), (256, 4 + 1), (512, 8 + 1), (1024, 16 + 2 + 1)])
def test_merkle_heap_levels_emulated(emu_shape, n, units, reverse):
    """The Merkle kernel at 2^3 nodes a block: a block builds its 8 leaves
    to one root (four leaves a thread and their two levels in registers,
    then one level in shared memory), and the last of each group of 8
    siblings to arrive carries
    the group's roots on, one to three times (N = 64: 8 roots, one carry;
    1024: 128, 16, 2 roots, three), in one launch; each carried unit has a
    counter.  The blocks run in grid order and in reverse
    (-DZK_EMU_REVERSE_BLOCKS=1: the last arrival of a group is its lowest
    block).  Exact against the plain version and the JAX merkle_flat, and
    the counters are zero again."""
    lib = emu_shape("merkle.cu", "zk_merkle_heap", ("ZK_MERKLE_K=3", f"ZK_EMU_REVERSE_BLOCKS={reverse}"))
    assert lib.zk_merkle_counters(n) == units
    words, leaves = _merkle_leaves(n + reverse, n)
    heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
    assert made == 1
    assert not tmerkle._counters[torch.device("cpu")].any()
    got = to_numpy(heap)
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


@pytest.mark.parametrize("reverse", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("k,group,n", [(6, 0, 4096), (6, 0, 32), (6, 0, 64), (3, 2, 256), (4, 4, 1024)])
def test_merkle_heap_top_emulated(emu_shape, k, group, n, reverse):
    """The tree's top in one warp: at 2^6 nodes a block (32 threads) a
    unit keeps 32 roots, so N = 4096 carries five times before the top's
    five levels on __syncwarp(), N = 64 is one level in the block and
    the top, and N = 32 is the top alone (all one leaf a thread: a unit of
    64 has too few grandparents for four); with -DZK_MERKLE_GROUP a unit
    of 2^k nodes keeps 2^k / G roots (k = 3, G = 2: 4 roots, a one-level
    unit; k = 4, G = 4: 4 roots).  Both block orders, one launch; exact
    against the plain version and the JAX merkle_flat."""
    defines = (f"ZK_MERKLE_K={k}", f"ZK_MERKLE_GROUP={group}", f"ZK_EMU_REVERSE_BLOCKS={reverse}")
    lib = emu_shape("merkle.cu", "zk_merkle_heap", defines)
    words, leaves = _merkle_leaves(n + k, n)
    heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
    assert made == 1
    got = to_numpy(heap)
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


def test_merkle_trees_leave_the_counters_zero(emu_shape):
    """Three trees in a row on one scratch (2^3 nodes a block, the blocks
    in reverse order): each is exact, and the counters are all zero after
    them, so no tree needs a memset."""
    lib = emu_shape("merkle.cu", "zk_merkle_heap", ("ZK_MERKLE_K=3", "ZK_EMU_REVERSE_BLOCKS=1"))
    scratch = tmerkle.counters(lib, torch.device("cpu"), 1024)
    for n in (1024, 64, 512):
        _, leaves = _merkle_leaves(3 * n, n)
        heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
        assert made == 1
        np.testing.assert_array_equal(to_numpy(heap), to_numpy(tmerkle.merkle_flat_plain(leaves)))
    assert tmerkle.counters(lib, torch.device("cpu"), 1024) is scratch
    assert scratch.numel() >= lib.zk_merkle_counters(1024) > 0
    assert not scratch.any()


def test_merkle_launches_of_the_shipped_kernel(emu):
    """The shipped kernel (2^10 nodes a block) reports one launch a tree at
    every N, one block or several (the 2^23-leaf trees of the 2^20-row
    path are counted on the card by chip_smoke.py); it needs no counter up
    to 2^10 leaves and one from 2^11; the entry refuses a leaf count that
    is not a power of two, or too few counters, and reports no launch."""
    made = [tmerkle.launch_heap(emu, 0, torch.zeros((8, 1 << k), dtype=torch.int32))[1] for k in (0, 1, 10, 11, 12)]
    assert made == [1, 1, 1, 1, 1]
    assert [emu.zk_merkle_counters(1 << k) for k in (0, 5, 10, 11, 15, 23)] == [0, 0, 0, 1, 1, 256 + 8 + 1]
    assert emu.zk_merkle_counters(24) == -1
    count = ctypes.c_int(7)
    assert emu.zk_merkle_heap(None, None, 24, None, 1024, ctypes.byref(count), None) == 1
    assert count.value == 0
    count = ctypes.c_int(7)
    assert emu.zk_merkle_heap(None, None, 1 << 23, None, 264, ctypes.byref(count), None) == 1
    assert count.value == 0


def test_hash_launches_build_no_constants(emu, monkeypatch):
    """K2's and the Merkle kernel's launch functions build no tensor from
    host data (on a card each such copy waits for the stream): the IV and
    flags are constants of the CUDA source.  Leaf counts that are not a
    power of two raise before any launch, as does a device with no kernel."""
    built = []
    for mod, name in [(torch, "tensor"), (torch, "from_numpy"), (torch, "as_tensor")]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: built.append(_n) or _f(*a, **k))
    x = torch.zeros((8, 8, 32), dtype=torch.int32)
    tb3t.launch_rows(emu, 0, x)
    tmerkle.launch_heap(emu, 0, x[0])
    assert built == [], f"the launches built {built}"
    with pytest.raises(ValueError, match="power of two"):
        tmerkle.launch_heap(None, 0, x[0, :, :24].contiguous())
    with pytest.raises(ValueError, match="no kernel"):
        tmerkle.merkle_flat(torch.empty((4, 8), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("t", [160, 48, 256])
def test_composition_emulated(emu, t):
    """K3 with the field's edge values in every input, at T = 160 (a full
    block of 128 rows and a partial one), 48 (one partial block) and 256
    (two full blocks); the last row's next row is row 0."""
    from test_torch_composition import _ORDER, composition_inputs
    from zkvm_torch.air import composition as tcp

    arrays, delta, bcols0, bcols1 = composition_inputs(6, t=t)
    args = [from_numpy(arrays[k]) for k in _ORDER]
    got = tcp.launch_composition(emu, 0, *args, delta, bcols0, bcols1)
    want = tcp.composition_t(*args, delta, bcols0, bcols1)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


def _transition_inputs(domain, t, blowup, seed):
    """K4's inputs over the full domain (next row +blowup, period-16*blowup
    tables) or one class (next row +1, 16-step patterns), the field's edge
    values mixed into the trace and the alphas."""
    from test_torch_composition import rand_limbs as edge_limbs
    from zkvm_torch.air import periodic as tper

    rng = np.random.default_rng(seed)
    if domain == "full":
        n, step = t * blowup, blowup
        tab = from_numpy(tper.periodic_table(t, blowup))
        mask, ark = tab[0], tab[1:].contiguous()
    else:
        n, step = t, 1
        mask_p, ark_p = tper.periodic_class_patterns(t, blowup)
        mask = from_numpy(np.ascontiguousarray(np.swapaxes(mask_p[1], -1, -2)))
        ark = from_numpy(np.ascontiguousarray(np.swapaxes(ark_p[1], -1, -2)))
    lde = from_numpy(edge_limbs(rng, (28, 8, n), edges=True))
    alphas = from_numpy(np.ascontiguousarray(np.swapaxes(edge_limbs(rng, (8, 20), edges=True), 0, 1)))
    return lde, mask, ark, alphas, step


@pytest.mark.parametrize("domain,t", [("full", 32), ("class", 32), ("full", 48), ("class", 144)])
def test_transition_emulated(emu, domain, t):
    """K4 over the full domain (next row +blowup, period-16*blowup tables)
    and over one class (next row +1, 16-step patterns), with the field's
    edge values in the trace and the alphas; the last ``step`` rows read
    rows 0 .. step-1 (wrap-around).  N = 128 and 32 fill whole blocks or
    one partial block; N = 192 and 144 end in a partial block, so the
    wrap-around crosses from the last, partial block to the first."""
    from zkvm_torch.air import transition as ttr

    lde, mask, ark, alphas, step = _transition_inputs(domain, t, 4, 41 + t + (domain == "class"))
    n = lde.shape[-1]
    got = to_numpy(ttr.launch_transition(emu, 0, lde, mask, ark, alphas, 12345, step))
    want = to_numpy(ttr.merged_transition(lde, mask, ark, alphas, 12345, step))
    np.testing.assert_array_equal(got[:, n - step:], want[:, n - step:])  # the wrap-around rows
    np.testing.assert_array_equal(got, want)


def test_air_launches_build_no_constants(emu, monkeypatch):
    """A second call of K3's and K4's launch functions builds no tensor
    from host data: on a card each such copy waits for the stream.  The
    matrices are built once per device; delta and the boundary columns go
    to the C entry by value."""
    from test_torch_composition import _ORDER, composition_inputs
    from zkvm_torch.air import composition as tcp
    from zkvm_torch.air import transition as ttr

    built = []

    def counting(name, fn):
        return lambda *a, **k: built.append(name) or fn(*a, **k)

    for mod, name in [(tcp, "from_numpy"), (torch, "tensor"), (torch, "from_numpy"), (torch, "as_tensor")]:
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    arrays, delta, bcols0, bcols1 = composition_inputs(7, t=32)
    args = [from_numpy(arrays[k]) for k in _ORDER]
    lde, mask, ark, alphas, step = _transition_inputs("full", 16, 2, 8)
    tcp.mds_dev.cache_clear()
    calls = [lambda: tcp.launch_composition(emu, 0, *args, delta, bcols0, bcols1),
             lambda: ttr.launch_transition(emu, 0, lde, mask, ark, alphas, delta, step)]
    first = []
    for call in calls:
        call()
        first.append(list(built))
        built.clear()
        call()
        assert built == [], f"the second call built {built}"
    assert first[0], "the first K3 call builds the matrices once (so the counting works)"
    assert first[1] == [], "K4 shares K3's cached matrices"


def test_air_wrappers_refuse_what_the_kernels_cannot_hold():
    """More boundary columns than K3's arguments hold, or a periodic table
    longer than K4 stages into shared memory, raise before any launch."""
    from test_torch_composition import _ORDER, composition_inputs
    from zkvm_torch.air import composition as tcp
    from zkvm_torch.air import transition as ttr

    arrays, delta, bcols0, bcols1 = composition_inputs(8, t=32)
    many = tuple(range(tcp.MAX_BOUNDARY + 1))
    arrays["bv0"] = np.zeros((len(many), 8), np.uint32)
    arrays["bb0"] = np.zeros((len(many), 8), np.uint32)
    with pytest.raises(ValueError, match="boundary columns"):
        tcp.launch_composition(None, 0, *(from_numpy(arrays[k]) for k in _ORDER), delta, many, bcols1)
    p = 2 * ttr.MAX_PERIOD
    lde = torch.zeros((28, 8, p), dtype=torch.int32)
    with pytest.raises(ValueError, match="table length"):
        ttr.launch_transition(None, 0, lde, lde[0], torch.zeros((8, 8, p), dtype=torch.int32),
                              torch.zeros((20, 8), dtype=torch.int32), 1, 1)


def _binv_input(r, n, k, threads, seed):
    """(r, 8, n) limbs for the batch inverse: random elements, the field's
    edge values, and zeros at the tree's boundaries in row 0 (block b of a
    row takes the S = k * threads elements from b S on, its thread t the
    elements b S + t + i threads): each block's first and last element, the
    whole chunk of thread 1 in every other block (a leaf of one) and an
    element in the middle; row 1, where there is one, is all zeros."""
    rng = np.random.default_rng(seed)
    x = rand_limbs(rng, (r, 8, n))
    span = k * threads
    lanes = set()
    for first in range(0, n, span):
        lanes |= {first, min(first + span, n) - 1, first + threads // 2 + k // 2 * threads}
        if first // span % 2 == 0:
            lanes |= {first + 1 + i * threads for i in range(k)}
    x[0][:, sorted(j for j in lanes if j < n)] = 0
    edges = [0, 1, f128.P - 1, 45 * 2**40 - 1, 2**127]
    lanes = np.arange(min(n, len(edges)))
    x[-1][:, lanes] = np.swapaxes(to_limbs(edges[: len(lanes)]), 0, 1)
    if r > 1:
        x[1] = 0
    return x


BINV_SHIPPED = (8, 128)  # csrc/batch_inverse.cu's default ZK_BINV_K, ZK_BINV_THREADS


@pytest.mark.parametrize("k,threads", [(None, None), (3, 4), (2, 8)])
@pytest.mark.parametrize("r,n", [(1, 1), (1, 16), (3, 1), (1, 37), (3, 100), (2, 700), (2, 2500)])
def test_batch_inverse_emulated(emu, emu_shape, k, threads, r, n):
    """The batch-inverse kernel at its shipped shape (K = 8 elements a
    thread, 128 threads a block: S = 1024 elements a block) and at two
    small trees (K = 3 with 4 threads, K = 2 with 8: a block of 12 or 16
    elements): rows shorter than a block, rows that end inside a block,
    several blocks a row (2500 at the shipped shape; 37-700 at the small
    ones), R = 1, 2 and 3; zeros at the ends of blocks and chunks, a chunk
    of zeros, a row of zeros, the edge values.  Exact against the plain
    Fermat version and the golden inverse."""
    lib = emu if k is None else emu_shape(
        "batch_inverse.cu", "zk_batch_inverse", (f"ZK_BINV_K={k}", f"ZK_BINV_THREADS={threads}"))
    x = _binv_input(r, n, *((k, threads) if k else BINV_SHIPPED), 10 * r + n)
    a = from_numpy(x)
    got = to_numpy(tft.launch_batch_inverse(lib, 0, a))
    np.testing.assert_array_equal(got, to_numpy(tft.batch_inverse_plain(a)))
    vals = [int(v) for v in from_t(x.reshape(-1, 8, n).transpose(1, 0, 2).reshape(8, -1))]
    assert [int(v) for v in from_t(got.reshape(-1, 8, n).transpose(1, 0, 2).reshape(8, -1))] == [
        pow(v, f128.P - 2, f128.P) for v in vals]


def test_batch_inverse_power_chain_emulated(emu):
    """The batch inverse's addition chain for a^(p-2) alone (its probe
    kernel, one element a thread) against pow(a, p - 2, p) on the edge
    values and on random elements."""
    edges = [0, 1, 2, 3, f128.P - 1, f128.P - 2, 45 * 2**40 - 1, 2**127, 2**64 - 1, 2**64, f128.P - 2**64]
    rng = np.random.default_rng(129)
    rand = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, 300), dtype=np.int64))]
    vals = edges + [(v << 1 | (v & 1)) % f128.P for v in rand]
    words = np.array([[v & (2**64 - 1), v >> 64] for v in vals], dtype=np.uint64)
    out = np.zeros_like(words)
    assert emu.zk_binv_power(words.ctypes.data, out.ctypes.data, len(vals), None) == 0
    assert [int(hi) << 64 | int(lo) for lo, hi in out] == [pow(v, f128.P - 2, f128.P) for v in vals]


def test_batch_inverse_launch_takes_leading_dims_and_builds_nothing(emu, monkeypatch):
    """The launch takes (..., 8, N) with any leading dimensions (one axis R
    to the kernel), and a (8, N) tensor as R = 1; it builds no tensor from
    host data (on a card such a copy waits for the stream).  It refuses a
    strided input (the wrapper makes it contiguous) and an empty one."""
    x = from_numpy(_binv_input(6, 40, *BINV_SHIPPED, 5)).reshape(2, 3, 8, 40)
    built = []
    for name in ("tensor", "from_numpy", "as_tensor"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _n=name, _f=fn, **k: built.append(_n) or _f(*a, **k))
    got = tft.launch_batch_inverse(emu, 0, x)
    single = tft.launch_batch_inverse(emu, 0, x[1, 2])
    assert built == []
    np.testing.assert_array_equal(to_numpy(got), to_numpy(tft.batch_inverse_plain(x)))
    np.testing.assert_array_equal(to_numpy(single), to_numpy(got[1, 2]))
    with pytest.raises(ValueError, match="contiguous"):
        tft.launch_batch_inverse(emu, 0, x.transpose(0, 1))
    for empty in (x[..., :0], x[:0]):
        with pytest.raises(ValueError, match="not empty"):
            tft.launch_batch_inverse(emu, 0, empty)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_ops_edge_pairs_emulated(emu, op):
    """The field-op kernel on every pair of the edge values 0, 1, p - 1 and
    eps, and on random pairs: exact against the plain version and the
    golden model."""
    from test_torch_field import _pairs

    a, b = _pairs()
    xa, xb = from_numpy(tlimbs(a)), from_numpy(tlimbs(b))
    got = tft.launch_field_op(emu, 0, op, xa, xb)
    plain = {"add": tft.fadd_plain, "sub": tft.fsub_plain, "mul": tft.fmul_plain}[op]
    np.testing.assert_array_equal(to_numpy(got), to_numpy(plain(xa, xb)))
    golden = {"add": f128.fadd, "sub": f128.fsub, "mul": f128.fmul}[op]
    assert [int(v) for v in from_t(to_numpy(got))] == [golden(x, y) for x, y in zip(a, b)]


def _fop_operands(rng, case):
    """The operands of one broadcast or strided pattern of the provers."""
    limbs = lambda shape: from_numpy(rand_limbs(rng, shape))
    if case == "columns x column weights":  # (C, 8, T) x (C, 8, 1): a stride-0 lane axis
        return limbs((5, 8, 64)), limbs((5, 8, 1))
    if case == "ladders_join":  # (Q, N2, 8, 1) x (Q, 1, 8, S): stride 0 on lanes and on a batch axis
        return limbs((3, 8, 4)).transpose(-1, -2)[:, :, :, None], limbs((3, 8, 16))[:, None]
    if case == "an (8, 1) constant":
        return limbs((8, 96)), limbs((8, 1))
    if case == "a transposed operand":  # (N2, 8, N1) views of (8, N1, N2) limbs
        return limbs((8, 8, 4)).permute(2, 0, 1), limbs((4, 8, 8))
    if case == "narrowed halves":  # fsum's pairwise step, along a batch axis
        x = limbs((6, 8, 40))
        return x.narrow(0, 0, 3), x.narrow(0, 3, 3)
    if case == "odd lengths":  # axes that are not powers of two: the kernel divides
        return limbs((3, 1, 8, 7)), limbs((5, 8, 1))
    if case == "one element":
        return limbs((8, 1)), limbs((8, 1))
    return limbs((4, 8, 0)), limbs((8, 1))  # empty: no launch


@pytest.mark.parametrize("case", ["columns x column weights", "ladders_join", "an (8, 1) constant",
                                  "a transposed operand", "narrowed halves", "odd lengths", "one element",
                                  "empty"])
def test_field_ops_broadcast_emulated(emu, case):
    """The field-op kernel on the provers' broadcast and strided operands
    (read through their strides, nothing copied): exact against the plain
    version for add, sub and mul."""
    a, b = _fop_operands(np.random.default_rng(len(case)), case)
    for op, plain in (("add", tft.fadd_plain), ("sub", tft.fsub_plain), ("mul", tft.fmul_plain)):
        got = tft.launch_field_op(emu, 0, op, a, b)
        want = plain(a, b)
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


# the trace's limb transpose, (C, N, 8) -> (C, 8, N), an element a thread:
# the shipped block of 256 threads and one of 96
LT_SHAPES = [None, ("ZK_LT_THREADS=96",)]


def _lt_input(c, n, seed):
    """(C, N, 8) int32 words, every bit random (the transpose moves words,
    not field elements)."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(c, n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("defines", LT_SHAPES, ids=["shipped", "96 threads"])
@pytest.mark.parametrize("c,n", [(28, 1 << 4), (28, 1 << 10), (28, 1 << 12), (1, 1 << 12), (8, 1 << 12), (8, 37)])
def test_limb_transpose_emulated(emu, emu_shape, defines, c, n):
    """The limb transpose on the prover's 28 columns at N = 2^4, 2^10 and
    2^12 (16 blocks a column at the shipped shape, the last of 96 threads
    partial), on 1 and 8 columns, and at N = 37 (rows not 16-byte
    aligned): exact against its plain version and numpy's swapaxes."""
    lib = emu if defines is None else emu_shape("limb_transpose.cu", "zk_limb_transpose", defines)
    x = _lt_input(c, n, 100 * c + n)
    got = lm.launch_limb_transpose(lib, 0, x)
    assert got.shape == (c, 8, n) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), lm.limb_transpose_plain(x).numpy())
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(x.numpy(), 1, 2))


def test_limb_transpose_wrapper_on_the_cpu():
    """On a CPU tensor the wrapper takes the plain version (no launch): the
    same words as numpy's swapaxes, a new contiguous tensor."""
    x = _lt_input(28, 1 << 10, 3)
    before = kernels.launched.copy()
    got = lm.limb_transpose(x)
    assert kernels.launched == before and got.is_contiguous() and got.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(x.numpy(), 1, 2))


@pytest.mark.parametrize("case,error,match", [
    ("limbs of 4", ValueError, "expected \\(C, N, 8\\)"), ("two axes", ValueError, "expected \\(C, N, 8\\)"),
    ("empty", ValueError, "not empty"), ("int64", TypeError, "int32"), ("transposed", ValueError, "contiguous"),
    ("strided columns", ValueError, "contiguous"),
])
def test_limb_transpose_refusals(emu, case, error, match):
    """The wrapper (on the CPU too) and the launch refuse what the kernel
    does not take, before any launch: another limb count or rank, an empty
    input, another dtype, a non-contiguous view."""
    x = _lt_input(4, 64, 9)
    bad = {"limbs of 4": x.reshape(4, 128, 4), "two axes": x.reshape(256, 8), "empty": x[:, :0],
           "int64": x.long(), "transposed": x.transpose(0, 1), "strided columns": x[::2]}[case]
    before = kernels.launched.copy()
    with pytest.raises(error, match=match):
        lm.limb_transpose(bad)
    with pytest.raises(error, match=match):
        lm.launch_limb_transpose(emu, 0, bad)
    assert kernels.launched == before


def test_limb_transpose_launch_refuses_a_misaligned_start(emu):
    """A view that starts 4 bytes into its storage is contiguous but not
    16-byte aligned: the launch raises, and the C entry alone returns -1."""
    flat = _lt_input(1, 65, 5).reshape(-1)
    x = flat[1: 1 + 2 * 32 * 8].view(2, 32, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        lm.launch_limb_transpose(emu, 0, x)
    out = torch.empty(2, 8, 32, dtype=torch.int32)
    assert emu.zk_limb_transpose(x.data_ptr(), out.data_ptr(), 2, 32, None) == -1


@pytest.mark.parametrize("mode", ["tmode", "cls"])
def test_provers_through_the_emulated_limb_transpose(emu, monkeypatch, mode):
    """The T = 128 conformance prove with the trace's transpose launched
    through the kernel's host emulation, as the card would launch it on the
    uploaded (28, T, 8) limbs: exactly one launch, of (28, 128), and the
    proof's bytes are the conformance vector's."""
    monkeypatch.setattr(tpl, "limb_transpose", lambda x: lm.launch_limb_transpose(emu, 0, x))
    monkeypatch.setattr(kernels, "launched", collections.Counter())
    vec = json.loads((Path(__file__).resolve().parents[1] / "conformance" / "vectors_e2e.json").read_text())
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(vec["program_source"])
    inputs = vm.ProgramInputs(tuple(vec["public_inputs_tape"]), (key.encrypt(2),), key)
    _, _, proof = vm.prove(program, inputs, device="cpu", mode=mode)
    assert kernel_health.launches() == dict(dict.fromkeys(kernels.FAMILIES, 0), limb_transpose=1)
    assert kernel_health.launches_by_shape()["limb_transpose"] == {"C=28 N=128": 1}
    assert proof.trace_root.hex() == vec["trace_root_hex"]
    assert proof.to_wire_bytes().hex() == vec["proof_bytes_hex"]


class _Refusing:
    """A kernel library whose ``entry`` refuses every launch (returns 1, as
    a failed ``cudaGetLastError()`` would); its other entries are ``lib``'s."""

    def __init__(self, lib, entry):
        self.lib, self.entry = lib, entry

    def __getattr__(self, name):
        return (lambda *args: 1) if name == self.entry else getattr(self.lib, name)


def _ledger_cases(emu):
    """Per family of ``kernels.FAMILIES``: its C entry, its one ``launch_*``
    call on a given library, and the shape that call counts under.  The
    multi-eval's ladders are launched here, on ``emu``."""
    from test_torch_composition import _ORDER, composition_inputs
    from zkvm_torch.air import composition as tcp
    from zkvm_torch.air import transition as ttr
    from zkvm_torch.prover import deep as tdp
    from zkvm_torch.prover import fri as tfri
    from zkvm_torch.prover import multi_eval as tme

    rng = np.random.default_rng(24)
    limbs = lambda shape: from_numpy(rand_limbs(rng, shape))
    one, cols = limbs((8, 1))[:, 0], limbs((3, 8, 16))
    arrays, delta, bcols0, bcols1 = composition_inputs(24, t=32)
    comp = [from_numpy(arrays[k]) for k in _ORDER]
    lde, mask, ark, alphas, step = _transition_inputs("full", 16, 2, 24)
    tw = tnt._stage_twiddles_dev(8, False, torch.device("cpu"))
    bases = from_numpy(to_limbs([3, 5, 7]))
    lad = tme.launch_ladders(emu, 0, bases, 16)
    return {
        "ntt_stages": ("zk_ntt_stages", lambda lib: tnt.launch_stages(lib, 0, limbs((2, 8, 8, 4)), tw),
                       dict(M=8, B=2, NL=4, variant="plain", load="lanes", store="lanes")),
        "blake3_rows": ("zk_blake3_rows", lambda lib: tb3t.launch_rows(lib, 0, limbs((8, 8, 32))), dict(C=8, N=32)),
        "merkle": ("zk_merkle_heap", lambda lib: tmerkle.launch_heap(lib, 0, limbs((8, 8, 16))[0]), dict(N=16)),
        "composition": ("zk_composition", lambda lib: tcp.launch_composition(lib, 0, *comp, delta, bcols0, bcols1),
                        dict(T=32)),
        "transition": ("zk_transition", lambda lib: ttr.launch_transition(lib, 0, lde, mask, ark, alphas, delta, step),
                       dict(N=32, step=2)),
        "batch_inverse": ("zk_batch_inverse", lambda lib: tft.launch_batch_inverse(lib, 0, cols), dict(R=3, N=16)),
        "field_ops": ("zk_field_op", lambda lib: tft.launch_field_op(lib, 0, "mul", cols, one[:, None]),
                      dict(op="mul", n=48)),
        "multi_eval": ("zk_multi_eval", lambda lib: tme.launch_multi_eval(lib, 0, cols[:2].contiguous(), lad),
                       dict(C=2, Q=3, T=16)),
        "meval_ladders": ("zk_meval_ladders", lambda lib: tme.launch_ladders(lib, 0, bases, 16), dict(Q=3, T=16)),
        "fri_fold": ("zk_fri_fold", lambda lib: tfri.launch_fold(lib, 0, limbs((tfri.FOLD, 8, 16)), 5, 7),
                     dict(n=16)),
        "ladder": ("zk_ladder", lambda lib: tnt.launch_ladder(lib, 0, one, one, 16), dict(B=1, n=16)),
        "ladder_const": ("zk_ladder_const", lambda lib: tnt.launch_ladder_const(lib, 0, 3, 5, 16, device="cpu"),
                         dict(B=1, n=16)),
        "weighted_sum": ("zk_weighted_sum", lambda lib: tdp.launch_weighted_sum(lib, 0, cols, [[1, 2, 3]]),
                         dict(K=1, C=3, N=16)),
        "deep_quotient": ("zk_deep_quotient", lambda lib: tdp.launch_deep_quotient(lib, 0, cols, [1, 2, 3], cols),
                          dict(K=3, N=16)),
        "limb_transpose": ("zk_limb_transpose", lambda lib: lm.launch_limb_transpose(lib, 0, _lt_input(2, 16, 24)),
                           dict(C=2, N=16)),
    }


@pytest.mark.parametrize("family", kernels.FAMILIES)
def test_each_launch_adds_one_ledger_entry(emu, monkeypatch, family):
    """One call of a family's ``launch_*`` through the emulated library adds
    exactly one launch to the ledger (``kernels.launched``), under the
    family and the shape it launched; the same call through a library
    whose entry refuses the launch raises and adds nothing."""
    ledger = collections.Counter()
    monkeypatch.setattr(kernels, "launched", ledger)
    entry, launch, shape = _ledger_cases(emu)[family]
    assert entry in kernels.SIGNATURES
    ledger.clear()
    launch(emu)
    assert ledger == {(family, tuple(shape.items())): 1}
    assert kernel_health.report()["total"] == 1
    ledger.clear()
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed"):
        launch(_Refusing(emu, entry))
    assert not ledger
