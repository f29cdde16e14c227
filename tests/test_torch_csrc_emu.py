"""The CUDA kernels' sources, run on the CPU through a host emulation.

``zkvm_torch/csrc`` compiles as plain C++ against ``csrc/host_emu.h``, which
runs each CUDA thread of a block as a host thread (a std::barrier stands in
for __syncthreads()).  That checks the kernels' index, carry and
shared-memory logic without a card: each emulated kernel must equal its
plain PyTorch version exactly.  The kernels themselves, as nvcc builds them
for sm_90a, are checked on the card by chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm_torch import kernels
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy
from zkvm.hash import blake3_jax as b3j
from zkvm.hash import blake3_t as jb3t
from zkvm_torch.hash import blake3_t as tb3t
from zkvm_torch.hash import merkle as tmerkle
from zkvm_torch.ntt import ntt_t as tnt

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
    built once a shape."""
    out, built = tmp_path_factory.mktemp("emu_shapes"), {}

    def get(source, entry, defines):
        if (source, defines) not in built:
            lib = ctypes.CDLL(str(_build_emu(out, [source], defines)))
            getattr(lib, entry).argtypes = list(kernels.SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
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


@pytest.mark.parametrize("k,n", [(3, 1), (3, 2), (3, 4), (3, 8), (3, 16), (3, 64), (None, 8), (None, 2048)])
def test_merkle_heap_emulated(emu, emu_shape, k, n):
    """The Merkle kernel at 2^k leaves a block (k = 3, or the shipped k
    where None): N = 1 ([0, leaf]), 2, 2^(k-1) and 2^k take launch (i)
    alone, 2^(k+1) and 2^(k+3) both launches.  Exact against the plain
    version and the JAX merkle_flat."""
    lib = emu if k is None else emu_shape("merkle.cu", "zk_merkle_heap", (f"ZK_MERKLE_K={k}",))
    words = np.random.default_rng(n).integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    leaves = from_numpy(words)
    got = to_numpy(tmerkle.launch_heap(lib, 0, leaves.T.contiguous()))
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


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
