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
from zkvm_torch.field import f128t as tft
from zkvm_torch.field.limbs import from_numpy, from_t, tlimbs, to_limbs, to_numpy
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
    heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
    assert made == (1 if n <= 2 ** (k or 10) else 2)
    got = to_numpy(heap)
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


@pytest.mark.parametrize("top,n,launches", [(3, 128, 3), (3, 256, 3), (3, 1024, 4), (1, 64, 2), (5, 512, 3)])
def test_merkle_heap_levels_emulated(emu_shape, top, n, launches):
    """The Merkle kernel at 2^3 nodes a block with the top launch's
    capacity at 2^top roots (-DZK_MERKLE_TOP): past it, the subtree launch
    runs again over the roots, so N = 128 and 256 take three launches and
    1024 four (ceil(log2 N / 3)).  Exact against the plain version and the
    JAX merkle_flat."""
    lib = emu_shape("merkle.cu", "zk_merkle_heap", ("ZK_MERKLE_K=3", f"ZK_MERKLE_TOP={top}"))
    words = np.random.default_rng(n + top).integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    leaves = from_numpy(words)
    heap, made = tmerkle.launch_heap(lib, 0, leaves.T.contiguous())
    assert made == launches <= -(-(n.bit_length() - 1) // 3)
    got = to_numpy(heap)
    np.testing.assert_array_equal(got, to_numpy(tmerkle.merkle_flat_plain(leaves)))
    np.testing.assert_array_equal(got, np.asarray(b3j.merkle_flat(jnp.asarray(words))))


def test_merkle_launches_of_the_shipped_kernel(emu):
    """The shipped kernel (2^10 nodes a block) reports the launches it
    made: one up to 2^10 leaves, two from 2^11 (the 2^23-leaf trees of the
    2^20-row path, three launches, are counted on the card by chip_smoke.py);
    the entry refuses a leaf count that is not a power of two and reports
    no launch."""
    made = [tmerkle.launch_heap(emu, 0, torch.zeros((8, 1 << k), dtype=torch.int32))[1] for k in (0, 1, 10, 11, 12)]
    assert made == [1, 1, 1, 2, 2]
    count = ctypes.c_int(7)
    assert emu.zk_merkle_heap(None, None, 24, ctypes.byref(count), None) == 1
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
