"""The CUDA kernels' sources, run on the CPU through a host emulation.

``zkvm_torch/csrc`` compiles as plain C++ against ``csrc/host_emu.h``, which
runs each CUDA thread of a block as a host thread (a std::barrier stands in
for __syncthreads()).  That checks the kernels' index, carry and
shared-memory logic without a card: each emulated kernel must equal its
plain PyTorch version exactly.  The kernels themselves, as nvcc builds them
for sm_90a, are checked on the card by chip_smoke.py.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkvm.field import f128
from zkvm_torch import kernels
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy
from zkvm_torch.hash import blake3_t as tb3t
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA sources")
    so = tmp_path_factory.mktemp("emu") / "libzkvm_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-x", "c++", "-o", str(so)]
    cmd += [str(kernels.CSRC / s) for s in kernels.SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return kernels.bind(so)


def rand_limbs(rng, shape):
    """(..., 8, L) limbs of random canonical elements (edges mixed in)."""
    n = int(np.prod(shape)) // 8
    vals = [int(a) << 64 | int(b) for a, b in zip(*rng.integers(0, 2**63, size=(2, n), dtype=np.int64))]
    edges = [0, 1, f128.P - 1, 45 * 2**40 - 1, 2**127]
    vals[: len(edges)] = edges[:n]
    return np.swapaxes(to_limbs(vals).reshape(shape[:-2] + (shape[-1], 8)), -1, -2)


@pytest.mark.parametrize(
    "m,nl,variant", [(8, 64, "plain"), (4, 8, "full"), (16, 4, "r1"), (512, 4, "full")]
)
def test_ntt_stages_emulated(emu, m, nl, variant):
    rng = np.random.default_rng(m + nl)
    y = from_numpy(rand_limbs(rng, (2, m, 8, nl)))
    tw = from_numpy(tnt._stage_twiddles(m, variant == "r1"))
    pre = from_numpy(rand_limbs(rng, (m, 8, nl))) if variant == "full" else None
    r1 = (from_numpy(rand_limbs(rng, (8, m))), from_numpy(rand_limbs(rng, (8, nl)))) if variant == "r1" else None
    got = tnt.launch_stages(emu, 0, y, tw, pre=pre, r1=r1)
    want = tnt.pease_stages(y, tw, pre=pre, r1=r1)  # CPU tensors: the plain version
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


@pytest.mark.parametrize("c,n", [(28, 300), (8, 64), (1, 5)])
def test_blake3_rows_emulated(emu, c, n):
    x = from_numpy(rand_limbs(np.random.default_rng(c), (c, 8, n)))
    got = tb3t.launch_rows(emu, 0, x)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(tb3t.hash_rows_t(x)))


def test_composition_emulated(emu):
    from test_torch_composition import _ORDER, composition_inputs
    from zkvm_torch.air import composition as tcp

    arrays, delta, bcols0, bcols1 = composition_inputs(6, t=160)
    args = [from_numpy(arrays[k]) for k in _ORDER]
    got = tcp.launch_composition(emu, 0, *args, delta, bcols0, bcols1)
    want = tcp.composition_t(*args, delta, bcols0, bcols1)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


@pytest.mark.parametrize("domain", ["full", "class"])
def test_transition_emulated(emu, domain):
    """K4 over the full domain (next row +blowup, period-16*blowup tables)
    and over one class (next row +1, 16-step patterns); the last ``step``
    rows read rows 0 .. step-1 (wrap-around)."""
    from zkvm_torch.air import periodic as tper
    from zkvm_torch.air import transition as ttr

    t, blowup = 32, 4
    rng = np.random.default_rng(41 if domain == "full" else 42)
    if domain == "full":
        n, step = t * blowup, blowup
        tab = from_numpy(tper.periodic_table(t, blowup))
        mask, ark = tab[0], tab[1:].contiguous()
    else:
        n, step = t, 1
        mask_p, ark_p = tper.periodic_class_patterns(t, blowup)
        mask = from_numpy(np.ascontiguousarray(np.swapaxes(mask_p[1], -1, -2)))
        ark = from_numpy(np.ascontiguousarray(np.swapaxes(ark_p[1], -1, -2)))
    lde = from_numpy(rand_limbs(rng, (28, 8, n)))
    alphas = from_numpy(np.ascontiguousarray(np.swapaxes(rand_limbs(rng, (8, 20)), 0, 1)))
    got = to_numpy(ttr.launch_transition(emu, 0, lde, mask, ark, alphas, 12345, step))
    want = to_numpy(ttr.merged_transition(lde, mask, ark, alphas, 12345, step))
    np.testing.assert_array_equal(got[:, n - step:], want[:, n - step:])  # the wrap-around rows
    np.testing.assert_array_equal(got, want)
