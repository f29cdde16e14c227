"""The four-step NTT on the card (skipped without one): at the prover's
sizes every transform launches K1 (``ntt_stages_kernel``) and nothing else
(a coset LDE's zero padding, torch's fill and copy, apart), gives the bytes of the four-step form
that materialised each pass's operand with torch's copies (the form before
K1 read strided views), and the size-2^23 LDE of 28 columns holds no more
than its padded input, its output and one intermediate.

The file imports no JAX, so it runs where the port runs alone; the
suite's conftest sets JAX up, so leave it out there:

    python -m pytest --noconftest -m chip tests/test_torch_ntt_chip.py
"""

import pytest
import torch

from zkvm_torch.field import f128
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.utils import kernel_health

K1 = "ntt_stages_kernel"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


def _limbs(shape, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=device, dtype=torch.int32)
    x[..., 7, :] %= 0xFFFF  # below p
    return x


def _copied_axis(y, m, inverse, pre=None):
    """K1 along axis -3 on a contiguous copy of its operand."""
    batch = y.shape[:-3]
    yb = y.reshape((-1,) + tuple(y.shape[-3:])).contiguous()
    out = nt.pease_stages(yb, nt._stage_twiddles_dev(m, inverse, y.device), pre=pre)
    return out.reshape(batch + tuple(out.shape[-3:]))


def _copied_core(x, inverse, top=True):
    """The four-step transform with every pass's operand materialised by
    torch (transposes, ``.contiguous()``, reshapes), K1 on contiguous
    (B, M, 8, NL) limbs: the layout the kernel took before it read
    strided views."""
    n = x.shape[-1]
    n2, n1 = nt._split(n)
    batch = tuple(x.shape[:-2])
    y = x.reshape(batch + (8, n2, n1)).transpose(-3, -2)  # (..., N2, 8, N1)
    if n2 <= nt.MAX_AXIS:
        y = _copied_axis(y, n2, inverse).transpose(-3, -1)
    else:
        y = _copied_core(y.transpose(-3, -1).contiguous(), inverse, top=False)
    y = _copied_axis(y, n1, inverse, pre=nt._mid_twiddles(n, inverse, inverse and top, x.device))
    return y.transpose(-3, -2).reshape(batch + (8, n))


def _kernels(fn):
    """The names of the device kernels that one call of ``fn`` launches."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.chip
@pytest.mark.parametrize("cols,t", [(28, 1 << 16), (28, 1 << 20)], ids=["2^16", "2^20"])
def test_class_ntt_launches_k1_alone_and_gives_the_copied_form_bytes(card, cols, t):
    x = _limbs((cols, 8, t), card, t + cols)
    base = f128.fmul(f128.DOMAIN_OFFSET, f128.get_root_of_unity(8 * t))
    scale = nt.premultiplier(base, t, card)
    got = nt.class_ntt_t(x, base, scale)  # builds the cached tables
    kernel_health.reset()
    names = _kernels(lambda: nt.class_ntt_t(x, base, scale))
    assert names and all(K1 in n for n in names), sorted(set(names))
    assert kernel_health.launches()["ntt_stages"] == len(names)
    want = _copied_core(nt.ladder_t_host(base, t, x=x), False)
    assert torch.equal(got, want)


@pytest.mark.chip
def test_coset_lde_2p23_launches_k1_and_the_padding_and_holds_three_buffers(card):
    t, cols = 1 << 20, 28
    coeffs = _limbs((cols, 8, t), card, 23)
    got = nt.coset_lde_t(coeffs, 8)  # builds the cached tables
    kernel_health.reset()
    names = _kernels(lambda: nt.coset_lde_t(coeffs, 8))
    others = sorted(n for n in names if K1 not in n)
    assert len(names) - len(others) == 3 == kernel_health.launches()["ntt_stages"]
    # the rest is the zero padding's fill and copy (torch splits each into
    # launches of 32-bit indexing), and nothing else
    assert others == sorted(_kernels(lambda: torch.nn.functional.pad(coeffs, (0, 7 * t)))), others
    del got
    torch.cuda.empty_cache()
    buffer = cols * 8 * 8 * t * 4
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    got = nt.coset_lde_t(coeffs, 8)
    held = torch.cuda.max_memory_allocated(card) - base
    assert held <= 3 * buffer + (64 << 20), held / 2**30  # padded input, output, one intermediate
    padded = torch.nn.functional.pad(nt.ladder_t_host(f128.DOMAIN_OFFSET, t, x=coeffs), (0, 7 * t))
    assert torch.equal(got, _copied_core(padded, False))
