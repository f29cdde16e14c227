"""The per-class composition value: merged transition constraints, the
domain factor and the boundary groups, over (28, 8, T) limbs.

Port of ``zkvm.air.constraints_pallas`` (``merged_transition_t``,
``composition_body_t``, ``composition_t``) and of the MDS constants of
``zkvm.hash.rescue_jax``.  :func:`merged_transition_t` is also the plain
version of kernel K4 (:mod:`zkvm_torch.air.transition`).  :func:`composition_t` is kernel K3
(``csrc/composition.cu``) for CUDA tensors and :func:`composition_body_t`
in plain PyTorch for CPU tensors.  Unlike the reference, it takes the
periodic columns as their 16-step patterns (8, 16) / (8, 8, 16): the kernel
reads them at n % 16 and the plain version tiles them.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from zkvm_torch.air.constraints_golden import LWE_SIZE
from zkvm_torch.air.layout import Columns
from zkvm_torch.hash import rescue
from zkvm_torch import kernels
from zkvm_torch.field import f128, f128t as ft
from zkvm_torch.field.limbs import from_numpy, to_limbs

# (4, 4, 8) limbs-last MDS and inverse-MDS matrices (rescue_jax.mds_limbs)
MDS_LIMBS = to_limbs([[rescue.MDS[i * 4 + j] for j in range(4)] for i in range(4)])
INV_MDS_LIMBS = to_limbs([[rescue.INV_MDS[i * 4 + j] for j in range(4)] for i in range(4)])

# selector bit patterns b0..b4 (b0 = MSB): 1 -> bit, 0 -> (1 - bit)
_SEL = {
    "add": (0, 1, 0, 0, 0),
    "sadd": (0, 1, 0, 1, 0),
    "add2": (0, 1, 0, 1, 1),
    "mul": (0, 1, 0, 0, 1),
    "smul": (0, 1, 1, 0, 0),
    "push": (1, 0, 0, 0, 0),
    "read": (1, 0, 0, 0, 1),
    "read2": (1, 0, 0, 1, 0),
    "noop": (0, 0, 0, 0, 0),
}


def _selectors(bits, one):
    nb = [ft.fsub_plain(one, b) for b in bits]
    out = {}
    for name, pattern in _SEL.items():
        ops = [bits[i] if pattern[i] else nb[i] for i in range(5)]
        pair01, pair23 = ft.fmul_plain(ops[0], ops[1]), ft.fmul_plain(ops[2], ops[3])
        out[name] = ft.fmul_plain(ft.fmul_plain(pair01, pair23), ops[4])
    return out


def _sbox(state):
    return ft.fmul_plain(ft.fmul_plain(state, state), state)


def _mds(mat, state):
    """(4, 4, 8) matrix x (4, 8, N) state -> (4, 8, N)."""
    return ft.fsum_plain(ft.fmul_plain(mat[..., None], state[None]), axis=1)


def merged_transition_t(cur, nxt, mask, ark, mds, inv_mds, alphas, delta):
    """sum_k alpha_k * gate_k * C_k as (8, N); cur/nxt (28, 8, N), mask
    (8, N), ark (8, 8, N), mds/inv_mds (4, 4, 8), alphas (20, 8), delta a
    host int.  The yardstick of K3 and K4, so in the plain arithmetic."""
    n = cur.shape[-1]
    dev = cur.device
    one = ft.ones(n, dev)
    const = lambda v: ft.const_col(v, dev)
    s = lambda i: cur[Columns.STACK + i]
    sn = lambda i: nxt[Columns.STACK + i]
    bits = [cur[5], cur[4], cur[3], cur[2], cur[1]]  # b0 = MSB
    f = _selectors(bits, one)
    shr, shl = bits[0], bits[1]

    exprs, gates = [None] * 20, [None] * 20
    exprs[0] = ft.fsub_plain(nxt[Columns.CLK], ft.fadd_plain(cur[Columns.CLK], one))
    gates[0] = one
    four = const(4)
    depth = ft.fadd_plain(ft.fsub_plain(ft.fsub_plain(nxt[Columns.DEPTH], cur[Columns.DEPTH]), shr), shl)
    depth = ft.fsub_plain(depth, ft.fmul_plain(f["read2"], four))
    exprs[1] = ft.fadd_plain(depth, ft.fmul_plain(f["add2"], four))
    gates[1] = one
    exprs[2] = ft.fmul_plain(shr, shl)
    gates[2] = one
    exprs[3] = ft.fsub_plain(sn(0), ft.fadd_plain(s(0), s(1)))
    gates[3] = f["add"]
    stack = Columns.STACK
    sn04 = ft.fsum_plain(nxt[stack : stack + LWE_SIZE], axis=0)
    s15 = ft.fsum_plain(cur[stack + 1 : stack + 1 + LWE_SIZE], axis=0)
    exprs[4] = ft.fsub_plain(ft.fsub_plain(sn04, s15), ft.fmul_plain(const(delta), s(0)))
    gates[4] = f["sadd"]
    s04 = ft.fsum_plain(cur[stack : stack + LWE_SIZE], axis=0)
    s59 = ft.fsum_plain(cur[stack + LWE_SIZE : stack + 2 * LWE_SIZE], axis=0)
    exprs[5] = ft.fsub_plain(ft.fsub_plain(sn04, s04), s59)
    gates[5] = f["add2"]
    exprs[6] = ft.fsub_plain(sn(0), ft.fmul_plain(s(0), s(1)))
    gates[6] = f["mul"]
    exprs[7] = ft.fsub_plain(sn04, ft.fmul_plain(s(0), s15))
    gates[7] = f["smul"]
    for k, (name, tgt) in enumerate(
        [("push", sn(1)), ("read", sn(1)), ("read2", sn(LWE_SIZE)), ("noop", sn(0))]
    ):
        exprs[8 + k] = ft.fsub_plain(tgt, s(0))
        gates[8 + k] = f[name]

    # 12-15: hash round, meeting in the middle
    h0 = cur[Columns.HFLAG]
    state = torch.stack([cur[c] for c in Columns.HASH], dim=0)  # (4, 8, N)
    step0 = ft.fadd_plain(_mds(mds, _sbox(state)), ark[0:4])
    opcode = None
    for w, b in zip([16, 8, 4, 2, 1], bits):
        term = ft.fmul_plain(const(w), b)
        opcode = term if opcode is None else ft.fadd_plain(opcode, term)
    inj0 = ft.fadd_plain(step0[0], opcode)
    inj1 = ft.fadd_plain(step0[1], ft.fmul_plain(sn(0), f["push"]))
    step0 = torch.cat([inj0[None], inj1[None], step0[2:]], dim=0)
    state_n = torch.stack([nxt[c] for c in Columns.HASH], dim=0)
    step1 = _sbox(_mds(inv_mds, ft.fsub_plain(state_n, ark[4:8])))
    diff = ft.fsub_plain(step1, step0)
    gate = ft.fmul_plain(mask, h0)
    for i in range(4):
        exprs[12 + i] = diff[i]
        gates[12 + i] = gate
    # 16-19: hash copy / capacity reset
    ngate = ft.fmul_plain(ft.fsub_plain(one, mask), h0)
    exprs[16] = ft.fsub_plain(nxt[Columns.HASH[0]], cur[Columns.HASH[0]])
    exprs[17] = ft.fsub_plain(nxt[Columns.HASH[1]], cur[Columns.HASH[1]])
    exprs[18] = nxt[Columns.HASH[2]]
    exprs[19] = nxt[Columns.HASH[3]]
    for i in range(4):
        gates[16 + i] = ngate

    acc = None
    for e, g, al in zip(exprs, gates, alphas):
        term = ft.fmul_plain(ft.fmul_plain(e, g), al[:, None])
        acc = term if acc is None else ft.fadd_plain(acc, term)
    return acc


def boundary_group(cur, cols, bvals, bbetas, arith=ft.DISPATCH):
    """sum_j (cur[cols_j] - bvals_j) * bbetas_j as (8, N); cur (28, 8, N),
    bvals/bbetas (k, 8).  One column at a time, so the limb products never
    span more than one (8, N) column.  ``arith``: the plain operations in
    K3's plain version, the dispatching ones on the provers' paths."""
    acc = torch.zeros_like(cur[0])
    for slot, c in enumerate(cols):
        term = arith.fmul(arith.fsub(cur[c], bvals[slot][:, None]), bbetas[slot][:, None])
        acc = arith.fadd(acc, term)
    return acc


def composition_body_t(cur, nxt, mask, ark, ee, i0, i1, mds, inv_mds, alphas,
                       bvals0, bbetas0, bvals1, bbetas1, delta, bcols0, bcols1):
    """Per-class composition value (8, N), plain PyTorch: the merged
    transition value x ee, plus boundary group 0 x i0 and group 1 x i1."""
    q = ft.fmul_plain(merged_transition_t(cur, nxt, mask, ark, mds, inv_mds, alphas, delta), ee)
    q = ft.fadd_plain(q, ft.fmul_plain(boundary_group(cur, bcols0, bvals0, bbetas0, ft.PLAIN), i0))
    return ft.fadd_plain(q, ft.fmul_plain(boundary_group(cur, bcols1, bvals1, bbetas1, ft.PLAIN), i1))


# ---------------------------------------------------------------------------
# kernel K3
# ---------------------------------------------------------------------------

launches = 0  # launches of the CUDA kernel in this process
launches_by_shape = collections.Counter()  # the same, by T
MAX_BOUNDARY = 16  # boundary columns per group that the kernel's arguments hold


@functools.lru_cache(maxsize=None)
def mds_dev(device) -> torch.Tensor:
    """(32, 8) limbs on ``device``: the MDS then the inverse-MDS matrix,
    row-major, built once per device (K3 and K4 read it)."""
    return from_numpy(np.concatenate([MDS_LIMBS.reshape(16, 8), INV_MDS_LIMBS.reshape(16, 8)]), device)


def mds_pair(device):
    """The cached MDS and inverse-MDS matrices as two (4, 4, 8) views."""
    m = mds_dev(device)
    return m[:16].view(4, 4, 8), m[16:].view(4, 4, 8)


def delta_words(delta: int):
    """delta mod p as the two 64-bit words the C entries take by value."""
    d = delta % f128.P
    return d & (2**64 - 1), d >> 64


def _columns(cols, group: str):
    """A boundary group's column indices as a host int array for the C
    entry, which copies them into the kernel's arguments."""
    if len(cols) > MAX_BOUNDARY:
        raise ValueError(f"composition: {len(cols)} boundary columns in {group}, at most {MAX_BOUNDARY}")
    return (ctypes.c_int * len(cols))(*cols)


def composition_plain(cur_t, mask_pat, ark_pat, ee_t, i0_t, i1_t, alphas,
                      bv0, bb0, bv1, bb1, delta, bcols0, bcols1) -> torch.Tensor:
    """Plain version of K3 (same arguments as :func:`composition_t`): the
    next rows by a cyclic roll, the periodic patterns tiled to T."""
    t = cur_t.shape[-1]
    dev = cur_t.device
    return composition_body_t(
        cur_t, torch.roll(cur_t, -1, dims=-1), mask_pat.repeat(1, t // 16),
        ark_pat.repeat(1, 1, t // 16), ee_t, i0_t, i1_t, *mds_pair(dev),
        alphas, bv0, bb0, bv1, bb1, delta, bcols0, bcols1,
    )


def launch_composition(lib, stream, cur_t, mask_pat, ark_pat, ee_t, i0_t, i1_t, alphas,
                       bv0, bb0, bv1, bb1, delta, bcols0, bcols1) -> torch.Tensor:
    """Call the K3 entry point of ``lib``; all limb tensors contiguous int32
    on one device.  It copies nothing to the device (the matrices are
    cached per device, delta and the columns go by value), so it never
    waits for the stream."""
    dev = cur_t.device
    t = cur_t.shape[-1]
    k0, k1 = len(bcols0), len(bcols1)
    for name, tns, shape in [
        ("cur", cur_t, (28, 8, t)), ("mask", mask_pat, (8, 16)), ("ark", ark_pat, (8, 8, 16)),
        ("ee", ee_t, (8, t)), ("i0", i0_t, (8, t)), ("i1", i1_t, (8, t)),
        ("alphas", alphas, (20, 8)), ("bv0", bv0, (k0, 8)), ("bb0", bb0, (k0, 8)),
        ("bv1", bv1, (k1, 8)), ("bb1", bb1, (k1, 8)),
    ]:
        kernels.expect(tns, shape, dev, name)
    bc0, bc1 = _columns(bcols0, "group 0"), _columns(bcols1, "group 1")
    out = torch.empty((8, t), dtype=torch.int32, device=dev)
    p = kernels.ptr
    rc = lib.zk_composition(
        p(cur_t), p(mask_pat), p(ark_pat), p(ee_t), p(i0_t), p(i1_t), p(mds_dev(dev)), p(alphas),
        *delta_words(delta), p(bv0), p(bb0), bc0, k0, p(bv1), p(bb1), bc1, k1, p(out), t, stream,
    )
    kernels.check(rc, "zk_composition")
    return out


def composition_t(cur_t, mask_pat, ark_pat, ee_t, i0_t, i1_t, alphas,
                  bv0, bb0, bv1, bb1, delta, bcols0, bcols1) -> torch.Tensor:
    """K3: one blowup class's composition values (8, T).

    cur_t (28, 8, T) class LDE (the next row is the next index, cyclic);
    mask_pat (8, 16) and ark_pat (8, 8, 16) periodic patterns; ee/i0/i1
    (8, T) domain constants; alphas (20, 8); bv*/bb* (k, 8) boundary values
    and coefficients; delta a host int; bcols* the boundary column tuples.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    global launches
    args = (cur_t, mask_pat, ark_pat, ee_t, i0_t, i1_t, alphas, bv0, bb0, bv1, bb1)
    if cur_t.device.type == "cpu":
        return composition_plain(*args, delta, bcols0, bcols1)
    if cur_t.device.type != "cuda":
        raise ValueError(f"composition: no kernel for device {cur_t.device}")
    out = launch_composition(
        kernels.lib(), kernels.stream_of(cur_t), *(a.contiguous() for a in args),
        delta, bcols0, bcols1,
    )
    launches += 1
    launches_by_shape[cur_t.shape[-1]] += 1
    return out
