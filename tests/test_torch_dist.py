"""zkvm_torch's sharded prover (``zkvm_torch.dist``) on the CPU: ranks
spawned over gloo by ``dist.multihost.spawn`` (a FileStore in a temporary
directory, a time limit on every run), held against the port's one-process
functions and the JAX package's sharded ones on ``make_mesh(P)`` (the
conftest gives JAX 8 virtual CPU devices).  Every comparison is exact.

* the collectives, and ``ntt_sharded`` / ``intt_sharded`` /
  ``coset_lde_sharded`` at P = 2 and 4 (four-step, one column a chunk, and
  N < P^2 gathered);
* ``merged_transition_sharded`` (K4 with a one-period halo) against K4's
  plain version over the whole domain;
* the sharded Merkle tree's root and paths;
* ``sharded_prove_step`` at P = 2 against P = 1 and against the
  one-process trace commitment (``-m slow``: against JAX's step);
* the full prove at world sizes 1, 2 and 4 (T = 128): every rank's bytes
  equal the conformance vector and the port's one-process mono and T-mode
  proofs, and the proof verifies; ``vm.prove(config=...with_mesh(2))``;
* a rank's default card (its place among the ranks on its host, also when
  the group comes from the ZKVM_* variables alone);
* what must raise: a mesh with another mode, no group, a rank that fails.

The spawned ranks run ``zkvm_torch.dist.run``'s programs, so they never
import this module (nor JAX).  Each world size is spawned once for all its
cases (``_results``).
"""

import functools
import json
import random
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_torch import vm
from zkvm_torch.air import periodic as tper
from zkvm_torch.air import transition as ttr
from zkvm_torch.dist import mesh as tmesh
from zkvm_torch.dist import multihost, run
from zkvm_torch.field.limbs import from_numpy, to_numpy
from zkvm_torch.hash import blake3_t as b3t
from zkvm_torch.hash import merkle as mk
from zkvm_torch.ntt import ntt_t as nt
from zkvm_torch.prover import pipeline as tpl

torch.set_num_threads(1)

VECTORS = Path(__file__).resolve().parents[1] / "conformance" / "vectors_e2e.json"
SPAWN_TIMEOUT = 240.0  # seconds for one spawned run of all a world size's cases
BLOWUP = 8


def _limbs(seed, shape):
    """Random canonical elements as uint32 limbs (..., 8, N): 16-bit limbs,
    the top one below 0xFFFF."""
    x = np.random.default_rng(seed).integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., 7, :] %= 0xFFFF
    return x


def _jax_layout(x):
    """(..., 8, N) -> (..., N, 8)."""
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, -1, -2)))


def _joined(blocks):
    """The ranks' (..., 8, L) blocks joined along the row axis."""
    return np.concatenate(blocks, axis=-1)


# ---------------------------------------------------------------------------
# the cases, run once per world size
# ---------------------------------------------------------------------------

VEC = json.loads(VECTORS.read_text())
# (P, N, blowup of the LDE, the transforms also held against JAX's; each
# costs seconds of XLA compile, the LDE's shares the forward one's)
NTT_CASES = [
    (2, 64, 8, ("ntt", "intt", "lde")), (4, 64, 8, ("ntt", "lde")),  # four-step
    (4, 16, 4, ()),  # four-step at N = P^2: one column a chunk
    (4, 8, 2, ("ntt",)), (2, 2, 1, ()),  # N < P^2: gathered
]
NTT_X = {(p, n): _limbs(100 + n + p, (2, 8, n)) for p, n, _, _ in NTT_CASES}
T_TR = 64  # the transition's trace length: D = 512, blocks of 256 and 128 rows
TAB = tper.periodic_table(T_TR, BLOWUP)  # (9, 8, 128)
TR_LDE = _limbs(7, (28, 8, T_TR * BLOWUP))
TR_ALPHAS = _limbs(8, (20, 8, 1))[..., 0]
DELTA = vm.DEMO_PARAMETERS.delta
FOREST_ROWS = _limbs(9, (4, 8, 512))
FOREST_POSITIONS = [0, 1, 127, 128, 255, 256, 300, 511]


def _step_cols():
    """The (28, T, 8) limbs of the ``push.1 push.2 add`` trace (T = 128)."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    trace = vm.run(vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key), use_native=False)
    return np.asarray(trace.as_limbs()), key.parameters.delta


def _calls(p):
    """(name, run-module program, its args) of every case at world size p."""
    out = [("comm", "comm_ops", ())]
    for q, n, blowup, _ in NTT_CASES:
        if q == p:
            out.append((("ntt", n), "ntt_blocks", (NTT_X[(p, n)], blowup)))
    if p > 1:
        out.append(("transition", "transition_block",
                    (TR_LDE, TAB[0], np.ascontiguousarray(TAB[1:]), TR_ALPHAS, DELTA, BLOWUP)))
        out.append(("forest", "forest", (FOREST_ROWS, FOREST_POSITIONS)))
    if p <= 2:
        out.append(("step", "sharded_prove_step", _step_cols()))
    out.append(("prove", "prove_program", (VEC["program_source"], VEC["public_inputs_tape"], (2,), 7, False)))
    if p == 2:
        out.append(("vm", "prove_program",
                    (VEC["program_source"], VEC["public_inputs_tape"], (2,), 7, False, True)))
    return out


@functools.lru_cache(maxsize=None)
def _results(p):
    """{case name: [each rank's result]} of one spawned run at world size p."""
    cases = _calls(p)
    per_rank = multihost.spawn(run.calls, p, "gloo", "cpu", args=([(f, a) for _, f, a in cases],),
                               timeout=SPAWN_TIMEOUT)
    return {name: [r[i] for r in per_rank] for i, (name, _, _) in enumerate(cases)}


@functools.lru_cache(maxsize=None)
def _one_process_proofs():
    """The port's one-process mono and T-mode proofs of the conformance
    program, as bytes."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program = vm.Program.compile(VEC["program_source"])
    inputs = vm.ProgramInputs(tuple(VEC["public_inputs_tape"]), (key.encrypt(2),), key)
    return {mode: vm.prove(program, inputs, device="cpu", mode=mode, use_native=False)[2].to_wire_bytes()
            for mode in ("mono", "tmode")}


# ---------------------------------------------------------------------------
# collectives and the sharded pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4])
def test_collectives(p):
    got = _results(p)["comm"]
    xs = [np.arange(3 * p, dtype=np.uint32)[None] + 100 * q for q in range(p)]
    for q, res in enumerate(got):
        want_a2a = np.concatenate([x[:, 3 * q:3 * q + 3] for x in xs], axis=-1)
        np.testing.assert_array_equal(res["all_to_all"], want_a2a)
        np.testing.assert_array_equal(res["all_gather"], np.concatenate(xs, axis=0))
        np.testing.assert_array_equal(res["shift_from_right"], xs[(q + 1) % p])
        np.testing.assert_array_equal(res["replicated"], np.concatenate(xs, axis=-1))


@pytest.mark.parametrize("p,n,blowup,jax_kinds", NTT_CASES, ids=[f"P{c[0]}-N{c[1]}" for c in NTT_CASES])
def test_ntt_sharded(p, n, blowup, jax_kinds):
    ranks = _results(p)[("ntt", n)]
    x = NTT_X[(p, n)]
    got = {k: _joined([r[k] for r in ranks]) for k in ("ntt", "intt", "lde")}
    coeffs = x[..., : n // blowup]
    np.testing.assert_array_equal(got["ntt"], to_numpy(nt.ntt_t(from_numpy(x))))
    np.testing.assert_array_equal(got["intt"], to_numpy(nt.intt_t(from_numpy(x))))
    np.testing.assert_array_equal(got["lde"], to_numpy(nt.coset_lde_t(from_numpy(coeffs), blowup)))
    four_step = (n // p) % p == 0
    want_calls = {"all_to_all": 9} if four_step else {"all_gather": 3}
    if four_step:
        want_calls["all_gather"] = 1  # the LDE's scaled coefficients
    else:
        want_calls["all_gather"] += 1
    assert ranks[0]["comm"]["calls"] == want_calls
    if jax_kinds:
        from zkvm.dist import coset_lde_sharded, intt_sharded, make_mesh, ntt_sharded

        m = make_mesh(p)
        jax_fns = {"ntt": lambda: ntt_sharded(_jax_layout(x), m), "intt": lambda: intt_sharded(_jax_layout(x), m),
                   "lde": lambda: coset_lde_sharded(_jax_layout(coeffs), blowup, m)}
        for name in jax_kinds:
            np.testing.assert_array_equal(np.swapaxes(np.asarray(jax_fns[name]()), -1, -2), got[name])


@pytest.mark.parametrize("max_axis", [nt.MAX_AXIS, 4, 2], ids=["fused", "recursing", "nested"])
def test_twiddles_premultiply_the_local_transform(monkeypatch, max_axis):
    """Rank q's twiddles w_N^(q n2) (and 1/P for the inverse) as K1's
    premultiplier, also where pass 1 recurses once or more (MAX_AXIS
    patched down; the inner transform's premultiplier and pass 2's mid
    twiddles carry them): equal to the plain product with the ladder, then
    the local transform."""
    from zkvm_torch.dist import ntt_dist
    from zkvm_torch.field import f128
    from zkvm_torch.field import f128t as ft

    monkeypatch.setattr(nt, "MAX_AXIS", max_axis)
    p, local = 4, 64
    y = from_numpy(_limbs(21, (2, 8, local)))
    for inverse in (False, True):
        w = f128.get_root_of_unity(p * local)
        w = f128.finv(w) if inverse else w
        for q in range(p):
            lad = nt.ladder_t_host(pow(w, q, f128.P), local, f128.finv(p) if inverse else 1)
            want = (nt.intt_t if inverse else nt.ntt_t)(ft.fmul(y, lad))
            got = ntt_dist._twiddled_transform(y, p * local, p, q, inverse)
            np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


@pytest.mark.parametrize("p", [2, 4])
def test_transition_sharded_equals_whole_domain(p):
    got = _joined(_results(p)["transition"])
    tab = from_numpy(TAB)
    want = ttr.merged_transition_plain(from_numpy(TR_LDE), tab[0], tab[1:], from_numpy(TR_ALPHAS), DELTA,
                                       BLOWUP)
    np.testing.assert_array_equal(got, to_numpy(want))


def test_transition_sharded_matches_jax():
    from zkvm.air.constraints_dist import merged_transition_sharded
    from zkvm.air.periodic import periodic_lde
    from zkvm.dist import make_mesh

    mask, ark = periodic_lde(T_TR, BLOWUP)
    want = merged_transition_sharded(_jax_layout(TR_LDE), BLOWUP, mask, ark, DELTA,
                                     jnp.asarray(np.ascontiguousarray(TR_ALPHAS)), make_mesh(2))
    np.testing.assert_array_equal(np.asarray(want).T, _joined(_results(2)["transition"]))


@pytest.mark.parametrize("p", [2, 4])
def test_forest_root_and_paths(p):
    from zkvm.dist import make_mesh
    from zkvm.hash import blake3_jax as b3j
    from zkvm.hash.merkle import ShardedMerkleTree as JaxShardedMerkleTree

    ranks = _results(p)["forest"]
    root, paths = ranks[0]
    assert all(r == (root, paths) for r in ranks)
    whole = mk.DeviceMerkleTree(mk.merkle_flat(b3t.hash_rows_t(from_numpy(FOREST_ROWS)).transpose(0, 1)))
    assert root == whole.root
    assert paths == whole.open_many(FOREST_POSITIONS)
    leaves = b3j.hash_rows(jnp.asarray(np.ascontiguousarray(np.moveaxis(FOREST_ROWS, -1, 0))))  # (N, 8)
    jtree = JaxShardedMerkleTree(b3j.merkle_forest_flat(leaves, make_mesh(p)), p)
    assert root == jtree.root
    assert paths == jtree.open_many(FOREST_POSITIONS)
    for pos, path in zip(FOREST_POSITIONS, paths):
        leaf = to_numpy(whole.nodes[whole.n + pos]).astype("<u4").tobytes()
        assert mk.MerkleTree.verify(root, pos, leaf, path)


def test_sharded_prove_step_equals_one_rank_and_trace_commit():
    """The step's three outputs at P = 2 equal P = 1's, and its trace
    digests are the one-process mono trace commitment's leaves."""
    from zkvm_torch.prover.mono import MonoStages

    one, two = _results(1)["step"], _results(2)["step"]
    for got in two + one[1:]:
        for a, b in zip(one[0], got):
            np.testing.assert_array_equal(a, b)
    trace_digests, comp_digests, folded = two[0]
    cols, _ = _step_cols()
    t = cols.shape[1]
    d = t * BLOWUP
    assert trace_digests.shape == comp_digests.shape == (d, 8) and folded.shape == (t, 8)
    _, nodes = MonoStages(t, BLOWUP, "cpu").trace_commit(from_numpy(np.swapaxes(cols, 1, 2)))
    np.testing.assert_array_equal(to_numpy(nodes[d:]), trace_digests)


@pytest.mark.slow  # the JAX step's CPU compile takes minutes
def test_sharded_prove_step_matches_jax():
    from zkvm.dist import make_mesh, sharded_prove_step

    cols, delta = _step_cols()
    for a, b in zip(sharded_prove_step(make_mesh(2), cols, delta), _results(2)["step"][0]):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the prover over a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_prove_bytes_at_every_world_size(p):
    ranks = _results(p)["prove"]
    want = VEC["proof_bytes_hex"]
    one = _one_process_proofs()
    for r in ranks:
        assert r["proof"].hex() == want
        assert r["proof"] == one["mono"] == one["tmode"]
    first = ranks[0]
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    vm.verify_bytes(first["proof"], first["program_hash"], first["outputs"], key)
    calls = first["comm"]["calls"]
    # 4 sharded transforms of 3 exchanges; K4's halo; the gathers of the
    # two LDEs' coefficients, the OOD coefficients, Y, the roots, the paths
    # and the query rows
    assert calls.get("all_to_all") == 12 and calls.get("all_gather") == 11
    assert calls.get("shift_from_right", 0) == (1 if p > 1 else 0)
    assert first["comm"]["host_staged_bytes"] == 0  # CPU tensors stage nothing


def test_vm_prove_with_mesh_config():
    ranks = _results(2)["vm"]
    for r in ranks:
        assert r["proof"].hex() == VEC["proof_bytes_hex"]
    assert ranks[0]["comm"]["calls"].get("all_to_all") == 12


def test_vm_prove_reads_the_config():
    """Without a mesh: the config's seed and trace generator reach the
    prove (``zkvm/vm.py:29-62``), options given explicitly win."""
    from dataclasses import replace

    from zkvm_torch.config import ZkVmConfig

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program, inputs = vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)
    base = ZkVmConfig()
    python_trace = replace(base, runtime=replace(base.runtime, use_native_trace=False))
    seeded = replace(python_trace, runtime=replace(python_trace.runtime, seed=5))
    prove = lambda **kw: vm.prove(program, inputs, device="cpu", mode="mono", **kw)[2]
    default = prove(use_native=False).to_wire_bytes()
    assert prove(config=python_trace).to_wire_bytes() == default
    other = prove(config=seeded)
    assert other.to_wire_bytes() != default
    vm.verify(other, program.hash, vm.run(program, inputs, False, 5).outputs, key)


def test_vm_prove_mesh_config_needs_a_group():
    from zkvm_torch.config import RuntimeConfig, ZkVmConfig

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program, inputs = vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        vm.prove(program, inputs, device="cpu", config=ZkVmConfig().with_mesh(2))
    from zkvm_torch.utils.profiler import profiler

    profiled = ZkVmConfig(runtime=RuntimeConfig(profile=True)).with_mesh(2)
    try:
        with pytest.raises(RuntimeError, match="no torch.distributed process group"):
            vm.prove(program, inputs, device="cpu", config=profiled)
    finally:
        profiler.disable()


def test_mesh_means_mono_and_limits_per_rank(monkeypatch):
    from zkvm_torch.prover import limits

    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(7))
    program, inputs = vm.Program.compile("push.1\npush.2\nadd"), vm.ProgramInputs((), (), key)
    trace = vm.run(program, inputs, use_native=False)
    pub = vm.PublicInputs(program.hash, trace.outputs, key)
    mesh = tmesh.Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for mode in ("tmode", "cls"):
        with pytest.raises(ValueError, match="sharded prover is mono"):
            tpl.prove(trace, pub, mesh=mesh, mode=mode)
    with pytest.raises(ValueError, match="differs from the mesh"):
        tpl.prove(trace, pub, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="power of two"):
        tpl.prove(trace, pub, mesh=tmesh.Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo"))
    # the limit is per rank: T <= MONO_RANK_MAX_TRACE_LENGTH * P
    t = trace.length
    monkeypatch.setattr(limits, "MONO_RANK_MAX_TRACE_LENGTH", t // 4)
    with pytest.raises(ValueError, match=f"mono: trace length {t} > {t // 2} is not supported"):
        tpl.prove(trace, pub, mesh=mesh)


def test_mesh_rows():
    m = tmesh.Mesh(rank=1, size=4, device=torch.device("cpu"), backend="gloo")
    assert m.rows(64) == slice(16, 32)
    with pytest.raises(ValueError, match="do not split"):
        m.rows(6)
    x = torch.arange(64).reshape(1, 64)
    assert torch.equal(tmesh.row_block(m, x), x[:, 16:32])


def test_make_mesh_needs_a_group_and_distinct_cards():
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_mesh(2)
    tmesh.check_distinct_devices([(1, 0), (1, 1), (2, 0)])
    with pytest.raises(ValueError, match="ranks 0 and 2 share cuda:1 on one host.*gloo"):
        tmesh.check_distinct_devices([(5, 1), (5, 0), (5, 1)])


def test_default_card_is_the_rank_on_its_host():
    """Without LOCAL_RANK: a rank's card is its place among the ranks on
    its host, so two hosts of one card each both take cuda:0; NCCL ranks
    past a host's cards raise naming gloo, gloo ranks share."""
    assert tmesh.local_ranks([7, 9]) == [0, 0]
    assert tmesh.local_ranks([7, 7, 9, 9, 7]) == [0, 1, 0, 1, 2]
    assert [tmesh.default_card("nccl", r, loc, 1) for r, loc in enumerate(tmesh.local_ranks([7, 9]))] == [0, 0]
    assert [tmesh.default_card("nccl", r, r, 4) for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="rank 1 is rank 1 on its host, which has 1 card.*gloo"):
        tmesh.default_card("nccl", 1, 1, 1)
    assert [tmesh.default_card("gloo", r, r, 2) for r in range(4)] == [0, 1, 0, 1]


def test_initialize_from_env_derives_the_local_rank(tmp_path):
    """Two ranks joined by ``multihost.initialize`` from ZKVM_COORDINATOR,
    ZKVM_NUM_PROCESSES and ZKVM_PROCESS_ID alone (LOCAL_RANK unset), on
    one host: local ranks 0 and 1, and each rank's default device a card
    (none here, so the prove would raise rather than move to the CPU)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    envs = [{"ZKVM_COORDINATOR": f"localhost:{port}", "ZKVM_NUM_PROCESSES": "2", "ZKVM_PROCESS_ID": str(r),
             "GLOO_SOCKET_IFNAME": "lo"} for r in range(2)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run.join_from_env, args=(envs[r], str(tmp_path)), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    got = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(2)]
    assert [(g["rank"], g["local_rank"]) for g in got] == [(0, 0), (1, 1)]
    assert all(g["device"] == "cuda" for g in got)


def test_initialize_reads_all_three_or_none(monkeypatch):
    for name in ("ZKVM_COORDINATOR", "ZKVM_NUM_PROCESSES", "ZKVM_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("ZKVM_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="missing ZKVM_COORDINATOR, ZKVM_PROCESS_ID"):
        multihost.initialize()


def test_a_failing_rank_fails_the_run_in_time():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 3 failed.*fails on purpose"):
        multihost.spawn(run.fail_on_rank, 3, "gloo", "cpu", args=(1,), timeout=60.0)
    assert time.monotonic() - t0 < 60.0
