"""zkvm_torch prover components against the JAX reference: multi-point
evaluation and the FRI fold (exact equality on inputs from numpy seeds),
and the copied host modules against their originals."""

import random
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm.field import f128
from zkvm_torch.field.limbs import from_numpy, to_limbs, to_numpy
from zkvm_torch.ntt import ntt_t as tnt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _vals(seed, shape):
    rng = np.random.default_rng(seed)
    hi, lo = rng.integers(0, 2**63, size=(2,) + tuple(shape), dtype=np.int64)
    return (hi.astype(object) << 64 | lo.astype(object)) % f128.P


def _t(vals):
    """(..., n) ints -> (..., 8, n) uint32 limbs."""
    return np.ascontiguousarray(np.swapaxes(to_limbs(vals), -1, -2))


def test_multi_eval_matches_reference():
    from zkvm.prover import eval_mxu as em
    from zkvm_torch.prover import multi_eval as tme

    coeffs = _t(_vals(1, (4, 32)))
    pts = [int(v) for v in _vals(2, (3,))]
    want = em.multi_eval_rows(jnp.asarray(coeffs), pts)
    assert tme.multi_eval_rows(from_numpy(coeffs), pts) == want


def test_multi_eval_pairs_match_reference(monkeypatch):
    """Past the chunk threshold (patched to T = 32 here) the points go in
    pairs, as the reference's do past 2^18: the same rows as one call."""
    from zkvm.prover import eval_mxu as em
    from zkvm_torch.prover import limits
    from zkvm_torch.prover import multi_eval as tme

    coeffs = _t(_vals(1, (4, 32)))
    pts = [int(v) for v in _vals(2, (3,))]  # a pair and a single point
    want = em.multi_eval_rows(jnp.asarray(coeffs), pts)
    monkeypatch.setattr(limits, "CHUNK_T", 32)
    calls = []
    contract = tme._contract
    monkeypatch.setattr(tme, "_contract", lambda c, l: calls.append(l.shape[0]) or contract(c, l))
    assert tme.multi_eval_rows(from_numpy(coeffs), pts) == want
    assert calls == [2, 1]
    # the ladders of T > 256 lanes, from factors built once for all points
    lad = tnt.ladders_t(from_numpy(to_limbs(pts)), 1024)
    l1, l2 = tnt.ladders_split(from_numpy(to_limbs(pts)), 1024)
    joined = torch.cat([tnt.ladders_join(l1[i:i + 2], l2[i:i + 2]) for i in (0, 2)])
    np.testing.assert_array_equal(to_numpy(joined), to_numpy(lad))


def test_fri_fold_matches_reference():
    from zkvm.prover import fri as jfri
    from zkvm_torch.prover import fri as tfri

    groups = _t(_vals(5, (tfri.FOLD, 64)))  # (FOLD, 8, L)
    q = _t(_vals(6, (64,)))  # (8, L)
    want = jfri._fold_core_t(jnp.asarray(groups), jnp.asarray(q))
    got = tfri._fold_core_t_plain(from_numpy(groups), from_numpy(q))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # the verifier-side fold of one opened group agrees with the device fold
    beta, offset, d = 12345, f128.DOMAIN_OFFSET, tfri.FOLD * 64
    w_d = f128.get_root_of_unity(d)
    scale = f128.fmul(beta, f128.finv(offset))
    q_t = tnt.ladder_t_host(f128.finv(w_d), d // tfri.FOLD, scale)
    folded = tfri.fold_t(from_numpy(groups), scale, f128.finv(w_d))
    np.testing.assert_array_equal(to_numpy(folded), to_numpy(tfri._fold_core_t_plain(from_numpy(groups), q_t)))
    from zkvm_torch.field.limbs import from_t

    j = 9
    group = [int(v) for v in from_t(groups)[:, j]]
    assert tfri.fold_group_values(group, j, d, beta, offset) == int(from_t(to_numpy(folded))[j])


def _code_lines(path, strip_header):
    lines = Path(path).read_text().splitlines()
    if strip_header:
        while lines[0].startswith("#"):
            lines.pop(0)
    return lines


# The copies of the JAX package's host modules in zkvm_torch/ (the port
# imports nothing of zkvm), as (original, copy) under zkvm/ and zkvm_torch/;
# the example's originals lie outside zkvm/.
_COPIES = [(f"prover/{m}.py",) * 2 for m in ("options", "proof", "transcript", "wire")] + [
    (m, m) for m in (
        "config.py", "verifier/verifier.py", "field/f128.py", "hash/blake3.py", "hash/rescue.py",
        "air/layout.py", "air/constraints_golden.py", "ntt/golden.py", "utils/serde.py",
        "fhe/__init__.py", "fhe/lwe.py", "isa/__init__.py", "isa/opcodes.py", "isa/program.py",
        "processor/__init__.py", "processor/golden.py",
        "runtime/__init__.py", "runtime/native.py", "runtime/csrc/trace_gen.cpp",
    )
] + [(f"../examples/linear_regression/{m}", f"examples/linear_regression/{m}")
     for m in ("protocol.py", "main.py", "lr.txt")]

# The named deviations, per copy: (lines of the original, lines of the copy).
_DEVIATIONS = {
    # the limb conversions come from zkvm_torch.field.limbs, not jax_f128
    "processor/golden.py": [
        ([f"            from zkvm.field.jax_f128 import {f}"],
         [f"            from zkvm_torch.field.limbs import {f}"])
        for f in ("to_limbs", "from_limbs")
    ],
    "runtime/native.py": [
        # to_limbs from zkvm_torch.field.limbs, not jax_f128
        (["from zkvm.field.jax_f128 import to_limbs"], ["from zkvm_torch.field.limbs import to_limbs"]),
        # the library is built under zkvm_torch/build/ (git-ignored)
        (['_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")'],
         ['_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")']),
        # g++ links to a temporary name that is renamed into place, so
        # processes that build at once never load a half-written library
        (['    try:',
          '        subprocess.run(',
          '            ["g++", "-O3", "-shared", "-fPIC", _CSRC, "-o", _SO],'],
         ['    tmp = f"{_SO}.{os.getpid()}.tmp"',
          '    try:',
          '        subprocess.run(',
          '            ["g++", "-O3", "-shared", "-fPIC", _CSRC, "-o", tmp],']),
        (['        return True'], ['        os.replace(tmp, _SO)', '        return True']),
    ],
    # run as a module of the port, on the device the caller names
    "examples/linear_regression/main.py": [
        (["Run from the repo root:  python examples/linear_regression/main.py"],
         ["Run from the repo root:  python -m zkvm_torch.examples.linear_regression.main [cpu]"]),
        (['sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))'],
         ['sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))']),
        (["from examples.linear_regression.protocol import InputData, OutputData", "from zkvm import vm"],
         ["from zkvm_torch.examples.linear_regression.protocol import InputData, OutputData",
          "from zkvm_torch import vm"]),
        (["def server_prove(input_bytes: bytes) -> bytes:"],
         ['def server_prove(input_bytes: bytes, device="cuda") -> bytes:']),
        (["    hash_, output, proof = vm.prove(program, inputs)"],
         ["    hash_, output, proof = vm.prove(program, inputs, device=device)"]),
        (["def main():"], ['def main(device="cuda"):']),
        (["    output_bytes = server_prove(input_bytes)"], ["    output_bytes = server_prove(input_bytes, device)"]),
        (["    main()"], ["    main(*sys.argv[1:])"]),
    ],
}


def _apply(lines, old, new):
    hits = [i for i in range(len(lines)) if lines[i:i + len(old)] == old]
    assert len(hits) == 1, old[0]
    return lines[: hits[0]] + new + lines[hits[0] + len(old):]


@pytest.mark.parametrize("orig,copy", _COPIES, ids=[c for _, c in _COPIES])
def test_copied_host_modules_equal_originals(orig, copy):
    """Each copy is its original with only import lines rewritten from
    zkvm.* to zkvm_torch.* (below a comment header; the C++ source and
    lr.txt have none), apart from the named deviations."""
    a = _code_lines(REPO / "zkvm" / orig, False)
    b = _code_lines(REPO / "zkvm_torch" / copy, copy.endswith(".py"))
    for old, new in _DEVIATIONS.get(copy, []):
        a = _apply(a, old, new)
    assert len(a) == len(b), copy
    for la, lb in zip(a, b):
        if la != lb:
            assert lb.lstrip().startswith(("from ", "import ")), (copy, lb)
            assert lb.replace("zkvm_torch.", "zkvm.") == la, (copy, lb)


def test_copied_merkle_tree_equals_original():
    """zkvm_torch/hash/merkle.py ends with zkvm/hash/merkle.py's host
    MerkleTree, word for word."""
    a = (REPO / "zkvm/hash/merkle.py").read_text()
    b = (REPO / "zkvm_torch/hash/merkle.py").read_text()
    assert b[b.index("class MerkleTree:"):] == a[a.index("class MerkleTree:"):]


def test_limb_conversions_equal_jax_f128():
    """The processor copy's deviation: zkvm_torch.field.limbs gives the
    arrays jax_f128 gives, for values, for a trace and back."""
    from zkvm.field import jax_f128 as jf
    from zkvm.processor import ExecutionTrace as JaxTrace
    from zkvm.processor import Processor as JaxProcessor
    from zkvm_torch import vm
    from zkvm_torch.field import limbs
    from zkvm_torch.processor import ExecutionTrace, Processor

    vals = [int(v) for v in _vals(7, (40,))] + [0, 1, f128.P - 1, f128.P, 2**128 - 1]
    np.testing.assert_array_equal(limbs.to_limbs(vals), jf.to_limbs(vals))
    arr = jf.to_limbs(vals)
    assert list(limbs.from_limbs(arr)) == list(jf.from_limbs(arr))
    assert limbs.from_limbs(arr[3]) == jf.from_limbs(arr[3])

    import zkvm.isa

    source = "\n".join(["read"] + ["read", "add"] * 19)
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(1))
    port = Processor.run(vm.Program.compile(source), vm.ProgramInputs((1,) * 22, (), key)).trace(seed=vm.DEFAULT_SEED)
    jax_inputs = zkvm.isa.ProgramInputs((1,) * 22, (), key)
    jax_trace = JaxProcessor.run(zkvm.isa.Program.compile(source), jax_inputs).trace(seed=vm.DEFAULT_SEED)
    np.testing.assert_array_equal(port.as_limbs(), jax_trace.as_limbs())
    cols = ExecutionTrace(None, port.program_hash, port.outputs, limbs=port.as_limbs())._materialize_columns()
    want = JaxTrace(None, port.program_hash, port.outputs, limbs=port.as_limbs())._materialize_columns()
    assert cols == want == port.columns


def test_program_hash_equals_reference_past_256_ops():
    """A program of 256 ops or more (hashed by the port's native fast
    path) hashes to the reference's digest."""
    import zkvm.isa
    from zkvm_torch.isa import Program

    source = "\n".join(["push.1"] + ["push.2", "add"] * 150)
    assert Program.compile(source).hash == zkvm.isa.Program.compile(source).hash
