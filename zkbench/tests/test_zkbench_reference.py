"""The reference's trace and trace commitment against the plain host
definitions and against the port, on the CPU."""

import random

import numpy as np
import pytest
import torch

from zkbench import traffic as tf
from zkbench.reference import blake3, commitment as cm, execution as ex, f128, machine, ntt as golden, program

P = f128.P
EDGES = [0, 1, 2, P - 1, P - 2, 2**128 - P + 5, 2**127, 2**64 - 1, 45 * 2**40, P // 2]


def _t(values):
    return torch.from_numpy(ex.limbs(values).astype(np.int64)).T.contiguous()


def _v(t):
    return [ex.element(r) for r in t.T.numpy().astype(np.uint16)]


def test_field_arithmetic_is_exact():
    rng = random.Random(5)
    a = EDGES + [rng.randrange(P) for _ in range(2000)]
    b = EDGES[::-1] + [rng.randrange(P) for _ in range(2000)]
    ta, tb = _t(a), _t(b)
    assert _v(cm.mul(ta, tb)) == [x * y % P for x, y in zip(a, b)]
    assert _v(cm.mul(ta, ta)) == [x * x % P for x in a]
    assert _v(cm.add(ta, tb)) == [(x + y) % P for x, y in zip(a, b)]
    assert _v(cm.sub(ta, tb)) == [(x - y) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_ntt_matches_the_golden_one(n):
    vals = [random.Random(n).randrange(P) for _ in range(n)]
    assert _v(cm.ntt(_t(vals)[:, None], f128.get_root_of_unity(n))[:, 0]) == golden.ntt(vals)


def test_lde_matches_the_golden_coset_extension():
    rng = random.Random(7)
    cols = [[rng.randrange(P) for _ in range(32)] for _ in range(3)]
    got = cm.lde(torch.stack([_t(c) for c in cols], 1), 8)
    for i, c in enumerate(cols):
        assert _v(got[:, i]) == golden.coset_lde(golden.intt(c), 8)


def test_row_hashes_and_merkle_root_match_plain_blake3():
    rng = random.Random(9)
    rows = [[rng.randrange(P) for _ in range(28)] for _ in range(8)]
    limbs = torch.from_numpy(np.stack([ex.limbs(r) for r in rows]).astype(np.int64)).permute(2, 0, 1)
    digests = cm.hash_rows(cm._words(limbs).permute(1, 2, 0).reshape(8, 112))
    got = [np.asarray(d, dtype="<u4").tobytes() for d in digests.numpy()]
    assert got == [blake3.hash_elements(r) for r in rows]
    level = got
    while len(level) > 1:
        level = [blake3.merge(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    assert cm.merkle_root(digests) == level[0]


@pytest.mark.parametrize("body", [["read", "add"], ["read2", "read", "smul", "add2"]])
def test_the_trace_is_the_ports(body):
    from zkvm_torch.fhe import FheUInt8, LweParameters, ServerKey
    from zkvm_torch.isa import Program, ProgramInputs
    from zkvm_torch.processor import Processor

    cfg = dict(tf.load_json("configs", "lr_enc_2p20"), program={"head": ["read2", "read", "smul"], "body": body,
                                                                "tail": ["read", "sadd"], "terms": 6})
    key = tf.secret_key(cfg, 11)
    inp = tf.trace_inputs(cfg, key, 11, 0, 0)
    lwe = cfg["lwe"]
    server_key = ServerKey.from_key(key, LweParameters(lwe["plaintext_modulus"], lwe["ciphertext_modulus"],
                                                       lwe["k"], lwe["std"]))
    prog = Program.compile(tf.program_source(cfg))
    port = Processor.run(prog, ProgramInputs(inp.public, tuple(FheUInt8(c) for c in inp.secret), server_key))
    port_trace = port.trace(seed=ex.RANDOM_ROW_SEED)
    code = program.compile_code(tf.program_source(cfg))
    sponge = ex.sponge_rows(code)
    rows = []
    outputs, t_len = machine.run(code, inp.public, inp.secret, lwe["k"], tf.lwe_delta(cfg), rows=rows)
    mine = ex.trace_limbs(code, sponge, rows, t_len)
    assert outputs == port_trace.outputs and ex.program_hash(sponge) == tuple(prog.hash)
    assert (mine.astype(np.uint32) == np.asarray(port_trace.as_limbs())).all()
