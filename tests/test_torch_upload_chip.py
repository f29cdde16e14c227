"""The trace's upload on the card (skipped without one): the native
generator's 2^16 limbs are page-locked, ``limbs.upload`` copies them by DMA
bit for bit as the pageable copy does, a prove of the page-locked trace in
each mode counts one pinned upload (in the launch ledger,
``kernels.launched``) and gives the pageable trace's bytes, and a freed
trace's page-locked block serves the next trace of its size.

The file imports no JAX, so it runs where the port runs alone; the
suite's conftest sets JAX up, so leave it out there:

    python -m pytest --noconftest -m chip tests/test_torch_upload_chip.py
"""

import collections
import gc
import random

import numpy as np
import pytest
import torch

from zkvm_torch import kernels, vm
from zkvm_torch.field import limbs
from zkvm_torch.processor.golden import ExecutionTrace
from zkvm_torch.prover import pipeline as tpl


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def chain(card):
    """The 2^16 READ/ADD chain: (program, inputs, its trace, public inputs)."""
    key = vm.ServerKey(vm.DEMO_PARAMETERS, random.Random(23))
    program, inputs = vm.read_add_chain(vm.BENCH_N_OPS, key)
    trace = vm.run(program, inputs)
    assert trace.length == 1 << 16
    return program, inputs, trace, vm.PublicInputs(program.hash, trace.outputs, key)


def _pinned(arr) -> bool:
    return torch.from_numpy(arr.view(np.int32)).is_pinned()


def _uploads():
    """The ledger's uploads by host memory kind."""
    return {dict(shape)["kind"]: k for (name, shape), k in kernels.launched.items() if name == "upload"}


@pytest.mark.chip
def test_native_limbs_are_pinned_and_upload_as_the_pageable_copy(card, chain, monkeypatch):
    trace = chain[2]
    pageable = np.array(trace.limbs)
    assert type(trace.limbs) is np.ndarray and trace.limbs.dtype == np.uint32
    assert _pinned(trace.limbs) and not _pinned(pageable)
    monkeypatch.setattr(kernels, "launched", collections.Counter())
    got, want = limbs.upload(trace.limbs, card), limbs.upload(pageable, card)
    torch.cuda.synchronize(card)
    assert _uploads() == {"pinned": 1, "pageable": 1}
    assert torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("mode", ["tmode", "cls", "mono"])
def test_pinned_trace_proves_the_pageable_bytes(card, chain, mode, monkeypatch):
    """One pinned upload a prove of the native trace, and the bytes of a
    prove of its pageable copy."""
    _, _, trace, pub = chain
    pageable = ExecutionTrace(None, trace.program_hash, trace.outputs, limbs=np.array(trace.limbs))
    monkeypatch.setattr(kernels, "launched", collections.Counter())
    pinned_bytes = tpl.prove(trace, pub, device=card, mode=mode).to_wire_bytes()
    assert _uploads() == {"pinned": 1}
    assert tpl.prove(pageable, pub, device=card, mode=mode).to_wire_bytes() == pinned_bytes
    assert _uploads() == {"pinned": 1, "pageable": 1}


@pytest.mark.chip
def test_a_freed_trace_block_serves_the_next_trace(card, chain):
    """The host allocator pins once for a trace size: a trace made after
    another of the same T was freed takes its block."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        pytest.skip(f"torch {torch.__version__} has no torch.cuda.host_memory_stats")
    program, inputs, _, _ = chain
    first = vm.run(program, inputs)
    assert _pinned(first.limbs)
    del first
    gc.collect()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    second = vm.run(program, inputs)
    assert _pinned(second.limbs)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
