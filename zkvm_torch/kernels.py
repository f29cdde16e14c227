"""Build and bind the CUDA kernels of ``zkvm_torch/csrc``.

The kernels are compiled at first use, from the sources in the checkout,
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` (one nvcc per source,
all started together, then one link) into one shared library with a plain
C interface, and loaded with :mod:`ctypes`.  The library lands
in ``zkvm_torch/build/`` under a name keyed by a digest of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("ntt_stages.cu", "blake3_rows.cu", "merkle.cu", "composition.cu", "transition.cu")
HEADERS = ("zk_common.cuh", "f128.cuh", "transition.cuh", "blake3.cuh", "host_emu.h")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_U64 = ctypes.c_uint64
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
# C signatures: every device pointer and the stream are void*, sizes are
# int/long; delta goes as two uint64 words, boundary columns as host ints
SIGNATURES = {
    # y, out, tw, pre, rs, ls, B, M, NL, S, variant, stream
    "zk_ntt_stages": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # a, b, out (packed elements), n, stream: zk::mul32 alone (a check)
    "zk_mul32": (_P, _P, _P, _I, _P),
    # x, out, C, N, stream
    "zk_blake3_rows": (_P, _P, _I, _L, _P),
    # leaves, heap, N, stream
    "zk_merkle_heap": (_P, _P, _L, _P),
    # cur, mask, ark, ee, i0, i1, mds, alphas, delta_lo, delta_hi,
    # bv0, bb0, bc0 (host), k0, bv1, bb1, bc1 (host), k1, out, T, stream
    "zk_composition": (_P,) * 8 + (_U64, _U64, _P, _P, _IP, _I, _P, _P, _IP, _I, _P, _L, _P),
    # lde, mask, ark, mds, alphas, delta_lo, delta_hi, out, N, P, step, stream
    "zk_transition": (_P,) * 5 + (_U64, _U64, _P, _L, _L, _L, _P),
}

build_seconds = 0.0  # wall time of the last nvcc build in this process
build_log = ""  # nvcc / ptxas output of that build


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD / f"libzkvm_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels (if this source digest is not built yet): each
    source to an object file, all at once, then link them."""
    global build_seconds, build_log
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{Path(s).stem}.{os.getpid()}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)] for o, s in zip(objs, SOURCES)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append((link, res.returncode))
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(" ".join(c) + "\n" + log for c, log in zip(cmds, logs))
    (BUILD / "nvcc.log").write_text(build_log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][1]}):\n{build_log[-4000:]}")
    os.replace(tmp, so)
    return so


def bind(path) -> ctypes.CDLL:
    """Load a kernel library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use."""
    return bind(build())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def ptr(t):
    """Device pointer of a tensor (None for a missing optional input)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    """The current CUDA stream of a tensor's device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t, shape, device, name: str):
    """Check a kernel input: int32, on ``device``, contiguous, of ``shape``."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
