"""Build and bind the CUDA kernels of ``zkvm_torch/csrc``.

The kernels are compiled at first use, from the sources in the checkout,
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared library
with a plain C interface, and loaded with :mod:`ctypes`.  The library lands
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
SOURCES = ("ntt_stages.cu", "blake3_rows.cu", "composition.cu")
HEADERS = ("zk_common.cuh", "f128.cuh", "host_emu.h")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# C signatures: every pointer and the stream are void*, sizes are int/long
SIGNATURES = {
    # y, out, tw, pre, rs, ls, B, M, NL, S, variant, stream
    "zk_ntt_stages": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, C, N, stream
    "zk_blake3_rows": (_P, _P, _I, _L, _P),
    # cur, mask, ark, ee, i0, i1, mds, imds, alphas, delta,
    # bv0, bb0, bc0, k0, bv1, bb1, bc1, k1, out, T, stream
    "zk_composition": (_P,) * 13 + (_I, _P, _P, _P, _I, _P, _L, _P),
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
    """Compile the kernels (if this source digest is not built yet)."""
    global build_seconds, build_log
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    (BUILD / "nvcc.log").write_text(" ".join(cmd) + "\n" + build_log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log[-4000:]}")
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
