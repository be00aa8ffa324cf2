"""Build the port's CUDA kernels with one nvcc call and load them with ctypes.

Every `csrc/*.cu` file is compiled by a single `nvcc` invocation into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds). The library lands in the git-ignored `build/` directory of
this package, named by a hash of the sources and flags, and is built at the
first kernel launch of a process, never at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (the launchers return the cudaError_t of their launches)
_SIGNATURES = {
    # keys, queries, values, mask, sigma, B, K, Q, C, p, out_sig, out_den, stream
    "npf_setconv_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, stream
    "npf_mlp_chain_fwd": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P],
    # M, C, H, L1, O -> floats of scratch (-1: widths too large)
    "npf_mlp_chain_bwd_scratch": [_I, _I, _I, _I, _I],
    # x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx, grads, scratch, stream
    "npf_mlp_chain_bwd": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
}
# return types other than int
_RESTYPES = {"npf_mlp_chain_bwd_scratch": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None


@dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when the library already existed
    log: str  # nvcc's output (ptxas resource usage when verbose)


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> BuildResult:
    """Compile all kernels into one shared library unless it already exists.

    verbose adds `-Xptxas -v`, whose report (registers, shared memory and
    spills per kernel) is returned in `log`; it does not change the binary.
    """
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"libnpf_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path) and not verbose:
        return BuildResult(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    return BuildResult(path, seconds, proc.stdout + proc.stderr)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build().path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
