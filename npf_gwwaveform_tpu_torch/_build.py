"""Build the port's CUDA kernels with one nvcc call and load them with ctypes.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers they include) is
compiled by a single `nvcc` invocation into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). The library lands
in the git-ignored `build/` directory of this package, named by a hash of the
sources and flags, and is built at the first kernel launch of a process,
never at import. `build(csrc_dir=...)` and `load` build and bind another
directory of sources with the same entry points, and `using` routes the
wrappers' launches to it, for comparing two versions of the kernels in one
process.
"""

from __future__ import annotations

import contextlib
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
    # M, C, H, O -> bytes of shared memory a block takes (-1: widths too large)
    "npf_mlp_chain_fwd_smem": [_I, _I, _I, _I],
    # M, C, H, L1, O -> floats of scratch (-1: widths too large)
    "npf_mlp_chain_bwd_scratch": [_I, _I, _I, _I, _I],
    # x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx, grads, scratch, stream
    "npf_mlp_chain_bwd": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    # the bfloat16 chain (x, g, out and dx bf16; weights, biases and grads f32):
    # the same arguments as its float32 counterpart above
    "npf_mlp_chain_fwd_bf16": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P],
    "npf_mlp_chain_fwd_bf16_smem": [_I, _I, _I, _I],
    # M, C, H, L1, O -> bytes of scratch (-1: widths too large)
    "npf_mlp_chain_bwd_bf16_scratch": [_I, _I, _I, _I, _I],
    "npf_mlp_chain_bwd_bf16": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P,
                               _P],
}
# return types other than int
_RESTYPES = {name: ctypes.c_longlong for name in (
    "npf_mlp_chain_bwd_scratch", "npf_mlp_chain_fwd_smem", "npf_mlp_chain_bwd_bf16_scratch",
    "npf_mlp_chain_fwd_bf16_smem")}

_lock = threading.Lock()
_lib = None


@dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when the library already existed
    log: str  # nvcc's output (ptxas resource usage when verbose)


def sources(csrc_dir: str = CSRC_DIR) -> list:
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(csrc_dir: str = CSRC_DIR) -> str:
    """Where the library of `csrc_dir` is built: named by a hash of the nvcc
    flags and of every source and header, so that any edit rebuilds it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources(csrc_dir) + sorted(glob.glob(os.path.join(csrc_dir, "*.cuh"))):
        with open(s, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libnpf_kernels_{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False, csrc_dir: str = CSRC_DIR) -> BuildResult:
    """Compile all kernels of `csrc_dir` into one shared library unless it
    already exists.

    verbose adds `-Xptxas -v`, whose report (registers, shared memory and
    spills per kernel) is returned in `log`; it does not change the binary.
    """
    srcs = sources(csrc_dir)
    path = library_path(csrc_dir)
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


def load(path: str) -> ctypes.CDLL:
    """A built kernel library with its entry points' signatures set. An
    entry point the library lacks (an earlier build's) is left unset."""
    handle = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build().path)
        return _lib


@contextlib.contextmanager
def using(handle: ctypes.CDLL):
    """Inside the block, `lib()` is `handle` (another build, from `load`), so
    every wrapper launches that build's kernels."""
    global _lib
    with _lock:
        prev, _lib = _lib, handle
    try:
        yield handle
    finally:
        with _lock:
            _lib = prev


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
