"""Build and bind the hand-written CUDA kernels (`csrc/*.cu`).

All sources compile in one `nvcc` call into a shared library with a plain
C interface, loaded with ctypes.  The build runs at first use, never at
import, into `build/historian_tpu_torch/` beside the package, keyed by a
hash of the sources and flags so an edited kernel always rebuilds.  The
C functions return the launch's `cudaGetLastError()`; `check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "historian_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # y_src, y_lp, y_flags, absorb, maskg, xvec, trans, out, SY, SX, KY, stream
    "colforward": [_P] * 8 + [_I] * 3 + [_P],
    # planes, SY, SX, y_src, y_lp, KY, y_null, tx, t6, xe_src, xe_lp,
    # ye_src, ye_lp, KE, uniforms, is_best, T, L, pi, pj, ps, vals,
    # n_steps, stream
    "pairtrace": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                  _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> str:
    """Compile every csrc/*.cu into one library if it is not built yet;
    returns its path."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libhistorian_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(handle, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")
