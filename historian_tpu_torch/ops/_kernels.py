"""Build and bind the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles in its own `nvcc` process, all started together,
and one more `nvcc` links the objects into a shared library with a plain
C interface, loaded with ctypes.  The build runs at first use, never at
import, into `build/historian_tpu_torch/` beside the package, keyed by a
hash of the sources, headers and flags so an edited kernel always
rebuilds.  The
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes, progress, rec,
    # out, SY, SX, KY, NS, stream
    "colforward": [_P] * 11 + [_I] * 4 + [_P],
    # strips of K1's width that can be resident at once
    "colforward_capacity": [],
    # planes, SY, SX, y_src, y_lp, KY, y_null, tx, t6, xe_src, xe_lp,
    # ye_src, ye_lp, KE, uniforms, n_best, T, L, pi, pj, ps, vals,
    # n_steps, stream
    "pairtrace": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                  _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # y_src, y_lp, y_flags, ey, ex_t, xvec, params, lanes, progress, rec, out,
    # SY, SX, KY, CA, NS, stream
    "colforward_fused": [_P] * 11 + [_I] * 5 + [_P],
    # NS, CA -> strips that can be resident at once
    "colforward_fused_capacity": [_I, _I],
    # x_tok, y_tok, diag, nd, rank_lo, rank_hi, NDP, x_len, y_len, submat,
    # A, trans, sg, end_x, end_y, PX, PY, bp, bp_off, col, steps, n_steps,
    # x_end, y_end, lead_i, lead_j, score, B, stream
    "guidealign": [_P] * 6 + [_I] + [_P] * 3 + [_I] + [_P] * 4 + [_I, _I] + [_P] * 10
                  + [_I, _P],
    # absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, stream
    "pairforward_lp": [_P] * 7 + [_I] * 3 + [_P],
    # absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows, stream
    "pairforward_lp_tiled": [_P] * 7 + [_I] * 4 + [_P],
    # tiled, Y1, out[5] (lanes a thread, warps, registers, local bytes, static smem)
    "pairforward_attrs": [_I, _I, _P],
    # emit, ins, mask, trans8, xa, xb, cells, sx, sy, viterbi, threads, stream
    "branchfill": [_P] * 7 + [_I] * 4 + [_P],
}
#: the dtypes each kernel is built for, where not both
_DTYPES = {"branchfill": ("f64",)}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's errors."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")


def build() -> str:
    """Compile every csrc/*.cu into one library if it is not built yet;
    returns its path."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libhistorian_kernels_{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{key}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)])
    tmp = f"{lib}.{os.getpid()}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            for suffix in _DTYPES.get(name, ("f32", "f64")):
                fn = getattr(handle, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")
