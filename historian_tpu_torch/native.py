"""Loader for the native host runtime of the port (csrc/fill.cpp).

Builds the shared library on demand with g++ -O3 into
`build/historian_tpu_torch/` beside the package, keyed by a hash of the
source and flags, and binds it via ctypes + numpy.ctypeslib.  Set
HISTORIAN_NATIVE=0 to force the pure numpy fills (used to cross-validate
the two implementations).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
from numpy.ctypeslib import ndpointer

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "fill.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "historian_tpu_torch")
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: -march=native code built on one
    machine may not run on another, so they key the library too."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _build() -> str:
    """Compile fill.cpp if this source, these flags and this CPU are not
    built yet; returns the library's path.  Each process compiles to its
    own file and renames it into place, so concurrent first uses never
    load a half-written library."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _cpu_flags())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libhistfill_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
    return lib


_lib = None
_tried = False


def _f64(ndim=1):
    return ndpointer(dtype=np.float64, ndim=ndim, flags="C_CONTIGUOUS")


def _i64():
    return ndpointer(dtype=np.int64, ndim=1, flags="C_CONTIGUOUS")


def _u8(ndim=1):
    return ndpointer(dtype=np.uint8, ndim=ndim, flags="C_CONTIGUOUS")


def get_native():
    """The bound library, or None if disabled/unbuildable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("HISTORIAN_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(_build())
        lib.forward_fill.restype = None
        lib.forward_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _i64(), _i64(), _f64(),  # x in-edges (CSR)
            _i64(), _i64(), _f64(),  # y in-edges
            _u8(), _u8(), _u8(), _u8(), _u8(),  # x_null, y_null, x_ready, y_ready, x_emit_or_start
            ctypes.c_uint8, ctypes.c_uint8,  # x_empty, y_empty
            _f64(), _f64(), _f64(), _f64(),  # insx, rootsubx, insy, rootsuby
            _f64(2), _u8(2), _f64(),  # absorb, env_mask, trans18
            _f64(3),  # cells
        ]
        lib.sibling_fill.restype = None
        lib.sibling_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _f64(), _f64(), _f64(2), _u8(2),  # l_emit, r_emit, match_emit, mask
            _f64(2),  # t[12, 12]
            _f64(3), _f64(),  # cells, lp_end[1]
        ]
        lib.prefault.restype = None
        lib.prefault.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.envelope_mask.restype = None
        lib.envelope_mask.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _i64(), _i64(), ctypes.c_int64,
            _u8(), _u8(), _u8(2),
        ]
        lib.state_levels.restype = None
        lib.state_levels.argtypes = [
            ctypes.c_int64, _i64(), _i64(),
            ndpointer(dtype=np.int32, ndim=1, flags="C_CONTIGUOUS"),
        ]
        lib.posterior_cells.restype = ctypes.c_int64
        lib.posterior_cells.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _f64(3), _f64(3), _u8(2),
            ctypes.c_double, ctypes.c_int64,
            ndpointer(dtype=np.int64, ndim=2, flags="C_CONTIGUOUS"),
            _f64(),
        ]
        lib.postprob_select.restype = ctypes.c_int64
        lib.postprob_select.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _f64(3), _f64(3), _u8(2),  # bwd cells, fwd cells, env_mask
            ctypes.c_double, ctypes.c_double,  # lp_end, lpp_threshold
            ctypes.c_int64,  # cap
            ndpointer(dtype=np.int64, ndim=2, flags="C_CONTIGUOUS"),  # out_ijs
            _f64(),  # out_lpp
        ]
        lib.transition_pool.restype = None
        lib.transition_pool.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _f64(3), _f64(3), _u8(2),  # fwd cells, bwd cells, env_mask
            ctypes.c_double,  # lp_end
            _i64(), _i64(), _f64(), _i64(),  # x in-edges (CSR + edge idx)
            _i64(), _i64(), _f64(), _i64(),  # y in-edges
            _u8(), _u8(), _u8(), _u8(), _u8(),  # x_null, y_null, x_ready, y_ready, x_emit_or_start
            ctypes.c_uint8, ctypes.c_uint8,  # x_empty, y_empty
            _f64(), _f64(), _f64(), _f64(),  # insx, rootsubx, insy, rootsuby
            _f64(2), _f64(2),  # absorb, trans_table [6,6]
            ctypes.c_int64, ctypes.c_int64,  # n_x_trans, n_y_trans
            _f64(), _f64(), _f64(),  # wx, wy, wcat out
        ]
        lib.sumprod_fill.restype = None
        lib.sumprod_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ndpointer(dtype=np.int32, ndim=2, flags="C_CONTIGUOUS"),  # tokens
            _i64(), _i64(), _i64(), _i64(),  # parent, left, right, sibling
            ndpointer(dtype=np.float64, ndim=4, flags="C_CONTIGUOUS"),  # sub
            _f64(2), _f64(),  # ins, log cpt weights
            ctypes.c_uint8,  # down
            ndpointer(dtype=np.float64, ndim=4, flags="C_CONTIGUOUS"),  # F
            _f64(3),  # logF
            ndpointer(dtype=np.float64, ndim=4, flags="C_CONTIGUOUS"),  # E
            _f64(3),  # logE
            ndpointer(dtype=np.float64, ndim=4, flags="C_CONTIGUOUS"),  # G
            _f64(3),  # logG
            _f64(2), _f64(),  # cpt_ll, col_ll
        ]
        lib.branch_fill.restype = None
        lib.branch_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _f64(2), _f64(), _u8(2),  # match_emit, ins_emit, mask
            _f64(),  # trans8
            ctypes.c_uint8,  # viterbi
            _f64(3),  # cells out
        ]
        lib.align_merge.restype = ctypes.c_int64
        lib.align_merge.argtypes = [
            ctypes.c_int64,
            _i64(), _i64(), _i64(), _i64(),  # rows_ptr, row_ids, cols, cell_ptr
            _u8(),  # cells (flattened per-align row-major bool matrices)
            ctypes.c_int64,  # n_rows
            _i64(),  # seq_len per dense row
            _u8(2),  # out [n_rows, sum(cols)]
        ]
        lib.backward_fill.restype = None
        lib.backward_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            _i64(), _i64(), _f64(),  # x absorb-out (CSR)
            _i64(), _i64(), _f64(),  # x null-out
            _i64(), _i64(), _f64(),  # y absorb-out
            _i64(), _i64(), _f64(),  # y null-out
            _u8(), _u8(), _u8(),  # x_ready, y_ready, x_emit_or_start
            ctypes.c_uint8, ctypes.c_uint8,
            _f64(), _f64(), _f64(), _f64(),
            _f64(2), _u8(2), _f64(),
            _f64(3),
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def csr_in_edges(profile):
    """CSR in-edge arrays (ptr, src, lp) over a profile's states."""
    ptr = np.zeros(profile.size + 1, dtype=np.int64)
    srcs: list[int] = []
    lps: list[float] = []
    for i, st in enumerate(profile.states):
        for t in st.in_trans:
            srcs.append(profile.trans[t].src)
            lps.append(profile.trans[t].lp)
        ptr[i + 1] = len(srcs)
    return ptr, np.array(srcs, dtype=np.int64), np.array(lps, dtype=np.float64)


def csr_in_edges_idx(profile):
    """CSR in-edge arrays (ptr, src, lp, edge) -- like `csr_in_edges` but
    also returning each entry's index into profile.trans, so natively
    pooled per-edge weights map back to the transitions' count payloads."""
    ptr = np.zeros(profile.size + 1, dtype=np.int64)
    srcs: list[int] = []
    lps: list[float] = []
    edges: list[int] = []
    for i, st in enumerate(profile.states):
        for t in st.in_trans:
            srcs.append(profile.trans[t].src)
            lps.append(profile.trans[t].lp)
            edges.append(t)
        ptr[i + 1] = len(srcs)
    return (
        ptr,
        np.array(srcs, dtype=np.int64),
        np.array(lps, dtype=np.float64),
        np.array(edges, dtype=np.int64),
    )


def csr_out_edges(profile, attr: str):
    """CSR out-edge arrays (ptr, dest, lp) for null_out or absorb_out."""
    ptr = np.zeros(profile.size + 1, dtype=np.int64)
    dests: list[int] = []
    lps: list[float] = []
    for i, st in enumerate(profile.states):
        for t in getattr(st, attr):
            dests.append(profile.trans[t].dest)
            lps.append(profile.trans[t].lp)
        ptr[i + 1] = len(dests)
    return ptr, np.array(dests, dtype=np.int64), np.array(lps, dtype=np.float64)
