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
    # emit, mask, ins, trans8, rowpos, off, diag, cells, plan, exch, progress,
    # sx, sy, viterbi, design, threads, ring_rows, strip_rows, lead, blocks,
    # stream
    "branchfill": [_P] * 11 + [_I] * 9 + [_P],
    # strip_rows, lead, viterbi -> blocks of the strip design resident at once
    "branchfill_capacity": [_I] * 3,
    # trans8, steps, viterbi, out, stream: the dependency floor's step
    "branchfill_chain": [_P, _I, _I, _P, _P],
    # emit, mask, l_emit, r_emit, rowpos, off, diag, plan, sx, sy, width,
    # ring_rows, stream: the ring design's plan
    "siblingplan": [_P] * 8 + [_I] * 4 + [_P],
    # plan, emit, mask, l_emit, r_emit, t144, rowpos, off, cells, lp_end,
    # exch, progress, sx, sy, n, design, width, ring_rows, strip_rows,
    # blocks, stream
    "siblingfill": [_P] * 12 + [_I] * 8 + [_P],
    # strip_rows -> blocks of the strip design that can be resident at once
    "siblingfill_capacity": [_I],
    # t144, steps, split, out, stream: the dependency floors' steps
    "siblingfill_chain": [_P, _I, _I, _P, _P],
    # cells, wave, x_ptr, x_src, x_lp, y_ptr, y_src, y_lp, x_flags, y_flags,
    # insx, rootsubx, insy, rootsuby, ex, shift_x, ey, shift_y, rowpos, off,
    # diag, band, rank_of, wave_of, counts, n, N, W, sx, sy, CA, stream
    "dagplan_count": [_P] * 25 + [_I] * 6 + [_P],
    # the same 21 inputs, rank_of, wave_of, counts, incl, recs, terms, spans,
    # n, N, W, sx, sy, CA, R, width, ring, stream
    "dagplan_records": [_P] * 28 + [_I] * 9 + [_P],
    # recs, terms, spans, trans18, cells, arrivals, W, R, width, blocks,
    # threads, stream
    "dagfill": [_P] * 6 + [_I] * 5 + [_P],
    # threads -> blocks of the wide design that can be resident at once
    "dagfill_capacity": [_I],
    # trans18, steps, split, out, stream: the dependency floors' steps
    "dagfill_chain": [_P, _I, _I, _P, _P],
    # shard table, n_shards, strip table, blocks, cluster, y_src, y_lp, y_flags,
    # trans, lanes, SY, KY, NS, stream: the sequence-parallel fill's launch
    # on one device
    "spcolforward": [_P, _I, _P, _I, _I] + [_P] * 5 + [_I] * 3 + [_P],
    # lanes, warps, cluster -> strips of the SP fill resident at once
    "spcolforward_capacity": [_I] * 3,
    # writer, reader -> 1 with peer access on, 0 without, -(CUDA error)
    "spcolforward_peer": [_I, _I],
    # table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
    # trans, cells, lp_best, X1, Y1, stream: kernel (f), the tropical pair DP
    "tropical": [_P] + [_I] * 4 + [_P] * 9 + [_I] * 2 + [_P],
    # lanes, warps, cluster -> blocks of kernel (f) resident at once
    "tropical_capacity": [_I] * 3,
    # table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
    # trans, lp_end, X1, Y1, stream: kernel (g2), the sequence-parallel pair
    # Forward on one device
    "sppairforward": [_P] + [_I] * 4 + [_P] * 8 + [_I] * 2 + [_P],
    # lanes, warps, cluster -> blocks of kernel (g2) resident at once
    "sppairforward_capacity": [_I] * 3,
    # table, blocks, lanes, warps, cluster, stages, items, n_items, slots,
    # absorb, rsx, rsy, ix, iy, trans, lp_end, X1, Y1, stream: kernel (g3),
    # the pipeline-parallel pair Forward
    "pppairforward": [_P] + [_I] * 4 + [_P, _P, _I, _I] + [_P] * 7 + [_I] * 2 + [_P],
    # lanes, warps, cluster -> blocks of kernel (g3) resident at once
    "pppairforward_capacity": [_I] * 3,
    # l_emit, r_emit, emit, mask, t144, ends, cells, lp_end, ring, K, sx, sy,
    # groups, turns, cluster, stream: kernel (d'), K sibling fills in one
    # launch
    "siblingbatch": [_P] * 9 + [_I] * 6 + [_P],
    # -> the shared memory a block of the card may take (its opt-in limit)
    "smem_optin": [],
}
#: the dtypes each kernel is built for, where not both
_DTYPES = {name: ("f64",) for name in ("branchfill", "branchfill_capacity",
                                       "branchfill_chain", "siblingplan",
                                       "siblingfill", "siblingfill_capacity",
                                       "siblingfill_chain", "dagfill",
                                       "dagfill_capacity", "dagfill_chain", "dagplan_count",
                                       "dagplan_records", "siblingbatch")}
_DTYPES["spcolforward_peer"] = _DTYPES["smem_optin"] = ("",)

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
                fn = getattr(handle, f"{name}_{suffix}" if suffix else name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")


_SMEM: dict = {}


def smem_limit(dev) -> int:
    """The shared memory a block of CUDA device `dev` may take (its opt-in
    limit), asked of the card once."""
    import torch

    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMEM:
        with torch.cuda.device(index):
            _SMEM[index] = lib().smem_optin()
        if _SMEM[index] <= 0:
            raise RuntimeError(f"CUDA device {index}: its shared memory limit cannot be read")
    return _SMEM[index]
