"""DAG x DAG merge fill (kernel (a)): the 5-state pair-HMM Forward of a
merge whose x is not a chain (a sampled or posterior profile) against
any profile y.

Counterpart of historian_tpu/ops/dagforward.py (`dag_pair_forward_cells`,
an XLA scan over x rows with an affine scan and a junction scan along y)
and of its bridge historian_tpu/ops/devicedp.py `dag_forward_cells`.  The
port keeps the host route's per-cell order instead (csrc/fill.cpp
`fwd_cell`): profile states are toposorted, so with a level per state (1
+ the largest level of its in-edges' sources) a cell (i, j) reads only
cells of a smaller level_x[i] + level_y[j], and the cells of one such
wavefront are independent (fill.cpp `in_levels`, `wavefront_run`).

- `upload_band` builds the plan on the host: each row's hull of the
  envelope and the band over it (ops/branchdp.py `band_layout`), the
  in-envelope cells sorted by wavefront, the absorb value of each, the
  in-edge CSRs and the state flags; on the card it is copied up in one
  pinned buffer (`branchdp.pinned_upload`, logged in UPLOADS).
- `dag_fill_band` fills the band: the hand-written CUDA kernel
  csrc/dagfill.cu for CUDA tensors (float64 only; one thread a cell of a
  wavefront, a barrier a wavefront), `dag_fill_band_plain` for CPU
  tensors: the same cells, wavefront by wavefront in PyTorch, each cell
  gathering its in-edge sources and applying fwd_cell's arithmetic in its
  order (fill.cpp's lse2, the in-edges in CSR order).  Both leave -inf
  where fill.cpp does (outside the envelope, no path).
- `read_band` copies the band back once (`readback.gather_to_host`, kind
  "dag") into the host grid; `dag_forward_cells` is the bridge that
  engine/forward.py calls.

Not ported: the JAX bridge's shape buckets and `_device_io` (its
compile-cache machinery) and `_profile_dag_arrays`'s K-padded edges,
junction list and governors, which only the row scan needs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from historian_tpu_torch.native import csr_in_edges
from historian_tpu_torch.ops.branchdp import BandLayout, band_layout, pinned_upload
from historian_tpu_torch.ops.readback import gather_to_host

N_STATES = 5
IMM, IMD, IDM, IMI, IIW = range(5)
#: x state flags: null, ready (or the profile empty), emit or start
X_NULL, X_READY, X_EOS = 1, 2, 4
#: y state flags: null, ready (or the profile empty)
Y_NULL, Y_READY = 1, 2
#: kernel launches made by `dag_fill_band` (never by the plain version)
LAUNCHES = 0
#: one entry a plan upload (`upload_band` on the card): bytes, the copy's ms
#: (CUDA events) and the host's ms packing it
UPLOADS: list = []
#: the last launch's blocks, threads a block and wavefronts
LAST_LAUNCH: dict = {}
#: threads a block of the kernel (csrc/dagfill.cu, at most 256)
THREADS = 256


def trans18(hmm) -> np.ndarray:
    """A PairHMM's 18 transitions in fill.cpp's `Trans` order."""
    h = hmm
    return np.array([h.imm_imm, h.imm_imd, h.imm_idm, h.imm_imi, h.imm_iiw,
                     h.imd_imm, h.imd_imd, h.imd_idm,
                     h.idm_imm, h.idm_imd, h.idm_idm,
                     h.imi_imm, h.imi_imd, h.imi_imi, h.imi_iiw,
                     h.iiw_imm, h.iiw_idm, h.iiw_iiw], dtype=np.float64)


def levels(ptr: np.ndarray, src: np.ndarray, n: int) -> np.ndarray:
    """fill.cpp `in_levels`: the level of states 0..n-1, 1 + the largest
    level of an in-edge's source (sources at or past the state ignored)."""
    lvl = [0] * n
    p, s = ptr.tolist(), src.tolist()
    for i in range(n):
        m = -1
        for e in range(p[i], p[i + 1]):
            k = s[e]
            if 0 <= k < i and lvl[k] > m:
                m = lvl[k]
        lvl[i] = m + 1
    return np.array(lvl, dtype=np.int64)


def mask_hull(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi), int64 [X+1]: each interior row's first and last in-mask
    interior column of a host mask [X+1, Y+1] (`branchdp.interior_hull`'s
    form, in numpy)."""
    X1, Y1 = mask.shape
    lo = np.full(X1, Y1, dtype=np.int64)
    hi = np.zeros(X1, dtype=np.int64)
    if X1 > 2 and Y1 > 2:
        inner = mask[1:-1, 1:-1].view(np.uint8)
        some = inner.any(axis=1)
        lo[1:-1] = np.where(some, inner.argmax(axis=1) + 1, Y1)
        hi[1:-1] = np.where(some, Y1 - 2 - inner[:, ::-1].argmax(axis=1), 0)
    return lo, hi


def absorb_at(dp, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """The xy-absorb values at cells (ii, jj): `DPMatrix.absorb` there, in
    its order of operations (log of the factors' product, then the x and
    the y shift), without the dense [Sx, Sy] matrix."""
    ex, shift_x, ey, shift_y = dp.absorb_factors
    out = np.einsum("ij,ij->i", ex[ii], ey[jj])
    with np.errstate(divide="ignore"):
        np.log(out, out=out)
    out += shift_x[ii]
    out += shift_y[jj]
    return out


@dataclass
class DagPlan:
    """A merge's fill plan on the host, for a grid of nx = x_size - 1 rows
    and ny = y_size - 1 columns (the END states excluded): the band
    `layout`; the in-envelope cells `cells` [N, 2] (i, j) sorted by
    wavefront, `wave` [W + 1] where each non-empty wavefront starts, the
    absorb value of each cell `absorb` [N]; the in-edge CSRs of states
    0..nx-1 and 0..ny-1 (ptr, src, lp); the flags (X_*, Y_*), the emission
    vectors and the 18 transitions."""

    layout: BandLayout
    cells: np.ndarray
    wave: np.ndarray
    absorb: np.ndarray
    x_csr: tuple
    y_csr: tuple
    x_flags: np.ndarray
    y_flags: np.ndarray
    insx: np.ndarray
    rootsubx: np.ndarray
    insy: np.ndarray
    rootsuby: np.ndarray
    trans: np.ndarray

    @property
    def widest(self) -> int:
        return int(np.diff(self.wave).max(initial=0))


def _csr(profile, n: int) -> tuple:
    ptr, src, lp = csr_in_edges(profile)
    ptr = ptr[: n + 1]
    return ptr, src[: ptr[-1]], lp[: ptr[-1]]


def plan(dp) -> DagPlan:
    """The plan of a merge (a ForwardMatrix whose profiles are not empty)."""
    nx, ny = dp.x_size - 1, dp.y_size - 1
    x_csr, y_csr = _csr(dp.x, nx), _csr(dp.y, ny)
    mask = dp.env_mask[:nx, :ny]
    if dp.env_vectors is None:  # no envelope: every cell
        lo, hi = np.ones(nx, dtype=np.int64), np.full(nx, ny - 2, dtype=np.int64)
    else:
        lo, hi = mask_hull(mask)
    layout = band_layout(lo, hi, nx, ny)
    ii, jj = np.divmod(layout.flat_index(), ny)
    keep = mask[ii, jj]  # the band's in-envelope cells, row-major
    ii, jj = ii[keep], jj[keep]
    w = levels(*x_csr[:2], nx)[ii] + levels(*y_csr[:2], ny)[jj]
    order = np.argsort(w, kind="stable")
    ii, jj, w = ii[order], jj[order], w[order]
    starts = np.flatnonzero(np.diff(w)) + 1
    wave = np.concatenate([[0], starts, [len(w)]]).astype(np.int64)
    x_flags = (dp.x_null[:nx] * X_NULL + (dp.x_ready[:nx] | dp.x_empty) * X_READY
               + dp.x_emit_or_start[:nx] * X_EOS).astype(np.uint8)
    y_flags = (dp.y_null[:ny] * Y_NULL + (dp.y_ready[:ny] | dp.y_empty) * Y_READY).astype(np.uint8)
    return DagPlan(layout, np.stack([ii, jj], axis=1), wave, absorb_at(dp, ii, jj),
                   x_csr, y_csr, x_flags, y_flags,
                   dp.insx[:nx], dp.rootsubx[:nx], dp.insy[:ny], dp.rootsuby[:ny],
                   trans18(dp.hmm))


@dataclass
class DagBandInputs:
    """A band fill's inputs, all on one device: the plan's cells [N, 2]
    (int32), wave [W + 1] (int32), absorb [N]; the CSRs' ptr and src
    (int32) and lp; the flags (uint8); insx, rootsubx [nx], insy, rootsuby
    [ny], trans [18]; the layout's rowpos, off and diag (int32)."""

    layout: BandLayout
    cells: torch.Tensor
    wave: torch.Tensor
    absorb: torch.Tensor
    x_ptr: torch.Tensor
    x_src: torch.Tensor
    x_lp: torch.Tensor
    y_ptr: torch.Tensor
    y_src: torch.Tensor
    y_lp: torch.Tensor
    x_flags: torch.Tensor
    y_flags: torch.Tensor
    insx: torch.Tensor
    rootsubx: torch.Tensor
    insy: torch.Tensor
    rootsuby: torch.Tensor
    trans: torch.Tensor
    rowpos: torch.Tensor
    off: torch.Tensor
    diag: torch.Tensor


def _host_parts(p: DagPlan) -> dict:
    """name: (numpy dtype, host array) of every input, in upload order."""
    lay = p.layout
    return {
        "absorb": (np.float64, p.absorb), "x_lp": (np.float64, p.x_csr[2]),
        "y_lp": (np.float64, p.y_csr[2]), "insx": (np.float64, p.insx),
        "rootsubx": (np.float64, p.rootsubx), "insy": (np.float64, p.insy),
        "rootsuby": (np.float64, p.rootsuby), "trans": (np.float64, p.trans),
        "cells": (np.int32, p.cells.reshape(-1)), "wave": (np.int32, p.wave),
        "x_ptr": (np.int32, p.x_csr[0]), "x_src": (np.int32, p.x_csr[1]),
        "y_ptr": (np.int32, p.y_csr[0]), "y_src": (np.int32, p.y_csr[1]),
        "rowpos": (np.int32, lay.rowpos), "off": (np.int32, lay.off),
        "diag": (np.int32, lay.diag.reshape(-1)),
        "x_flags": (np.uint8, p.x_flags), "y_flags": (np.uint8, p.y_flags),
    }


def upload_band(p: DagPlan, device: torch.device) -> DagBandInputs:
    """The plan's inputs on `device`: on the card packed into one pinned
    buffer and copied in one piece (`branchdp.pinned_upload`, logged in
    UPLOADS); elsewhere as tensors over the host arrays."""
    parts = _host_parts(p)
    if device.type == "cuda":
        def write(hv):
            for name, (_, a) in parts.items():
                hv[name][:] = a

        dev = pinned_upload({name: (dt, len(a)) for name, (dt, a) in parts.items()}, write,
                            device, UPLOADS)
    else:
        dev = {name: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
               for name, (dt, a) in parts.items()}
    dev["cells"] = dev["cells"].view(-1, 2)
    dev["diag"] = dev["diag"].view(-1, 2)
    return DagBandInputs(p.layout, **dev)


# ------------------------------------------------------------ plain version
#: fill.cpp's lse2: torch.logaddexp computes the same max + log1p(exp(-|x -
#: y|)), and -inf for two -infs, where fill.cpp's x + LOG2 gives -inf too
lse2 = torch.logaddexp


def _fold(acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """acc lse2-accumulated with terms[:, 0], terms[:, 1], ... in turn."""
    for k in range(terms.shape[1]):
        acc = lse2(acc, terms[:, k])
    return acc


def _chain(*terms: torch.Tensor) -> torch.Tensor:
    """lse2(lse2(t0, t1), t2) ..., left to right."""
    out = terms[0]
    for t in terms[1:]:
        out = lse2(out, t)
    return out


def _edges(ptr: torch.Tensor, src: torch.Tensor, lp: torch.Tensor, state: torch.Tensor):
    """[N, K] in-edge sources (0 past a state's in-degree) and lps (-inf
    there) of `state` [N], in CSR order; K the largest in-degree."""
    first = ptr[state]
    deg = ptr[state + 1] - first
    k = torch.arange(int(deg.max()) if len(deg) else 0, device=state.device)
    ok = k[None, :] < deg[:, None]
    e = torch.where(ok, first[:, None] + k[None, :], 0)
    return (torch.where(ok, src[e], 0), torch.where(ok, lp[e], -torch.inf), deg)


def dag_fill_band_plain(inp: DagBandInputs) -> torch.Tensor:
    """The band's cells [n, 5] (IMM IMD IDM IMI IIW), float64, wavefront by
    wavefront in PyTorch with fill.cpp's per-cell arithmetic; -inf outside
    the envelope and where no path reaches."""
    lay = inp.layout
    X1, Y1 = lay.shape
    Y = Y1 - 1
    dev = inp.absorb.device
    f64, i64 = torch.float64, torch.int64
    n = lay.n
    ninf = torch.tensor(-torch.inf, dtype=f64, device=dev)
    (t_imm_imm, t_imm_imd, t_imm_idm, t_imm_imi, t_imm_iiw, t_imd_imm, t_imd_imd, t_imd_idm,
     t_idm_imm, t_idm_imd, t_idm_idm, t_imi_imm, t_imi_imd, t_imi_imi, t_imi_iiw,
     t_iiw_imm, t_iiw_idm, t_iiw_iiw) = inp.trans.to(f64).tolist()
    off = inp.off.to(i64)
    # per row: its hull lo..hi, where (x, y) of the hull lies (rowpos + y),
    # where its columns 0 and Y lie (rows 0 and X: the whole row is hull)
    rows = torch.stack([torch.from_numpy(lay.lo).to(dev), torch.from_numpy(lay.hi).to(dev),
                        inp.rowpos.to(i64), off[:-1], off[1:] - 1], dim=1)

    def pos(x, y):
        lo, hi, rowpos, col0, colY = rows[x].unbind(-1)
        p = torch.where((y >= lo) & (y <= hi), rowpos + y, n)  # n: outside the band
        return torch.where(y == 0, col0, torch.where(y == Y, colY, p))

    ci, cj = inp.cells[:, 0].to(i64), inp.cells[:, 1].to(i64)
    xs_all, xl_all, deg_x = _edges(inp.x_ptr.to(i64), inp.x_src.to(i64), inp.x_lp, ci)
    ys_all, yl_all, deg_y = _edges(inp.y_ptr.to(i64), inp.y_src.to(i64), inp.y_lp, cj)
    px_all = pos(xs_all, cj[:, None])  # (x source, j)
    py_all = pos(ci[:, None], ys_all)  # (i, y source)
    xf, yf = inp.x_flags[ci], inp.y_flags[cj]
    xnull_all, xeos_all = (xf & X_NULL) != 0, (xf & X_EOS) != 0
    xrdy_all, ynull_all, yrdy_all = (xf & X_READY) != 0, (yf & Y_NULL) != 0, (yf & Y_READY) != 0
    origin_all = (ci == 0) & (cj == 0)
    out_pos = pos(ci, cj)
    rsx, isx = inp.rootsubx[ci], inp.insx[ci]
    rsy, isy = inp.rootsuby[cj], inp.insy[cj]
    # one row more: the value of every cell outside the band
    cells = torch.full((n + 1, N_STATES), -torch.inf, dtype=f64, device=dev)
    wave = inp.wave.tolist()
    seg = torch.repeat_interleave(torch.arange(len(wave) - 1, device=dev),
                                  inp.wave[1:].to(i64) - inp.wave[:-1].to(i64))
    k_x = torch.zeros(len(wave) - 1, dtype=i64, device=dev).scatter_reduce(
        0, seg, deg_x, "amax").tolist()
    k_y = torch.zeros(len(wave) - 1, dtype=i64, device=dev).scatter_reduce(
        0, seg, deg_y, "amax").tolist()
    for w in range(len(wave) - 1):
        a, b, kx, ky = wave[w], wave[w + 1], k_x[w], k_y[w]
        xnull, xeos, xrdy = xnull_all[a:b], xeos_all[a:b], xrdy_all[a:b]
        ynull, yrdy, origin = ynull_all[a:b], yrdy_all[a:b], origin_all[a:b]
        imm0 = torch.where(origin, 0.0, ninf)

        # from (x in-edge source, j): IMD and IIW; IMM where x is null
        xl = xl_all[a:b, :kx]
        sc = cells[px_all[a:b, :kx]]  # [m, KX, 5]
        e_imd = _chain(sc[..., IMM] + t_imm_imd, sc[..., IMD] + t_imd_imd,
                       sc[..., IDM] + t_idm_imd, sc[..., IMI] + t_imi_imd) + xl
        e_iiw = _chain(sc[..., IMM] + t_imm_iiw, sc[..., IMI] + t_imi_iiw,
                       sc[..., IIW] + t_iiw_iiw) + xl
        imd = _fold(ninf, torch.where(xnull[:, None], sc[..., IMD] + xl, e_imd))
        iiw = _fold(ninf, torch.where(xnull[:, None], sc[..., IIW] + xl, e_iiw))
        imd = torch.where(yrdy, torch.where(xnull, imd, imd + rsx[a:b]), ninf)
        iiw = torch.where(yrdy, torch.where(xnull, iiw, iiw + isx[a:b]), ninf)
        imm_xn = torch.where(yrdy, _fold(ninf, sc[..., IMM] + xl), ninf)

        # from (i, y in-edge source): IDM and IMI; IMM where y is null
        yl = yl_all[a:b, :ky]
        sc = cells[py_all[a:b, :ky]]  # [m, KY, 5]
        e_idm = _chain(sc[..., IMM] + t_imm_idm, sc[..., IMD] + t_imd_idm,
                       sc[..., IDM] + t_idm_idm, sc[..., IIW] + t_iiw_idm) + yl
        e_imi = lse2(sc[..., IMM] + t_imm_imi, sc[..., IMI] + t_imi_imi) + yl
        idm = _fold(ninf, torch.where(ynull[:, None], sc[..., IDM] + yl, e_idm))
        imi = _fold(ninf, torch.where(ynull[:, None], sc[..., IMI] + yl, e_imi))
        idm = torch.where(ynull, idm, torch.where(xrdy, idm + rsy[a:b], ninf))
        imi = torch.where(ynull, imi, torch.where(xrdy, imi + isy[a:b], ninf))
        imm_yn = _fold(imm0, sc[..., IMM] + yl)

        # from (x source, y source), x outer: IMM where neither is null
        sc = cells[pos(xs_all[a:b, :kx, None], ys_all[a:b, None, :ky])]  # [m, KX, KY, 5]
        e_imm = (_chain(sc[..., IMM] + t_imm_imm, sc[..., IMD] + t_imd_imm,
                        sc[..., IDM] + t_idm_imm, sc[..., IMI] + t_imi_imm,
                        sc[..., IIW] + t_iiw_imm) + xl[:, :, None] + yl[:, None, :])
        imm_xy = _fold(imm0, e_imm.reshape(b - a, -1)) + inp.absorb[a:b]

        imm = torch.where(~xnull & ~ynull, imm_xy,
                          torch.where(ynull & xeos, imm_yn, torch.where(xnull, imm_xn, imm0)))
        imm = torch.where(origin, 0.0, imm)
        cells[out_pos[a:b]] = torch.stack([imm, imd, idm, imi, iiw], dim=1)
    return cells[:n]


# ------------------------------------------------------------------ kernel
def dag_fill_band(inp: DagBandInputs) -> torch.Tensor:
    """Kernel (a) on the band: its cells [n, 5], -inf where fill.cpp leaves
    -inf.  The plain version for CPU tensors; for CUDA tensors (float64
    only) the kernel, in one block where the widest wavefront fits it, else
    in as many blocks as that wavefront needs and the card holds resident
    at once; any other device raises."""
    global LAUNCHES
    lay = inp.layout
    dev = inp.absorb.device
    if dev.type == "cpu":
        return dag_fill_band_plain(inp)
    if dev.type != "cuda":
        raise RuntimeError(f"the DAG fill has no kernel for device {dev}")
    X1, Y1 = lay.shape
    N, W = inp.cells.shape[0], inp.wave.shape[0] - 1
    expect = {"cells": 2 * N, "wave": W + 1, "absorb": N, "x_ptr": X1 + 1, "y_ptr": Y1 + 1,
              "x_src": inp.x_lp.numel(), "y_src": inp.y_lp.numel(), "x_flags": X1,
              "y_flags": Y1, "insx": X1, "rootsubx": X1, "insy": Y1, "rootsuby": Y1,
              "trans": 18, "rowpos": X1, "off": X1 + 1, "diag": 2 * (X1 + Y1 - 1)}
    for name, count in expect.items():
        t = getattr(inp, name)
        if t.device != dev or t.numel() != count or not t.is_contiguous():
            raise ValueError(f"DAG fill input {name}: {t.numel()} elements on {t.device}, "
                             f"contiguous {t.is_contiguous()}; expected {count} on {dev}")
    for name in ("absorb", "x_lp", "y_lp", "insx", "rootsubx", "insy", "rootsuby", "trans"):
        if getattr(inp, name).dtype != torch.float64:
            raise ValueError(f"the DAG fill kernel takes float64, not "
                             f"{getattr(inp, name).dtype} ({name})")
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    widest = int((inp.wave[1:] - inp.wave[:-1]).max()) if W else 1
    threads = min(THREADS, max(32, -(-widest // 32) * 32))
    blocks = -(-widest // threads)
    if blocks > 1:
        with torch.cuda.device(dev):
            capacity = lib.dagfill_capacity_f64(threads)
        if capacity < 1:
            raise RuntimeError("dagfill: the card's resident-block capacity query failed")
        blocks = min(blocks, capacity)
    cells = torch.empty((lay.n, N_STATES), dtype=torch.float64, device=dev)
    arrivals = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [getattr(inp, name).data_ptr() for name in (
        "cells", "wave", "absorb", "x_ptr", "x_src", "x_lp", "y_ptr", "y_src", "y_lp",
        "x_flags", "y_flags", "insx", "rootsubx", "insy", "rootsuby", "trans", "rowpos",
        "off", "diag")]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dagfill_f64(*ptrs, cells.data_ptr(), arrivals.data_ptr(), lay.n, W, X1, Y1,
                               blocks, threads, stream)
    _kernels.check(code, "dagfill")
    LAUNCHES += 1
    LAST_LAUNCH.update(blocks=blocks, threads=threads, waves=W, widest=widest)
    return cells


def read_band(cells: torch.Tensor, layout: BandLayout, out: np.ndarray) -> None:
    """The filled band [n, 5] copied to the host once
    (`readback.gather_to_host`, logged in its READBACKS as a "dag") and
    scattered into the host grid `out` [x_size, y_size, 5] (-inf outside
    the band, as the caller filled it)."""
    (vals,) = gather_to_host("dag", cells, 0, None)
    ii, jj = np.divmod(layout.flat_index(), layout.shape[1])
    out.reshape(-1, N_STATES)[ii * out.shape[1] + jj] = vals.numpy()


def dag_forward_cells(dp, device: torch.device, out: np.ndarray) -> DagPlan:
    """Fill a merge whose x is not a chain on `device` and read its band
    into the host grid `out` [x_size, y_size, 5] (float64, filled with
    -inf by the caller); returns the plan."""
    p = plan(dp)
    read_band(dag_fill_band(upload_band(p, device)), p.layout, out)
    return p


def device_bytes(n_cells: int, nx: int, ny: int) -> int:
    """The card memory a fill of `n_cells` in-envelope cells takes at most:
    its band (no more than the in-envelope cells plus three a row) of 40 B
    a cell, the plan's 8 B and the absorb's 8 B a cell, the per-state
    arrays."""
    return (n_cells + 3 * nx + ny) * (40 + 16) + (nx + ny) * 64
