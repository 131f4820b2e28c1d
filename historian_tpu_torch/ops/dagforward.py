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

- `plan` is the host's part, per state and cheap: the in-edge CSRs,
  fill.cpp's levels (`levels`), each row's hull from the envelope's row
  ranges (`envelope_hull`) and the band over it (ops/branchdp.py
  `band_layout`), the in-envelope band cells in wavefront order, the
  state flags, the absorb factors ex/ey [S, C*A] and their shifts, and
  the design (`RING_MAX_CELLS`).  `upload_band` copies it up in one
  pinned buffer (`branchdp.pinned_upload`, logged in UPLOADS).
- `plan_records` is the per-cell part: a 64-byte record a cell (its
  band position, ring slot, first term, the end of each state's terms,
  the value each state adds after its sum, flags) and a 32-byte entry a
  term (the source's band position, ring slot or "outside the band",
  the term's kind, its lp or lps kept apart), and each wavefront's span
  of both.  On the card the plan kernel of csrc/dagfill.cu
  (`dagplan_*`, one thread a cell, PLAN_LAUNCHES); for CPU tensors
  `plan_records_plain`, the same records in PyTorch.
- `dag_fill_band` fills the band from the records: csrc/dagfill.cu for
  CUDA tensors (float64 only; a lane group of LANES a cell, the terms
  over its lanes, each state's sum folded in CSR order by its lane; the
  ring design keeps the last RING_WAVES wavefronts in shared memory and
  streams the records in ahead, the wide design is a cooperative launch
  reading sources from device memory), `dag_fill_band_plain` for CPU
  tensors: the same terms and folds, wavefront by wavefront, with the
  same ring.  Both leave -inf where fill.cpp does (outside the envelope,
  no path).
- `read_band` copies the band back once (`readback.gather_to_host`, kind
  "dag") into the host grid; `dag_forward_cells` is the bridge that
  engine/forward.py calls.

Not ported: the JAX bridge's shape buckets and `_device_io` (its
compile-cache machinery) and `_profile_dag_arrays`'s K-padded edges,
junction list and governors, which only the row scan needs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from historian_tpu_torch.native import csr_in_edges, get_native
from historian_tpu_torch.ops.branchdp import BandLayout, band_layout, pinned_upload
from historian_tpu_torch.ops.readback import gather_to_host

N_STATES = 5
IMM, IMD, IDM, IMI, IIW = range(5)
#: x state flags: null, ready (or the profile empty), emit or start
X_NULL, X_READY, X_EOS = 1, 2, 4
#: y state flags: null, ready (or the profile empty)
Y_NULL, Y_READY = 1, 2
#: lanes a cell (csrc/dagfill.cu kLanes)
LANES = 8
#: wavefronts the ring design keeps in shared memory (kRingWaves)
RING_WAVES = 8
#: the widest wavefront of the ring design: one block of 1024 threads
RING_MAX_CELLS = 1024 // LANES
#: threads a block of the wide design (a cooperative launch)
WIDE_THREADS = 256
#: a record (int32 words): add[5] (float64), pos, slot, t0, the ends of
#: IMM|IMD, IDM|IMI (16 bits each), IIW | flags << 16
REC_WORDS = 16
#: a term (int32 words): lpa, lpb (float64), loc, kind, two words unused
TERM_WORDS = 8
#: record flags: bit s, state s adds its value after the sum; ORIGIN
ORIGIN = 32
#: a term's source: band position (>= 0), OUTSIDE (reads -inf), or ring
#: slot r as -2 - r
OUTSIDE = -1
#: a cell's terms, at most (the ends are 16-bit)
MAX_TERMS = 32767
#: fill kernel launches made by `dag_fill_band` (never by the plain version)
LAUNCHES = 0
#: plan kernel launches made by `plan_records` (never by the plain version)
PLAN_LAUNCHES = 0
#: one entry a plan upload (`upload_band` on the card): bytes, the copy's ms
#: (CUDA events) and the host's ms packing it
UPLOADS: list = []
#: the last launch's design, lanes a cell, blocks, threads a block,
#: wavefronts, widest wavefront and terms
LAST_LAUNCH: dict = {}


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
    level of an in-edge's source (sources at or past the state ignored).
    Through fill.cpp itself (`state_levels`); in Python where the native
    library is off (HISTORIAN_NATIVE=0)."""
    lib = get_native()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.state_levels(n, np.ascontiguousarray(ptr, dtype=np.int64),
                         np.ascontiguousarray(src, dtype=np.int64), out)
        return out.astype(np.int64)
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


def envelope_hull(dp, nx: int, ny: int) -> tuple[np.ndarray, np.ndarray]:
    """`mask_hull` of the merge's mask [nx, ny] from the envelope's factored
    form, without a scan of the mask: a cell is in the envelope where its x
    state is near the start, its y state near the end, or |m1[i] - m2[j]|
    <= max_distance (engine/forward.py `_envelope_mask`).  m2 never falls
    along y in the profiles merged, so each row's range is one interval,
    found by binary search; where it does fall, the mask is scanned."""
    X1, Y1 = nx, ny
    lo = np.full(X1, Y1, dtype=np.int64)
    hi = np.zeros(X1, dtype=np.int64)
    if X1 <= 2 or Y1 <= 2:
        return lo, hi
    if dp.env_vectors is None:  # no envelope: every cell
        lo[1:-1], hi[1:-1] = 1, Y1 - 2
        return lo, hi
    m1, m2, dist = dp.env_vectors
    m1, m2 = m1[1:X1 - 1], m2[1:Y1 - 1]
    if np.any(np.diff(m2) < 0):
        return mask_hull(dp.env_mask[:nx, :ny])
    a = np.searchsorted(m2, m1 - dist, side="left")
    b = np.searchsorted(m2, m1 + dist, side="right") - 1
    ends = np.flatnonzero(dp.y_near_end[1:Y1 - 1])
    if len(ends):
        a = np.minimum(a, ends[0])
        b = np.maximum(b, ends[-1])
    start = dp.x_near_start[1:X1 - 1]
    a[start], b[start] = 0, Y1 - 3
    some = b >= a
    lo[1:-1] = np.where(some, a + 1, Y1)
    hi[1:-1] = np.where(some, b + 1, 0)
    return lo, hi


@dataclass
class DagPlan:
    """A merge's fill plan on the host, for a grid of nx = x_size - 1 rows
    and ny = y_size - 1 columns (the END states excluded): the band
    `layout`; the in-envelope cells `cells` [N, 2] (i, j) sorted by
    wavefront (row-major within one), `wave` [W + 1] where each non-empty
    wavefront starts; the in-edge CSRs of states 0..nx-1 and 0..ny-1 (ptr,
    src, lp); the flags (X_*, Y_*), the emission vectors, the absorb
    factors (ex [nx, C*A], shift_x [nx], ey [ny, C*A], shift_y [ny]) and
    the 18 transitions; `ring` (the ring design) and `host_ms`, the host's
    ms by part."""

    layout: BandLayout
    cells: np.ndarray
    wave: np.ndarray
    x_csr: tuple
    y_csr: tuple
    x_flags: np.ndarray
    y_flags: np.ndarray
    insx: np.ndarray
    rootsubx: np.ndarray
    insy: np.ndarray
    rootsuby: np.ndarray
    factors: tuple
    trans: np.ndarray
    host_ms: dict = field(default_factory=dict)

    @property
    def widest(self) -> int:
        return int(np.diff(self.wave).max(initial=0))

    @property
    def ring(self) -> bool:
        return self.widest <= RING_MAX_CELLS


def _csr(profile, n: int) -> tuple:
    ptr, src, lp = csr_in_edges(profile)
    ptr = ptr[: n + 1]
    return ptr, src[: ptr[-1]], lp[: ptr[-1]]


def wavefront_order(w: np.ndarray) -> np.ndarray:
    """The stable order of cells by wavefront w (a radix sort where the
    wavefronts fit 16 bits)."""
    if len(w) and w.max() < 2**16:
        return np.argsort(w.astype(np.uint16), kind="stable")
    return np.argsort(w, kind="stable")


def plan(dp) -> DagPlan:
    """The plan of a merge (a ForwardMatrix whose profiles are not empty)."""
    ms, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    nx, ny = dp.x_size - 1, dp.y_size - 1
    x_csr, y_csr = _csr(dp.x, nx), _csr(dp.y, ny)
    lap("csr")
    lx, ly = levels(*x_csr[:2], nx), levels(*y_csr[:2], ny)
    lap("levels")
    layout = band_layout(*envelope_hull(dp, nx, ny), nx, ny)
    lap("hull")
    ii, jj = np.divmod(layout.flat_index(), ny)
    if dp.env_vectors is not None:
        keep = dp.env_mask[ii, jj]  # the band's in-envelope cells, row-major
        ii, jj = ii[keep], jj[keep]
    lap("cells")
    w = lx[ii] + ly[jj]
    order = wavefront_order(w)
    ii, jj, w = ii[order], jj[order], w[order]
    starts = np.flatnonzero(np.diff(w)) + 1
    wave = np.concatenate([[0], starts, [len(w)]]).astype(np.int64)
    cells = np.stack([ii, jj], axis=1)
    lap("order")
    x_flags = (dp.x_null[:nx] * X_NULL + (dp.x_ready[:nx] | dp.x_empty) * X_READY
               + dp.x_emit_or_start[:nx] * X_EOS).astype(np.uint8)
    y_flags = (dp.y_null[:ny] * Y_NULL + (dp.y_ready[:ny] | dp.y_empty) * Y_READY).astype(np.uint8)
    ex, shift_x, ey, shift_y = dp.absorb_factors
    factors = (ex[:nx], shift_x[:nx], ey[:ny], shift_y[:ny])
    lap("flags")
    return DagPlan(layout, cells, wave, x_csr, y_csr, x_flags, y_flags,
                   dp.insx[:nx], dp.rootsubx[:nx], dp.insy[:ny], dp.rootsuby[:ny],
                   factors, trans18(dp.hmm), ms)


@dataclass
class DagBandInputs:
    """A band fill's inputs, all on one device: the plan's cells [N, 2]
    (int32), wave [W + 1] (int32); the CSRs' ptr and src (int32) and lp;
    the flags (uint8); insx, rootsubx [nx], insy, rootsuby [ny]; ex [nx,
    C*A], shift_x [nx], ey [ny, C*A], shift_y [ny]; trans [18]; the
    layout's rowpos, off and diag (int32); the design (`ring`) and the
    ring's row of slots (`ring_width`, the widest wavefront)."""

    layout: BandLayout
    cells: torch.Tensor
    wave: torch.Tensor
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
    ex: torch.Tensor
    shift_x: torch.Tensor
    ey: torch.Tensor
    shift_y: torch.Tensor
    trans: torch.Tensor
    rowpos: torch.Tensor
    off: torch.Tensor
    diag: torch.Tensor
    ring: bool
    ring_width: int


def _host_parts(p: DagPlan) -> dict:
    """name: (numpy dtype, host array) of every input, in upload order."""
    lay = p.layout
    ex, shift_x, ey, shift_y = p.factors
    return {
        "x_lp": (np.float64, p.x_csr[2]), "y_lp": (np.float64, p.y_csr[2]),
        "insx": (np.float64, p.insx), "rootsubx": (np.float64, p.rootsubx),
        "insy": (np.float64, p.insy), "rootsuby": (np.float64, p.rootsuby),
        "ex": (np.float64, ex.reshape(-1)), "shift_x": (np.float64, shift_x),
        "ey": (np.float64, ey.reshape(-1)), "shift_y": (np.float64, shift_y),
        "trans": (np.float64, p.trans),
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
    ca = p.factors[0].shape[1]
    dev["ex"] = dev["ex"].view(-1, ca)
    dev["ey"] = dev["ey"].view(-1, ca)
    return DagBandInputs(p.layout, **dev, ring=p.ring, ring_width=max(p.widest, 1))


@dataclass
class DagRecords:
    """The per-cell plan on the inputs' device: `recs` [N, REC_WORDS] and
    `terms` [T, TERM_WORDS] (int32 words, float64 fields viewed), `spans`
    [W, 4] (each wavefront's first and end record, first and end term)."""

    recs: torch.Tensor
    terms: torch.Tensor
    spans: torch.Tensor

    def fields(self) -> dict:
        """The records' and terms' fields as tensors (for the plain fill and
        the tests)."""
        r, t = self.recs, self.terms
        flags_ends = r[:, 13:16].to(torch.int64) & 0xFFFFFFFF
        ends = torch.stack([flags_ends[:, 0] & 0xFFFF, flags_ends[:, 0] >> 16,
                            flags_ends[:, 1] & 0xFFFF, flags_ends[:, 1] >> 16,
                            flags_ends[:, 2] & 0xFFFF], dim=1)
        return dict(add=r.view(torch.float64)[:, :5], pos=r[:, 10].long(), slot=r[:, 11].long(),
                    t0=r[:, 12].long(), ends=ends, flags=flags_ends[:, 2] >> 16,
                    lpa=t.view(torch.float64)[:, 0], lpb=t.view(torch.float64)[:, 1],
                    loc=t[:, 4].long(), kind=t[:, 5].long())


# ------------------------------------------------------------ plain version
#: fill.cpp's lse2: torch.logaddexp computes the same max + log1p(exp(-|x -
#: y|)), and -inf for two -infs, where fill.cpp's x + LOG2 gives -inf too
lse2 = torch.logaddexp


def band_pos(inp: DagBandInputs, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The band position of cells (x, y) (int64), n where a cell lies
    outside the band (band.cuh `kind_of`, `pos_of`)."""
    lay = inp.layout
    Y = lay.shape[1] - 1
    off = inp.off.long()
    lo = torch.from_numpy(lay.lo).to(x.device)[x]
    hi = torch.from_numpy(lay.hi).to(x.device)[x]
    p = torch.where((y >= lo) & (y <= hi), inp.rowpos.long()[x] + y, lay.n)
    return torch.where(y == 0, off[x], torch.where(y == Y, off[x + 1] - 1, p))


def _segments(counts: torch.Tensor):
    """(owner, rank) of each item when owner k has counts[k] of them."""
    owner = torch.repeat_interleave(torch.arange(len(counts), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(len(owner), device=counts.device) - first[owner]


def absorb_plain(inp: DagBandInputs, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """`DPMatrix.absorb` at cells (ci, cj) as the plan kernel computes it:
    the factors' products summed in order of k (each product and sum
    rounded apart), its log, then the x and the y shift."""
    s = torch.zeros(len(ci), dtype=torch.float64, device=ci.device)
    for k in range(inp.ex.shape[1]):
        s = s + inp.ex[ci, k] * inp.ey[cj, k]
    return torch.log(s) + inp.shift_x[ci] + inp.shift_y[cj]


def plan_records_plain(inp: DagBandInputs) -> DagRecords:
    """The records, terms and spans of csrc/dagfill.cu's plan kernel, in
    PyTorch on the inputs' device.  A cell's terms go state by state (IMM,
    IMD, IDM, IMI, IIW), each state's in CSR order (the xy sources x
    in-edge outer), as fwd_cell sums them; a source lies in the ring when
    the design has one and it is fewer than RING_WAVES wavefronts back."""
    dev = inp.wave.device
    i64 = torch.int64
    ci, cj = inp.cells[:, 0].long(), inp.cells[:, 1].long()
    N, W = len(ci), len(inp.wave) - 1
    wave = inp.wave.long()
    wave_of = torch.repeat_interleave(torch.arange(W, device=dev), wave[1:] - wave[:-1])
    rank = torch.arange(N, device=dev)
    R, RW = RING_WAVES, inp.ring_width
    slot_of = (wave_of % R) * RW + rank - wave[wave_of]
    pos = band_pos(inp, ci, cj)
    rank_of = torch.full((inp.layout.n + 1,), -1, dtype=i64, device=dev)
    rank_of[pos] = rank

    xf, yf = inp.x_flags[ci].long(), inp.y_flags[cj].long()
    xnull, xrdy, xeos = (xf & X_NULL) != 0, (xf & X_READY) != 0, (xf & X_EOS) != 0
    ynull, yrdy = (yf & Y_NULL) != 0, (yf & Y_READY) != 0
    x_ptr, y_ptr = inp.x_ptr.long(), inp.y_ptr.long()
    kx, ky = x_ptr[ci + 1] - x_ptr[ci], y_ptr[cj + 1] - y_ptr[cj]
    full = ~xnull & ~ynull
    pass_y = ~full & ynull & xeos  # IMM from (i, y source)
    pass_x = ~full & ~pass_y & xnull & yrdy  # IMM from (x source, j)
    zero = torch.zeros_like(kx)
    n_imm = torch.where(full, kx * ky, torch.where(pass_y, ky, torch.where(pass_x, kx, zero)))
    n_x = torch.where(yrdy, kx, zero)  # IMD and IIW
    n_y = torch.where(ynull | xrdy, ky, zero)  # IDM and IMI
    counts = torch.stack([n_imm, n_x, n_y, n_y, n_x], dim=1)
    ends = torch.cumsum(counts, 1)
    if N and int(ends[:, 4].max()) > MAX_TERMS:
        raise ValueError(f"a DAG fill cell has more than {MAX_TERMS} terms")
    total = ends[:, 4]
    t0 = torch.cumsum(total, 0) - total
    T = int(total.sum())

    lpa = torch.zeros(T, dtype=torch.float64, device=dev)
    lpb = torch.zeros(T, dtype=torch.float64, device=dev)
    sx = torch.zeros(T, dtype=i64, device=dev)
    sy = torch.zeros(T, dtype=i64, device=dev)
    kind = torch.zeros(T, dtype=i64, device=dev)
    owner_w = torch.zeros(T, dtype=i64, device=dev)
    starts = ends - counts
    for s in range(N_STATES):
        c, r = _segments(counts[:, s])
        at = t0[c] + starts[c, s] + r
        owner_w[at] = wave_of[c]
        i, j = ci[c], cj[c]
        if s == IMM:
            f, py = full[c], pass_y[c]
            k_y = ky[c].clamp(min=1)
            ex_ = torch.where(f, r // k_y, r)  # x in-edge (full or pass_x)
            ey_ = torch.where(f, r % k_y, r)  # y in-edge (full or pass_y)
            e_x = (x_ptr[i] + ex_).clamp(max=max(len(inp.x_src) - 1, 0))
            e_y = (y_ptr[j] + ey_).clamp(max=max(len(inp.y_src) - 1, 0))
            xs, xl = inp.x_src.long()[e_x], inp.x_lp[e_x]
            ys, yl = inp.y_src.long()[e_y], inp.y_lp[e_y]
            sx[at] = torch.where(py, i, xs)
            sy[at] = torch.where(f | py, ys, j)
            lpa[at] = torch.where(py, yl, xl)
            lpb[at] = torch.where(f, yl, 0.0)
            kind[at] = torch.where(f, IMM, N_STATES + IMM)
        elif s in (IMD, IIW):
            e = x_ptr[i] + r
            sx[at], sy[at], lpa[at] = inp.x_src.long()[e], j, inp.x_lp[e]
            kind[at] = torch.where(xnull[c], N_STATES + s, s)
        else:
            e = y_ptr[j] + r
            sx[at], sy[at], lpa[at] = i, inp.y_src.long()[e], inp.y_lp[e]
            kind[at] = torch.where(ynull[c], N_STATES + s, s)
    spos = band_pos(inp, sx, sy)
    src = rank_of[spos]
    near = (src >= 0) & (owner_w - wave_of[src.clamp(min=0)] < R) & inp.ring
    loc = torch.where(src < 0, OUTSIDE, torch.where(near, -2 - slot_of[src.clamp(min=0)], spos))

    add_x = ~xnull & yrdy
    add_y = ~ynull & xrdy
    zero_f = torch.zeros(N, dtype=torch.float64, device=dev)
    absorb = torch.where(full, absorb_plain(inp, ci, cj), zero_f)
    adds = torch.stack([absorb, torch.where(add_x, inp.rootsubx[ci], zero_f),
                        torch.where(add_y, inp.rootsuby[cj], zero_f),
                        torch.where(add_y, inp.insy[cj], zero_f),
                        torch.where(add_x, inp.insx[ci], zero_f)], dim=1)
    flags = (full.long() | add_x.long() << IMD | add_y.long() << IDM | add_y.long() << IMI
             | add_x.long() << IIW | ((ci == 0) & (cj == 0)).long() * ORIGIN)

    recs = torch.zeros((N, REC_WORDS), dtype=torch.int32, device=dev)
    recs.view(torch.float64)[:, :5] = adds
    recs[:, 10] = pos.to(torch.int32)
    recs[:, 11] = (slot_of if inp.ring else torch.full_like(slot_of, -1)).to(torch.int32)
    recs[:, 12] = t0.to(torch.int32)
    recs[:, 13] = (ends[:, 0] | ends[:, 1] << 16).to(torch.int32)
    recs[:, 14] = (ends[:, 2] | ends[:, 3] << 16).to(torch.int32)
    recs[:, 15] = (ends[:, 4] | flags << 16).to(torch.int32)
    terms = torch.zeros((T, TERM_WORDS), dtype=torch.int32, device=dev)
    terms.view(torch.float64)[:, 0] = lpa
    terms.view(torch.float64)[:, 1] = lpb
    terms[:, 4] = loc.to(torch.int32)
    terms[:, 5] = kind.to(torch.int32)
    t_end = torch.cumsum(total, 0)
    spans = torch.stack([wave[:-1], wave[1:], t0[wave[:-1]] if N else wave[:-1],
                         t_end[wave[1:] - 1] if N else wave[1:]], dim=1).to(torch.int32)
    return DagRecords(recs, terms, spans)


#: each full kind's sources' states and transitions (fill.cpp Trans index),
#: in fwd_cell's order of its sum
FULL_FORMS = {
    IMM: ((IMM, 0), (IMD, 5), (IDM, 8), (IMI, 11), (IIW, 15)),
    IMD: ((IMM, 1), (IMD, 6), (IDM, 9), (IMI, 12)),
    IDM: ((IMM, 2), (IMD, 7), (IDM, 10), (IIW, 16)),
    IMI: ((IMM, 3), (IMI, 13)),
    IIW: ((IMM, 4), (IMI, 14), (IIW, 17)),
}


def term_values(sc: torch.Tensor, kind: torch.Tensor, lpa: torch.Tensor, lpb: torch.Tensor,
                trans: list) -> torch.Tensor:
    """Each term's value from its source's five cells `sc` [m, 5]: a full
    kind s, fwd_cell's sum for state s (lse2 left to right) plus lpa (and
    lpb for IMM); a pass-through kind 5 + s, sc[s] plus lpa.  Every form
    is computed for every term and the term's kind picked (no host sync)."""
    out = sc.gather(1, (kind % N_STATES)[:, None])[:, 0] + lpa
    for s, form in FULL_FORMS.items():
        acc = sc[:, form[0][0]] + trans[form[0][1]]
        for state, t in form[1:]:
            acc = lse2(acc, sc[:, state] + trans[t])
        acc = acc + lpa
        if s == IMM:
            acc = acc + lpb
        out = torch.where(kind == s, acc, out)
    return out


def dag_fill_band_plain(inp: DagBandInputs, recs: DagRecords | None = None) -> torch.Tensor:
    """The band's cells [n, 5] (IMM IMD IDM IMI IIW), float64, wavefront by
    wavefront in PyTorch from the records (`plan_records_plain` unless
    given): each term from its source (the band, -inf outside it, or the
    ring of the last RING_WAVES wavefronts, which it keeps as the kernel
    does), each state's terms folded with fill.cpp's lse2 in CSR order,
    then its value added; -inf outside the envelope and where no path
    reaches."""
    if recs is None:
        recs = plan_records_plain(inp)
    dev = inp.wave.device
    f64, i64 = torch.float64, torch.int64
    n = inp.layout.n
    f = recs.fields()
    trans = inp.trans.to(f64).tolist()
    N, T = len(f["t0"]), len(f["kind"])
    # each term's (cell, state) run and its step in that run, the fold's order
    cell_of = torch.repeat_interleave(torch.arange(N, device=dev), f["ends"][:, 4])
    rel = torch.arange(T, device=dev) - f["t0"][cell_of]
    state = (rel[:, None] >= f["ends"][cell_of]).sum(1)
    starts = torch.cat([torch.zeros_like(f["ends"][:, :1]), f["ends"][:, :4]], 1)
    step = rel - starts[cell_of, state]
    counts = f["ends"] - starts
    spans = recs.spans.long()
    wave_of = torch.repeat_interleave(torch.arange(len(spans), device=dev),
                                      spans[:, 1] - spans[:, 0])
    longest = torch.zeros(len(spans), dtype=i64, device=dev).scatter_reduce(
        0, wave_of, counts.amax(1), "amax").tolist()
    bits = 1 << torch.arange(N_STATES, device=dev)
    # one row more each: -inf, the value of a source outside the band
    cells = torch.full((n + 1, N_STATES), -torch.inf, dtype=f64, device=dev)
    ring = torch.full((RING_WAVES * inp.ring_width + 1, N_STATES), -torch.inf, dtype=f64,
                      device=dev)
    loc = f["loc"]
    in_ring = loc <= -2
    band_at = torch.where(loc >= 0, loc, n)
    ring_at = torch.where(in_ring, -2 - loc, len(ring) - 1)  # the last row: -inf
    for (a, b, ta, tb), K in zip(spans.tolist(), longest):
        sc = torch.where(in_ring[ta:tb, None], ring[ring_at[ta:tb]], cells[band_at[ta:tb]])
        v = term_values(sc, f["kind"][ta:tb], f["lpa"][ta:tb], f["lpb"][ta:tb], trans)
        runs = torch.full(((b - a) * N_STATES, max(K, 1)), -torch.inf, dtype=f64, device=dev)
        runs[(cell_of[ta:tb] - a) * N_STATES + state[ta:tb], step[ta:tb]] = v
        have = counts[a:b].reshape(-1)
        acc = runs[:, 0]
        for k in range(1, K):
            acc = torch.where(have > k, lse2(acc, runs[:, k]), acc)
        acc = acc.view(b - a, N_STATES)
        flags = f["flags"][a:b, None]
        acc = torch.where((flags & bits) != 0, acc + f["add"][a:b], acc)
        acc[:, IMM] = torch.where((flags[:, 0] & ORIGIN) != 0, 0.0, acc[:, IMM])
        cells[f["pos"][a:b]] = acc
        if inp.ring:
            ring[f["slot"][a:b]] = acc
    return cells[:n]


# ------------------------------------------------------------------ kernel
_F64 = ("insx", "rootsubx", "insy", "rootsuby", "ex", "shift_x", "ey", "shift_y", "trans",
        "x_lp", "y_lp")


def _check(inp: DagBandInputs, dev: torch.device) -> None:
    X1, Y1 = inp.layout.shape
    ca = inp.ex.shape[1] if inp.ex.dim() == 2 else 0
    expect = {"cells": 2 * inp.cells.shape[0], "wave": inp.wave.numel(), "x_ptr": X1 + 1,
              "y_ptr": Y1 + 1, "x_src": inp.x_lp.numel(), "y_src": inp.y_lp.numel(),
              "x_flags": X1, "y_flags": Y1, "insx": X1, "rootsubx": X1, "insy": Y1,
              "rootsuby": Y1, "ex": X1 * ca, "shift_x": X1, "ey": Y1 * ca, "shift_y": Y1,
              "trans": 18, "rowpos": X1, "off": X1 + 1, "diag": 2 * (X1 + Y1 - 1)}
    for name, count in expect.items():
        t = getattr(inp, name)
        if t.device != dev or t.numel() != count or not t.is_contiguous():
            raise ValueError(f"DAG fill input {name}: {t.numel()} elements on {t.device}, "
                             f"contiguous {t.is_contiguous()}; expected {count} on {dev}")
    for name in _F64:
        if getattr(inp, name).dtype != torch.float64:
            raise ValueError(f"the DAG fill kernel takes float64, not "
                             f"{getattr(inp, name).dtype} ({name})")


def plan_records(inp: DagBandInputs) -> tuple[DagRecords, torch.Tensor]:
    """The per-cell plan and the band [n, 5] set to -inf, on the inputs'
    device: the plain version for CPU tensors; for CUDA tensors the plan
    kernel (csrc/dagfill.cu `dagplan_*`, one thread a cell: the band and
    the source map set, the terms counted, their offsets summed, the
    records and terms written); any other device raises."""
    global PLAN_LAUNCHES
    dev = inp.wave.device
    lay = inp.layout
    if dev.type == "cpu":
        return (plan_records_plain(inp),
                torch.full((lay.n, N_STATES), -torch.inf, dtype=torch.float64))
    if dev.type != "cuda":
        raise RuntimeError(f"the DAG fill has no kernel for device {dev}")
    _check(inp, dev)
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    X1, Y1 = lay.shape
    N, W = inp.cells.shape[0], inp.wave.shape[0] - 1
    i32 = dict(dtype=torch.int32, device=dev)
    cells = torch.empty((lay.n, N_STATES), dtype=torch.float64, device=dev)
    rank_of = torch.empty(lay.n, **i32)
    wave_of = torch.empty(max(N, 1), **i32)
    counts = torch.empty(max(N, 1), **i32)
    recs = torch.empty((N, REC_WORDS), **i32)
    spans = torch.empty((W, 4), **i32)
    geo = [inp.cells, inp.wave, inp.x_ptr, inp.x_src, inp.x_lp, inp.y_ptr, inp.y_src, inp.y_lp,
           inp.x_flags, inp.y_flags, inp.insx, inp.rootsubx, inp.insy, inp.rootsuby, inp.ex,
           inp.shift_x, inp.ey, inp.shift_y, inp.rowpos, inp.off, inp.diag]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dagplan_count_f64(*(t.data_ptr() for t in geo), cells.data_ptr(),
                                     rank_of.data_ptr(), wave_of.data_ptr(), counts.data_ptr(),
                                     lay.n, N, W, X1, Y1, inp.ex.shape[1], stream)
        _kernels.check(code, "dagplan_count")
        incl = torch.cumsum(counts[:N], 0, dtype=torch.int32)
        T = int(incl[-1]) if N else 0
        terms = torch.empty((T, TERM_WORDS), **i32)
        code = lib.dagplan_records_f64(*(t.data_ptr() for t in geo), rank_of.data_ptr(),
                                       wave_of.data_ptr(), counts.data_ptr(), incl.data_ptr(),
                                       recs.data_ptr(), terms.data_ptr(), spans.data_ptr(),
                                       lay.n, N, W, X1, Y1, inp.ex.shape[1], RING_WAVES,
                                       inp.ring_width, int(inp.ring), stream)
        _kernels.check(code, "dagplan_records")
    PLAN_LAUNCHES += 1
    return DagRecords(recs, terms, spans), cells


def dag_fill_band(inp: DagBandInputs, planned: tuple | None = None) -> torch.Tensor:
    """Kernel (a) on the band: its cells [n, 5], -inf where fill.cpp leaves
    -inf, from the plan (`plan_records(inp)` unless given).  The plain
    version for CPU tensors; for CUDA tensors (float64 only) the kernel:
    the ring design in one block where the widest wavefront has at most
    RING_MAX_CELLS cells, else the wide design in as many blocks of
    WIDE_THREADS as that wavefront needs and the card holds resident at
    once (a cooperative launch); any other device raises."""
    global LAUNCHES
    lay = inp.layout
    dev = inp.wave.device
    if dev.type == "cpu":
        return dag_fill_band_plain(inp, planned[0] if planned is not None else None)
    if dev.type != "cuda":
        raise RuntimeError(f"the DAG fill has no kernel for device {dev}")
    recs, cells = planned if planned is not None else plan_records(inp)
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    W = recs.spans.shape[0]
    widest = inp.ring_width
    if inp.ring:
        threads = max(32, -(-widest * LANES // 32) * 32)
        blocks = 1
    else:
        threads = WIDE_THREADS
        blocks = -(-widest * LANES // threads)
        with torch.cuda.device(dev):
            capacity = lib.dagfill_capacity_f64(threads)
        if capacity < 1:
            raise RuntimeError("dagfill: the card's resident-block capacity query failed")
        blocks = min(blocks, capacity)
    arrivals = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dagfill_f64(recs.recs.data_ptr(), recs.terms.data_ptr(),
                               recs.spans.data_ptr(), inp.trans.data_ptr(), cells.data_ptr(),
                               arrivals.data_ptr(), W, RING_WAVES if inp.ring else 0, widest,
                               blocks, threads, stream)
    _kernels.check(code, "dagfill")
    LAUNCHES += 1
    LAST_LAUNCH.update(design="ring" if inp.ring else "wide", lanes=LANES, blocks=blocks,
                       threads=threads, waves=W, widest=widest, terms=recs.terms.shape[0])
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


def device_bytes(n_cells: int, nx: int, ny: int, terms_per_cell: float = 10.0) -> int:
    """The card memory a fill of `n_cells` in-envelope cells takes at most:
    its band (no more than the in-envelope cells plus three a row) of 40 B
    a cell and its source map's 4 B; the plan's 8 B, the record's 64 B,
    12 B of the plan kernel's scratch and `terms_per_cell` terms of 32 B
    (2 (kx ky + 2 kx + 2 ky) at the profiles' mean in-degrees, from
    `devicedp.merge_fits`) a cell; the per-state arrays."""
    return (int((n_cells + 3 * nx + ny) * 44 + n_cells * (8 + 64 + 12 + 32 * terms_per_cell))
            + (nx + ny) * 256)
