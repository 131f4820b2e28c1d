"""Branch fill: the 3-state (Match/Insert/Delete) alignment of a parent
position-weight matrix to a child PWM, Viterbi or Forward.

Port of historian_tpu/ops/branchdp.py (`_branch_fill`, `branch_viterbi`,
`branch_forward`).  `branch_fill_plain` is the JAX formulation in
PyTorch: a scan over y columns, Match and Insert from the previous
column, Delete as a segmented prefix scan over x (`_seg_scan`, the
`_seg_combine_max` / `_seg_combine_lse` of the JAX package).

The card fills the band only (`band_layout`): rows 0 and X whole, and on
each row 0 < x < X its column 0, its hull [lo(x), hi(x)] of in-mask
interior columns and its column Y, packed row after row.
`branch_fill_band` is the band's entry: the hand-written CUDA kernel
csrc/branchfill.cu for CUDA tensors (float64), which keeps the host
route's per-cell order (csrc/fill.cpp `branch_fill`), so its Viterbi
cells equal the host's bit for bit, in one of two designs (DESIGNS): the
ring, one block, where a diagonal fits it, else the strips, a pipeline of
row strips over many SMs (`strip_plan`); `branch_fill_band_plain`, the
plain full fill gathered at the band, for CPU tensors.  `upload_band` packs a
host grid's band into one pinned buffer and copies it once;
`read_band` copies the filled band back once, and `BandCells` answers
the host traceback's cell reads from it (a cell outside the band is NEG
in all three states, as it is outside the mask).  `branch_fill` keeps
the JAX package's signature: the plain version on the CPU, and on the
card the band of the mask taken where the mask lies, the kernel, and
the band scattered into a NEG grid.
"""

from __future__ import annotations


import time
from dataclasses import dataclass

import numpy as np
import torch

from historian_tpu_torch.ops.readback import gather_to_host

NEG = -1e30

MATCH, INSERT, DELETE = 0, 1, 2

#: kernel launches made by `branch_fill_band` (never by the plain version)
LAUNCHES = 0
#: those launches by design (csrc/branchfill.cu): "ring", one block with
#: the previous two diagonals in shared memory, for a band whose diagonals
#: hold at most RING_MAX_CELLS cells; "strip", a pipeline of row strips
#: over many SMs, for the rest (a full mask, a wide envelope)
DESIGNS = {"ring": 0, "strip": 0}
#: those launches by mode: the refiner's Viterbi, the sampler's Forward
MODES = {"viterbi": 0, "forward": 0}
#: the last launch's design and shape: the ring's threads and slots, or
#: the strip plan (`strip_plan`)
LAST_LAUNCH: dict = {}
#: the ring design's largest block, one thread a cell of a diagonal
#: (csrc/branchfill.cu kRingMaxCells)
RING_MAX_CELLS = 256
#: the ring design's plan record (csrc/branchfill.cu Rec)
PLAN_RECORD_BYTES = 32
#: the strip design's rows a strip (a multiple of 32) and its lead, the
#: diagonals of the row above its io warp may stage ahead (csrc/branchfill.cu
#: kStripMaxRows, kStripMaxLead)
STRIP_MAX_ROWS = 256
STRIP_MAX_LEAD = 254
#: the strip design's layout by mode, (rows a strip, lead): the fastest of
#: `branch_bench.py --sweep` (rows 32-192 x lead 2-64) at long6 `mcmc`'s
#: full-mask fill (5997 x 5807) on an H100 80GB HBM3 at 700 W: Viterbi
#: 6.475 ms, Forward 15.400 (128 rows 16.034, 64 rows 17.300)
STRIP_RULE = {"viterbi": (64, 16), "forward": (96, 8)}
#: the strip design's resident blocks by (device, rows, lead, mode), asked
#: of the card once each
_CAPACITY: dict = {}
#: one entry a band upload (`upload_band` on the card): bytes, the copy's
#: ms (CUDA events) and the host's ms packing the band into pinned memory
UPLOADS: list = []


def _seg_scan(z: torch.Tensor, flag: torch.Tensor, viterbi: bool) -> torch.Tensor:
    """Inclusive scan of z along dim 0 under max (Viterbi) or logaddexp
    (Forward), restarting where flag is set (the JAX package's segmented
    combine: (vl, fl) o (vr, fr) = (vr if fr else red(vl, vr), fl | fr)),
    by doubling steps."""
    red = torch.maximum if viterbi else torch.logaddexp
    v, f = z, flag
    d = 1
    while d < len(v):
        nv = torch.where(f[d:], v[d:], red(v[:-d], v[d:]))
        nf = f[:-d] | f[d:]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def branch_fill_plain(match_emit, ins_emit, mask, trans, viterbi: bool) -> torch.Tensor:
    """match_emit [X+1, Y+1] (valid at x, y >= 1); ins_emit [Y+1]; mask
    [X+1, Y+1] bool; trans [8] = mm, mi, md, im, ii, id, dm, dd.  Returns
    the cells [X+1, Y+1, 3] (Match, Insert, Delete)."""
    mm, mi, md, im, ii, id_, dm, dd = (trans[k] for k in range(8))
    X1, Y1 = match_emit.shape
    dtype, dev = match_emit.dtype, match_emit.device
    reduce2 = torch.maximum if viterbi else torch.logaddexp
    idx = torch.arange(X1, dtype=dtype, device=dev)
    neg = torch.full((X1,), NEG, dtype=dtype, device=dev)
    neg1 = neg[:1]
    out = torch.empty((X1, Y1, 3), dtype=dtype, device=dev)

    def shift_down(v):
        return torch.cat([neg1, v[:-1]])

    m_p = i_p = d_p = neg
    for y in range(Y1):
        mask_col = mask[:, y]
        if y == 0:
            m = torch.where(idx == 0, torch.zeros_like(neg), neg)
            i = neg
        else:
            m = reduce2(reduce2(shift_down(m_p) + mm, shift_down(i_p) + im), shift_down(d_p) + dm)
            m = m + match_emit[:, y]
            i = reduce2(m_p + mi, i_p + ii) + ins_emit[y]
        m = torch.where(mask_col, m, neg)
        i = torch.where(mask_col, i, neg)
        # Delete: d[x] = red(base[x], d[x-1] + dd), base from this column
        base = reduce2(shift_down(m) + md, shift_down(i) + id_)
        z = torch.where(mask_col, base - idx * dd, neg)
        seg = _seg_scan(z, ~mask_col, viterbi)
        d = torch.where(mask_col, seg + idx * dd, neg)
        out[:, y, 0], out[:, y, 1], out[:, y, 2] = m, i, d
        m_p, i_p, d_p = m, i, d
    return out


def _check_inputs(match_emit, ins_emit, mask, trans) -> None:
    dev = match_emit.device
    X1, Y1 = match_emit.shape
    if ins_emit.shape != (Y1,) or mask.shape != (X1, Y1) or trans.shape != (8,):
        raise ValueError(f"branch fill shapes: emit {tuple(match_emit.shape)}, ins "
                         f"{tuple(ins_emit.shape)}, mask {tuple(mask.shape)}, trans "
                         f"{tuple(trans.shape)}")
    for t in (ins_emit, mask, trans):
        if t.device != dev:
            raise ValueError("branch fill inputs lie on different devices")
    if mask.dtype != torch.bool:
        raise ValueError(f"branch fill mask must be bool, not {mask.dtype}")


def interior_hull(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), int64 [X+1]: on each row of the mask [X+1, Y+1] the first
    and the last in-mask interior column (0 < y < Y), computed where the
    mask lies; (Y+1, 0) on a row with none and on rows 0 and X."""
    X1, Y1 = mask.shape
    lo = torch.full((X1,), Y1, dtype=torch.int64, device=mask.device)
    hi = torch.zeros(X1, dtype=torch.int64, device=mask.device)
    if X1 > 2 and Y1 > 2:
        inner = mask[1:-1, 1:-1].to(torch.uint8)
        some = inner.amax(dim=1) > 0
        lo[1:-1] = torch.where(some, inner.argmax(dim=1) + 1, Y1)
        hi[1:-1] = torch.where(some, Y1 - 2 - inner.flip(1).argmax(dim=1), 0)
    return lo, hi


@dataclass
class BandLayout:
    """The band of a [X+1, Y+1] grid (csrc/branchfill.cu), in numpy on the
    host: per row its hull lo..hi (rows 0 and X: 0..Y), `off` [X+2] where
    each row starts in the packed band, `rowpos` [X+1] with a hull cell
    (x, y) at rowpos[x] + y, (x, 0) at off[x] and (x, Y) at off[x + 1] - 1;
    per anti-diagonal k its first and last hull row `diag` [X+Y+1, 2]; n
    cells in all, `widest` cells on the fullest diagonal, `span` hull rows
    on the fullest."""

    shape: tuple
    lo: np.ndarray
    hi: np.ndarray
    off: np.ndarray
    rowpos: np.ndarray
    diag: np.ndarray
    n: int
    widest: int
    span: int

    def flat_index(self) -> np.ndarray:
        """int64 [n]: x * (Y+1) + y of each band cell, in band order."""
        X1, Y1 = self.shape
        # a hull cell (or one of rows 0 and X) at rowpos[x] + y, then each
        # other row's first and last cells, (x, 0) and (x, Y)
        idx = np.arange(self.n) + np.repeat(np.arange(X1) * Y1 - self.rowpos, np.diff(self.off))
        inner = np.arange(1, X1 - 1)
        idx[self.off[inner]] = inner * Y1
        idx[self.off[inner + 1] - 1] = inner * Y1 + Y1 - 1
        return idx

    def design(self) -> str:
        return "ring" if self.widest <= RING_MAX_CELLS else "strip"


def strip_plan(X1: int, rows: int, capacity: int, lead: int) -> dict:
    """The strip design's launch for a grid of X1 rows: strips of `rows`
    rows (the last one partial where `rows` does not divide X1), as many
    blocks as strips but at most `capacity` (the blocks resident at once;
    block b then takes strips b, b + blocks, ... in order), and `lead`."""
    if rows % 32 or not 32 <= rows <= STRIP_MAX_ROWS:
        raise ValueError(f"strips of {rows} rows: a multiple of 32 up to {STRIP_MAX_ROWS}")
    if not 1 <= lead <= STRIP_MAX_LEAD:
        raise ValueError(f"a strip lead of {lead}: 1 to {STRIP_MAX_LEAD}")
    if capacity < 1:
        raise RuntimeError("branchfill: the card holds no strip block at once")
    strips = -(-X1 // rows)
    return dict(strips=strips, rows=rows, last_rows=X1 - (strips - 1) * rows,
                blocks=min(strips, capacity), lead=lead)


def band_layout(lo: np.ndarray, hi: np.ndarray, X1: int, Y1: int) -> BandLayout:
    """The band of a [X1, Y1] grid from each interior row's hull lo..hi
    (int [X1], `interior_hull`'s form; rows 0 and X1-1 are ignored).  The
    hulls are first widened where needed so that neither end ever falls as
    x grows (lo to its suffix minimum, hi to its prefix maximum; an
    envelope's hulls already are so), which makes each diagonal's hull
    rows contiguous."""
    X, Y = X1 - 1, Y1 - 1
    lo, hi = np.array(lo, dtype=np.int64), np.array(hi, dtype=np.int64)
    if X1 > 2:
        lo[1:X] = np.minimum.accumulate(lo[1:X][::-1])[::-1]
        hi[1:X] = np.maximum.accumulate(hi[1:X])
    lo[0] = lo[X] = 0
    hi[0] = hi[X] = Y
    counts = np.maximum(hi - lo + 1, 0) + 1 + int(Y >= 1)
    counts[0] = counts[X] = Y1
    off = np.zeros(X1 + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    rowpos = off[:-1] + 1 - lo
    rowpos[0], rowpos[X] = off[0], off[X]
    k = np.arange(X1 + Y1 - 1)
    if X1 > 2:
        xs = np.arange(1, X)
        xa = np.searchsorted(xs + hi[1:X], k) + 1  # first row whose hull reaches k
        xb = np.searchsorted(xs + lo[1:X], k, side="right")  # last row whose hull starts by k
    else:
        xa, xb = np.ones_like(k), np.zeros_like(k)
    rows = np.maximum(xb - xa + 1, 0)
    cells = (rows + (k <= Y) + ((Y >= 1) & (k - Y >= 1) & (k - Y <= X - 1))
             + ((k >= 1) & (k <= X - 1)) + ((X >= 1) & (k >= X) & (k - X <= Y)))
    n = int(off[-1])
    if n >= 2**31:
        raise ValueError(f"a branch band of {n} cells is past the kernel's 32-bit positions")
    return BandLayout((X1, Y1), lo, hi, off, rowpos, np.stack([xa, xb], 1), n,
                      int(cells.max()), int(rows.max()))


@dataclass
class BandInputs:
    """A band fill's inputs, all on one device: the emission [n] and the
    mask bytes [n] at the band's cells, ins [Y+1], trans [8], and the
    layout's rowpos, off and diag as int32."""

    layout: BandLayout
    emit: torch.Tensor
    mask: torch.Tensor
    ins: torch.Tensor
    trans: torch.Tensor
    rowpos: torch.Tensor
    off: torch.Tensor
    diag: torch.Tensor


def band_inputs(layout: BandLayout, match_emit, mask, ins_emit, trans) -> BandInputs:
    """The band's inputs gathered from full grids where they lie."""
    dev = match_emit.device
    idx = torch.from_numpy(layout.flat_index()).to(dev)
    return BandInputs(layout, match_emit.reshape(-1)[idx].to(torch.float64),
                      mask.reshape(-1)[idx].to(torch.uint8),
                      ins_emit.to(torch.float64), trans.to(torch.float64),
                      *(torch.from_numpy(a.astype(np.int32)).to(dev)
                        for a in (layout.rowpos, layout.off, layout.diag)))


_TORCH_DTYPES = {np.float64: torch.float64, np.int32: torch.int32, np.uint8: torch.uint8}


def pinned_upload(parts: dict, write, device: torch.device, log: list) -> dict:
    """Host arrays packed into one pinned buffer and copied to `device` in
    one piece: `parts` maps a name to (numpy dtype, count), `write(views)`
    fills each part's host view, each part starts 16-byte aligned.  Appends
    the copy to `log` (bytes, the copy's ms by CUDA events, the host's ms
    packing) and returns the parts on the device, as torch tensors."""
    t0 = time.perf_counter()
    spans, at = {}, 0
    for name, (dt, count) in parts.items():
        size = count * np.dtype(dt).itemsize
        spans[name] = slice(at, at + size)
        at += -(-size // 16) * 16
    host = torch.empty(at, dtype=torch.uint8, pin_memory=True)
    write({name: host.numpy()[sl].view(parts[name][0]) for name, sl in spans.items()})
    pack_ms = (time.perf_counter() - t0) * 1e3
    buf = torch.empty(at, dtype=torch.uint8, device=device)
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    buf.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    log.append(dict(bytes=at, ms=begin.elapsed_time(end), pack_ms=pack_ms))
    return {name: buf[sl].view(_TORCH_DTYPES[parts[name][0]]) for name, sl in spans.items()}


def upload_band(layout: BandLayout, match_emit: np.ndarray, mask: np.ndarray,
                ins_emit: np.ndarray, trans: np.ndarray, device: torch.device) -> BandInputs:
    """The band's inputs from host grids (a layout built on the host), on
    `device`.  On the card: gathered straight into one pinned buffer and
    copied in one piece (`pinned_upload`, logged in UPLOADS); elsewhere
    `band_inputs`."""
    if device.type != "cuda":
        return band_inputs(layout, *(torch.from_numpy(np.ascontiguousarray(a))
                                     for a in (match_emit, mask, ins_emit, trans)))
    X1, Y1 = layout.shape
    n, K = layout.n, X1 + Y1 - 1
    parts = {"emit": (np.float64, n), "ins": (np.float64, Y1), "trans": (np.float64, 8),
             "rowpos": (np.int32, X1), "off": (np.int32, X1 + 1), "diag": (np.int32, 2 * K),
             "mask": (np.uint8, n)}

    def write(hv):
        idx = layout.flat_index()
        np.take(np.ascontiguousarray(match_emit).reshape(-1), idx, out=hv["emit"])
        np.take(np.ascontiguousarray(mask).reshape(-1).view(np.uint8), idx, out=hv["mask"])
        hv["ins"][:] = ins_emit
        hv["trans"][:] = trans
        hv["rowpos"][:] = layout.rowpos
        hv["off"][:] = layout.off
        hv["diag"][:] = layout.diag.reshape(-1)

    dev = pinned_upload(parts, write, device, UPLOADS)
    return BandInputs(layout, dev["emit"], dev["mask"], dev["ins"], dev["trans"], dev["rowpos"],
                      dev["off"], dev["diag"].view(K, 2))


def branch_fill_band_plain(inp: BandInputs, viterbi: bool) -> torch.Tensor:
    """The band's cells [n, 3]: the plain full fill (`branch_fill_plain`)
    of the grids the band was gathered from, gathered at the band."""
    X1, Y1 = inp.layout.shape
    idx = torch.from_numpy(inp.layout.flat_index()).to(inp.emit.device)
    emit = torch.full((X1 * Y1,), NEG, dtype=torch.float64, device=idx.device)
    emit[idx] = inp.emit
    mask = torch.zeros(X1 * Y1, dtype=torch.bool, device=idx.device)
    mask[idx] = inp.mask != 0
    grid = branch_fill_plain(emit.view(X1, Y1), inp.ins, mask.view(X1, Y1), inp.trans, viterbi)
    return grid.reshape(-1, 3)[idx]


def branch_fill_band(inp: BandInputs, viterbi: bool) -> torch.Tensor:
    """Kernel (e) on the band: its cells [n, 3] (M, I, D), a hull cell
    outside the mask NEG.  The plain version for CPU tensors; for CUDA
    tensors (float64 only) the kernel, in the ring design where the
    fullest diagonal fits its block, else in the strip design (DESIGNS;
    its rows and lead by STRIP_RULE); any other device raises."""
    return _fill_band(inp, viterbi)


def _fill_band(inp: BandInputs, viterbi: bool, design: str | None = None,
               strip_rows: int | None = None, lead: int | None = None,
               blocks: int | None = None) -> torch.Tensor:
    """`branch_fill_band`, where `design`, `strip_rows`, `lead` and `blocks`
    (at most the card's resident capacity) force a layout: the seam tests
    and benches take (the strips take any band)."""
    global LAUNCHES
    lay = inp.layout
    dev = inp.emit.device
    if dev.type == "cpu":
        return branch_fill_band_plain(inp, viterbi)
    if dev.type != "cuda":
        raise RuntimeError(f"the branch fill has no kernel for device {dev}")
    for t in (inp.emit, inp.ins, inp.trans):
        if t.dtype != torch.float64:
            raise ValueError(f"the branch fill kernel takes float64, not {t.dtype}")
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    mode = "viterbi" if viterbi else "forward"
    design = design or lay.design()
    X1, Y1 = lay.shape
    cells = torch.empty((lay.n, 3), dtype=torch.float64, device=dev)
    plan = exch = progress = None
    threads = ring_rows = 0
    rows, lead_ = STRIP_RULE[mode]
    rows, lead_ = strip_rows or rows, lead or lead_
    if design == "ring":
        if lay.widest > RING_MAX_CELLS:
            raise ValueError(f"the ring design takes diagonals of at most {RING_MAX_CELLS} "
                             f"cells, not {lay.widest}")
        threads = -(-lay.widest // 32) * 32
        ring_rows = 1 << max(0, lay.span - 1).bit_length()
        # the plan: a 32-byte record a cell slot of each diagonal
        plan = torch.empty((X1 + Y1 - 1) * threads * PLAN_RECORD_BYTES, dtype=torch.uint8,
                           device=dev)
        launch = dict(design="ring", threads=threads, ring_rows=ring_rows)
    elif design == "strip":
        with torch.cuda.device(dev):
            key = (torch.cuda.current_device(), rows, lead_, mode)
            if key not in _CAPACITY:
                _CAPACITY[key] = lib.branchfill_capacity_f64(rows, lead_, int(bool(viterbi)))
        launch = dict(design="strip", **strip_plan(X1, rows, _CAPACITY[key], lead_))
        if blocks is not None:
            if not 1 <= blocks <= launch["blocks"]:
                raise ValueError(f"{blocks} strip blocks: 1 to {launch['blocks']}")
            launch["blocks"] = blocks
        exch = torch.empty(launch["strips"] * Y1 * 3, dtype=torch.float64, device=dev)
        progress = torch.zeros(launch["strips"], dtype=torch.int32, device=dev)
    else:
        raise ValueError(f"no branch fill design {design!r}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.branchfill_f64(
            inp.emit.data_ptr(), inp.mask.data_ptr(), inp.ins.data_ptr(), inp.trans.data_ptr(),
            inp.rowpos.data_ptr(), inp.off.data_ptr(), inp.diag.data_ptr(), cells.data_ptr(),
            None if plan is None else plan.data_ptr(),
            None if exch is None else exch.data_ptr(),
            None if progress is None else progress.data_ptr(), X1, Y1, int(bool(viterbi)),
            int(design == "strip"), threads, ring_rows, rows, lead_, launch.get("blocks", 1),
            stream)
    _kernels.check(code, "branchfill")
    LAUNCHES += 1
    DESIGNS[design] += 1
    MODES[mode] += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(launch, mode=mode)
    return cells


def branch_fill(match_emit, ins_emit, mask, trans, viterbi: bool) -> torch.Tensor:
    """Kernel (e) in the JAX package's signature: the cells [X+1, Y+1, 3].
    The plain version for CPU tensors; for CUDA tensors (float64 only) the
    band of the mask taken on the card (`interior_hull`, `band_layout`),
    `branch_fill_band`, and the band scattered into a grid of NEG."""
    _check_inputs(match_emit, ins_emit, mask, trans)
    dev = match_emit.device
    if dev.type == "cpu":
        return branch_fill_plain(match_emit, ins_emit, mask, trans, viterbi)
    for t in (match_emit, ins_emit, trans):
        if t.dtype != torch.float64:
            raise ValueError(f"the branch fill kernel takes float64, not {t.dtype}")
    X1, Y1 = match_emit.shape
    layout = band_layout(*(t.cpu().numpy() for t in interior_hull(mask)), X1, Y1)
    band = branch_fill_band(band_inputs(layout, match_emit, mask, ins_emit, trans), viterbi)
    grid = torch.full((X1 * Y1, 3), NEG, dtype=torch.float64, device=dev)
    grid[torch.from_numpy(layout.flat_index()).to(dev)] = band
    return grid.view(X1, Y1, 3)


class BandCells:
    """A band's cells on the host, read as the full grid is: `cells[x, y, s]`
    and `cells[x, y]` ([S]); a cell outside the band is `neg` in every
    state, as the fill leaves it (NEG for the branch fill, -inf for the
    sibling fill)."""

    def __init__(self, vals: np.ndarray, layout: BandLayout, neg: float = NEG):
        X1, Y1 = layout.shape
        self.vals = vals  # [n, S], in band order
        self.lo, self.hi, self.off, self.rowpos = (
            a.tolist() for a in (layout.lo, layout.hi, layout.off, layout.rowpos))
        self.Y = Y1 - 1
        self.shape = (X1, Y1, vals.shape[1])
        self._neg = np.full(vals.shape[1], neg)

    def _row(self, x: int, y: int):
        if self.lo[x] <= y <= self.hi[x]:
            return self.vals[self.rowpos[x] + y]
        if y == 0:
            return self.vals[self.off[x]]
        if y == self.Y:
            return self.vals[self.off[x + 1] - 1]
        return self._neg

    def __getitem__(self, key):
        if len(key) == 3:
            return self._row(int(key[0]), int(key[1]))[key[2]]
        return self._row(int(key[0]), int(key[1])).copy()


def read_band(band: torch.Tensor, layout: BandLayout) -> BandCells:
    """The filled band [n, 3] copied to the host once
    (`readback.gather_to_host`, logged in its READBACKS as a "branch") and
    wrapped in a BandCells."""
    (vals,) = gather_to_host("branch", band, 0, None)
    return BandCells(vals.numpy(), layout)
