"""Sibling fill: the 11-state sibling-transducer Forward that aligns two
sibling profiles (left x, right y) under their parent.

Port of historian_tpu/ops/siblingdp.py (`pack_sibling_transitions`,
`sibling_forward`, `sibling_forward_batch`).  `sibling_forward` is the JAX formulation in
PyTorch, the plain version: a loop over x rows in which the states read
from the row before are vector operations, IMI is an affine scan along y
and the coupled (IDM, IDI) pair a scan of 2x2 log-matrix affine maps,
both by doubling steps, with NEG = -1e30 as the semiring's zero.

The card fills the band only (ops/branchdp.py `band_layout`: rows 0 and
X whole, on each other row its column 0, its hull of in-mask interior
columns and its column Y).  `sibling_fill_band` is the band's entry: the
hand-written CUDA kernel csrc/siblingfill.cu for CUDA tensors (float64),
which keeps the host route's per-cell order (csrc/fill.cpp
`sibling_fill`), so its cells differ from the host's only by the card's
exp and log; `sibling_fill_band_plain`, the plain full fill gathered at
the band, for CPU tensors.  Both give -inf where the host fill does (a
cell outside the mask, a state no path reaches).  The kernel spreads a
cell's 11 states over a lane group of LANES and runs one of two designs
(DESIGNS): the ring, where the widest diagonal holds at most
RING_MAX_CELLS cells (one block streaming a plan's records, the last two
diagonals in shared memory; `plan_records` is the plan, on the card its
kernel, `plan_records_plain` the same records in PyTorch), else the
strips (a block a strip of STRIP_ROWS rows, each strip a pipeline stage
behind the one above).  `upload_band` packs a host grid's band into one
pinned buffer and copies it once, `read_band` copies the filled band and
lp_end back once.

`sibling_forward_batch` fills K grids of one padded shape at once, each to
its own corner: the plain version `sibling_forward_batch_plain` runs
`sibling_forward` an item at a time; for CUDA tensors kernel (d')
(csrc/siblingfill.cu `siblingbatch`: a thread block cluster an item, its
rows in strips of a block, a lane group a row on kernel (d)'s cell step,
the last two diagonals in shared memory, or in device memory where a
strip's outgrow it, `batch_layout`) fills them in one launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from historian_tpu_torch.ops.branchdp import BandCells, BandLayout, pinned_upload
from historian_tpu_torch.ops.readback import gather_to_host

NEG = -1e30
N_STATES = 11
#: state order of the cells (sampler/sibling.py)
STATES = ("IMM", "IMD", "IDM", "IDD", "WWW", "WWX", "WXW", "IMI", "IIW", "IDI", "IIX")
#: the transition table's states: STATES, then EEE
_INDEX = {name: k for k, name in enumerate(STATES + ("EEE",))}

# packed transition layout (see pack_sibling_transitions)
_KEYS = [
    ("IMM", "IIW"), ("IMI", "IIW"), ("IIW", "IIW"),
    ("IMD", "IIX"), ("IIX", "IIX"),
    ("WWW", "IMD"), ("WWX", "IMD"), ("WXW", "IMD"), ("IDD", "IMD"),
    ("WWW", "IMM"), ("WWX", "IMM"), ("WXW", "IMM"), ("IDD", "IMM"),
    ("IIW", "WWW"), ("IMI", "WWW"), ("IMM", "WWW"),
    ("IIX", "WWX"), ("IMD", "WWX"),
    ("IDI", "WXW"), ("IDM", "WXW"),
    ("WWW", "IDD"), ("WWX", "IDD"), ("WXW", "IDD"),
    ("IMM", "IMI"), ("IMI", "IMI"),
    ("IDM", "IDI"), ("IDI", "IDI"),
    ("WWW", "IDM"), ("WWX", "IDM"), ("WXW", "IDM"), ("IDD", "IDM"),
    ("IDD", "EEE"), ("WWW", "EEE"), ("WWX", "EEE"), ("WXW", "EEE"),
]

#: kernel launches made by `sibling_fill_band` (never by the plain version)
LAUNCHES = 0
#: those launches by design (csrc/siblingfill.cu): "ring", one block
#: streaming the plan's records, for a band whose diagonals hold at most
#: RING_MAX_CELLS cells; "strip", a pipeline of row strips, for the rest
DESIGNS = {"ring": 0, "strip": 0}
#: launches of the ring design's plan kernel (`plan_records` on the card)
PLAN_LAUNCHES = 0
#: one entry a band upload (`upload_band` on the card): bytes, the copy's
#: ms and the host's ms packing the band
UPLOADS: list = []
#: the last launch's design, lanes a cell, blocks, threads a block, and
#: the ring's slots a diagonal or the strips' rows and count
LAST_LAUNCH: dict = {}
#: launches of kernel (d'), the batch (`sibling_forward_batch` on the card)
BATCH_LAUNCHES = 0
#: the last batch launch: items, the grid, lanes a cell, and
#: `batch_layout`'s cluster, lane groups, turns, rows a block and ring
LAST_BATCH: dict = {}
#: lanes a cell (csrc/siblingfill.cu kLanes)
LANES = 4
#: the ring design's widest diagonal (kRingMaxCells)
RING_MAX_CELLS = 128
#: rows a strip of the strip design (a multiple of 8, at most
#: STRIP_MAX_ROWS = kStripMaxRows)
STRIP_ROWS = 64
STRIP_MAX_ROWS = 64
#: kernel (d')'s lane groups a block at most (csrc/siblingfill.cu
#: kBatchMaxGroups) and doubles a plane slot (kPitch)
BATCH_MAX_GROUPS = 160
BATCH_PITCH = 12
#: kernel (d')'s rule: the fewest blocks a cluster (1, 2, 4, 8) whose
#: strips of at most BATCH_ROWS rows hold an item's rows.  On bench.py:566's
#: 16 grids (305 rows), `sibling_bench.py --batch --sweep` on an H100 80GB
#: HBM3 at 700 W: the one mirrored sweep (1, 2, 4, 8, 8, 4, 2, 1 in one
#: process) put clusters of 4 (80-row strips) ahead of 8 in both halves,
#: 2.713 / 2.958 ms against 3.010 / 3.156; single passes in four other
#: calls put 8 ahead in three (8 / 4: 3.058 / 3.105, 3.118 / 3.265,
#: 2.747 / 3.088) and 4 ahead in one (2.657 against 2.882): the two trade
#: places by up to 11 % between calls.  2 (3.16-3.41) and 1 (two rows a lane group in
#: turns, 5.53-6.10) trail
BATCH_ROWS = 80
#: the ring design's plan record (csrc/siblingfill.cu Rec): match
#: emission, l_emit, r_emit (float64), band position (int32), the ring
#: slots of the cell and of (x-1, y), (x, y-1), (x-1, y-1) (uint16),
#: flags (int32: 1 in the mask, 2 the origin), 8 bytes of zeros
REC_BYTES = 48
#: band.cuh's cell kinds
_ROW0, _ROWX, _COL0, _COLY, _HULL = 1, 2, 3, 4, 5


def transition_table(sib) -> np.ndarray:
    """A SiblingMatrix's transitions as fill.cpp takes them: [12, 12],
    t[src, dest], -inf where there is none."""
    tmat = np.full((12, 12), -np.inf)
    for (s, d), lp in sib.t.items():
        tmat[s, d] = lp
    return tmat


def pack_sibling_transitions(sib) -> np.ndarray:
    """Flatten a sampler.sibling.SiblingMatrix transition table."""
    return pack_table(transition_table(sib))


def pack_table(tmat: np.ndarray) -> np.ndarray:
    """The [35] packed transitions of a [12, 12] table, NEG where none."""
    out = np.array([tmat[_INDEX[a], _INDEX[b]] for a, b in _KEYS], dtype=np.float64)
    return np.where(np.isfinite(out), out, NEG)


def _lse(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.logaddexp(out, x)
    return out


def _scan(op, items: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 1 of the stacked elements `items` [k, n]
    under the associative `op(left, right)`, by doubling steps."""
    d, n = 1, items.shape[1]
    while d < n:
        items = torch.cat([items[:, :d], op(items[:, :-d], items[:, d:])], dim=1)
        d *= 2
    return items


def _aff(left, right):
    # (a, b) o (a', b') = (lse(a', a + b'), b + b')
    out = left + right[1:2]
    out[0] = torch.logaddexp(right[0], out[0])
    return out


# _mataff's products: element k of the composition is lse(R[_RA[k]] +
# L[_LA[k]], R[_RB[k]] + L[_LB[k]]), then (rows 4, 5, the constant terms)
# lse with R[k]; the elements are (m00, m01, m10, m11, c0, c1)
_RA, _LA = [0, 0, 2, 2, 0, 2], [0, 1, 0, 1, 4, 4]
_RB, _LB = [1, 1, 3, 3, 1, 3], [2, 3, 2, 3, 5, 5]


def _mataff(left, right):
    # compose: (M_r, c_r) after (M_l, c_l)
    out = torch.logaddexp(right[_RA] + left[_LA], right[_RB] + left[_LB])
    out[4:] = torch.logaddexp(out[4:], right[4:])
    return out


def sibling_forward(l_emit, r_emit, match_emit, mask, trans):
    """Returns (cells [X+1, Y+1, 11], lp_end).

    l_emit: [X] left-insert scores; r_emit: [Y]; match_emit: [X+1, Y+1]
    (1-based, row/col 0 = NEG); mask: [X+1, Y+1] bool; trans: [35]
    packed by pack_sibling_transitions.  Every input finite (NEG for
    -inf).  State order matches sampler.sibling: IMM IMD IDM IDD WWW WWX
    WXW IMI IIW IDI IIX.  A cell no path reaches holds about NEG.
    """
    (tIMM_IIW, tIMI_IIW, tIIW_IIW,
     tIMD_IIX, tIIX_IIX,
     tWWW_IMD, tWWX_IMD, tWXW_IMD, tIDD_IMD,
     tWWW_IMM, tWWX_IMM, tWXW_IMM, tIDD_IMM,
     tIIW_WWW, tIMI_WWW, tIMM_WWW,
     tIIX_WWX, tIMD_WWX,
     tIDI_WXW, tIDM_WXW,
     tWWW_IDD, tWWX_IDD, tWXW_IDD,
     tIMM_IMI, tIMI_IMI,
     tIDM_IDI, tIDI_IDI,
     tWWW_IDM, tWWX_IDM, tWXW_IDM, tIDD_IDM,
     tIDD_EEE, tWWW_EEE, tWWX_EEE, tWXW_EEE) = (trans[k] for k in range(35))

    X1, Y1 = match_emit.shape
    dtype, dev = match_emit.dtype, match_emit.device
    neg_row = torch.full((Y1,), NEG, dtype=dtype, device=dev)
    first_col = torch.arange(Y1, device=dev) == 0
    neg1 = neg_row[:1]

    def shift_right(v):
        return torch.cat([neg1, v[:-1]])

    # effective IDM source weights from the W states, folding the stored
    # IDD[y-1] = lse_W(W + t(W,IDD)) value through t(IDD,IDM)
    aWWW = torch.logaddexp(tWWW_IDM, tWWW_IDD + tIDD_IDM)
    aWWX = torch.logaddexp(tWWX_IDM, tWWX_IDD + tIDD_IDM)
    aWXW = torch.logaddexp(tWXW_IDM, tWXW_IDD + tIDD_IDM)

    # pad emissions with a leading NEG (position 0 = start boundary)
    le = torch.cat([neg1, l_emit.to(dtype)])   # [X1]
    ren = torch.cat([neg1, r_emit.to(dtype)])  # [Y1]
    m00 = ren + tIDM_WXW + aWXW
    m01 = ren + tIDI_WXW + aWXW
    m10 = ren + tIDM_IDI
    m11 = ren + tIDI_IDI
    b_imi_all = tIMI_IMI + ren

    p = {k: neg_row for k in STATES}
    out = torch.empty((X1, Y1, N_STATES), dtype=dtype, device=dev)
    for i in range(X1):
        mask_row = mask[i]
        le_i = le[i]

        def gate(v):
            return torch.where(mask_row, v, neg_row)

        # x-direction (previous row, same column)
        iiw = gate(le_i + _lse(p["IMM"] + tIMM_IIW, p["IMI"] + tIMI_IIW, p["IIW"] + tIIW_IIW))
        iix = gate(le_i + torch.logaddexp(p["IMD"] + tIMD_IIX, p["IIX"] + tIIX_IIX))
        imd = gate(le_i + _lse(p["WWW"] + tWWW_IMD, p["WWX"] + tWWX_IMD,
                               p["WXW"] + tWXW_IMD, p["IDD"] + tIDD_IMD))
        # xy-diagonal
        imm = match_emit[i] + shift_right(
            _lse(p["WWW"] + tWWW_IMM, p["WWX"] + tWWX_IMM, p["WXW"] + tWXW_IMM,
                 p["IDD"] + tIDD_IMM))
        if i == 0:
            imm = torch.where(first_col, torch.zeros_like(imm), imm)
        imm = gate(imm)
        wwx = torch.logaddexp(iix + tIIX_WWX, imd + tIMD_WWX)

        # scan 1: IMI (sources IMM within the row)
        imi = gate(_scan(_aff, torch.stack([gate(shift_right(imm + tIMM_IMI) + ren),
                                            gate(b_imi_all)]))[0])
        www = gate(_lse(iiw + tIIW_WWW, imi + tIMI_WWW, imm + tIMM_WWW))
        wwx = gate(wwx)

        # scan 2: coupled (IDM, IDI) as a 2x2 log-matrix affine scan,
        # s[y] = M[y] (x) s[y-1] (+) c[y], s = (IDM, IDI)
        c = torch.logaddexp(www + aWWW, wwx + aWWX)  # known W contribution
        scanned = _scan(_mataff, torch.stack([m00, m01, m10, m11, ren + shift_right(c),
                                              neg_row]).where(mask_row, neg_row))
        idm, idi = gate(scanned[4]), gate(scanned[5])

        wxw = gate(torch.logaddexp(idi + tIDI_WXW, idm + tIDM_WXW))
        if i == 0:
            www = torch.where(first_col, tIMM_WWW.expand(Y1), www)
        idd = gate(_lse(www + tWWW_IDD, wwx + tWWX_IDD, wxw + tWXW_IDD))
        p = {"IMM": imm, "IMD": imd, "IDM": idm, "IDD": idd, "WWW": www, "WWX": wwx,
             "WXW": wxw, "IMI": imi, "IIW": iiw, "IDI": idi, "IIX": iix}
        out[i] = torch.stack([p[k] for k in STATES], dim=-1)
    lp_end = _lse(p["IDD"][Y1 - 1] + tIDD_EEE, p["WWW"][Y1 - 1] + tWWW_EEE,
                  p["WWX"][Y1 - 1] + tWWX_EEE, p["WXW"][Y1 - 1] + tWXW_EEE)
    return out, lp_end


def _finite(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(a), a, torch.full_like(a, NEG))


@dataclass
class SiblingBandInputs:
    """A band fill's inputs, all on one device: the match emission [n] and
    the mask bytes [n] at the band's cells, l_emit [X], r_emit [Y], the
    [12, 12] transition table (`transition_table`) flattened, and the
    layout's rowpos, off and diag as int32."""

    layout: BandLayout
    emit: torch.Tensor
    mask: torch.Tensor
    l_emit: torch.Tensor
    r_emit: torch.Tensor
    trans: torch.Tensor
    rowpos: torch.Tensor
    off: torch.Tensor
    diag: torch.Tensor


def band_inputs(layout: BandLayout, match_emit, mask, l_emit, r_emit, tmat) -> SiblingBandInputs:
    """The band's inputs gathered from full grids where they lie."""
    dev = match_emit.device
    idx = torch.from_numpy(layout.flat_index()).to(dev)
    return SiblingBandInputs(layout, match_emit.reshape(-1)[idx].to(torch.float64),
                             mask.reshape(-1)[idx].to(torch.uint8),
                             l_emit.to(torch.float64), r_emit.to(torch.float64),
                             tmat.reshape(-1).to(torch.float64),
                             *(torch.from_numpy(a.astype(np.int32)).to(dev)
                               for a in (layout.rowpos, layout.off, layout.diag)))


def upload_band(layout: BandLayout, match_emit: np.ndarray, mask: np.ndarray,
                l_emit: np.ndarray, r_emit: np.ndarray, tmat: np.ndarray,
                device: torch.device) -> SiblingBandInputs:
    """The band's inputs from host grids, on `device`: on the card in one
    pinned copy (`branchdp.pinned_upload`, logged in UPLOADS), elsewhere
    `band_inputs`."""
    if device.type != "cuda":
        return band_inputs(layout, *(torch.from_numpy(np.ascontiguousarray(a))
                                     for a in (match_emit, mask, l_emit, r_emit, tmat)))
    X1, Y1 = layout.shape
    n, K = layout.n, X1 + Y1 - 1
    parts = {"emit": (np.float64, n), "l_emit": (np.float64, X1 - 1),
             "r_emit": (np.float64, Y1 - 1), "trans": (np.float64, 144),
             "rowpos": (np.int32, X1), "off": (np.int32, X1 + 1), "diag": (np.int32, 2 * K),
             "mask": (np.uint8, n)}

    def write(hv):
        idx = layout.flat_index()
        np.take(np.ascontiguousarray(match_emit).reshape(-1), idx, out=hv["emit"])
        np.take(np.ascontiguousarray(mask).reshape(-1).view(np.uint8), idx, out=hv["mask"])
        hv["l_emit"][:] = l_emit
        hv["r_emit"][:] = r_emit
        hv["trans"][:] = tmat.reshape(-1)
        hv["rowpos"][:] = layout.rowpos
        hv["off"][:] = layout.off
        hv["diag"][:] = layout.diag.reshape(-1)

    dev = pinned_upload(parts, write, device, UPLOADS)
    return SiblingBandInputs(layout, dev["emit"], dev["mask"], dev["l_emit"], dev["r_emit"],
                             dev["trans"], dev["rowpos"], dev["off"], dev["diag"].view(K, 2))


def sibling_fill_band_plain(inp: SiblingBandInputs) -> tuple:
    """The band's cells [n, 11] and lp_end [1]: the plain full fill
    (`sibling_forward`) of the grids the band was gathered from, gathered
    at the band, with -inf where it holds NEG or less than -1e29."""
    X1, Y1 = inp.layout.shape
    dev = inp.emit.device
    idx = torch.from_numpy(inp.layout.flat_index()).to(dev)
    emit = torch.full((X1 * Y1,), NEG, dtype=torch.float64, device=dev)
    emit[idx] = _finite(inp.emit)
    mask = torch.zeros(X1 * Y1, dtype=torch.bool, device=dev)
    mask[idx] = inp.mask != 0
    trans = torch.from_numpy(pack_table(inp.trans.cpu().numpy().reshape(12, 12))).to(dev)
    grid, lp_end = sibling_forward(_finite(inp.l_emit), _finite(inp.r_emit),
                                   emit.view(X1, Y1), mask.view(X1, Y1), trans)
    cells = grid.reshape(-1, N_STATES)[idx]
    ninf = torch.tensor(-torch.inf, dtype=torch.float64, device=dev)
    return (torch.where(cells < -1e29, ninf, cells),
            torch.where(lp_end < -1e29, ninf, lp_end).reshape(1))


def ring_shape(layout: BandLayout) -> tuple:
    """The ring design's (slots a diagonal, ring rows): the widest
    diagonal rounded up to a multiple of 8 (LANES a slot fill whole
    warps), and the least power of two no smaller than any diagonal's
    hull rows."""
    return max(8, -(-layout.widest // 8) * 8), 1 << max(0, layout.span - 1).bit_length()


def plan_records_plain(inp: SiblingBandInputs, width: int, ring_rows: int) -> torch.Tensor:
    """csrc/siblingfill.cu's plan in PyTorch on the inputs' device: uint8
    [K, width, REC_BYTES], a record for each of `width` cell slots of each
    diagonal x + y = k, in band.cuh's order of x ((0, k), (k - Y, Y), the
    hull rows, (k, 0), (X, k - X)).  A slot with no cell has position -1,
    every ring slot the guard (ring_rows + 4) and zeros elsewhere; a
    neighbour outside the band or the mask reads the guard."""
    lay = inp.layout
    dev = inp.emit.device
    X1, Y1 = lay.shape
    X, Y, K, R = X1 - 1, Y1 - 1, X1 + Y1 - 1, ring_rows
    i64 = torch.int64
    k = torch.arange(K, device=dev)[:, None]
    diag = inp.diag.reshape(K, 2).long()
    rowpos, off = inp.rowpos.long(), inp.off.long()
    offX = off[X]

    def boundary_counts(k):
        return ((k <= Y).long(), ((Y >= 1) & (k - Y >= 1) & (k - Y <= X - 1)).long(),
                ((k >= 1) & (k <= X - 1)).long(), ((X >= 1) & (k >= X) & (k - X <= Y)).long())

    # band.cuh cell_at: the kind and row of slot t of diagonal k
    n0, nY, nC, nX = boundary_counts(k)
    xa, xb = diag[:, :1], diag[:, 1:]
    nh = (xb - xa + 1).clamp(min=0)
    t = torch.arange(width, device=dev)[None, :]
    kind = torch.zeros((K, width), dtype=i64, device=dev)
    x = torch.zeros((K, width), dtype=i64, device=dev)
    u = t - n0
    parts = ((u < 0, _ROW0, torch.zeros_like(k)), (u - nY < 0, _COLY, k - Y),
             (u - nY - nh < 0, _HULL, xa + u - nY), (u - nY - nh - nC < 0, _COL0, k),
             (u - nY - nh - nC - nX < 0, _ROWX, X + torch.zeros_like(k)))
    for cond, kd, xs in reversed(parts):
        kind = torch.where(cond, kd, kind)
        x = torch.where(cond, xs.expand(K, width), x)
    kind = torch.where(u - nY - nh - nC - nX < 0, kind, 0)
    cell = kind > 0
    y = k - x

    def pos_of(kind, x, y):
        return torch.where(kind == _ROW0, y, torch.where(
            kind == _ROWX, offX + y, torch.where(
                kind == _COL0, off[x.clamp(0, X)], torch.where(
                    kind == _COLY, off[(x + 1).clamp(0, X1)] - 1,
                    rowpos[x.clamp(0, X)] + y))))

    def kind_of(x, y, dk):
        r = diag[dk.clamp(min=0)]
        hull = (x >= r[..., 0]) & (x <= r[..., 1])
        return torch.where(x == 0, _ROW0, torch.where(x == X, _ROWX, torch.where(
            y == 0, _COL0, torch.where(y == Y, _COLY, torch.where(hull, _HULL, 0)))))

    mask = inp.mask.long()
    guard = R + 4

    def slot_of(kind, x):
        return torch.where(kind == _HULL, x & (R - 1), R + kind - _ROW0)

    def neighbour(x, y, dk, ok):
        kd = kind_of(x, y, dk)
        ok = ok & (kd > 0)
        ok = ok & (mask[torch.where(ok, pos_of(kd, x, y), 0).clamp(0, lay.n - 1)] != 0)
        return torch.where(ok, slot_of(kd, x), guard)

    kk = k.expand(K, width)
    pos = torch.where(cell, pos_of(kind, x, y), -1)
    at = pos.clamp(min=0)
    me = torch.where(cell, inp.emit[at], 0.0)
    le = torch.where(cell & (x >= 1), inp.l_emit[(x - 1).clamp(0, max(X - 1, 0))]
                     if X >= 1 else torch.zeros(1, dtype=torch.float64, device=dev), 0.0)
    ren = torch.where(cell & (y >= 1), inp.r_emit[(y - 1).clamp(0, max(Y - 1, 0))]
                      if Y >= 1 else torch.zeros(1, dtype=torch.float64, device=dev), 0.0)
    flags = torch.where(cell, (mask[at] != 0).long() | ((x == 0) & (y == 0)).long() << 1, 0)
    slots = torch.stack([torch.where(cell, slot_of(kind, x), guard),
                         neighbour(x - 1, y, kk - 1, cell & (x >= 1)),
                         neighbour(x, y - 1, kk - 1, cell & (y >= 1)),
                         neighbour(x - 1, y - 1, kk - 2, cell & (x >= 1) & (y >= 1))], -1)
    raw = [torch.stack([me, le, ren], -1).contiguous().view(torch.uint8),
           pos.to(torch.int32)[..., None].contiguous().view(torch.uint8),
           slots.to(torch.int16).contiguous().view(torch.uint8),
           flags.to(torch.int32)[..., None].contiguous().view(torch.uint8),
           torch.zeros((K, width, 8), dtype=torch.uint8, device=dev)]
    return torch.cat(raw, -1)


def plan_fields(recs: torch.Tensor) -> dict:
    """The fields of plan records (uint8 [..., REC_BYTES]): me, le, ren
    (float64), pos (int32), slots (int16 [..., 4]: the cell's, (x-1, y),
    (x, y-1), (x-1, y-1)), flags (int32)."""
    r = recs.contiguous()
    return dict(me=r[..., 0:8].view(torch.float64)[..., 0],
                le=r[..., 8:16].view(torch.float64)[..., 0],
                ren=r[..., 16:24].view(torch.float64)[..., 0],
                pos=r[..., 24:28].view(torch.int32)[..., 0],
                slots=r[..., 28:36].view(torch.int16),
                flags=r[..., 36:40].view(torch.int32)[..., 0])


def _check(inp: SiblingBandInputs, dev: torch.device) -> None:
    X1, Y1 = inp.layout.shape
    n = inp.layout.n
    expect = {"emit": n, "mask": n, "l_emit": X1 - 1, "r_emit": Y1 - 1, "trans": 144,
              "rowpos": X1, "off": X1 + 1, "diag": 2 * (X1 + Y1 - 1)}
    for name, count in expect.items():
        t = getattr(inp, name)
        if t.device != dev or t.numel() != count or not t.is_contiguous():
            raise ValueError(f"sibling fill input {name}: {t.numel()} elements on {t.device}, "
                             f"contiguous {t.is_contiguous()}; expected {count} on {dev}")
    for name in ("emit", "l_emit", "r_emit", "trans"):
        if getattr(inp, name).dtype != torch.float64:
            raise ValueError(f"the sibling fill kernel takes float64, not "
                             f"{getattr(inp, name).dtype} ({name})")
    if inp.mask.dtype != torch.uint8:
        raise ValueError(f"the sibling fill mask must be uint8, not {inp.mask.dtype}")


def plan_records(inp: SiblingBandInputs) -> torch.Tensor:
    """The ring design's plan (uint8 [K, width, REC_BYTES], `ring_shape`),
    on the inputs' device: the plain version for CPU tensors; for CUDA
    tensors the plan kernel (csrc/siblingfill.cu `siblingplan`, a thread a
    cell slot, PLAN_LAUNCHES); any other device raises."""
    global PLAN_LAUNCHES
    dev = inp.emit.device
    width, R = ring_shape(inp.layout)
    if dev.type == "cpu":
        return plan_records_plain(inp, width, R)
    if dev.type != "cuda":
        raise RuntimeError(f"the sibling fill has no kernel for device {dev}")
    _check(inp, dev)
    from historian_tpu_torch.ops import _kernels

    X1, Y1 = inp.layout.shape
    recs = torch.empty((X1 + Y1 - 1, width, REC_BYTES), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = _kernels.lib().siblingplan_f64(
            inp.emit.data_ptr(), inp.mask.data_ptr(), inp.l_emit.data_ptr(),
            inp.r_emit.data_ptr(), inp.rowpos.data_ptr(), inp.off.data_ptr(),
            inp.diag.data_ptr(), recs.data_ptr(), X1, Y1, width, R,
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "siblingplan")
    PLAN_LAUNCHES += 1
    return recs


def design_of(layout: BandLayout) -> str:
    return "ring" if layout.widest <= RING_MAX_CELLS else "strip"


def sibling_fill_band(inp: SiblingBandInputs, planned: torch.Tensor | None = None,
                      design: str | None = None, strip_rows: int | None = None,
                      blocks: int | None = None) -> tuple:
    """Kernel (d) on the band: its cells [n, 11] and lp_end [1], -inf
    where fill.cpp leaves -inf.  The plain version for CPU tensors; for
    CUDA tensors (float64 only) the kernel in the ring design where the
    widest diagonal holds at most RING_MAX_CELLS cells (after the plan
    kernel, unless `planned` holds its records), else in the strip design
    (`strip_rows` rows a strip, STRIP_ROWS by default; as many blocks as
    strips, at most those resident at once, or `blocks`); `design` forces
    one (a strip design runs any band); any other device raises."""
    global LAUNCHES
    lay = inp.layout
    dev = inp.emit.device
    if dev.type == "cpu":
        return sibling_fill_band_plain(inp)
    if dev.type != "cuda":
        raise RuntimeError(f"the sibling fill has no kernel for device {dev}")
    _check(inp, dev)
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    design = design or design_of(lay)
    X1, Y1 = lay.shape
    cells = torch.empty((lay.n, N_STATES), dtype=torch.float64, device=dev)
    lp_end = torch.empty(1, dtype=torch.float64, device=dev)
    width, R = ring_shape(lay)
    H = strip_rows or STRIP_ROWS
    strips = 1
    exch = progress = plan = None
    if design == "ring":
        if width > RING_MAX_CELLS:
            raise ValueError(f"the ring design takes diagonals of at most {RING_MAX_CELLS} "
                             f"cells, not {lay.widest}")
        plan = plan_records(inp) if planned is None else planned
        threads, blocks = LANES * width, 1
    elif design == "strip":
        if H % 8 or not 8 <= H <= STRIP_MAX_ROWS:
            raise ValueError(f"strips of {H} rows: a multiple of 8 up to {STRIP_MAX_ROWS}")
        strips = -(-X1 // H)
        with torch.cuda.device(dev):
            capacity = lib.siblingfill_capacity_f64(H)
        if capacity < 1:
            raise RuntimeError("siblingfill: the card's resident-block capacity query failed")
        blocks = min(strips, capacity, blocks or strips)
        exch = torch.empty(strips * Y1 * 12, dtype=torch.float64, device=dev)
        progress = torch.zeros(strips, dtype=torch.int32, device=dev)
        threads = LANES * H + 64
    else:
        raise ValueError(f"no sibling fill design {design!r}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.siblingfill_f64(
            None if plan is None else plan.data_ptr(), inp.emit.data_ptr(),
            inp.mask.data_ptr(), inp.l_emit.data_ptr(), inp.r_emit.data_ptr(),
            inp.trans.data_ptr(), inp.rowpos.data_ptr(), inp.off.data_ptr(), cells.data_ptr(),
            lp_end.data_ptr(), None if exch is None else exch.data_ptr(),
            None if progress is None else progress.data_ptr(), X1, Y1, lay.n,
            int(design == "strip"), width, R, H, blocks, stream)
    _kernels.check(code, "siblingfill")
    LAUNCHES += 1
    DESIGNS[design] += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(design=design, lanes=LANES, blocks=blocks, threads=threads)
    LAST_LAUNCH.update(dict(width=width, ring_rows=R) if design == "ring"
                       else dict(strip_rows=H, strips=strips))
    return cells, lp_end


def unpack_tables(trans: torch.Tensor) -> torch.Tensor:
    """[K, 144]: each packed row of `trans` [K, 35] as the [12, 12] table
    the kernels take (`transition_table`, flattened), -inf where a packed
    value is at or below -1e29 or the table has no entry."""
    K = trans.shape[0]
    idx = torch.tensor([_INDEX[a] * 12 + _INDEX[b] for a, b in _KEYS], device=trans.device)
    out = torch.full((K, 144), -torch.inf, dtype=torch.float64, device=trans.device)
    t = trans.to(torch.float64)
    out[:, idx] = torch.where(t <= -1e29, -torch.inf, t)
    return out


def _batch_lp_end(cells, trans, ends):
    """lp_end [K] read at each item's corner `ends`, the JAX package's
    `sibling_forward_batch` order: (IDD, WWW, WWX, WXW) to EEE, the
    transitions at trans[:, 31:35]."""
    corner = cells[torch.arange(cells.shape[0], device=cells.device), ends[:, 0], ends[:, 1]]
    return torch.logaddexp(
        torch.logaddexp(corner[:, 3] + trans[:, 31], corner[:, 4] + trans[:, 32]),
        torch.logaddexp(corner[:, 5] + trans[:, 33], corner[:, 6] + trans[:, 34]))


def sibling_forward_batch_plain(l_emit, r_emit, match_emit, mask, trans, ends) -> tuple:
    """The plain version of `sibling_forward_batch`: `sibling_forward`
    for each item on its grid up to its corner (the padding, masked, adds
    nothing inside it), NEG past the corner, then lp_end read at `ends`."""
    K, X1, Y1 = match_emit.shape
    cells = torch.full((K, X1, Y1, N_STATES), NEG, dtype=match_emit.dtype,
                       device=match_emit.device)
    for k in range(K):
        x1, y1 = int(ends[k, 0]) + 1, int(ends[k, 1]) + 1
        cells[k, :x1, :y1] = sibling_forward(l_emit[k, : x1 - 1], r_emit[k, : y1 - 1],
                                             match_emit[k, :x1, :y1], mask[k, :x1, :y1],
                                             trans[k])[0]
    return cells, _batch_lp_end(cells, trans, ends.long())


def _check_batch(l_emit, r_emit, match_emit, mask, trans, ends) -> None:
    if match_emit.dim() != 3:
        raise ValueError(f"match_emit must be [K, X+1, Y+1], got {tuple(match_emit.shape)}")
    K, X1, Y1 = match_emit.shape
    want = {"l_emit": (l_emit, (K, X1 - 1)), "r_emit": (r_emit, (K, Y1 - 1)),
            "mask": (mask, (K, X1, Y1)), "trans": (trans, (K, 35)), "ends": (ends, (K, 2))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != match_emit.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, expected {shape} on "
                             f"{match_emit.device}")
    if mask.dtype != torch.bool or ends.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"mask must be bool and ends integers, not {mask.dtype}, {ends.dtype}")
    e = ends.cpu()
    if K and (int(e.min()) < 0 or int(e[:, 0].max()) >= X1 or int(e[:, 1].max()) >= Y1):
        raise ValueError(f"ends outside the grids [{X1}, {Y1}]")


def batch_layout(sx: int, smem: int, cluster: int | None = None) -> dict:
    """Kernel (d')'s launch for grids of sx rows on a card whose blocks may
    take `smem` bytes of shared memory: a thread block cluster of
    `cluster` blocks an item (by default the fewest of 1, 2, 4, 8 whose
    strips of BATCH_ROWS rows hold sx, else 8), each block a strip of
    `rows` = `groups` x `turns` rows: `groups` lane groups (a multiple of
    8, at most BATCH_MAX_GROUPS) of `turns` rows each (1 unless the
    strip's rows outnumber a block's lane groups).  `ring` says where the
    strip's planes (three diagonals of a slot a row, and the row above)
    lie: in shared memory where `smem` holds them, else in device memory."""
    if cluster is None:
        cluster = next((c for c in (1, 2, 4, 8) if c * BATCH_ROWS >= sx), 8)
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"kernel (d') takes clusters of 1, 2, 4 or 8 blocks, not {cluster}")
    per = -(-sx // cluster)
    turns = -(-per // BATCH_MAX_GROUPS)
    groups = -(-(-(-per // turns)) // 8) * 8
    rows = groups * turns
    fits = 8 * BATCH_PITCH * 3 * (rows + 1) <= smem
    return dict(cluster=cluster, groups=groups, turns=turns, rows=rows,
                ring="shared" if fits else "device")


def sibling_forward_batch(l_emit, r_emit, match_emit, mask, trans, ends) -> tuple:
    """K sibling fills at once, the JAX package's `sibling_forward_batch`:
    l_emit [K, X], r_emit [K, Y], match_emit and mask [K, X+1, Y+1], trans
    [K, 35] (`pack_sibling_transitions`, one row an item), ends [K, 2] each
    item's own corner (x, y).  Returns (cells [K, X+1, Y+1, 11], lp_end [K]
    read at each item's corner); inside an item's corner the cells are its
    own fill's, a cell no path reaches at or below -1e29.  The plain
    version for CPU tensors; for CUDA tensors (float64) kernel (d') in one
    launch (`batch_layout`), which fills each item up to its corner (-inf
    past it, and where fill.cpp has -inf) in fill.cpp's per-cell order; any
    other device raises."""
    return _forward_batch(l_emit, r_emit, match_emit, mask, trans, ends)


def _forward_batch(l_emit, r_emit, match_emit, mask, trans, ends,
                   cluster: int | None = None) -> tuple:
    """`sibling_forward_batch`, where `cluster` forces kernel (d')'s blocks
    an item: the seam tests and benches take."""
    global BATCH_LAUNCHES
    _check_batch(l_emit, r_emit, match_emit, mask, trans, ends)
    dev = match_emit.device
    if dev.type == "cpu":
        return sibling_forward_batch_plain(l_emit, r_emit, match_emit, mask, trans, ends)
    if dev.type != "cuda":
        raise RuntimeError(f"the batched sibling fill has no kernel for device {dev}")
    for name, t in (("l_emit", l_emit), ("r_emit", r_emit), ("match_emit", match_emit),
                    ("trans", trans)):
        if t.dtype != torch.float64:
            raise ValueError(f"kernel (d') takes float64, not {t.dtype} ({name})")
    from historian_tpu_torch.ops import _kernels

    K, X1, Y1 = match_emit.shape
    lay = batch_layout(X1, _kernels.smem_limit(dev), cluster)
    args = [t.contiguous() for t in (l_emit, r_emit, match_emit)] + [
        mask.contiguous().view(torch.uint8), unpack_tables(trans),
        ends.to(torch.int32).contiguous()]
    cells = torch.empty((K, X1, Y1, N_STATES), dtype=torch.float64, device=dev)
    lp_end = torch.empty(K, dtype=torch.float64, device=dev)
    ring = None
    if lay["ring"] == "device":
        ring = torch.empty(K * 3 * (lay["cluster"] * lay["rows"] + 1) * BATCH_PITCH,
                           dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        code = _kernels.lib().siblingbatch_f64(
            *(t.data_ptr() for t in args), cells.data_ptr(), lp_end.data_ptr(),
            None if ring is None else ring.data_ptr(), K, X1, Y1, lay["groups"], lay["turns"],
            lay["cluster"], torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "siblingbatch")
    BATCH_LAUNCHES += 1
    LAST_BATCH.clear()
    LAST_BATCH.update(items=K, grid=(X1, Y1), lanes=LANES, threads=LANES * lay["groups"], **lay)
    return cells, lp_end


def read_band(cells: torch.Tensor, lp_end: torch.Tensor, layout: BandLayout) -> tuple:
    """The filled band [n, 11] and lp_end copied to the host once
    (`readback.gather_to_host`, logged in its READBACKS as a "sibling"):
    a BandCells (-inf outside the band) and lp_end as a float."""
    vals, lp = gather_to_host("sibling", cells, 0, None, lp_end)
    return BandCells(vals.numpy(), layout, neg=-np.inf), float(lp[0])
