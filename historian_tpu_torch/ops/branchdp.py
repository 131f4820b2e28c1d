"""Branch fill: the 3-state (Match/Insert/Delete) alignment of a parent
position-weight matrix to a child PWM, Viterbi or Forward.

Port of historian_tpu/ops/branchdp.py (`_branch_fill`, `branch_viterbi`,
`branch_forward`).  `branch_fill_plain` is the JAX formulation in
PyTorch: a scan over y columns, Match and Insert from the previous
column, Delete as a segmented prefix scan over x (`_seg_scan`, the
`_seg_combine_max` / `_seg_combine_lse` of the JAX package).
`branch_fill` is the wrapper: the plain version for CPU tensors, the
hand-written CUDA kernel csrc/branchfill.cu for CUDA tensors (float64),
which keeps the host route's per-cell order (csrc/fill.cpp
`branch_fill`), so its Viterbi cells equal the host's bit for bit.

The grid [X+1, Y+1, 3] stays where it was filled; `read_band` finds and
gathers the cells inside the mask there and copies them and their
indices to the host, and `BandCells` answers the host traceback's cell
reads from them (a cell outside the mask is NEG in all three states).
"""

from __future__ import annotations


import numpy as np
import torch

from historian_tpu_torch.ops.readback import gather_to_host

NEG = -1e30

MATCH, INSERT, DELETE = 0, 1, 2

#: kernel launches made by `branch_fill` (never by the plain version)
LAUNCHES = 0
#: the kernel's largest block (csrc/branchfill.cu kThreads)
MAX_THREADS = 1024


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


def diagonal_ranges(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xa, xb), int32 [X+Y+1]: on each anti-diagonal x + y = k of the mask
    [X+1, Y+1], the first and the last row x of an in-mask interior cell
    (0 < x < X, 0 < y < Y); xa > xb where the diagonal has none.  Computed
    where the mask lies, on a skewed copy whose column k is diagonal k."""
    X1, Y1 = mask.shape
    W = X1 + Y1 - 1
    inner = mask.clone()
    inner[0, :] = inner[-1, :] = False
    inner[:, 0] = inner[:, -1] = False
    skew = torch.zeros(X1 * W, dtype=torch.uint8, device=mask.device)
    skew.as_strided((X1, Y1), (W + 1, 1)).copy_(inner)  # skew[x, x + y] = inner[x, y]
    skew = skew.view(X1, W)
    some = skew.amax(dim=0) > 0
    xa = torch.where(some, skew.argmax(dim=0), 1).to(torch.int32)
    xb = torch.where(some, X1 - 1 - skew.flip(0).argmax(dim=0), 0).to(torch.int32)
    return xa, xb


def branch_fill(match_emit, ins_emit, mask, trans, viterbi: bool) -> torch.Tensor:
    """Kernel (e): the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (float64 only).  Any other device or dtype raises.  The
    kernel computes each diagonal's in-mask cells (`diagonal_ranges`) and
    the boundary lines in a grid filled with NEG, with a block sized to the
    widest diagonal."""
    global LAUNCHES
    _check_inputs(match_emit, ins_emit, mask, trans)
    dev = match_emit.device
    if dev.type == "cpu":
        return branch_fill_plain(match_emit, ins_emit, mask, trans, viterbi)
    if dev.type != "cuda":
        raise RuntimeError(f"the branch fill has no kernel for device {dev}")
    for t in (match_emit, ins_emit, trans):
        if t.dtype != torch.float64:
            raise ValueError(f"the branch fill kernel takes float64, not {t.dtype}")
    from historian_tpu_torch.ops import _kernels

    X1, Y1 = match_emit.shape
    emit, ins, m, tr = (t.contiguous() for t in (match_emit, ins_emit, mask, trans))
    xa, xb = diagonal_ranges(m)
    widest = int((xb - xa + 1).clamp(min=0).max()) + 4  # and the boundary lines
    threads = min(MAX_THREADS, -(-widest // 32) * 32)
    cells = torch.full((X1, Y1, 3), NEG, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _kernels.lib().branchfill_f64(emit.data_ptr(), ins.data_ptr(), m.data_ptr(),
                                             tr.data_ptr(), xa.data_ptr(), xb.data_ptr(),
                                             cells.data_ptr(), X1, Y1, int(bool(viterbi)),
                                             threads, stream)
    _kernels.check(code, "branchfill")
    LAUNCHES += 1
    return cells


class BandCells:
    """A grid's cells inside its mask, on the host, read as the full grid
    is: `cells[x, y, s]` and `cells[x, y]` ([3]); a cell outside the mask
    is NEG in all three states, as the fill writes it."""

    def __init__(self, vals: np.ndarray, rows: np.ndarray, cols: np.ndarray, shape: tuple):
        self.vals = vals  # [n, 3], the in-mask cells in row-major order
        self.cols = cols  # [n] their y
        self.row_ptr = np.searchsorted(rows, np.arange(shape[0] + 1))
        self.shape = (*shape, 3)
        self._neg = np.full(3, NEG)
        self._last = (-1, -1, self._neg)  # a traceback reads a cell's 3 states in turn

    def _row(self, x: int, y: int):
        lx, ly, row = self._last
        if (lx, ly) == (x, y):
            return row
        lo, hi = self.row_ptr[x], self.row_ptr[x + 1]
        k = lo + int(np.searchsorted(self.cols[lo:hi], y))
        row = self.vals[k] if k < hi and self.cols[k] == y else self._neg
        self._last = (x, y, row)
        return row

    def __getitem__(self, key):
        if len(key) == 3:
            return self._row(int(key[0]), int(key[1]))[key[2]]
        return self._row(int(key[0]), int(key[1])).copy()


def read_band(cells: torch.Tensor, mask: torch.Tensor) -> BandCells:
    """Find the cells where `mask` [X+1, Y+1] (bool) is set, where the grid
    `cells` [X+1, Y+1, 3] lies; copy their values and flat indices to the
    host once (`readback.gather_to_host`, logged in its READBACKS as a
    "branch") and wrap them in a BandCells."""
    X1, Y1 = mask.shape
    idx = mask.reshape(-1).nonzero().squeeze(1)
    vals, flat = gather_to_host("branch", cells.reshape(-1, 3), 0, idx, idx)
    rows, cols = np.divmod(flat.numpy(), Y1)
    return BandCells(vals.numpy(), rows, cols, (X1, Y1))
