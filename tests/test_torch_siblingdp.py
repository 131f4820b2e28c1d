"""Kernel (d)'s plain version, the sibling fill (ops/siblingdp.py), on the
CPU in float64, on seeded synthetic grids (a banded and a full mask, and
the edge shapes):

- `sibling_forward` against the JAX package's `sibling_forward` (XLA on
  the CPU) on the same inputs: the same NEG pattern (cells under -1e29),
  the other cells and lp_end within 1e-9;
- against csrc/fill.cpp `sibling_fill` (the host route, the JAX package's
  native fill): the plain version's NEG cells are fill.cpp's -inf cells,
  the rest and lp_end within 1e-9;
- the band entry (`upload_band`, `sibling_fill_band`, `read_band` on the
  CPU: the plain full fill gathered at the band) against fill.cpp at every
  cell of the grid, -inf outside the band;
- the band entry's input checks;
- the ring design's plain plan (`plan_records_plain`): each band cell in
  one record, in band.cuh's order along each diagonal, its flags and
  emissions; a plain walk that reads each neighbour only through the
  records' ring slots (three planes of slots, as the kernel keeps in
  shared memory), and a plain walk of the strip design (strips of H rows,
  the row above a strip only through its exchange), each with the
  kernel's lane-group order of a cell's states, against fill.cpp and the
  JAX package's `sibling_forward`."""

import numpy as np
import pytest
import torch

from historian_tpu.ops import siblingdp as jax_sib
from historian_tpu_torch.ops import branchdp, siblingdp
from historian_tpu_torch.sampler.sibling import native_fill

TOL = 1e-9
CASES = {"banded 90x120": (90, 120, 6), "full 70x50": (70, 50, None),
         "full 1x1": (1, 1, None), "full 2x0": (2, 0, None), "banded 40x41 band 1": (40, 41, 1),
         "holes 60x80": (60, 80, "holes"), "full 1x40": (1, 40, None)}
#: the cases of the plain plan and walks
PLAN_CASES = ["full 70x50", "banded 90x120", "holes 60x80", "full 1x1", "full 1x40"]


def fill_inputs(X: int, Y: int, band, seed: int = 3) -> tuple:
    """(l_emit [X], r_emit [Y], match_emit [X+1, Y+1] with -inf on row and
    column 0, mask [X+1, Y+1] with its boundary rows and columns in, the
    [12, 12] transition table with -inf where there is none)."""
    rng = np.random.default_rng(seed)
    tmat = np.full((12, 12), -np.inf)
    for a, b in siblingdp._KEYS:
        tmat[siblingdp._INDEX[a], siblingdp._INDEX[b]] = np.log(rng.uniform(0.05, 0.9))
    l_emit, r_emit = rng.uniform(-4, -1, X), rng.uniform(-4, -1, Y)
    match = np.full((X + 1, Y + 1), -np.inf)
    match[1:, 1:] = rng.uniform(-8, -2, (X, Y))
    mask = np.ones((X + 1, Y + 1), bool)
    if band == "holes":
        mask = rng.random((X + 1, Y + 1)) < 0.6
    elif band is not None:
        diag = np.arange(X + 1)[:, None] * (Y / max(X, 1))
        mask = np.abs(diag - np.arange(Y + 1)[None, :]) <= band
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    return l_emit, r_emit, match, mask, tmat


def host_fill(l_emit, r_emit, match, mask, tmat) -> tuple:
    return native_fill(l_emit, r_emit, match, mask, tmat)


def plain_fill(l_emit, r_emit, match, mask, tmat) -> tuple:
    cells, lp = siblingdp.sibling_forward(
        torch.tensor(l_emit), torch.tensor(r_emit),
        torch.tensor(np.where(np.isfinite(match), match, siblingdp.NEG)), torch.tensor(mask),
        torch.tensor(siblingdp.pack_table(tmat)))
    return cells.numpy(), float(lp)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case):
    inputs = fill_inputs(*CASES[case])
    l_emit, r_emit, match, mask, tmat = inputs
    got, lp = plain_fill(*inputs)
    # importing historian_tpu.ops enables x64: float64 inputs stay float64
    ref, ref_lp = jax_sib.sibling_forward(
        l_emit, r_emit, np.where(np.isfinite(match), match, jax_sib.NEG), mask,
        siblingdp.pack_table(tmat))
    ref, ref_lp = np.asarray(ref), float(ref_lp)
    assert ref.dtype == np.float64
    assert got.shape == ref.shape == match.shape + (11,)
    assert np.array_equal(got < -1e29, ref < -1e29)
    live = ref > -1e29
    assert live.any()
    assert np.abs(got[live] - ref[live]).max() < TOL
    assert abs(lp - ref_lp) < TOL


def drift(X: int, band, seed: int = 3) -> dict:
    """The largest absolute cell errors between the three fills of one
    seeded X x (X + 13) grid: the JAX package's row scan, the port's plain
    version (its copy in PyTorch) and fill.cpp; `magnitude`, the largest
    |cell| of fill.cpp's; `lp`, lp_end's errors against fill.cpp's."""
    inputs = fill_inputs(X, X + 13, band, seed)
    l_emit, r_emit, match, mask, tmat = inputs
    host, host_lp = host_fill(*inputs)
    plain, plain_lp = plain_fill(*inputs)
    scan, scan_lp = jax_sib.sibling_forward(
        l_emit, r_emit, np.where(np.isfinite(match), match, jax_sib.NEG), mask,
        siblingdp.pack_table(tmat))
    scan = np.asarray(scan)
    live = np.isfinite(host)
    assert np.array_equal(live, plain > -1e29) and np.array_equal(live, scan > -1e29)
    host, plain, scan = host[live], plain[live], scan[live]
    return dict(magnitude=float(np.abs(host).max()),
                jax_vs_fill_cpp=float(np.abs(scan - host).max()),
                plain_vs_fill_cpp=float(np.abs(plain - host).max()),
                plain_vs_jax=float(np.abs(plain - scan).max()),
                lp=(float(scan_lp) - host_lp, plain_lp - host_lp))


def test_plain_drifts_with_the_jax_scan():
    """At a longer banded grid (1200 x 1213, band 20 as the guide's) the
    row scan's doubling steps drift from fill.cpp's per-cell order, and the
    plain version drifts with the JAX package's scan: the two stay within
    1e-10 of each other, and both within 1e-9 of fill.cpp here.  At long6's
    6000 columns the same drift passes 1e-9 (tests/sibling_drift.py)."""
    d = drift(1200, 20)
    assert d["plain_vs_jax"] < 1e-10
    assert d["plain_vs_fill_cpp"] < TOL and d["jax_vs_fill_cpp"] < TOL
    assert all(abs(e) < TOL for e in d["lp"])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_fill_cpp(case):
    inputs = fill_inputs(*CASES[case])
    got, lp = plain_fill(*inputs)
    ref, ref_lp = host_fill(*inputs)
    assert np.array_equal(got < -1e29, ref == -np.inf)
    live = np.isfinite(ref)
    assert np.abs(got[live] - ref[live]).max() < TOL
    assert abs(lp - ref_lp) < TOL * max(1.0, abs(ref_lp))


@pytest.mark.parametrize("case", list(CASES))
def test_band_entry_matches_fill_cpp(case):
    """On the CPU the band entry is the plain full fill gathered at the
    band; read back as a BandCells it answers every cell of the grid as
    fill.cpp's grid holds it."""
    l_emit, r_emit, match, mask, tmat = inputs = fill_inputs(*CASES[case])
    ref, ref_lp = host_fill(*inputs)
    X1, Y1 = match.shape
    lo, hi = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
    layout = branchdp.band_layout(lo, hi, X1, Y1)
    inp = siblingdp.upload_band(layout, match, mask, l_emit, r_emit, tmat, torch.device("cpu"))
    assert inp.emit.shape == (layout.n,) and inp.trans.shape == (144,)
    launches = siblingdp.LAUNCHES
    band, lp_end = siblingdp.sibling_fill_band(inp)
    assert siblingdp.LAUNCHES == launches  # the plain version counts no launch
    assert band.shape == (layout.n, 11) and lp_end.shape == (1,)
    cells, lp = siblingdp.read_band(band, lp_end, layout)
    grid = np.array([[cells[x, y] for y in range(Y1)] for x in range(X1)])
    assert np.array_equal(grid == -np.inf, ref == -np.inf)
    live = np.isfinite(ref)
    assert np.abs(grid[live] - ref[live]).max() < TOL
    assert abs(lp - ref_lp) < TOL * max(1.0, abs(ref_lp))
    if CASES[case][2] is not None:
        assert layout.n < X1 * Y1  # a band, not the grid


def test_band_layout_of_a_full_mask_is_the_grid():
    """A full mask's band is every cell in row-major order, and its widest
    diagonal is the grid's shorter side plus one."""
    X1, Y1 = 31, 40
    lo, hi = (t.numpy() for t in branchdp.interior_hull(torch.ones(X1, Y1, dtype=torch.bool)))
    layout = branchdp.band_layout(lo, hi, X1, Y1)
    assert layout.n == X1 * Y1 and layout.widest == X1
    assert np.array_equal(layout.flat_index(), np.arange(X1 * Y1))


def test_band_entry_rejects_other_devices():
    l_emit, r_emit, match, mask, tmat = fill_inputs(5, 6, None)
    lo, hi = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
    layout = branchdp.band_layout(lo, hi, 6, 7)
    inp = siblingdp.band_inputs(layout, *(torch.from_numpy(a) for a in
                                          (match, mask, l_emit, r_emit, tmat)))
    meta = siblingdp.SiblingBandInputs(layout, *(t.to("meta") for t in (
        inp.emit, inp.mask, inp.l_emit, inp.r_emit, inp.trans, inp.rowpos, inp.off, inp.diag)))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        siblingdp.sibling_fill_band(meta)


# --------------------------------------------------- the kernel's dataflow
IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX, EEE = range(12)
LOG2 = np.log(2.0)


@np.errstate(divide="ignore", invalid="ignore")
def lse_list(vs):
    """fill.cpp sib::lse_list over arrays: max shift, Neumaier sum."""
    m = vs[0]
    for v in vs[1:]:
        m = np.where(v > m, v, m)
    none = m == -np.inf
    mm = np.where(none, 0.0, m)
    s = c = np.zeros_like(mm)
    for v in vs:
        x = np.exp(v - mm)
        t = s + x
        c = c + np.where(np.abs(s) >= np.abs(x), (s - t) + x, (x - t) + s)
        s = t
    return np.where(none, -np.inf, mm + np.log(s + c))


@np.errstate(invalid="ignore")
def lse2(x, y):
    """fill.cpp lse2 over arrays."""
    d = x - y
    r = np.where(d > 0, x + np.log1p(np.exp(-np.abs(d))), y + np.log1p(np.exp(-np.abs(d))))
    return np.where(x == y, x + LOG2, np.where((d > 0) | (d <= 0), r, x + y))


def lane_cells(t, l, r, lr, le, ren, me, origin, inside):
    """Cells [n, 11] from their neighbours' [n, 11] (-inf where absent) in
    csrc/siblingfill.cu's lane-group order: the four lse_lists (IIW with a
    -inf fourth term) and three lse2 from the neighbours, then WWW, WWX and
    WXW, then IDD; -inf outside the mask."""
    ninf = np.full(len(le), -np.inf)
    w_ = (WWW, WWX, WXW, IDD)
    imm = me + lse_list([lr[:, s] + t[s, IMM] for s in w_])
    imd = le + lse_list([l[:, s] + t[s, IMD] for s in w_])
    idm = ren + lse_list([r[:, s] + t[s, IDM] for s in w_])
    iiw = le + lse_list([l[:, IMM] + t[IMM, IIW], l[:, IMI] + t[IMI, IIW],
                         l[:, IIW] + t[IIW, IIW], ninf])
    iix = le + lse2(l[:, IMD] + t[IMD, IIX], l[:, IIX] + t[IIX, IIX])
    imi = ren + lse2(r[:, IMM] + t[IMM, IMI], r[:, IMI] + t[IMI, IMI])
    idi = ren + lse2(r[:, IDM] + t[IDM, IDI], r[:, IDI] + t[IDI, IDI])
    www = lse2(lse2(iiw + t[IIW, WWW], imi + t[IMI, WWW]), imm + t[IMM, WWW])
    www = np.where(origin, t[IMM, WWW], www)
    imm = np.where(origin, 0.0, imm)
    wwx = lse2(iix + t[IIX, WWX], imd + t[IMD, WWX])
    wxw = lse2(idi + t[IDI, WXW], idm + t[IDM, WXW])
    idd = lse_list([www + t[WWW, IDD], wwx + t[WWX, IDD], wxw + t[WXW, IDD]])
    out = np.stack([imm, imd, idm, idd, www, wwx, wxw, imi, iiw, idi, iix], 1)
    return np.where(inside[:, None], out, -np.inf)


def lp_end_of(t, c):
    return float(lse_list([np.array([c[s] + t[s, EEE]]) for s in (IDD, WWW, WWX, WXW)])[0])


def band_setup(case):
    l_emit, r_emit, match, mask, tmat = inputs = fill_inputs(*CASES[case])
    X1, Y1 = match.shape
    lo, hi = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
    layout = branchdp.band_layout(lo, hi, X1, Y1)
    inp = siblingdp.upload_band(layout, match, mask, l_emit, r_emit, tmat, torch.device("cpu"))
    return inputs, layout, inp


def ring_walk(inp, recs, ring_rows, tmat):
    """The ring design's fill from the plan's records alone: each diagonal's
    cells from three planes of R + 5 slots (hull rows x mod R, the four
    boundary lines, the guard of -inf), each neighbour read at the slot its
    record names; the band [n, 11] and lp_end."""
    f = {k: v.numpy() for k, v in siblingdp.plan_fields(recs).items()}
    R = ring_rows
    ring = np.full((3, R + 5, 11), -np.inf)
    band = np.full((inp.layout.n, 11), -np.inf)
    for k in range(recs.shape[0]):
        live = f["pos"][k] >= 0
        sl = f["slots"][k][live].astype(np.int64)
        flags = f["flags"][k][live]
        out = lane_cells(tmat, ring[(k - 1) % 3][sl[:, 1]], ring[(k - 1) % 3][sl[:, 2]],
                         ring[(k - 2) % 3][sl[:, 3]], f["le"][k][live], f["ren"][k][live],
                         f["me"][k][live], (flags & 2) != 0, (flags & 1) != 0)
        ring[k % 3][sl[:, 0]] = out
        band[f["pos"][k][live]] = out
    return band, lp_end_of(tmat, band[-1])


def strip_walk(inp, H, tmat):
    """The strip design's fill: strips of H rows, each walking the
    diagonals that cross it with a lane group a row, its last two
    diagonals in planes of H + 1 slots (slot 0 the row above the strip,
    slot i + 1 row i), the row above read only from the strip above's
    exchange (its last row's cells by column); the band and lp_end."""
    lay = inp.layout
    X1, Y1 = lay.shape
    X, Y = X1 - 1, Y1 - 1
    off, rowpos = lay.off, lay.rowpos
    emit, mask = inp.emit.numpy(), inp.mask.numpy()
    l_emit, r_emit = inp.l_emit.numpy(), inp.r_emit.numpy()
    strips = -(-X1 // H)
    exch = np.full((strips, Y1, 11), -np.inf)
    band = np.full((lay.n, 11), -np.inf)
    for b in range(strips):
        x0, xl = b * H, min(b * H + H - 1, X)
        x = np.arange(x0, x0 + H)
        row = x <= X
        xr = np.minimum(x, X)
        lo = off[xr] + 1 - rowpos[xr]
        hi = lo + off[np.minimum(xr + 1, X1)] - off[xr] - 1 - int(Y >= 1) - 1
        le = np.where(x >= 1, l_emit[np.clip(x - 1, 0, max(X - 1, 0))] if X else 0.0, 0.0)
        planes = np.full((3, H + 1, 11), -np.inf)

        def above(d):  # the row above's cell of diagonal d, from the exchange
            y = d - (x0 - 1)
            return exch[b - 1][y] if b > 0 and 0 <= y <= Y else np.full(11, -np.inf)

        planes[(x0 - 1) % 3][0] = above(x0 - 1)
        for k in range(x0, xl + Y + 1):
            y = k - x
            inner = (x > 0) & (x < X) & (y > 0) & (y < Y)
            cell = row & (y >= 0) & (y <= Y) & (~inner | ((y >= lo) & (y <= hi)))
            pos = np.where(x == 0, y, np.where(x == X, off[X] + y, np.where(
                y == 0, off[xr], np.where(y == Y, off[np.minimum(xr + 1, X1)] - 1,
                                          rowpos[xr] + y))))
            pos = np.where(cell, pos, 0)
            p1, p2 = planes[(k - 1) % 3], planes[(k - 2) % 3]
            ren = np.where(cell & (y >= 1), r_emit[np.clip(y - 1, 0, max(Y - 1, 0))]
                           if Y else 0.0, 0.0)
            out = lane_cells(tmat, p1[:H], p1[1:], p2[:H], le, ren,
                             np.where(cell, emit[pos], 0.0), (x == 0) & (y == 0),
                             cell & (mask[pos] != 0))
            planes[k % 3][1:] = out
            band[pos[cell]] = out[cell]
            if b + 1 < strips and 0 <= y[-1] <= Y:
                exch[b][y[-1]] = out[-1]
            planes[k % 3][0] = above(k)
    return band, lp_end_of(tmat, band[-1])


def check_walk(case, band, lp, layout, inputs):
    """The walk's band against fill.cpp (TOL) and the JAX package's
    sibling_forward (the NEG pattern, TOL)."""
    l_emit, r_emit, match, mask, tmat = inputs
    ref, ref_lp = host_fill(*inputs)
    idx = layout.flat_index()
    host = ref.reshape(-1, 11)[idx]
    assert np.array_equal(band == -np.inf, host == -np.inf), case
    live = np.isfinite(host)
    assert np.abs(band[live] - host[live]).max(initial=0.0) < TOL
    assert abs(lp - ref_lp) < TOL * max(1.0, abs(ref_lp))
    scan, scan_lp = jax_sib.sibling_forward(
        l_emit, r_emit, np.where(np.isfinite(match), match, jax_sib.NEG), mask,
        siblingdp.pack_table(tmat))
    scan = np.asarray(scan).reshape(-1, 11)[idx]
    assert np.array_equal(band == -np.inf, scan < -1e29)
    assert np.abs(band[live] - scan[live]).max(initial=0.0) < TOL
    assert abs(lp - float(scan_lp)) < TOL * max(1.0, abs(ref_lp))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plain_plan_records(case):
    """Every band cell in one record, in band.cuh's order along its
    diagonal; its position, emissions and flags; an empty slot's record."""
    (l_emit, r_emit, match, mask, tmat), layout, inp = band_setup(case)
    width, R = siblingdp.ring_shape(layout)
    recs = siblingdp.plan_records(inp)  # on the CPU: the plain plan
    X1, Y1 = layout.shape
    assert recs.shape == (X1 + Y1 - 1, width, siblingdp.REC_BYTES) and recs.dtype == torch.uint8
    f = {k: v.numpy() for k, v in siblingdp.plan_fields(recs).items()}
    live = f["pos"] >= 0
    assert np.array_equal(np.sort(f["pos"][live]), np.arange(layout.n))
    idx = layout.flat_index()
    k_of, slot = np.nonzero(live)
    x, y = np.divmod(idx[f["pos"][live]], Y1)
    assert np.array_equal(x + y, k_of)
    # along a diagonal: (0, k), (k - Y, Y), the hull rows, (k, 0), (X, k - X)
    X, Y = X1 - 1, Y1 - 1
    rank = np.where(x == 0, 0, np.where((y == Y) & (x < X), 1, np.where(
        (y == 0) & (x < X), 3, np.where(x == X, 4, 2))))
    order = np.lexsort((x, rank, k_of))
    assert np.array_equal(order, np.arange(len(order)))
    flat_mask = mask.reshape(-1)[idx]
    assert np.array_equal(f["flags"][live] & 1, flat_mask[f["pos"][live]])
    assert np.array_equal((f["flags"][live] & 2) != 0, (x == 0) & (y == 0))
    assert np.array_equal(f["me"][live], match.reshape(-1)[idx][f["pos"][live]])
    assert np.array_equal(f["le"][live], np.where(x >= 1, l_emit[np.maximum(x - 1, 0)]
                                                  if X else 0.0, 0.0))
    assert np.array_equal(f["ren"][live], np.where(y >= 1, r_emit[np.maximum(y - 1, 0)]
                                                   if Y else 0.0, 0.0))
    assert np.all(f["slots"][~live] == R + 4) and np.all(f["flags"][~live] == 0)
    assert np.all(recs.numpy()[..., 40:] == 0)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_ring_walk_through_the_plan_matches_fill_cpp(case):
    """The ring design's dataflow: each cell reads its neighbours only at
    the ring slots its record names, the planes of the two diagonals
    before it; equal to fill.cpp and to the JAX package's fill."""
    inputs, layout, inp = band_setup(case)
    width, R = siblingdp.ring_shape(layout)
    band, lp = ring_walk(inp, siblingdp.plan_records(inp), R, inputs[4])
    check_walk(case, band, lp, layout, inputs)


@pytest.mark.parametrize("H", [8, 16])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_strip_walk_matches_fill_cpp(case, H):
    """The strip design's dataflow, strips of H rows (three or more at the
    larger cases), the row above a strip read only from its exchange;
    equal to fill.cpp and to the JAX package's fill."""
    inputs, layout, inp = band_setup(case)
    band, lp = strip_walk(inp, H, inputs[4])
    check_walk(case, band, lp, layout, inputs)


def test_design_rule():
    """The ring design up to RING_MAX_CELLS cells on the widest diagonal,
    the strip design past it; the ring's slots a diagonal fill whole warps
    and its rows a power of two."""
    _, banded, _ = band_setup("banded 90x120")
    _, full, _ = band_setup("full 70x50")
    assert siblingdp.design_of(banded) == "ring" and banded.widest <= siblingdp.RING_MAX_CELLS
    width, R = siblingdp.ring_shape(banded)
    assert width % 8 == 0 and width >= banded.widest and R >= banded.span and R & (R - 1) == 0
    big = branchdp.band_layout(*(t.numpy() for t in branchdp.interior_hull(
        torch.ones(300, 200, dtype=torch.bool))), 300, 200)
    assert siblingdp.design_of(big) == "strip" and siblingdp.design_of(full) == "ring"
