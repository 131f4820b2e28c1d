"""The branch fill (kernel (e)'s slice) on the CPU in float64: the port's
plain version (historian_tpu_torch/ops/branchdp.py) against the JAX
package's `branch_viterbi` / `branch_forward` (jit on the CPU) to 1e-12
relative, the port's csrc/fill.cpp `branch_fill` against the JAX
package's native one bit for bit, the plain version against fill.cpp to
1e-12; the band the card fills (`band_layout`: each row's hull, the
diagonals' hull rows, the packed order), the band entry's plain version
against the full plain fill at every band cell, and the band readback
against the full grid.  Inputs: seeded emissions and transitions, full,
banded or holed masks of the refiner's shape (boundary rows and columns
always in)."""

import numpy as np
import pytest
import torch

from historian_tpu.native import get_native as jax_native
from historian_tpu.ops import branchdp as jax_branchdp
from historian_tpu_torch.native import get_native
from historian_tpu_torch.ops import branchdp, readback

#: (X + 1, Y + 1, band): band -1 is the full grid
SHAPES = [(37, 53, -1), (130, 97, 6), (64, 64, 0), (2, 9, -1)]


def inputs(X1, Y1, band, seed=0):
    """(match_emit, ins_emit, mask, trans): emissions of a PWM x PWM fill
    (NEG on row and column 0), a mask of cumulative-match offsets within
    `band` of each other (-1: full; -2: random, with holes), and the 8 log
    transitions of a pair HMM."""
    rng = np.random.default_rng(seed)
    emit = rng.normal(-4.0, 1.5, (X1, Y1))
    emit[0, :] = emit[:, 0] = branchdp.NEG
    ins = np.concatenate([[branchdp.NEG], rng.normal(-3.0, 0.5, Y1 - 1)])
    if band == -2:
        mask = rng.random((X1, Y1)) < 0.3
    elif band < 0:
        mask = np.ones((X1, Y1), dtype=bool)
    else:
        m1 = np.cumsum(rng.random(X1) < 0.8)
        m2 = np.cumsum(rng.random(Y1) < 0.8)
        mask = np.abs(m1[:, None] - m2[None, :]) <= band
    mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
    p = rng.dirichlet([8, 1, 1], 3)  # from M, I, D: to M, I, D
    trans = np.log(np.array([p[0, 0], p[0, 1], p[0, 2], p[1, 0], p[1, 1], p[1, 2],
                             p[2, 0] + p[2, 1], p[2, 2]]))
    return emit, ins, mask, trans


def native_fill(lib, emit, ins, mask, trans, viterbi):
    cells = np.empty((*emit.shape, 3))
    lib.branch_fill(emit.shape[0], emit.shape[1], np.ascontiguousarray(emit), ins,
                    np.ascontiguousarray(mask, dtype=np.uint8), trans, np.uint8(viterbi), cells)
    return cells


def plain(emit, ins, mask, trans, viterbi):
    t = [torch.as_tensor(a) for a in (emit, ins, mask, trans)]
    return branchdp.branch_fill(*t, viterbi).numpy()


def close(got, ref, rtol=1e-12):
    return np.all(np.abs(got - ref) <= rtol * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in SHAPES])
def test_plain_matches_jax(shape, viterbi):
    emit, ins, mask, trans = inputs(*shape)
    fill = jax_branchdp.branch_viterbi if viterbi else jax_branchdp.branch_forward
    ref = np.asarray(fill(emit, ins, mask, trans))
    got = plain(emit, ins, mask, trans, viterbi)
    assert got.shape == ref.shape == (*shape[:2], 3)
    assert close(got, ref)
    assert np.all(got[~mask] == branchdp.NEG)


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in SHAPES])
def test_native_matches_jax_native_and_plain(shape, viterbi):
    emit, ins, mask, trans = inputs(*shape, seed=1)
    got = native_fill(get_native(), emit, ins, mask, trans, viterbi)
    ref = native_fill(jax_native(), emit, ins, mask, trans, viterbi)
    assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
    assert close(plain(emit, ins, mask, trans, viterbi), got)


def test_wrapper_checks_and_counts():
    """A CPU tensor takes the plain version and launches nothing; bad
    shapes and a non-bool mask raise."""
    emit, ins, mask, trans = (torch.as_tensor(a) for a in inputs(9, 7, 1))
    before = branchdp.LAUNCHES
    assert branchdp.branch_fill(emit, ins, mask, trans, True).shape == (9, 7, 3)
    assert branchdp.LAUNCHES == before
    with pytest.raises(ValueError, match="shapes"):
        branchdp.branch_fill(emit, ins[:-1], mask, trans, True)
    with pytest.raises(ValueError, match="bool"):
        branchdp.branch_fill(emit, ins, mask.to(torch.uint8), trans, True)


def hull(mask):
    """The mask's interior hull (`interior_hull`) as numpy arrays."""
    return tuple(t.numpy() for t in branchdp.interior_hull(torch.as_tensor(mask)))


def band_of(emit, ins, mask, trans):
    """The layout of the mask's band and the band's inputs (CPU tensors)."""
    lay = branchdp.band_layout(*hull(mask), *mask.shape)
    return lay, branchdp.band_inputs(lay, *(torch.as_tensor(a) for a in (emit, mask, ins, trans)))


@pytest.mark.parametrize("band", [-1, 3, -2])
def test_read_band_reads_as_the_grid(band):
    """BandCells answers every cell as the full grid: the band's cells from
    the band copied back (one readback of its n x 3 values), the rest NEG
    in all three states."""
    emit, ins, mask, trans = inputs(41, 33, band, seed=2)
    full = plain(emit, ins, mask, trans, True)
    lay, inp = band_of(emit, ins, mask, trans)
    n = len(readback.READBACKS)
    band_cells = branchdp.read_band(branchdp.branch_fill_band(inp, True), lay)
    assert readback.READBACKS[n]["cells"] == lay.n and readback.READBACKS[n]["kind"] == "branch"
    assert readback.READBACKS[n]["bytes"] == lay.n * 24
    for x in range(41):
        for y in range(33):
            assert np.array_equal(band_cells[x, y], full[x, y])
            assert band_cells[x, y, 2] == full[x, y, 2]
            assert band_cells[x, 32 - y, 1] == full[x, 32 - y, 1]


@pytest.mark.parametrize("shape", SHAPES + [(1, 1, -1), (1, 6, -1), (6, 1, -1), (3, 3, 0),
                                            (50, 40, -2)])
def test_diagonal_ranges(shape):
    """The layout's diagonals: on each anti-diagonal the hull rows are
    exactly diag[k] = (xa, xb) (xa > xb where there are none), and they
    hold every in-mask interior cell; band -2 is a random mask with
    holes."""
    X1, Y1, band = shape
    if band == -2:
        mask = np.random.default_rng(3).random((X1, Y1)) < 0.3
    else:
        mask = inputs(*shape)[2]
    lay = branchdp.band_layout(*hull(mask), X1, Y1)
    lo, hi, diag = lay.lo, lay.hi, lay.diag
    assert diag.shape == (X1 + Y1 - 1, 2)
    for k in range(X1 + Y1 - 1):
        rows = [x for x in range(1, X1 - 1) if lo[x] <= k - x <= hi[x]]
        assert all(mask[x, k - x] <= (x in rows) for x in range(1, X1 - 1) if 0 < k - x < Y1 - 1)
        if rows:
            assert tuple(diag[k]) == (rows[0], rows[-1])
            assert rows == list(range(rows[0], rows[-1] + 1))
        else:
            assert diag[k, 0] > diag[k, 1]


@pytest.mark.parametrize("shape", SHAPES + [(1, 1, -1), (1, 6, -1), (6, 1, -1), (3, 3, 0),
                                            (60, 50, -2), (2, 2, -1), (3, 40, -1)])
def test_band_layout(shape):
    """The hull of each interior row is the span of its in-mask interior
    columns, widened only so that neither end falls as x grows; the band is
    rows 0 and X whole and, on each other row, column 0, the hull and
    column Y, packed row after row, where rowpos and off place them; the
    fullest diagonal's cells and hull rows are `widest` and `span`."""
    X1, Y1, band = shape
    mask = inputs(X1, Y1, band, seed=4)[2]
    lo_raw, hi_raw = hull(mask)
    for x in range(1, X1 - 1):
        cols = [y for y in range(1, Y1 - 1) if mask[x, y]]
        assert (lo_raw[x], hi_raw[x]) == ((cols[0], cols[-1]) if cols else (Y1, 0))
    lay = branchdp.band_layout(lo_raw, hi_raw, X1, Y1)
    lo, hi, off, rowpos = lay.lo, lay.hi, lay.off, lay.rowpos
    some = hi_raw[1:-1] > 0
    if band != -2:  # a banded or full mask's hulls never fall: none is widened
        assert np.array_equal(lo[1:-1][some], lo_raw[1:-1][some])
        assert np.array_equal(hi[1:-1][some], hi_raw[1:-1][some])
        assert np.all(lo[1:-1][~some] > hi[1:-1][~some])
    assert np.all(np.diff(lo[1:-1]) >= 0) and np.all(np.diff(hi[1:-1]) >= 0)
    assert np.all(lo[1:-1] <= np.where(some, lo_raw[1:-1], Y1))
    assert np.all(hi[1:-1] >= hi_raw[1:-1])
    cells = []
    for x in range(X1):
        if x in (0, X1 - 1):
            cols = list(range(Y1))
        else:
            cols = sorted({0, Y1 - 1} | set(range(lo[x], hi[x] + 1)))
        cells += [(x, y) for y in cols]
        assert off[x + 1] - off[x] == len(cols)
        for j, y in enumerate(cols):
            at = off[x] + j
            if lo[x] <= y <= hi[x]:
                assert rowpos[x] + y == at
            assert y != 0 or off[x] == at
            assert y != Y1 - 1 or off[x + 1] - 1 == at
    assert lay.n == len(cells)
    assert np.array_equal(lay.flat_index(), [x * Y1 + y for x, y in cells])
    per_diag = np.bincount([x + y for x, y in cells], minlength=X1 + Y1 - 1)
    assert lay.widest == per_diag.max()
    diag = lay.diag
    assert lay.span == max(0, (diag[:, 1] - diag[:, 0] + 1).max())


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("band", [-1, 6, -2], ids=["full", "band", "holes"])
def test_band_plain_matches_plain_at_the_band(band, viterbi):
    """The band entry on CPU tensors (the plain full fill gathered at the
    band) equals `branch_fill_plain` at every band cell, a hull cell outside
    the mask NEG; every cell outside the band is NEG in the full fill; it
    launches nothing."""
    emit, ins, mask, trans = inputs(70, 61, band, seed=7)
    full = plain(emit, ins, mask, trans, viterbi).reshape(-1, 3)
    lay, inp = band_of(emit, ins, mask, trans)
    before = branchdp.LAUNCHES
    got = branchdp.branch_fill_band(inp, viterbi).numpy()
    assert branchdp.LAUNCHES == before and got.shape == (lay.n, 3)
    idx = lay.flat_index()
    assert np.array_equal(got, full[idx])
    assert np.all(got[~mask.reshape(-1)[idx]] == branchdp.NEG)
    outside = np.ones(len(full), dtype=bool)
    outside[idx] = False
    assert np.all(full[outside] == branchdp.NEG)


def test_upload_band_on_the_cpu():
    """`upload_band` off the card gathers the host grids' band as
    `band_inputs` does, logs no upload, and the int32 tables carry the
    layout."""
    emit, ins, mask, trans = inputs(30, 45, 4, seed=9)
    lay, ref = band_of(emit, ins, mask, trans)
    n = len(branchdp.UPLOADS)
    got = branchdp.upload_band(lay, emit, mask, ins, trans, torch.device("cpu"))
    assert len(branchdp.UPLOADS) == n
    for name in ("emit", "mask", "ins", "trans", "rowpos", "off", "diag"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.mask.shape == (lay.n,) and got.rowpos.dtype == torch.int32
    assert np.array_equal(got.diag.numpy(), lay.diag)


# ----------------------------------------------- the strip design's plan and dataflow
@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
def test_plain_matches_jax_full_mask_past_the_ring(viterbi):
    """A full mask (an uninitialised envelope) whose fullest diagonal holds
    more cells than the ring design's block: the layout picks the strip
    design, and the plain version equals the JAX package's fill (1e-12
    relative) and fill.cpp's."""
    emit, ins, mask, trans = inputs(300, 280, -1, seed=11)
    lay = branchdp.band_layout(*hull(mask), 300, 280)
    assert lay.widest > branchdp.RING_MAX_CELLS and lay.design() == "strip"
    assert branchdp.band_layout(*hull(inputs(300, 280, 6)[2]), 300, 280).design() == "ring"
    fill = jax_branchdp.branch_viterbi if viterbi else jax_branchdp.branch_forward
    ref = np.asarray(fill(emit, ins, mask, trans))
    got = plain(emit, ins, mask, trans, viterbi)
    assert close(got, ref)
    assert close(got, native_fill(get_native(), emit, ins, mask, trans, viterbi))


#: (X1, rows, capacity, lead) -> (strips, last strip's rows, blocks)
STRIP_PLANS = {(20, 64, 132, 8): (1, 20, 1),        # X smaller than one strip
               (64, 64, 132, 8): (1, 64, 1),
               (5997, 64, 132, 8): (94, 45, 94),    # a partial last strip
               (1000, 32, 4, 1): (32, 8, 4),        # more strips than blocks
               (257, 256, 1, 62): (2, 1, 1)}


@pytest.mark.parametrize("case", list(STRIP_PLANS), ids=[str(c) for c in STRIP_PLANS])
def test_strip_plan(case):
    """`strip_plan`: strips of `rows` rows over the grid's rows, the last
    partial where `rows` does not divide them, as many blocks as strips
    but at most the card's resident capacity, the lead carried."""
    X1, rows, capacity, lead = case
    plan = branchdp.strip_plan(X1, rows, capacity, lead)
    strips, last, blocks = STRIP_PLANS[case]
    assert plan == dict(strips=strips, rows=rows, last_rows=last, blocks=blocks, lead=lead)
    assert (strips - 1) * rows + last == X1


@pytest.mark.parametrize("bad", [(100, 48, 10, 8), (100, 288, 10, 8), (100, 64, 10, 0),
                                 (100, 64, 10, 255)])
def test_strip_plan_rejects(bad):
    with pytest.raises(ValueError):
        branchdp.strip_plan(*bad)
    with pytest.raises(RuntimeError, match="no strip block"):
        branchdp.strip_plan(100, 64, 0, 8)


LOG2 = float(np.log(2.0))


@np.errstate(over="ignore", invalid="ignore")
def red2(a, b, viterbi):
    """csrc/branchfill.cu red2 over arrays: max (the first operand on ties)
    or fill.cpp's lse2 in its select form."""
    if viterbi:
        return np.where(a > b, a, b)
    d = a - b
    up = d > 0
    t = np.where(up, -d, d)
    r = np.where(up, a, b) + np.where(t < -708.0, 0.0, np.log1p(np.exp(np.maximum(t, -708.0))))
    return np.where(a == b, a + LOG2, np.where(up | (d <= 0), r, a + b))


def cell_values(p, q, u, x_in, y_in, in_env, e, ins_y, tr, viterbi):
    """csrc/branchfill.cu's m_value, i_value and d_value over arrays of
    cells ([n, 3] neighbours p (x-1, y-1), q (x, y-1), u (x-1, y))."""
    neg = branchdp.NEG
    mr = red2(red2(p[:, 0] + tr[0], p[:, 1] + tr[3], viterbi), p[:, 2] + tr[6], viterbi)
    m = np.where(~in_env, neg, np.where(~y_in, np.where(x_in, neg, 0.0),
                                        np.where(x_in, mr, neg) + e))
    i = np.where(in_env & y_in, red2(q[:, 0] + tr[1], q[:, 1] + tr[4], viterbi) + ins_y, neg)
    d = np.where(in_env, red2(u[:, 2] + tr[7], red2(u[:, 0] + tr[2], u[:, 1] + tr[5], viterbi),
                              viterbi), neg)
    return np.stack([m, i, d], 1)


def strip_walk(inp, H, viterbi):
    """The strip design's fill (csrc/branchfill.cu `branchfill_strip`):
    strips of H rows, each walking the diagonals that cross it with a
    thread a row, its last two diagonals in planes of H + 1 slots (slot 0
    the row above the strip, slot i + 1 row i), the row above read only
    from the strip above's exchange (its last row's cells by column) and
    each row's band from `off` and `rowpos` as the kernel takes them; the
    band [n, 3]."""
    lay = inp.layout
    X1, Y1 = lay.shape
    X, Y = X1 - 1, Y1 - 1
    off, rowpos = lay.off, lay.rowpos
    emit, mask = inp.emit.numpy(), inp.mask.numpy()
    ins, tr = inp.ins.numpy(), inp.trans.numpy()
    neg = branchdp.NEG
    strips = -(-X1 // H)
    exch = np.full((strips, Y1, 3), np.nan)
    band = np.full((lay.n, 3), np.nan)
    for b in range(strips):
        x0, xl = b * H, min(b * H + H - 1, X)
        x = np.arange(x0, x0 + H)
        row = x <= xl
        xr = np.minimum(x, X)
        o0, oY, rp = off[xr], off[xr + 1] - 1, rowpos[xr]
        lo = o0 + 1 - rp
        hi = lo + (oY - o0 - int(Y >= 1)) - 1
        planes = np.full((3, H + 1, 3), neg)

        def above(d):  # the row above's cell of diagonal d: the stage, from the exchange
            y = d - (x0 - 1)
            return exch[b - 1][y] if b > 0 and 0 <= y <= Y else np.full(3, neg)

        for k in range(x0, xl + Y + 1):
            y = k - x
            inner = (x > 0) & (x < X) & (y > 0) & (y < Y)
            live = row & (y >= 0) & (y <= Y) & (~inner | ((y >= lo) & (y <= hi)))
            pos = np.where(x == 0, y, np.where(x == X, off[X] + y, np.where(
                y == 0, o0, np.where(y == Y, oY, rp + y))))
            pos = np.where(live, pos, 0)
            p1, p2 = planes[(k - 1) % 3], planes[(k - 2) % 3]
            p, u = p2[:H].copy(), p1[:H].copy()
            p[0], u[0] = above(k - 2), above(k - 1)
            v = cell_values(p, p1[1:], u, x > 0, y > 0, live & (mask[pos] != 0),
                            np.where(live, emit[pos], 0.0),
                            np.where(live, ins[np.clip(y, 0, Y)], 0.0), tr, viterbi)
            v = np.where(live[:, None], v, neg)
            planes[k % 3][1:] = v
            band[pos[live]] = v[live]
            last = xl - x0
            if b + 1 < strips and 0 <= k - xl <= Y:
                exch[b][k - xl] = v[last]
    return band


#: (X1, Y1, band, H): a full mask in strips with a partial last one, X
#: smaller than one strip, a banded and a holed mask, strips of one row's
#: worth of threads
WALKS = [(100, 90, -1, 32), (20, 50, -1, 32), (130, 97, 6, 32), (70, 61, -2, 32),
         (97, 64, -1, 64)]


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("case", WALKS, ids=[f"{a}x{b}b{c}h{d}" for a, b, c, d in WALKS])
def test_strip_walk_matches_fill_cpp(case, viterbi):
    """The strip design's dataflow (`strip_walk`, each band cell written
    once, the row above a strip only through its exchange) against
    csrc/fill.cpp at the band: Viterbi bit for bit, Forward within 1e-12
    relative (numpy's exp and log1p against glibc's)."""
    X1, Y1, band, H = case
    emit, ins, mask, trans = inputs(X1, Y1, band, seed=X1 + Y1)
    lay, inp = band_of(emit, ins, mask, trans)
    got = strip_walk(inp, H, viterbi)
    ref = native_fill(get_native(), emit, ins, mask, trans, viterbi).reshape(-1, 3)
    ref = ref[lay.flat_index()]
    assert not np.isnan(got).any()
    if viterbi:
        assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
    else:
        assert close(got, ref)
