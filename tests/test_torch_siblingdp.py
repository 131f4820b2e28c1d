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
- the band entry's input checks."""

import numpy as np
import pytest
import torch

from historian_tpu.ops import siblingdp as jax_sib
from historian_tpu_torch.ops import branchdp, siblingdp
from historian_tpu_torch.sampler.sibling import native_fill

TOL = 1e-9
CASES = {"banded 90x120": (90, 120, 6), "full 70x50": (70, 50, None),
         "full 1x1": (1, 1, None), "full 2x0": (2, 0, None), "banded 40x41 band 1": (40, 41, 1)}


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
    if band is not None:
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
