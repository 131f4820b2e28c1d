"""Kernel (a), the DAG x DAG merge fill (historian_tpu_torch/ops/
dagforward.py), on the CPU in float64: its plain version (the band's
cells, wavefront by wavefront in PyTorch) against the JAX package's
`dag_pair_forward_cells` (through historian_tpu/ops/devicedp.py
`dag_forward_cells`, HISTORIAN_DEVICE_DP=1) and against the port's host
fill (csrc/fill.cpp), each package on its own classes, at 1e-9 with the
same cells at -inf.

The merges (`CASES`): sampled profiles (10 traces and the best) of
sequences of tests/data/long6.fa cut to 110-240 aa, with null states and
states of several in-edges, against a sampled profile, against a leaf (a
chain y) and banded around a guide that aligns the sequences from their
first residue; a posterior profile (`-profminpost`'s) against a sampled
one; and a grid whose size is the JAX package's bucket (its index padding
must stay a no-op).  The plan: the in-envelope cells by wavefront, the
source table of its records against fwd_cell read from the CSRs and the
band, the ring slots (each its source's, overwritten by no cell before
its reader), the host's parts (fill.cpp's levels, the rows' hulls from
the envelope, the absorb), and no device but the CPU without a kernel.
Then the route: forced onto kernel (a) on the CPU
(`DAG_DEVICE_MIN_CELLS`), a merge gives the host route's cells and
profile, one that does not fit the device stays on fill.cpp
("oversized"), and small6 and small4 default `recon` equal the JAX
package's host route byte for byte."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from historian_tpu.ops import devicedp as jax_devicedp
from historian_tpu_torch import device
from historian_tpu_torch.ops import dagforward, readback
from historian_tpu_torch.ops import dagforward as D
from tests.test_torch_backward import assert_cells_close
from tests.test_torch_recon import rows_and_lp, write_small4
from tests.test_torch_sampled import MEMSIZE, _run, write_small6
from tests.torch_twins import DATA, JAX, PORT, PortHostForwardMatrix, host_forward, pair_hmm

F = PORT.forward
#: the envelope's band around the guide, in matched columns
BAND = 12
#: name: (x, y, banded); a side is a leaf (sequence k of long6 cut to n
#: aa) as ("leaf", (k, n)), the sampled profile (10 traces and the best,
#: mt19937 `seed`) of two leaves as ("sampled", (k, n), (k', n'), seed), or
#: the posterior profile (0.01, `-profminpost`'s) of two as ("posterior",
#: (k, n), (k', n')).  The x profiles of the first three have null states,
#: the y of the last has one; every x and DAG y has states of several
#: in-edges (junctions)
CASES = {
    "dag x dag": (("sampled", (2, 240), (3, 240), 7), ("sampled", (0, 120), (1, 110), 5489),
                  False),
    "dag x chain": (("sampled", (0, 240), (2, 240), 5489), ("leaf", (4, 200)), False),
    "dag x dag banded": (("sampled", (2, 240), (3, 240), 7),
                         ("sampled", (0, 230), (1, 220), 99), True),
    "posterior x dag": (("posterior", (0, 120), (1, 110)), ("sampled", (2, 130), (3, 125), 7),
                        False),
}


@pytest.fixture
def cpu64(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")


def merge(pkg, x_spec, y_spec, banded):
    """The ForwardMatrix arguments of a merge in `pkg`'s classes (each child
    profile filled on the host); the guide of a banded one aligns the
    sequences from their first residue."""
    model = pkg.presets.named_model("lg")
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long6.fa"))
    hmm = pair_hmm(pkg, model, 0.3, 0.25)
    rows = {}

    def leaf(k, n):
        rows[k] = n
        return pkg.profile.Profile.from_sequence(
            model.components, model.alphabet, pkg.seqs.FastSeq(name=seqs[k].name,
                                                                seq=seqs[k].seq[:n]), k)

    def side(spec, row):
        if spec[0] == "leaf":
            return leaf(*spec[1])
        fwd = host_forward(pkg, leaf(*spec[1]), leaf(*spec[2]), hmm, row)
        if spec[0] == "posterior":
            return pkg.forward.BackwardMatrix(fwd).post_prob_profile(
                0.01, 0, pkg.forward.COLLAPSE_CHAINS)
        return fwd.sample_profile(pkg.rng.MT19937(spec[3]), 10, 0)

    x, y = side(x_spec, 6), side(y_spec, 7)
    env = None
    if banded:
        guide = {k: np.arange(max(rows.values())) < n for k, n in rows.items()}
        env = pkg.alignpath.GuideAlignmentEnvelope(guide, x_spec[1][0], y_spec[1][0], BAND)
    return x, y, pair_hmm(pkg, model, 0.2, 0.35), 8, env


def port_plain(fwd) -> np.ndarray:
    """The plain version's cells of a port merge, in a -inf grid [nx, ny, 5]."""
    out = np.full((fwd.x_size, fwd.y_size, 5), -np.inf)
    n_read = len(readback.READBACKS)
    dagforward.dag_forward_cells(fwd, torch.device("cpu"), out)
    assert readback.READBACKS[n_read]["kind"] == "dag"
    return out[: fwd.x_size - 1, : fwd.y_size - 1]


def jax_cells(monkeypatch, args) -> np.ndarray:
    ref = JAX.forward.ForwardMatrix(*args)
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    try:
        return jax_devicedp.dag_forward_cells(ref)
    finally:
        monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")


def _nulls(profile) -> int:
    return sum(s.is_null for s in profile.states[1:-1])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_and_host(cpu64, monkeypatch, name):
    x_spec, y_spec, banded = CASES[name]
    host = PortHostForwardMatrix(*merge(PORT, *CASES[name]))
    assert host.x.as_chain() is None and (host.y.as_chain() is None) == (y_spec[0] != "leaf")
    assert host.lp_end > -np.inf
    nx, ny = host.x_size - 1, host.y_size - 1
    # the structure the fill must handle: null states, junctions, the band
    assert _nulls(host.y if name == "posterior x dag" else host.x) > 0
    assert max(len(s.in_trans) for s in host.x.states[1:-1]) > 1
    assert (np.count_nonzero(host.env_mask[:nx, :ny]) < nx * ny) == banded
    got = port_plain(host)
    assert_cells_close(got, host.cells[:nx, :ny])
    assert_cells_close(got, jax_cells(monkeypatch, merge(JAX, *CASES[name])))


def test_plain_matches_jax_at_the_bucket_size(cpu64, monkeypatch):
    """The JAX package's grid at the merge's own size (SY == ny, no bucket
    padding), as historian_tpu's test_dag_kernel_exact_bucket_size."""
    host = PortHostForwardMatrix(*merge(PORT, *CASES["dag x dag"]))
    monkeypatch.setattr(jax_devicedp, "_bucket", lambda n: n)
    ref = jax_cells(monkeypatch, merge(JAX, *CASES["dag x dag"]))
    assert ref.shape == (host.x_size - 1, host.y_size - 1, 5)
    got = port_plain(host)
    assert_cells_close(got, ref)
    assert_cells_close(got, host.cells[: host.x_size - 1, : host.y_size - 1])


def test_plan_orders_cells_by_wavefront(cpu64):
    """Every in-envelope cell once, in wavefronts of strictly increasing
    level sum, and each of its in-edge sources in an earlier wavefront."""
    fwd = PortHostForwardMatrix(*merge(PORT, *CASES["dag x dag banded"]))
    p = dagforward.plan(fwd)
    nx, ny = fwd.x_size - 1, fwd.y_size - 1
    ii, jj = p.cells.T
    assert len(p.cells) == np.count_nonzero(fwd.env_mask[:nx, :ny])
    assert fwd.env_mask[ii, jj].all() and len({(i, j) for i, j in p.cells}) == len(p.cells)
    lx = dagforward.levels(*p.x_csr[:2], nx)
    ly = dagforward.levels(*p.y_csr[:2], ny)
    w = lx[ii] + ly[jj]
    starts = p.wave[:-1]
    assert np.all(np.diff(w[starts]) > 0)
    assert all((w[a:b] == w[a]).all() for a, b in zip(p.wave[:-1], p.wave[1:]))
    xp, xs, _ = p.x_csr
    assert all(lx[xs[e]] < lx[i] for i in range(nx) for e in range(xp[i], xp[i + 1]))
    assert p.widest == np.diff(p.wave).max()
    assert p.factors[0].shape[0] == nx and p.factors[2].shape[0] == ny


def expected_terms(p, c):
    """Cell c's terms as fwd_cell sums them: (kind, source (x, y), lpa,
    lpb), state by state (IMM, IMD, IDM, IMI, IIW), each in CSR order."""
    i, j = p.cells[c]
    xf, yf = int(p.x_flags[i]), int(p.y_flags[j])
    xnull, xrdy, xeos = xf & D.X_NULL, xf & D.X_READY, xf & D.X_EOS
    ynull, yrdy = yf & D.Y_NULL, yf & D.Y_READY
    (xp, xs, xl), (yp, ys, yl) = p.x_csr, p.y_csr
    xe, ye = range(xp[i], xp[i + 1]), range(yp[j], yp[j + 1])
    out = {s: [] for s in range(5)}
    if not xnull and not ynull:
        out[D.IMM] = [(D.IMM, (xs[a], ys[b]), xl[a], yl[b]) for a in xe for b in ye]
    elif ynull and xeos:
        out[D.IMM] = [(5 + D.IMM, (i, ys[e]), yl[e], 0.0) for e in ye]
    elif xnull and yrdy:
        out[D.IMM] = [(5 + D.IMM, (xs[e], j), xl[e], 0.0) for e in xe]
    for s in (D.IMD, D.IIW):
        if yrdy:
            out[s] = [(s + 5 * bool(xnull), (xs[e], j), xl[e], 0.0) for e in xe]
    for s in (D.IDM, D.IMI):
        if ynull or xrdy:
            out[s] = [(s + 5 * bool(ynull), (i, ys[e]), yl[e], 0.0) for e in ye]
    return out


def records(p, ring_waves=None, monkeypatch=None):
    """The plain plan's records and terms of plan `p` on the CPU, the ring
    design as `p` chooses it (with `ring_waves` wavefronts), or the wide."""
    if ring_waves is not None:
        monkeypatch.setattr(D, "RING_WAVES", ring_waves)
    inp = D.upload_band(p, torch.device("cpu"))
    if ring_waves is None:
        inp.ring = False
    return inp, D.plan_records_plain(inp)


def test_plan_source_table_follows_the_csrs_and_the_band(cpu64, monkeypatch):
    """Each cell's terms in the wide design's source table, against fwd_cell
    read from the CSRs: the ends of each state's terms, each term's kind,
    its source's band position (OUTSIDE where the layout has no cell there
    or the band cell is outside the envelope, whose value is -inf), its lps
    in CSR order; each wavefront's span of records and terms."""
    outside = 0
    for name in ("dag x dag banded", "posterior x dag"):
        fwd = PortHostForwardMatrix(*merge(PORT, *CASES[name]))
        p = D.plan(fwd)
        nx, ny = fwd.x_size - 1, fwd.y_size - 1
        band = {int(f): k for k, f in enumerate(p.layout.flat_index())}
        planned = {(int(i), int(j)) for i, j in p.cells}
        inp, rec = records(p)
        f = {k: v.numpy() for k, v in rec.fields().items()}
        assert (f["slot"] == -1).all() and len(f["loc"]) == f["ends"][:, 4].sum()
        for c in range(len(p.cells)):
            want = expected_terms(p, c)
            ends = np.cumsum([len(want[s]) for s in range(5)])
            assert (f["ends"][c] == ends).all()
            at = f["t0"][c]
            for s in range(5):
                for kind, (x, y), lpa, lpb in want[s]:
                    pos = band.get(x * ny + y, -1) if (x, y) in planned else -1
                    outside += pos == -1
                    assert (f["kind"][at], f["loc"][at]) == (kind, pos)
                    assert (f["lpa"][at], f["lpb"][at]) == (lpa, lpb)
                    at += 1
            i, j = p.cells[c]
            assert f["pos"][c] == band[int(i) * ny + int(j)]
        spans = rec.spans.numpy()
        assert (spans[:, 0] == p.wave[:-1]).all() and (spans[:, 1] == p.wave[1:]).all()
        assert (spans[:, 2] == f["t0"][p.wave[:-1]]).all()
        assert (spans[1:, 2] == spans[:-1, 3]).all() and spans[-1, 3] == len(f["loc"])
    assert outside > 0  # sources outside the band or the envelope are met


@pytest.mark.parametrize("ring_waves", [2, D.RING_WAVES])
def test_plan_ring_slots_hold_their_sources(cpu64, monkeypatch, ring_waves):
    """The ring design's table: a term whose source lies fewer than
    RING_WAVES wavefronts back reads the slot that source's cell writes,
    which no cell of the wavefronts after it, up to the reader's, writes
    again; an older source reads the band; the rest as the wide design.
    The plain fill through either table gives the same cells, within 1e-9
    of fill.cpp's (at two wavefronts, many sources come from the band)."""
    fwd = PortHostForwardMatrix(*merge(PORT, *CASES["dag x dag banded"]))
    p = D.plan(fwd)
    assert p.ring and p.widest <= D.RING_MAX_CELLS
    inp_w, wide = records(p)
    inp_r, ring = records(p, ring_waves, monkeypatch)
    fw = {k: v.numpy() for k, v in wide.fields().items()}
    fr = {k: v.numpy() for k, v in ring.fields().items()}
    wave_of = np.repeat(np.arange(len(p.wave) - 1), np.diff(p.wave))
    rank = np.arange(len(p.cells)) - p.wave[wave_of]
    assert (fr["slot"] == (wave_of % ring_waves) * p.widest + rank).all()
    cell_at = {int(pos): c for c, pos in enumerate(fr["pos"])}
    reader = np.repeat(np.arange(len(p.cells)), fr["ends"][:, 4])
    in_ring = fr["loc"] <= -2
    assert in_ring.any() and ((fr["loc"] >= 0) == (fw["loc"] >= 0) & ~in_ring).all()
    assert (fr["loc"][~in_ring] == fw["loc"][~in_ring]).all()
    for t in np.flatnonzero(fw["loc"] >= 0):
        src, w = cell_at[int(fw["loc"][t])], wave_of[reader[t]]
        back = w - wave_of[src]
        assert back >= 1
        if back < ring_waves:
            assert fr["loc"][t] == -2 - fr["slot"][src]
            later = (wave_of > wave_of[src]) & (wave_of <= w)
            assert not (fr["slot"][later] == fr["slot"][src]).any()
        else:
            assert fr["loc"][t] == fw["loc"][t]
    if ring_waves == 2:
        assert (fr["loc"] >= 0).any()  # the band path is met too
    for k in ("kind", "lpa", "lpb"):
        assert (fr[k] == fw[k]).all()
    got = D.dag_fill_band_plain(inp_r, ring)
    assert torch.equal(got, D.dag_fill_band_plain(inp_w, wide))
    nx, ny = fwd.x_size - 1, fwd.y_size - 1
    assert_cells_close(got.numpy(), fwd.cells[:nx, :ny].reshape(-1, 5)[p.layout.flat_index()])


def test_plan_host_parts(cpu64, monkeypatch):
    """The plan's host parts: fill.cpp's levels (`state_levels`) equal the
    Python loop's; each row's hull from the envelope's factored form equals
    the mask's scan, banded and not; the absorb the plan computes is the
    DPMatrix's to round-off; the plan times its parts."""
    for name in ("dag x dag banded", "dag x dag", "posterior x dag"):
        fwd = PortHostForwardMatrix(*merge(PORT, *CASES[name]))
        nx, ny = fwd.x_size - 1, fwd.y_size - 1
        for (ptr, src, _), n in ((D._csr(fwd.x, nx), nx), (D._csr(fwd.y, ny), ny)):
            native = D.levels(ptr, src, n)
            monkeypatch.setattr(D, "get_native", lambda: None)
            assert (D.levels(ptr, src, n) == native).all()
            monkeypatch.undo()
        lo, hi = D.envelope_hull(fwd, nx, ny)
        want = D.mask_hull(fwd.env_mask[:nx, :ny])
        assert (lo == want[0]).all() and (hi == want[1]).all()
        p = D.plan(fwd)
        assert set(p.host_ms) == {"csr", "levels", "hull", "cells", "order", "flags"}
        inp = D.upload_band(p, torch.device("cpu"))
        ci, cj = inp.cells[:, 0].long(), inp.cells[:, 1].long()
        got = D.absorb_plain(inp, ci, cj).numpy()
        want = fwd.absorb[ci.numpy(), cj.numpy()]
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        live = np.isfinite(want)
        np.testing.assert_allclose(got[live], want[live], rtol=1e-14, atol=1e-14)
    order = D.wavefront_order(np.array([3, 1, 3, 0, 1]))
    assert order.tolist() == [3, 1, 4, 0, 2]
    assert D.wavefront_order(np.array([2**16, 5, 2**16, 5])).tolist() == [1, 3, 0, 2]


def test_kernel_entries_refuse_other_devices(cpu64):
    """The plan and the fill take the plain version for CPU tensors only:
    on a device with no kernel (here "meta") both raise, nothing falls
    back."""
    fwd = PortHostForwardMatrix(*merge(PORT, *CASES["dag x chain"]))
    inp = D.upload_band(D.plan(fwd), torch.device("meta"))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        D.plan_records(inp)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        D.dag_fill_band(inp)


def test_forced_route_fills_on_kernel_a(cpu64, monkeypatch):
    """With the threshold at 0 on the CPU, a merge of a sampled x takes
    route "dag" (the plain version), and gives the host route's lp_end,
    cells and sampled profile; the default leaves it on the host."""
    args = merge(PORT, *CASES["dag x dag"])
    fills = dict(F.FILLS)
    host = F.ForwardMatrix(*args, defer_cells=True)
    assert host.route == "host"
    monkeypatch.setitem(F.DAG_DEVICE_MIN_CELLS, "cpu", 0)
    dev = F.ForwardMatrix(*args, defer_cells=True)
    assert dev.route == "dag" and dev._trace_handle is None
    assert F.FILLS == dict(fills, host=fills["host"] + 1, dag=fills["dag"] + 1)
    assert dev.lp_end == pytest.approx(host.lp_end, rel=1e-12)
    assert_cells_close(dev.cells, host.cells)
    out = []
    for fwd in (host, dev):
        gen = PORT.rng.MT19937(31)
        out.append((fwd.sample_profile(gen, 10, 0, F.COLLAPSE_CHAINS | F.INCLUDE_BEST_TRACE)
                    .to_json(), gen.next_u32()))
    assert out[1] == out[0]


def test_dag_merge_that_does_not_fit_fills_on_the_host(cpu64, monkeypatch):
    """A merge of a sampled x whose band does not fit the device
    (`devicedp.merge_fits`) takes route "oversized" on fill.cpp, as a
    chain-x merge does, with the host route's cells."""
    from historian_tpu_torch.ops import devicedp

    args = merge(PORT, *CASES["dag x chain"])
    host = PortHostForwardMatrix(*args)
    monkeypatch.setitem(F.DAG_DEVICE_MIN_CELLS, "cpu", 0)
    monkeypatch.setattr(devicedp, "_fits_bytes", lambda device, need: False)
    fills = dict(F.FILLS)
    fwd = F.ForwardMatrix(*args, defer_cells=True)
    assert fwd.route == "oversized"
    assert F.FILLS == dict(fills, oversized=fills["oversized"] + 1)
    assert np.array_equal(fwd.cells, host.cells, equal_nan=True)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's host route on small6 and small4: {name: (args, stdout)}."""
    d = tmp_path_factory.mktemp("dag")
    fa4, nh4 = write_small4(d)
    inputs = {"small6": [write_small6(d)], "small4": ["-tree", nh4, fa4]}
    env = dict(JAX_PLATFORMS="cpu", HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="0")
    return {name: (args, _run("historian_tpu", args, env)) for name, args in inputs.items()}


@pytest.mark.parametrize("name", ["small6", "small4"])
def test_recon_on_kernel_a_matches_jax(cpu64, monkeypatch, jax_runs, name):
    """Default `recon -platform cpu` in the port with every merge of a
    sampled x on kernel (a)'s plain version: rows byte-identical to the JAX
    package's host route and `#=GF LP` within 1e-6."""
    from historian_tpu_torch import cli, recon

    args, ref = jax_runs[name]
    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    monkeypatch.setitem(F.DAG_DEVICE_MIN_CELLS, "cpu", 0)
    merges = dict(recon.MERGES)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", *args]) == 0
    assert recon.MERGES["dag"] > merges["dag"] and recon.MERGES["host"] == merges["host"]
    rows, lp = rows_and_lp(out.getvalue())
    ref_rows, ref_lp = rows_and_lp(ref)
    assert rows == ref_rows
    assert abs(lp - ref_lp) < 1e-6
