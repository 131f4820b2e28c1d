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
must stay a no-op).  Then the route: forced onto kernel (a) on the CPU
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
    assert p.widest == np.diff(p.wave).max() and len(p.absorb) == len(p.cells)


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
