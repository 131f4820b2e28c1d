"""The port's ForwardMatrix (its merge fill on the device route) against
the JAX package's host ForwardMatrix (HISTORIAN_DEVICE_DP=0) in float64,
each built from its own package's classes on the same inputs: cells and
lp_end to 1e-9, and the same best trace, best alignment path and best
profile, as tests/test_tracedp.py holds the JAX device route to the
host."""

import numpy as np
import pytest

from historian_tpu_torch import device
from tests.torch_twins import JAX, PORT, host_forward, leaves, pair_hmm


@pytest.fixture
def cpu64(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")


def _assert_same_merge(host, port):
    assert abs(port.lp_end - host.lp_end) < 1e-9
    port.ensure_cells()
    hc = np.where(np.isfinite(host.cells), host.cells, -1e99)
    pc = np.where(np.isfinite(port.cells), port.cells, -1e99)
    np.testing.assert_allclose(pc, hc, rtol=1e-9, atol=1e-9)
    assert port._device_best_path() == host.best_trace()
    hp, pp = host.best_align_path(), port.best_align_path()
    assert set(hp) == set(pp)
    for row in hp:
        np.testing.assert_array_equal(np.asarray(pp[row]), np.asarray(hp[row]))
    hprof, pprof = host.best_profile(), port.best_profile()
    assert hprof.size == pprof.size
    assert [t.lp for t in pprof.trans] == pytest.approx([t.lp for t in hprof.trans], rel=1e-9)
    assert [st.name for st in pprof.states] == [st.name for st in hprof.states]


def _merge(pkg, n, cut, times):
    """(x, y, hmm) of `pkg` for a merge of two leaves of long8."""
    model, profs = leaves(pkg, n, cut)
    return profs[0], profs[1], pair_hmm(pkg, model, *times)


def test_leaf_pair_300aa(cpu64):
    x, y, hmm = _merge(JAX, 2, 300, (0.12, 0.12))
    host = JAX.forward.ForwardMatrix(x, y, hmm, 2)
    x, y, hmm = _merge(PORT, 2, 300, (0.12, 0.12))
    port = PORT.forward.ForwardMatrix(x, y, hmm, 2, defer_cells=True)
    assert port._trace_handle is not None and host._trace_handle is None
    _assert_same_merge(host, port)


def _sampled_dag_merge(pkg):
    """A chain leaf x against a sampled-profile DAG y, built by `pkg`'s
    host fill and its mt19937 sampler."""
    model, (a, b, c) = leaves(pkg, 3, 120)
    y = host_forward(pkg, a, b, pair_hmm(pkg, model, 0.3, 0.2), 3).sample_profile(
        pkg.rng.MT19937(5489), 10, 0)
    assert y.as_chain() is None
    return c, y, pair_hmm(pkg, model, 0.25, 0.15)


def test_chain_x_against_sampled_dag_y(cpu64):
    """y a sampled-profile DAG (nulls, forks): the gathers of K1 and the
    y-move rows of the walker with KY > 1."""
    host = JAX.forward.ForwardMatrix(*_sampled_dag_merge(JAX), 4)
    port = PORT.forward.ForwardMatrix(*_sampled_dag_merge(PORT), 4, defer_cells=True)
    assert port.y.to_json() == host.y.to_json()
    _assert_same_merge(host, port)


def test_non_chain_x_is_not_ported(cpu64):
    """A non-chain x (a sampled profile) is not a merge for the device
    route: like the JAX package's default, it fills on the host
    (csrc/fill.cpp), counted there, and walks its traces there."""
    model, (a, b, c) = leaves(PORT, 3, 60)
    hmm = pair_hmm(PORT, model, 0.3, 0.2)
    dag = host_forward(PORT, a, b, hmm, 3).sample_profile(PORT.rng.MT19937(7), 10, 0)
    assert dag.as_chain() is None
    fills = dict(PORT.forward.FILLS)
    fwd = PORT.forward.ForwardMatrix(dag, c, hmm, 4, defer_cells=True)
    assert fwd._trace_handle is None and fwd.cells is not None
    assert PORT.forward.FILLS == dict(fills, host=fills["host"] + 1)
    assert fwd.lp_end > -np.inf
    path = fwd.best_trace()
    assert path[0] == fwd.start_cell and path[-1] == fwd.end_cell


def test_empty_x_takes_the_host_fill(cpu64):
    """An empty x profile has no grid for K1: like the JAX device route,
    the merge runs the host fill (without touching the JAX router)."""
    fills = []
    for pkg in (JAX, PORT):
        model, (_, y) = leaves(pkg, 2, 50)
        x = pkg.profile.Profile.from_sequence(
            model.components, model.alphabet, pkg.seqs.FastSeq(name="e", seq=""), 0)
        kw = {"defer_cells": True} if pkg is PORT else {}
        fills.append(pkg.forward.ForwardMatrix(x, y, pair_hmm(pkg, model, 0.2, 0.2), 2, **kw))
    host, port = fills
    assert port._trace_handle is None and port.x_empty
    assert abs(port.lp_end - host.lp_end) < 1e-9
    assert port.best_trace() == host.best_trace()


def test_sampled_walks_are_host_paths(cpu64):
    """Sampled traces (the generator's next uniforms, in order) are valid
    paths of the host DP: every step a candidate of the host's traceback,
    every visited value the host cell."""
    x, y, hmm = _merge(JAX, 2, 120, (0.5, 0.5))
    host = JAX.forward.ForwardMatrix(x, y, hmm, 2)
    x, y, hmm = _merge(PORT, 2, 120, (0.5, 0.5))
    port = PORT.forward.ForwardMatrix(x, y, hmm, 2, defer_cells=True)
    paths = port._device_traces(6, False, PORT.rng.MT19937(17))
    assert len(paths) == 6 and len({tuple(p) for p in paths}) > 1
    for path in paths:
        assert path[0][:2] == (0, 0) and path[-1] == port.end_cell
        for a, b in zip(path[:-1], path[1:]):
            assert a in host.source_transitions_without_emit_or_absorb(b), (a, b)
        for c in path[:-1]:
            assert port._trace_values[c] == pytest.approx(float(host.cells[c]), rel=1e-9)
    prof = port.sample_profile(PORT.rng.MT19937(5489), 10, 0)
    prof.assert_transitions_consistent()
    prof.assert_path_to_end_exists()
