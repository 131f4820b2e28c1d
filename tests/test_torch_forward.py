"""TorchForwardMatrix (the port's merge fill) against the JAX package's
host ForwardMatrix (HISTORIAN_DEVICE_DP=0) in float64: cells and lp_end
to 1e-9, and the same best trace, best alignment path and best profile,
as tests/test_tracedp.py holds the JAX device route to the host."""

import os

import numpy as np
import pytest

from historian_tpu.core.seqs import read_fasta
from historian_tpu.engine.forward import ForwardMatrix
from historian_tpu.engine.pairhmm import PairHMM
from historian_tpu.engine.profile import Profile
from historian_tpu.models.presets import named_model
from historian_tpu.models.ratemodel import ProbModel
from historian_tpu.utils.rng import MT19937
from historian_tpu_torch import device
from historian_tpu_torch.engine.forward import TorchForwardMatrix


@pytest.fixture
def cpu64(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")


def _leaves(n, cut):
    """The first n sequences of long8 cut to `cut` aa; the second loses
    two short stretches, so that sampled traces disagree on the gaps."""
    model = named_model("lg")
    seqs = read_fasta(os.path.join(os.path.dirname(__file__), "data", "long8.fa"))[:n]
    for s in seqs:
        s.seq = s.seq[:cut]
    seqs[1].seq = seqs[1].seq[:cut // 3] + seqs[1].seq[cut // 3 + 6: 3 * cut // 4] \
        + seqs[1].seq[3 * cut // 4 + 3:]
    profs = [Profile.from_sequence(model.components, model.alphabet, s, i)
             for i, s in enumerate(seqs)]
    return model, profs


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


def test_leaf_pair_300aa(cpu64):
    model, (x, y) = _leaves(2, 300)
    hmm = PairHMM(ProbModel(model, 0.12), ProbModel(model, 0.12), model.ins_prob)
    host = ForwardMatrix(x, y, hmm, 2)
    port = TorchForwardMatrix(x, y, hmm, 2, defer_cells=True)
    assert port._trace_handle is not None and host._trace_handle is None
    _assert_same_merge(host, port)


def test_chain_x_against_sampled_dag_y(cpu64):
    """y a sampled-profile DAG (nulls, forks): the gathers of K1 and the
    y-move rows of the walker with KY > 1."""
    model, (a, b, c) = _leaves(3, 120)
    hmm = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.2), model.ins_prob)
    y = ForwardMatrix(a, b, hmm, 3).sample_profile(MT19937(5489), 10, 0)
    assert y.as_chain() is None
    hmm2 = PairHMM(ProbModel(model, 0.25), ProbModel(model, 0.15), model.ins_prob)
    host = ForwardMatrix(c, y, hmm2, 4)
    port = TorchForwardMatrix(c, y, hmm2, 4, defer_cells=True)
    _assert_same_merge(host, port)


def test_non_chain_x_is_not_ported(cpu64):
    model, (a, b, c) = _leaves(3, 60)
    hmm = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.2), model.ins_prob)
    dag = ForwardMatrix(a, b, hmm, 3).sample_profile(MT19937(7), 10, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchForwardMatrix(dag, c, hmm, 4, defer_cells=True)


def test_empty_x_takes_the_host_fill(cpu64):
    """An empty x profile has no grid for K1: like the JAX device route,
    the merge runs the host fill (without touching the JAX router)."""
    from historian_tpu.core.seqs import FastSeq

    model, (_, y) = _leaves(2, 50)
    x = Profile.from_sequence(model.components, model.alphabet, FastSeq(name="e", seq=""), 0)
    hmm = PairHMM(ProbModel(model, 0.2), ProbModel(model, 0.2), model.ins_prob)
    host = ForwardMatrix(x, y, hmm, 2)
    port = TorchForwardMatrix(x, y, hmm, 2, defer_cells=True)
    assert port._trace_handle is None and port.x_empty
    assert abs(port.lp_end - host.lp_end) < 1e-9
    assert port.best_trace() == host.best_trace()


def test_sampled_walks_are_host_paths(cpu64):
    """Sampled traces (uniforms from a torch.Generator seeded by one
    mt19937 draw) are valid paths of the host DP: every step a candidate
    of the host's traceback, every visited value the host cell."""
    model, (x, y) = _leaves(2, 120)
    hmm = PairHMM(ProbModel(model, 0.5), ProbModel(model, 0.5), model.ins_prob)
    host = ForwardMatrix(x, y, hmm, 2)
    port = TorchForwardMatrix(x, y, hmm, 2, defer_cells=True)
    paths = port._device_traces(6, False, MT19937(17))
    assert len(paths) == 6 and len({tuple(p) for p in paths}) > 1
    for path in paths:
        assert path[0][:2] == (0, 0) and path[-1] == port.end_cell
        for a, b in zip(path[:-1], path[1:]):
            assert a in host.source_transitions_without_emit_or_absorb(b), (a, b)
        for c in path[:-1]:
            assert port._trace_values[c] == pytest.approx(float(host.cells[c]), rel=1e-9)
    prof = port.sample_profile(MT19937(5489), 10, 0)
    prof.assert_transitions_consistent()
    prof.assert_path_to_end_exists()
