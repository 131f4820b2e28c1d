"""The port's BackwardMatrix (historian_tpu_torch/engine/forward.py)
against the JAX package's, each built from its own package's classes on
the same inputs in float64, the JAX package on its host route
(HISTORIAN_DEVICE_DP=0): lp_start and the cells to 1e-9, the cells above
a posterior cut (the native `postprob_select`) equal, the posterior and
best profiles as identical profile strings, and the expected counts
(`get_counts`, with the sum-product token fills) to 1e-9.

Each case is the root merge of a small tree over the first sequences of
tests/data/long8.fa cut to 90 aa (the second with two short deletions):
a chain x against a chain y (two leaves), a chain x against a DAG y (a
leaf against a sampled profile) and a DAG x against a DAG y (two
sampled profiles), unbanded and banded around a guide that aligns the
sequences from their first residue.  The port fills a chain x on its
full-band device route (the planes' plain version on the CPU, the band
read back) and a DAG x on the host (csrc/fill.cpp)."""

import os

import numpy as np
import pytest

from historian_tpu_torch import device
from tests.torch_twins import DATA, JAX, PORT, host_forward, pair_hmm

F = PORT.forward
#: the profile strategy of a counting recon: the children carry their counts
STRATEGY = F.COLLAPSE_CHAINS | F.COUNT_SUBST_EVENTS | F.COUNT_INDEL_EVENTS | F.INCLUDE_BEST_TRACE
TREES = {
    "chain x chain": "(t0:0.12,t1:0.2)r;",
    "chain x dag": "(t2:0.15,(t0:0.3,t1:0.2)n:0.25)r;",
    "dag x dag": "((t0:0.3,t1:0.2)n:0.25,(t2:0.1,t3:0.2)m:0.15)r;",
}
CUT = 90
#: the envelope's band around the guide, in matched columns
BAND = 8
MIN_POST = 0.01


@pytest.fixture
def cpu64(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")


def _seqs(pkg):
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long8.fa"))[:4]
    for s in seqs:
        s.seq = s.seq[:CUT]
    s = seqs[1].seq
    seqs[1].seq = s[:CUT // 3] + s[CUT // 3 + 4: 3 * CUT // 4] + s[3 * CUT // 4 + 2:]
    return {f"t{k}": s for k, s in enumerate(seqs)}


def root_merge(pkg, kind: str, banded: bool, defer_cells: bool = False, counts: bool = True):
    """The root merge of TREES[kind] in `pkg`: (ForwardMatrix, model, tree).
    Each child that is not a leaf is a sampled profile of its two leaves
    (10 traces and the best, mt19937 seed 5489, counts kept), filled on the
    host.  The root merge takes the package's own route (the port's
    `defer_cells` as given; the JAX package's host fill), with the
    sum-product engine when `counts`."""
    tree = pkg.tree.Tree(TREES[kind])
    model = pkg.presets.named_model("lg")
    sumprod = pkg.sumprod.SumProductEngine(model, tree)
    seqs = _seqs(pkg)
    prof = {}
    for node in range(tree.n_nodes()):
        if tree.is_leaf(node):
            prof[node] = pkg.profile.Profile.from_sequence(
                model.components, model.alphabet, seqs[tree.node_name(node)], node)
        elif node != tree.root():
            l, r = tree.children(node)
            hmm = pair_hmm(pkg, model, tree.branch_length(l), tree.branch_length(r))
            child = host_forward(pkg, prof[l], prof[r], hmm, node, None, sumprod)
            prof[node] = child.sample_profile(pkg.rng.MT19937(5489), 10, 0, STRATEGY)
    l, r = tree.children(tree.root())
    env = None
    if banded:
        width = max(len(s.seq) for s in seqs.values())
        guide = {n: np.arange(width) < len(seqs[tree.node_name(n)].seq)
                 for n in range(tree.n_nodes()) if tree.is_leaf(n)}
        leaf = {n: n if tree.is_leaf(n) else tree.children(n)[0] for n in (l, r)}
        env = pkg.alignpath.GuideAlignmentEnvelope(guide, leaf[l], leaf[r], BAND)
    hmm = pair_hmm(pkg, model, tree.branch_length(l), tree.branch_length(r))
    kw = {"defer_cells": defer_cells} if pkg is PORT else {}
    fwd = pkg.forward.ForwardMatrix(prof[l], prof[r], hmm, tree.root(), env,
                                    sumprod if counts else None, **kw)
    assert fwd.lp_end > -np.inf
    return fwd, model, tree


def assert_cells_close(got, want):
    """Two grids of log values: the same cells -inf, the others to 1e-9."""
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-9, atol=1e-9)


def assert_counts_close(got, want):
    np.testing.assert_allclose(got.root_count, want.root_count, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.eigen_count, want.eigen_count, rtol=1e-9, atol=1e-12)
    for k in ("ins", "del_", "ins_ext", "del_ext", "ins_time", "del_time", "lp"):
        assert getattr(got.indel, k) == pytest.approx(getattr(want.indel, k), rel=1e-9, abs=1e-12)


CASES = [(kind, banded) for kind in TREES for banded in (False, True)]


@pytest.mark.parametrize("kind,banded", CASES)
def test_backward_matches_jax(cpu64, kind, banded):
    ref_fwd = root_merge(JAX, kind, banded)[0]
    fwd = root_merge(PORT, kind, banded)[0]
    assert fwd.route == ("host" if kind == "dag x dag" else "fullband")
    assert fwd.x.to_json() == ref_fwd.x.to_json() and fwd.y.to_json() == ref_fwd.y.to_json()
    assert fwd.lp_end == pytest.approx(ref_fwd.lp_end, rel=1e-12)
    ref, got = JAX.forward.BackwardMatrix(ref_fwd), F.BackwardMatrix(fwd)
    assert got.lp_start == pytest.approx(ref.lp_start, rel=1e-12)
    assert got.lp_start == pytest.approx(fwd.lp_end, rel=1e-9)
    assert_cells_close(got.cells, ref.cells)

    # [(log posterior, cell)], the best first: the same cells with the same
    # posteriors (ties within rounding, such as the start and end cells at
    # log posterior 0, may come in another order)
    cut = dict((c, p) for p, c in got.cells_above_post_prob_threshold(MIN_POST))
    ref_cut = dict((c, p) for p, c in ref.cells_above_post_prob_threshold(MIN_POST))
    assert len(cut) > fwd.x_size and sorted(cut) == sorted(ref_cut)
    np.testing.assert_allclose([cut[c] for c in sorted(cut)], [ref_cut[c] for c in sorted(cut)],
                               rtol=0, atol=1e-9)
    for strategy in (F.COLLAPSE_CHAINS | F.INCLUDE_BEST_TRACE, STRATEGY | F.KEEP_GAPS_OPEN):
        assert (got.post_prob_profile(MIN_POST, 0, strategy).to_json()
                == ref.post_prob_profile(MIN_POST, 0, strategy).to_json())
        assert got.best_profile(strategy).to_json() == ref.best_profile(strategy).to_json()
    # a cell budget: the best traces of the cells above the cut, in order,
    # until the budget is met
    budget = fwd.x_size + fwd.y_size
    assert (got.post_prob_profile(MIN_POST, budget, STRATEGY).to_json()
            == ref.post_prob_profile(MIN_POST, budget, STRATEGY).to_json())

    counts = got.get_counts()
    assert counts.indel.ins > 0 and counts.root_count.sum() > 0
    assert_counts_close(counts, ref.get_counts())


def test_backward_of_a_resident_fill(cpu64):
    """A resident chain-x fill (`defer_cells`) reads its band back when a
    BackwardMatrix wants it (`ensure_cells`): the same Backward cells."""
    fwd = root_merge(PORT, "chain x dag", True, defer_cells=True, counts=False)[0]
    assert fwd.route == "device" and fwd.cells is None
    full = root_merge(PORT, "chain x dag", True, counts=False)[0]
    assert full.route == "fullband"
    assert_cells_close(F.BackwardMatrix(fwd).cells, F.BackwardMatrix(full).cells)
    assert_cells_close(fwd.cells, full.cells)
