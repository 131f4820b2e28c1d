"""The port's `-savedot` graph (historian_tpu_torch/engine/seqgraph.py)
against the JAX package's: from the same posterior and best profiles of
one merge (tests/test_torch_backward.py `root_merge`, float64 on the CPU)
each package's SeqGraph, simplified, gives identical dot text; and the
simplification passes on hand-made graphs give the same nodes."""

import numpy as np
import pytest

from tests.test_torch_backward import F, cpu64, root_merge  # noqa: F401
from tests.torch_twins import JAX, PORT


def _dot(pkg, prof, model, min_sub):
    with np.errstate(divide="ignore"):
        graph = pkg.seqgraph.SeqGraph.from_profile(
            prof, model.alphabet.symbols, np.log(model.cpt_weight), np.log(model.ins_prob),
            min_sub)
    return graph.simplify().to_dot()


@pytest.mark.parametrize("kind", ["chain x dag", "dag x dag"])
@pytest.mark.parametrize("posterior,gaps_open,min_sub", [
    (True, False, 0.01), (True, True, 0.05), (False, False, 0.0), (False, True, 0.2)])
def test_dot_matches_jax(cpu64, kind, posterior, gaps_open, min_sub):  # noqa: F811
    dots = []
    for pkg in (JAX, PORT):
        fwd, model, _ = root_merge(pkg, kind, True, counts=False)
        bwd = pkg.forward.BackwardMatrix(fwd)
        strategy = F.INCLUDE_BEST_TRACE | (F.KEEP_GAPS_OPEN if gaps_open else 0)
        prof = bwd.post_prob_profile(0.01, 0, strategy) if posterior else \
            bwd.best_profile(strategy)
        dots.append(_dot(pkg, prof, model, min_sub))
    assert dots[1] == dots[0]
    assert dots[1].startswith("digraph profile {") and "label" in dots[1]
    if posterior:  # a posterior profile forks; a best profile is one chain
        assert "->" in dots[1]


@pytest.mark.parametrize("seqs,edges", [
    (["", "A", "C", "G", ""], {(0, 1), (1, 2), (2, 3), (3, 4)}),
    (["S", "A", "C", "E"], {(0, 1), (0, 2), (1, 3), (2, 3)}),
    (["S", "A", "", "C", "A", "E"], {(0, 1), (0, 2), (2, 3), (1, 5), (3, 5), (0, 4), (4, 5)}),
])
def test_simplify_matches_jax(seqs, edges):
    out = []
    for pkg in (JAX, PORT):
        g = pkg.seqgraph.SeqGraph()
        g.nodes = [pkg.seqgraph._Node(seq=s) for s in seqs]
        g.edges = set(edges)
        g._build_indices()
        s = g.simplify()
        out.append(([n.seq for n in s.nodes], s.to_dot()))
    assert out[1] == out[0]
