"""The port's `#=GF LP` rescore (historian_tpu_torch/engine/treealign.py,
Felsenstein up-pass in PyTorch) against the JAX package's
engine/treealign.py::log_likelihood, float64 on the CPU, to 1e-9."""

import numpy as np
import pytest

from historian_tpu.core.seqs import FastSeq
from historian_tpu.core.tree import Tree
from historian_tpu.engine import treealign as jax_treealign
from historian_tpu.models.presets import named_model
from historian_tpu_torch import device
from historian_tpu_torch.engine import treealign

TREES = [
    "((t1:0.12,t2:0.12):0.1,(t3:0.12,t4:0.12):0.1)root;",
    "(((a:0.3,b:0.05):0.2,c:0.7):0.1,(d:0.01,e:0.4):0.25)r;",
]


def _history(newick, model, L, seed):
    """Random gapped rows for every node: residues (or the odd wildcard)
    at leaves, '*' at ancestors, gaps anywhere; the root is gap-free so
    no column is empty."""
    rng = np.random.default_rng(seed)
    tree = Tree(newick)
    syms = np.array(list(model.alphabet.symbols))
    rows = []
    for n in range(tree.n_nodes()):
        if tree.is_leaf(n):
            row = syms[rng.integers(0, len(syms), L)].astype(object)
            row[rng.random(L) < 0.02] = "x"
        else:
            row = np.full(L, "*", dtype=object)
        if n != tree.root():
            row[rng.random(L) < 0.2] = "-"
        rows.append(FastSeq(name=tree.seq_name(n), seq="".join(row)))
    return tree, rows


@pytest.mark.parametrize("newick", TREES)
@pytest.mark.parametrize("preset", ["lg", "jc"])
def test_rescore_matches_jax(newick, preset):
    device.select("cpu")
    model = named_model(preset)
    tree, rows = _history(newick, model, 150, 7)
    got = treealign.log_likelihood(model, tree, rows)
    ref = jax_treealign.log_likelihood(model, tree, rows)
    assert np.isfinite(got)
    assert abs(got - ref) < 1e-9 * max(1.0, abs(ref))
