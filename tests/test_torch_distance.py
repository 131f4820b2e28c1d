"""The port's distance matrix and trees (historian_tpu_torch/ops/distance.py)
against the JAX package's `RateModel.distance_matrix` (which runs
historian_tpu/ops/distance.py::batched_ml_distances) on small6's guide
alignment, preset lg, CPU float64, and the UPGMA and neighbour-joining
Newick strings built from them, which must be identical.

- Jukes-Cantor (`-jc`, which `-fast` takes): host arithmetic in both,
  within rtol 1e-12.
- ML (100 iterations): within rtol 1e-6.  Both run the same grid and
  40 lockstep golden-section steps, but the NLL einsums sum in another
  order in torch than in XLA.  Once the bracket is ~1e-8 wide the two
  NLLs it compares differ by less than their rounding (~1e-13 of
  ~1e3), so the last steps of the two searches may choose differently:
  the distances agree to ~1e-7 relative, not to the last bit.
- Two sequences take the host per-pair path in both: identical.

The guide rows come from the port's guide graph; each package computes
on its own model and sequence objects."""

import numpy as np
import pytest
import torch

from historian_tpu_torch import device as devmod
from historian_tpu_torch.engine.span import AlignGraph
from historian_tpu_torch.ops.distance import distance_matrix
from tests.test_torch_span import small6
from tests.torch_twins import JAX, PORT


@pytest.fixture(scope="module")
def guide():
    """(JAX model, port model, JAX rows, port rows) of small6's guide."""
    devmod.select("cpu")
    model = PORT.presets.named_model("lg")
    graph = AlignGraph(small6(), model, 1.0, PORT.diagenv.DiagEnvParams(kmer_threshold=3),
                       rng=PORT.rng.MT19937(5489))
    gapped = graph.mst_gapped()
    jax_rows = [JAX.seqs.FastSeq(name=s.name, seq=s.seq) for s in gapped]
    return JAX.presets.named_model("lg"), model, jax_rows, gapped


@pytest.mark.parametrize("iterations,rtol", [(0, 1e-12), (100, 1e-6)], ids=["jc", "ml"])
def test_distances_and_trees_match_jax(guide, iterations, rtol):
    jax_model, model, jax_rows, gapped = guide
    ref = jax_model.distance_matrix(jax_rows, iterations)
    got = distance_matrix(model, gapped, iterations, torch.device("cpu"))
    assert got.shape == (6, 6) and (got[np.triu_indices(6, 1)] > 0).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    names = [s.name for s in gapped]
    for build in ("upgma", "neighbor_joining"):
        assert (getattr(PORT.tree.Tree, build)(names, got).to_string()
                == getattr(JAX.tree.Tree, build)(names, ref).to_string())


def test_two_sequences_take_the_host_path(guide):
    jax_model, model, jax_rows, gapped = guide
    for iterations in (0, 100):
        ref = jax_model.distance_matrix(jax_rows[:2], iterations)
        got = distance_matrix(model, gapped[:2], iterations, torch.device("cpu"))
        np.testing.assert_array_equal(got, ref)
