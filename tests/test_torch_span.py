"""The port's guide graph (historian_tpu_torch/engine/span.py AlignGraph)
against the JAX package's on small6 (the 6 sequences of
tests/data/long6.fa cut to 240-340 aa), preset lg, the `-fast` envelope
(`-kmatchn 3`), CPU float64: the random sparse edge set drawn from
MT19937(5489) (`-rndspan`) and the all-pairs one (`-allspan`).  The
merged guide rows must be identical.  Each package builds its graph
from its own classes."""

import os

import pytest

from historian_tpu.engine.span import AlignGraph as JaxGraph
from historian_tpu_torch import device as devmod
from historian_tpu_torch.engine.span import AlignGraph
from tests.torch_twins import DATA, JAX, PORT

SMALL6_CUTS = (240, 260, 280, 300, 320, 340)


def small6(pkg=PORT) -> list:
    """small6 as FastSeqs of `pkg`: the 6 sequences of tests/data/long6.fa
    cut to 240-340 aa."""
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long6.fa"))
    return [pkg.seqs.FastSeq(name=s.name, seq=s.seq[:n]) for s, n in zip(seqs, SMALL6_CUTS)]


def write_small6(d) -> str:
    path = os.path.join(d, "small6.fa")
    with open(path, "w") as f:
        for s in small6():
            f.write(f">{s.name}\n{s.seq}\n")
    return path


@pytest.mark.parametrize("dense", [False, True], ids=["rndspan", "allspan"])
def test_mst_rows_match_jax(monkeypatch, dense):
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    devmod.select("cpu")
    graphs = []
    for pkg, graph in ((JAX, JaxGraph), (PORT, AlignGraph)):
        graphs.append(graph(small6(pkg), pkg.presets.named_model("lg"), 1.0,
                            pkg.diagenv.DiagEnvParams(kmer_threshold=3),
                            rng=pkg.rng.MT19937(5489), dense=dense))
    ref, got = graphs
    assert sorted(got.edge_path) == sorted(ref.edge_path)
    rows = [(s.name, s.seq) for s in got.mst_gapped()]
    assert rows == [(s.name, s.seq) for s in ref.mst_gapped()]
    assert len(rows) == 6 and any("-" in seq for _, seq in rows)
