"""The port's guide graph (historian_tpu_torch/engine/span.py AlignGraph)
against the JAX package's on small6 (the 6 sequences of
tests/data/long6.fa cut to 240-340 aa), preset lg, the `-fast` envelope
(`-kmatchn 3`), CPU float64: the random sparse edge set drawn from
MT19937(5489) (`-rndspan`) and the all-pairs one (`-allspan`).  The
merged guide rows must be identical."""

import os

import pytest

from historian_tpu.core.seqs import FastSeq, read_fasta
from historian_tpu.engine.diagenv import DiagEnvParams
from historian_tpu.engine.span import AlignGraph as JaxGraph
from historian_tpu.models.presets import named_model
from historian_tpu.utils.rng import MT19937
from historian_tpu_torch import device as devmod
from historian_tpu_torch.engine.span import AlignGraph

DATA = os.path.join(os.path.dirname(__file__), "data")
SMALL6_CUTS = (240, 260, 280, 300, 320, 340)


def small6() -> list[FastSeq]:
    """small6: the 6 sequences of tests/data/long6.fa cut to 240-340 aa."""
    seqs = read_fasta(os.path.join(DATA, "long6.fa"))
    return [FastSeq(name=s.name, seq=s.seq[:n]) for s, n in zip(seqs, SMALL6_CUTS)]


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
    model, seqs = named_model("lg"), small6()
    params = DiagEnvParams(kmer_threshold=3)
    ref = JaxGraph(seqs, model, 1.0, params, rng=MT19937(5489), dense=dense)
    got = AlignGraph(seqs, model, 1.0, params, rng=MT19937(5489), dense=dense)
    assert sorted(got.edge_path) == sorted(ref.edge_path)
    rows = [(s.name, s.seq) for s in got.mst_gapped()]
    assert rows == [(s.name, s.seq) for s in ref.mst_gapped()]
    assert len(rows) == 6 and any("-" in seq for _, seq in rows)
