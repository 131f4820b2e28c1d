"""The port's guide stage aligner (historian_tpu_torch/engine/quickalign.py
through ops/guidedp.py, on the CPU: the torch fill plus the host walk)
against the JAX package's QuickAligner on the CPU, float64, preset lg.

Inputs: 6 pairs cut from tests/data/long8.fa (200-400 aa, unequal
lengths) with sparse k-mer envelopes (`-kmatchn 3`) and with full
envelopes, and the trivial and short pairs of tests/test_guidedp.py.
- Against the JAX device route (`guide_align_device`): step codes, end
  cell, lead cell and end score identical.
- Against the JAX host route (`_align_batch_host_backend`, `_finish`,
  `align_path`), which `recon` takes on the CPU: end score bits and
  alignment path identical."""

import os

import numpy as np
import pytest

from historian_tpu.core.seqs import FastSeq, read_fasta
from historian_tpu.engine.diagenv import DiagEnvParams, DiagonalEnvelope
from historian_tpu.engine.quickalign import QuickAligner as JaxAligner
from historian_tpu.models.presets import named_model
from historian_tpu_torch import device as devmod
from historian_tpu_torch.engine.quickalign import QuickAligner

DATA = os.path.join(os.path.dirname(__file__), "data")
CUTS = (200, 260, 310, 400, 230, 350, 280, 330)
PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (1, 4), (3, 6))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    devmod.select("cpu")


def long8_jobs(model, sparse: bool):
    seqs = read_fasta(os.path.join(DATA, "long8.fa"))
    for s, n in zip(seqs, CUTS):
        s.seq = s.seq[:n]
    jobs = []
    for a, b in PAIRS:
        x, y = seqs[a], seqs[b]
        env = DiagonalEnvelope(len(x.seq), len(y.seq))
        if sparse:
            env.init_sparse(model.alphabet.tokenize(x.seq), model.alphabet.tokenize(y.seq),
                            model.alphabet_size, DiagEnvParams(kmer_threshold=3))
        else:
            env.init_full()
        jobs.append((x, y, env))
    return jobs


def short_jobs():
    jobs = []
    for xs, ys in (("", "ACDEF"), ("ACD", ""), ("A", "A"), ("ACDEFG", "ACDEG")):
        env = DiagonalEnvelope(len(xs), len(ys)).init_full()
        jobs.append((FastSeq(name="x", seq=xs), FastSeq(name="y", seq=ys), env))
    return jobs


def _cases():
    model = named_model("lg")
    return {
        "sparse": (model, 1.0, long8_jobs(model, True)),
        "full": (model, 1.0, long8_jobs(model, False)),
        "short": (model, 0.5, short_jobs()),
    }


@pytest.mark.parametrize("case", ["sparse", "full", "short"])
def test_guide_matches_jax_device_route(case):
    model, t, jobs = _cases()[case]
    if case == "sparse":  # the k-mer envelopes really are sparse
        assert all(len(e.diagonals) < len(x.seq) + len(y.seq) - 1 for x, y, e in jobs)
    ref = JaxAligner(model, t)._align_batch_device(jobs)
    got = QuickAligner(model, t).align_batch(jobs)
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g.trivial == r.trivial, k
        assert g.end == r.end, (k, g.end, r.end)
        assert (g.x_end, g.y_end) == (r.x_end, r.y_end), k
        if not r.trivial:
            np.testing.assert_array_equal(g._steps, r._steps)
            assert g._lead == r._lead, k


def test_pair_guide_tensors_matches_jax_device_route():
    """`pair_guide_tensors`, the inputs chip_smoke.py hands the guide
    kernel, build the sparse pairs' arguments as `align_batch` does."""
    import torch

    from historian_tpu_torch.engine.quickalign import pair_guide_tensors
    from historian_tpu_torch.ops.guidedp import guide_align

    model, t, jobs = _cases()["sparse"]
    ref = JaxAligner(model, t)._align_batch_device(jobs)
    args = pair_guide_tensors([(x.seq, y.seq) for x, y, _ in jobs], "lg", 3, t,
                              torch.device("cpu"), torch.float64)
    kept = args["lut"].sum(1).tolist()
    assert kept == [len(e.diagonals) for _, _, e in jobs]
    steps, n_steps, x_end, y_end, lead_i, lead_j, score = guide_align(
        *(args[k] for k in ("x_tok", "y_tok", "lut", "x_len", "y_len", "submat", "trans",
                            "sg", "end_x", "end_y")))
    for k, r in enumerate(ref):
        assert float(score[k]) == r.end, k
        assert (int(x_end[k]), int(y_end[k])) == (r.x_end, r.y_end), k
        np.testing.assert_array_equal(steps[k, : n_steps[k]].numpy(), r._steps)
        assert (int(lead_i[k]), int(lead_j[k])) == r._lead, k


@pytest.mark.parametrize("case", ["sparse", "full", "short"])
def test_guide_matches_jax_host_route(case):
    model, t, jobs = _cases()[case]
    ref = JaxAligner(model, t)._align_batch_host_backend(jobs, serial=True)
    got = QuickAligner(model, t).align_batch(jobs)
    for k, (r, g) in enumerate(zip(ref, got)):
        assert np.float64(g.end).tobytes() == np.float64(r.end).tobytes(), (k, g.end, r.end)
        hp, gp = r.align_path(0, 1), g.align_path(0, 1)
        assert set(hp) == set(gp)
        for row in hp:
            np.testing.assert_array_equal(gp[row], hp[row])
