"""The guide kernel's rank space (historian_tpu_torch/ops/guidedp.py
`diagonal_ranks` and `_chunks`), on the CPU.

The CUDA guide kernel fills only the envelope's kept diagonals: lane r of
column j is the cell (j + d_r, j), and the traceback moves by rank (M
keeps r, I goes to r + 1, D to r - 1).  These tests hold the wrapper's
rank builder against the `lut` it reads, and show that every cell the JAX
package's guide traceback (`guide_align_device`, on the CPU) visits lies
on a kept diagonal inside its column's live range, so that the kernel's
back-pointers cover the walk: the sparse, full and short cases of
tests/test_torch_guidedp.py and two long12 pairs cut to 400 aa."""

import os

import numpy as np
import pytest
import torch

from historian_tpu.engine.quickalign import QuickAligner as JaxAligner
from historian_tpu_torch import convert
from historian_tpu_torch.engine.quickalign import QuickAligner, QuickAlignResult, \
    pair_guide_tensors
from historian_tpu_torch.ops import guidedp
from tests.test_torch_gpu import guide_args
from tests.test_torch_guidedp import _cases
from tests.torch_twins import DATA, JAX, PORT


def brute_ranks(lut, x_len, y_len, PY):
    """Per pair the kept diagonals and per column the live ranks, by
    enumerating the cells."""
    out = []
    for b in range(lut.shape[0]):
        X, Y = int(x_len[b]), int(y_len[b])
        d = [k - PY for k in np.nonzero(lut[b])[0] if 1 - Y <= k - PY <= X - 1]
        cols = {}
        for j in range(1, Y + 1):
            live = [r for r, dr in enumerate(d) if 1 <= j + dr <= X]
            assert live == list(range(live[0], live[-1] + 1)) if live else True
            cols[j] = (live[0], live[-1] + 1) if live else None
        out.append((d, cols))
    return out


LUT_CASES = {
    "random": [(40, 55), (61, 30), (1, 5), (7, 1), (50, 50)],
    "full": [(30, 45), (45, 30)],
    "single": [(20, 33), (33, 20)],
    "empty": [(12, 9), (4, 6)],
}


def _lut_case(name):
    a = guide_args(LUT_CASES[name], seed=11, full=name == "full")
    lut = a["lut"]
    PY = a["y_tok"].shape[1]
    if name == "single":  # one diagonal, d = 3
        lut[:] = False
        lut[:, 3 + PY] = True
    if name == "empty":  # kept diagonals only outside each grid
        lut[:] = False
        for b, (X, Y) in enumerate(LUT_CASES[name]):
            lut[b, X + PY] = True  # d = X: i = j + X > X
            lut[b, -Y + PY] = True  # d = -Y: i = j - Y < 1
    return a


@pytest.mark.parametrize("name", sorted(LUT_CASES))
def test_diagonal_ranks_against_lut(name):
    a = _lut_case(name)
    PY = a["y_tok"].shape[1]
    lut, x_len, y_len = (torch.as_tensor(a[k]) for k in ("lut", "x_len", "y_len"))
    got = guidedp.diagonal_ranks(lut, x_len, y_len, PY)
    diag, nd, lo, hi = (got[k].numpy() for k in ("diag", "nd", "lo", "hi"))
    assert diag.dtype == nd.dtype == lo.dtype == hi.dtype == np.int32
    assert diag.shape == (len(x_len), max(int(nd.max()), 1))
    for b, (d, cols) in enumerate(brute_ranks(a["lut"], a["x_len"], a["y_len"], PY)):
        n = int(nd[b])
        assert n == len(d) and diag[b, :n].tolist() == d, b
        assert (diag[b, n:] == guidedp.DIAG_PAD).all()
        # a run of diagonals breaks where the next diagonal is not kept
        runs = np.diff(diag[b, :n]) == 1
        assert runs.tolist() == [bool(a["lut"][b, dr + 1 + PY]) for dr in d[:-1]]
        for j, live in cols.items():
            want = live if live else (lo[b, j], lo[b, j])  # empty: any empty range
            assert (lo[b, j], hi[b, j]) == want, (b, j)
            assert lo[b, j] <= hi[b, j] <= n
    if name == "full":
        assert nd.tolist() == [x + y - 1 for x, y in LUT_CASES[name]]
    if name == "empty":
        assert nd.tolist() == [0, 0] and diag.shape == (2, 1)


def walk_cells(x_end, y_end, steps):
    """The cells (i, j) and states the traceback reads, end to start."""
    i, j = x_end, y_end
    out = []
    for s in steps:
        out.append((i, j, int(s)))
        if s != 1:
            i -= 1
        if s != 2:
            j -= 1
    return out


def assert_walk_in_rank_space(ranks, b, x_end, y_end, steps):
    diag = ranks["diag"][b, : int(ranks["nd"][b])].tolist()
    rank = {d: r for r, d in enumerate(diag)}
    prev = None
    for i, j, s in walk_cells(x_end, y_end, steps):
        assert i - j in rank, (b, i, j)
        r = rank[i - j]
        assert ranks["lo"][b, j] <= r < ranks["hi"][b, j], (b, i, j, r)
        if prev is not None:  # M keeps the rank, I adds one, D takes one
            pr, ps = prev
            assert r == pr + (ps == 1) - (ps == 2), (b, i, j)
        prev = (r, s)


def long12_jobs(pkg, model, pairs, cut):
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long12.fa"))
    jobs = []
    for a, b in pairs:
        x, y = seqs[a], seqs[b]
        x.seq, y.seq = x.seq[:cut], y.seq[:cut]
        env = pkg.diagenv.DiagonalEnvelope(len(x.seq), len(y.seq)).init_sparse(
            model.alphabet.tokenize(x.seq), model.alphabet.tokenize(y.seq), model.alphabet_size,
            pkg.diagenv.DiagEnvParams(kmer_threshold=3))
        jobs.append((x, y, env))
    return jobs


LONG12_PAIRS = ((0, 1), (3, 9))


@pytest.mark.parametrize("case", ["sparse", "full", "short", "long12"])
def test_jax_traceback_stays_on_kept_diagonals(case):
    """Every cell the JAX package's device guide walks is a lane of the
    kernel's rank space, and its rank moves as the kernel moves it."""
    if case == "long12":
        jmodel = JAX.presets.named_model("lg")
        jjobs = long12_jobs(JAX, jmodel, LONG12_PAIRS, 400)
        ref = JaxAligner(jmodel, 1.0)._align_batch_device(jjobs)
        pairs = [(x.seq, y.seq) for x, y, _ in jjobs]
        t = pair_guide_tensors(pairs, "lg", 3, 1.0, torch.device("cpu"), torch.float64)
        assert (t["lut"].sum(1) < t["x_len"] + t["y_len"] - 1).all()  # sparse
    else:
        jmodel, time, jjobs = _cases(JAX)[case]
        ref = [r for r in JaxAligner(jmodel, time)._align_batch_device(jjobs) if not r.trivial]
        model, time, jobs = _cases(PORT)[case]
        aligner = QuickAligner(model, time)
        todo = [QuickAlignResult(aligner, x, y, env) for x, y, env in jobs]
        todo = [r for r in todo if not r.trivial]
        t = convert.guide_tensors(aligner.guide_arrays(todo), torch.device("cpu"),
                                  torch.float64)
    assert len(ref) == t["lut"].shape[0] > 0
    ranks = guidedp.diagonal_ranks(t["lut"], t["x_len"], t["y_len"], t["y_tok"].shape[1])
    for b, r in enumerate(ref):
        assert len(r._steps) > 0
        assert_walk_in_rank_space(ranks, b, r.x_end, r.y_end, r._steps)


def test_backpointer_bytes_and_chunks():
    """The back-pointers take [Y + 1, ND] bytes a pair, and _chunks packs
    pairs under that budget in order; a pair above it raises."""
    a = _lut_case("random")
    PY = a["y_tok"].shape[1]
    lut, x_len, y_len = (torch.as_tensor(a[k]) for k in ("lut", "x_len", "y_len"))
    ranks = guidedp.diagonal_ranks(lut, x_len, y_len, PY)
    cells = ranks["bp_bytes"]
    assert cells == [(y + 1) * int(n) for (_, y), n in zip(LUT_CASES["random"], ranks["nd"])]
    # far below the full [Y + 1, X + 1] plane of the previous layout
    assert sum(cells) < sum((x + 1) * (y + 1) for x, y in LUT_CASES["random"])
    budget = max(cells) + min(c for c in cells if c)
    chunks = guidedp._chunks(cells, budget)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(cells)
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
    assert all(sum(cells[lo:hi]) <= budget for lo, hi in chunks)
    with pytest.raises(MemoryError):
        guidedp._chunks(cells, max(cells) - 1)
