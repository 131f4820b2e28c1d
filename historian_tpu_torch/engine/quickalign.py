"""Fast banded pairwise Viterbi alignment, the guide stage's workhorse.

Port of historian_tpu/engine/quickalign.py: `QuickAligner` derives the
3-state scores (substitution log-odds, symmetrized gap open/extend from
the rate model's branch probabilities, free end gaps) exactly as the
JAX package does, and `QuickAlignResult` decodes a traceback into an
alignment path.  Every pair of a batch goes through one call of the
guide kernel (ops/guidedp.py) on the selected device, in its fill
dtype: the CUDA kernel on the card, its plain version (the torch fill
plus the host walk) on the CPU.  The CPU route in float64 reproduces
the JAX package's host route (`_align_batch_host_backend`, `_finish`,
`align_path`) bit for bit.  No shape buckets and no batch padding: the
batch is padded only to its longest pair.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from historian_tpu.core.alignpath import AlignPath
from historian_tpu.core.seqs import FastSeq
from historian_tpu.engine.diagenv import DiagonalEnvelope
from historian_tpu.models.ratemodel import ProbModel, RateModel
from historian_tpu_torch import device as devmod
from historian_tpu_torch.ops.guidedp import guide_align
from historian_tpu_torch.ops.pairdp import NEG_INF


class QuickAligner:
    """Reusable scoring context for one (model, time)."""

    def __init__(self, model: RateModel, time: float):
        self.model = model
        self.time = time
        pm = ProbModel(model, time)
        with np.errstate(divide="ignore"):
            self.submat = np.log(pm.sub_mat[0]) - np.log(pm.ins_vec[0])[None, :]

        gap_prob = pm.ins + (1 - pm.ins) * pm.del_
        no_gap_prob = 1 - gap_prob
        gap_ext = 1.0 / ((pm.ins / gap_prob) / pm.ins_ext + (1 - pm.ins / gap_prob) / pm.del_ext)
        no_gap_ext = 1 - gap_ext

        self.no_gap = math.log(no_gap_prob)
        self.gap_open = math.log(gap_prob) + math.log(no_gap_ext)
        self.gap_extend = math.log(gap_ext)

        self.m2i = math.log(gap_prob)
        self.m2d = math.log(no_gap_prob * gap_prob)
        self.m2m = math.log(no_gap_prob * no_gap_prob)
        self.i2i = math.log(gap_ext)
        self.i2d = math.log(no_gap_ext * gap_prob)
        self.i2m = math.log(no_gap_ext * no_gap_prob)
        self.d2d = math.log(gap_ext)
        self.d2m = math.log(no_gap_ext)

    def _gap_score_vec(self, pos: np.ndarray) -> np.ndarray:
        """(pos==1 ? noGap : gapOpen + (pos-2)*gapExtend), vectorized."""
        return np.where(pos == 1, self.no_gap, self.gap_open + (pos - 2) * self.gap_extend)

    def _end_gap_vec(self, length: int, width: int) -> np.ndarray:
        """[width + 1]: the end-gap score of position 0..length (the JAX
        host route's end_i / end_j), zero past the sequence."""
        ii = np.arange(length + 1, dtype=np.float64)
        out = np.zeros(width + 1)
        out[: length + 1] = np.where(
            ii == length, self.no_gap, self.gap_open + (length - ii - 2) * self.gap_extend
        )
        return out

    def guide_arrays(self, results: list["QuickAlignResult"]) -> dict:
        """Host inputs of the guide kernel for non-trivial pairs, padded
        to the longest pair (see ops/guidedp.py)."""
        B = len(results)
        PX = max(r.x_len for r in results)
        PY = max(r.y_len for r in results)
        x_tok = np.full((B, PX), -1, np.int32)
        y_tok = np.full((B, PY), -1, np.int32)
        lut = np.zeros((B, PX + PY + 1), bool)
        end_x = np.zeros((B, PX + 1))
        end_y = np.zeros((B, PY + 1))
        for b, r in enumerate(results):
            x_tok[b, : r.x_len] = r.x_tok
            y_tok[b, : r.y_len] = r.y_tok
            lut[b, np.asarray(r.envelope.diagonals, dtype=np.int64) + PY] = True
            end_x[b] = self._end_gap_vec(r.x_len, PX)
            end_y[b] = self._end_gap_vec(r.y_len, PY)
        trans = np.array([self.m2m, self.m2i, self.m2d, self.i2i, self.i2m,
                          self.i2d, self.d2d, self.d2m, 0.0, 0.0])
        return dict(
            x_tok=x_tok, y_tok=y_tok, lut=lut,
            x_len=np.array([r.x_len for r in results], np.int32),
            y_len=np.array([r.y_len for r in results], np.int32),
            submat=self.submat, trans=trans,
            sg=self._gap_score_vec(np.arange(max(PX, PY) + 1, dtype=np.float64)),
            end_x=end_x, end_y=end_y,
        )

    def align_batch(self, jobs: "list[tuple[FastSeq, FastSeq, DiagonalEnvelope | None]]", progress=None):
        """Align every pair in one guide-kernel call on the selected device.
        `progress(done, total)` is called as results are decoded."""
        from historian_tpu_torch import convert

        results = [QuickAlignResult(self, x, y, env) for x, y, env in jobs]
        todo = [r for r in results if not r.trivial]
        if todo:
            dev = devmod.current()
            t = convert.guide_tensors(self.guide_arrays(todo), dev, devmod.fill_dtype(dev))
            out = guide_align(t["x_tok"], t["y_tok"], t["lut"], t["x_len"], t["y_len"],
                              t["submat"], t["trans"], t["sg"], t["end_x"], t["end_y"])
            steps, n_steps, x_end, y_end, lead_i, lead_j, score = (
                a.cpu().numpy() for a in out
            )
            for b, r in enumerate(todo):
                if progress is not None:
                    progress(b, len(todo))
                r.finish(steps[b, : n_steps[b]], int(x_end[b]), int(y_end[b]),
                         int(lead_i[b]), int(lead_j[b]), float(score[b]))
        return results


class QuickAlignResult:
    def __init__(self, aligner: QuickAligner, x: FastSeq, y: FastSeq, envelope: DiagonalEnvelope | None):
        self.aligner = aligner
        self.x = x
        self.y = y
        x_len, y_len = len(x.seq), len(y.seq)
        self.x_len, self.y_len = x_len, y_len
        if envelope is None:
            envelope = DiagonalEnvelope(x_len, y_len).init_full()
        self.envelope = envelope
        self._steps = None
        self.trivial = x_len == 0 or y_len == 0
        if self.trivial:
            # the nonempty sequence is one long gap run
            other = max(x_len, y_len)
            self.end = self.result = (
                0.0 if other == 0 else aligner.gap_open + (other - 2) * aligner.gap_extend
            )
            self.x_end, self.y_end = x_len, y_len
            return
        alphabet = aligner.model.alphabet
        self.x_tok, self.y_tok = alphabet.tokenize(x.seq), alphabet.tokenize(y.seq)

    def finish(self, steps: np.ndarray, x_end: int, y_end: int, lead_i: int,
               lead_j: int, score: float) -> None:
        """Store a guide-kernel result: step codes end to start, the best
        end cell, and the (i, j) where the walk took Start."""
        self._steps = np.asarray(steps)
        self.x_end, self.y_end = x_end, y_end
        self._lead = (lead_i, lead_j)
        self.end = self.result = score

    @property
    def finite(self) -> bool:
        return self.result > NEG_INF / 2

    def align_path(self, row1: int = 0, row2: int = 1) -> AlignPath:
        """The traceback as a 2-row path: leading free gap, the walk's
        steps start to end, trailing free gap."""
        if self.trivial:
            return {
                row1: np.concatenate([np.ones(self.x_len, bool), np.zeros(self.y_len, bool)]),
                row2: np.concatenate([np.zeros(self.x_len, bool), np.ones(self.y_len, bool)]),
            }
        if not self.finite:
            raise ValueError("can't do Viterbi traceback: final score is -infinity")
        steps = self._steps[::-1]  # start -> end
        mid_x = (steps == 0) | (steps == 2)  # M and D consume x
        mid_y = (steps == 0) | (steps == 1)  # M and I consume y
        li, lj = self._lead
        lead_x = np.concatenate([np.ones(li, bool), np.zeros(lj, bool)])
        lead_y = np.concatenate([np.zeros(li, bool), np.ones(lj, bool)])
        tx, ty = self.x_len - self.x_end, self.y_len - self.y_end
        tail_x = np.concatenate([np.ones(tx, bool), np.zeros(ty, bool)])
        tail_y = np.concatenate([np.zeros(tx, bool), np.ones(ty, bool)])
        path: AlignPath = {
            row1: np.concatenate([lead_x, mid_x, tail_x]),
            row2: np.concatenate([lead_y, mid_y, tail_y]),
        }
        assert int(path[row1].sum()) == self.x_len
        assert int(path[row2].sum()) == self.y_len
        return path


def pair_guide_tensors(pairs: "list[tuple[str, str]]", preset: str, kmer_threshold: int,
                       time: float, device, dtype) -> dict:
    """The guide kernel's inputs (`QuickAligner.guide_arrays`) as tensors
    on `device` for `pairs` of residue strings, scored by the named preset
    model at `time`, each pair in its sparse envelope of k-mer matches
    (`-kmatchn kmer_threshold`)."""
    from historian_tpu.engine.diagenv import DiagEnvParams
    from historian_tpu.models.presets import named_model
    from historian_tpu_torch import convert

    model = named_model(preset)
    aligner = QuickAligner(model, time)
    params = DiagEnvParams(kmer_threshold=kmer_threshold)
    results = []
    for k, (x, y) in enumerate(pairs):
        env = DiagonalEnvelope(len(x), len(y)).init_sparse(
            model.alphabet.tokenize(x), model.alphabet.tokenize(y), model.alphabet_size, params)
        results.append(QuickAlignResult(aligner, FastSeq(name=f"x{k}", seq=x),
                                        FastSeq(name=f"y{k}", seq=y), env))
    return convert.guide_tensors(aligner.guide_arrays(results), device, dtype)
