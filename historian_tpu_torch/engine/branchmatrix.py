"""Branch alignment matrices: the 3-state parent-child pair HMM over
position-weight matrices.

Port of historian_tpu/engine/branchmatrix.py (the reference's
BranchMatrixBase, Sampler::BranchMatrix and Refiner::BranchMatrix,
sampler.h:183-223, sampler.cpp:1005-1160, refiner.cpp:10-103).  The
emission and the envelope mask are built on the host as the JAX package
builds them; the fill runs on the host (csrc/fill.cpp `branch_fill`) or,
on the card, through kernel (e) (ops/branchdp.py, csrc/branchfill.cu) on
the band alone: each row's hull taken from the envelope (`envelope_hull`),
the emission and the mask at the band's cells uploaded in one pinned
copy, the filled band read back in one (`branchdp.read_band`).  The
traceback (best or sampled, on the run's mt19937 in the reference's
order) and the path scores walk the cells on the host.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from scipy.special import logsumexp

from historian_tpu_torch import device as devmod
from historian_tpu_torch.core.alignpath import AlignPath, GuideAlignmentEnvelope
from historian_tpu_torch.engine.treealign import calc_ins_probs, pre_multiply
from historian_tpu_torch.models.ratemodel import LogProbModel, ProbModel, RateModel
from historian_tpu_torch.ops import branchdp
from historian_tpu_torch.ops.branchdp import DELETE, INSERT, MATCH, NEG
from historian_tpu_torch.utils.rng import MT19937

MIN_BRANCH_LEN = 1e-9
START, END = 0, 3  # Start aliases Match in transition lookups
#: on the card, fills of more state-cells than this take kernel (e)
DEVICE_MIN_CELLS = 2_000_000
#: fills by route: "host" (csrc/fill.cpp) or "device" (ops/branchdp.py)
FILLS = {"host": 0, "device": 0}


def envelope_hull(env: GuideAlignmentEnvelope, x_env_pos, y_env_pos, x_size: int,
                  y_size: int):
    """(lo, hi), int64 [X+1]: each interior row's in-mask interior columns
    (0 < y < Y) as the envelope gives them, in `branchdp.interior_hull`'s
    form.  The mask keeps |m1[x] - m2[y]| <= max_distance, and the child's
    cumulative matches m2 never fall along y, so each row's columns are one
    interval, found by binary search.  None for an uninitialised envelope
    (the full mask) or where m2 falls, so that the hull is taken from the
    mask."""
    if not env.initialized or x_size < 3 or y_size < 3:
        return None
    m1 = env.cumulative_matches[env.row1_pos_to_col[np.asarray(x_env_pos)]][1:-1]
    m2 = env.cumulative_matches[env.row2_pos_to_col[np.asarray(y_env_pos)]][1:-1]
    if np.any(np.diff(m2) < 0):
        return None
    a = np.searchsorted(m2, m1 - env.max_distance, side="left")
    b = np.searchsorted(m2, m1 + env.max_distance, side="right")
    lo = np.full(x_size, y_size, dtype=np.int64)
    hi = np.zeros(x_size, dtype=np.int64)
    lo[1:-1] = np.where(b > a, a + 1, y_size)
    hi[1:-1] = np.where(b > a, b, 0)
    return lo, hi


class BranchMatrix:
    """Forward (sum) or Viterbi (max) branch DP over position-weight matrices."""

    def __init__(
        self,
        model: RateModel,
        x_pwm: np.ndarray,  # [X, C, A] parent conditional log-probs
        y_pwm: np.ndarray,  # [Y, C, A] child conditional log-probs
        dist: float,
        env: GuideAlignmentEnvelope,
        x_env_pos: np.ndarray,
        y_env_pos: np.ndarray,
        x_row: int,
        y_row: int,
        viterbi: bool = False,
    ):
        self.model = model
        self.prob_model = ProbModel(model, max(MIN_BRANCH_LEN, dist))
        self.log_prob_model = LogProbModel(self.prob_model)
        self.x_row, self.y_row = x_row, y_row
        self.viterbi = viterbi
        self.x_size = len(x_pwm) + 1
        self.y_size = len(y_pwm) + 1
        self.x_pwm = x_pwm
        self.y_sub = pre_multiply(y_pwm, self.log_prob_model.log_sub_prob)
        with np.errstate(divide="ignore"):
            self.y_emit = calc_ins_probs(
                y_pwm, self.log_prob_model.log_ins_prob, self.log_prob_model.log_cpt_weight
            )

        tp = self.prob_model.trans_prob

        def lg(p):
            return math.log(p) if p > 0 else -np.inf

        M, I, D, E = ProbModel.MATCH, ProbModel.INSERT, ProbModel.DELETE, ProbModel.END
        self.mm, self.mi, self.md, self.me = lg(tp(M, M)), lg(tp(M, I)), lg(tp(M, D)), lg(tp(M, E))
        self.im, self.ii, self.id, self.ie = lg(tp(I, M)), lg(tp(I, I)), lg(tp(I, D)), lg(tp(I, E))
        self.dm, self.dd, self.de = lg(tp(D, M)), lg(tp(D, D)), lg(tp(D, E))
        self._lp_trans = {
            (MATCH, MATCH): self.mm, (MATCH, INSERT): self.mi, (MATCH, DELETE): self.md, (MATCH, END): self.me,
            (INSERT, MATCH): self.im, (INSERT, INSERT): self.ii, (INSERT, DELETE): self.id, (INSERT, END): self.ie,
            (DELETE, MATCH): self.dm, (DELETE, INSERT): -np.inf, (DELETE, DELETE): self.dd, (DELETE, END): self.de,
        }

        # envelope mask [X+1, Y+1]: boundary rows and columns always in
        mask = np.zeros((self.x_size, self.y_size), dtype=bool)
        hull = envelope_hull(env, x_env_pos, y_env_pos, self.x_size, self.y_size)
        if env.initialized:
            m1 = env.cumulative_matches[env.row1_pos_to_col[np.asarray(x_env_pos)]]
            m2 = env.cumulative_matches[env.row2_pos_to_col[np.asarray(y_env_pos)]]
            mask[:, :] = np.abs(m1[:, None] - m2[None, :]) <= env.max_distance
        else:
            mask[:, :] = True
        mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
        self.mask = mask

        # match emission lse_{c,a}(x_pwm[x] + y_sub[y]) -> [X+1, Y+1]
        match_emit = np.full((self.x_size, self.y_size), NEG)
        if len(x_pwm) and len(y_pwm):
            mx = x_pwm.max(axis=(1, 2), keepdims=True)
            my = self.y_sub.max(axis=(1, 2), keepdims=True)
            sx = np.where(np.isfinite(mx), mx, 0.0)
            sy = np.where(np.isfinite(my), my, 0.0)
            ex = np.exp(x_pwm - sx).reshape(len(x_pwm), -1)
            ey = np.exp(self.y_sub - sy).reshape(len(y_pwm), -1)
            with np.errstate(divide="ignore"):
                match_emit[1:, 1:] = (
                    np.log(ex @ ey.T) + sx[:, 0, 0][:, None] + sy[:, 0, 0][None, :]
                )
        self.match_emit = match_emit
        ins_emit = np.concatenate([[NEG], self.y_emit]) if len(y_pwm) else np.array([NEG])

        trans = np.array([self.mm, self.mi, self.md, self.im, self.ii, self.id, self.dm, self.dd])
        self.cells = self._fill_cells(match_emit, ins_emit, mask, trans, viterbi, hull)
        end = self.cells[self.x_size - 1, self.y_size - 1]
        reduce3 = max if viterbi else lambda *v: logsumexp(list(v))
        self.lp_end = float(
            reduce3(end[MATCH] + self.me, end[INSERT] + self.ie, end[DELETE] + self.de)
        )

    @staticmethod
    def use_device(shape: tuple) -> bool:
        """The route of a fill of `shape` [X+1, Y+1]: HISTORIAN_DEVICE_BRANCH=1
        or 0 forces; otherwise kernel (e) on the card for more than
        DEVICE_MIN_CELLS state-cells, the host's fill.cpp for the rest and
        for every fill under -platform cpu (the JAX package's rule on a
        local accelerator)."""
        env = os.environ.get("HISTORIAN_DEVICE_BRANCH", "auto")
        if env in ("0", "1"):
            return env == "1"
        return devmod.current().type == "cuda" and shape[0] * shape[1] * 3 > DEVICE_MIN_CELLS

    @staticmethod
    def _fill_cells(match_emit, ins_emit, mask, trans, viterbi: bool, hull=None):
        """The cells [X+1, Y+1, 3]: a numpy grid from the host fill, or a
        BandCells from the device fill of the band, whose rows' hulls are
        `hull` (lo, hi), else the mask's."""
        if not BranchMatrix.use_device(match_emit.shape):
            from historian_tpu_torch.native import get_native

            lib = get_native()
            if lib is None:
                raise RuntimeError("the native host fill (historian_tpu_torch/csrc/fill.cpp) "
                                   "is unavailable: it did not build, or HISTORIAN_NATIVE=0")
            cells = np.empty((match_emit.shape[0], match_emit.shape[1], 3))
            lib.branch_fill(
                match_emit.shape[0], match_emit.shape[1],
                np.ascontiguousarray(match_emit),
                np.ascontiguousarray(ins_emit, dtype=np.float64),
                np.ascontiguousarray(mask, dtype=np.uint8),
                trans, np.uint8(viterbi), cells,
            )
            FILLS["host"] += 1
            return cells
        dev = devmod.current()
        if hull is None:
            hull = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
        layout = branchdp.band_layout(*hull, *match_emit.shape)
        band = branchdp.branch_fill_band(
            branchdp.upload_band(layout, match_emit, mask, ins_emit, trans, dev), viterbi)
        FILLS["device"] += 1
        return branchdp.read_band(band, layout)

    # ----------------------------------------------------------------- helpers
    def lp_trans(self, src: int, dest: int) -> float:
        return self._lp_trans.get((src, dest), -np.inf)

    def lp_emit(self, x: int, y: int, state: int) -> float:
        if state == MATCH:
            return self.match_emit[x, y] if (x > 0 and y > 0) else -np.inf
        if state == INSERT:
            return self.y_emit[y - 1] if y > 0 else -np.inf
        return 0.0

    @staticmethod
    def _column(state: int):
        if state == MATCH:
            return True, True
        if state == INSERT:
            return False, True
        if state == DELETE:
            return True, False
        return False, False

    def _traceback(self, chooser) -> AlignPath:
        x, y, state = self.x_size - 1, self.y_size - 1, END
        x_path: list[bool] = []
        y_path: list[bool] = []
        while x > 0 or y > 0:
            if state == END:
                dx = dy = False
            else:
                dx, dy = self._column(state)
                x_path.append(dx)
                y_path.append(dy)
            sx = x - 1 if dx else x
            sy = y - 1 if dy else y
            if state == END:
                sx, sy = x, y
            e = self.lp_emit(x, y, state) if state != END else 0.0
            cands = {}
            for s in (MATCH, INSERT, DELETE):
                cands[s] = self.cells[sx, sy, s] + self.lp_trans(s, state) + e
            state = chooser(cands)
            x, y = sx, sy
        x_path.reverse()
        y_path.reverse()
        return {
            self.x_row: np.array(x_path, dtype=bool),
            self.y_row: np.array(y_path, dtype=bool),
        }

    def best(self) -> AlignPath:
        def choose_best(cands):
            best_s, best_v = None, -np.inf
            for s in (MATCH, INSERT, DELETE):
                if cands[s] > best_v:
                    best_s, best_v = s, cands[s]
            return best_s

        return self._traceback(choose_best)

    def sample(self, rng: MT19937) -> AlignPath:
        """Stochastic traceback in the reference's random_key_log order
        (a map sorted by state index)."""

        def choose_sample(cands):
            items = sorted(cands.items())
            lpmax = max(v for _, v in items)
            weights = [math.exp(v - lpmax) for _, v in items]
            total = sum(weights)
            p = rng.uniform(0, total)
            for (s, _), w in zip(items, weights):
                p -= w
                if p <= 0:
                    return s
            return items[-1][0]

        return self._traceback(choose_sample)

    def log_path_prob(self, path: AlignPath) -> float:
        """Score one alignment path (sampler.cpp:1122-1152)."""
        x = y = 0
        state = MATCH  # Start aliases Match
        lp = 0.0
        xr = np.asarray(path[self.x_row], dtype=bool)
        yr = np.asarray(path[self.y_row], dtype=bool)
        for col in range(len(xr)):
            dx, dy = bool(xr[col]), bool(yr[col])
            if dx:
                x += 1
            if dy:
                y += 1
            next_state = ProbModel.get_state(dx, dy)
            if not self.mask[x, y]:
                return -np.inf
            lp += self.lp_trans(state, next_state) + self.lp_emit(x, y, next_state)
            lp = min(lp, float(self.cells[x, y, next_state]))
            state = next_state
        lp += self.lp_trans(state, END)
        return lp

    def log_post_prob(self, path: AlignPath) -> float:
        return min(self.log_path_prob(path), self.lp_end) - self.lp_end
