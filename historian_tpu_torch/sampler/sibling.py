"""Three-sequence sibling transducer DP: align (left, right) -> parent.

Port of historian_tpu/sampler/sibling.py (the reference's
Sampler::SiblingMatrix): an 11-state machine {IMM, IMD, IDM, IDD, WWW,
WWX, WXW, IMI, IIW, IDI, IIX} whose IDD self-loop is eliminated
analytically (geometric, re-added during traceback) and whose wait
states are eliminated for path scoring.  Samples a parent alignment of
two sibling profiles and produces the parent's position-weight matrix.

The emissions and the envelope mask are built on the host as the JAX
package builds them.  The fill's routes (`FILLS`): on the card, a fill of
more than DEVICE_MIN_CELLS in-mask state-cells runs kernel (d) on the band
(ops/siblingdp.py, csrc/siblingfill.cu: each row's hull from the mask,
the band up in one pinned copy and back in one); the rest runs on the
host in csrc/fill.cpp `sibling_fill`, bit-identical to the Python fill,
which runs only where that library does not build.
HISTORIAN_DEVICE_SIBLING=1/0 forces the device route (on the CPU, the
band entry's plain version) or the host's.  A device fill that fails
raises: no route falls back to another.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from scipy.special import logsumexp as logsumexp_nd

from historian_tpu_torch import device as devmod


def logsumexp(vals):
    """Scalar log-sum-exp over a small list.

    Same max-shift formulation as scipy.special.logsumexp (which this
    replaces: its array-API dispatch costs ~200us per call, and the
    sibling fill makes one call per cell), evaluated with math.* on
    floats."""
    m = max(vals)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(v - m) for v in vals))

from historian_tpu_torch.core.alignpath import AlignPath, GuideAlignmentEnvelope, align_path_columns
from historian_tpu_torch.engine.treealign import calc_ins_probs, pre_multiply, root_ext_prob
from historian_tpu_torch.models.ratemodel import LogProbModel, ProbModel, RateModel
from historian_tpu_torch.utils.rng import MT19937

NEG = -np.inf
MIN_BRANCH_LEN = 1e-9
#: on the card, fills of more in-mask state-cells than this take kernel (d).
#: The JAX package counts the grid's (2e6).  Timed on an H100 (PERF.md
#: section 6, chip_smoke.py (n)'s route sweep), whole SiblingMatrix builds
#: of long6 node-align cuts: with the lane-group kernel the card wins
#: banded cuts from ~1.0e6 in the mask (4.9e7 in the grid; even at 0.7e6)
#: and full masks from 1.0e6 (above 0.6e6, where fill.cpp turns to its
#: OpenMP wavefront); the mask's count serves both, the grid's puts them
#: two orders of magnitude apart
DEVICE_MIN_CELLS = 1_000_000
#: fills by route: "device" (kernel (d), or its plain version on the CPU),
#: "host" (csrc/fill.cpp), "python" (the Python fill)
FILLS = {"device": 0, "host": 0, "python": 0}

# state indices
IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX = range(11)
EEE = 11
SSS = IMM
N_STATES = 11


def _lg(p: float) -> float:
    return math.log(p) if p > 0 else NEG


def native_fill(l_emit, r_emit, match_emit, mask, tmat, cells=None):
    """csrc/fill.cpp `sibling_fill` on a fill's host inputs (l_emit [X],
    r_emit [Y], match_emit and mask [X+1, Y+1], the [12, 12] transition
    table): (cells [X+1, Y+1, 11], -inf where no path reaches, lp_end), or
    None where the library does not build.  `cells`, where given, is the
    -inf grid to fill."""
    from historian_tpu_torch.native import get_native

    lib = get_native()
    if lib is None or not hasattr(lib, "sibling_fill"):
        return None
    sx, sy = match_emit.shape
    if cells is None:
        cells = np.full((sx, sy, N_STATES), NEG)
    lp_end = np.zeros(1)
    lib.sibling_fill(
        sx, sy,
        np.ascontiguousarray(l_emit, np.float64),
        np.ascontiguousarray(r_emit, np.float64),
        np.ascontiguousarray(match_emit, np.float64),
        np.ascontiguousarray(mask.astype(np.uint8)),
        np.ascontiguousarray(tmat, np.float64), cells, lp_end,
    )
    return cells, float(lp_end[0])


class SiblingMatrix:
    def __init__(
        self,
        model: RateModel,
        l_pwm: np.ndarray,  # [L, C, A]
        r_pwm: np.ndarray,  # [R, C, A]
        pl_dist: float,
        pr_dist: float,
        env: GuideAlignmentEnvelope,
        l_env_pos: np.ndarray,
        r_env_pos: np.ndarray,
        l_row: int,
        r_row: int,
        p_row: int,
        defer_fill: bool = False,
    ):
        self.model = model
        self.l_prob = ProbModel(model, max(MIN_BRANCH_LEN, pl_dist))
        self.r_prob = ProbModel(model, max(MIN_BRANCH_LEN, pr_dist))
        l_log = LogProbModel(self.l_prob)
        r_log = LogProbModel(self.r_prob)
        self.l_row, self.r_row, self.p_row = l_row, r_row, p_row
        with np.errstate(divide="ignore"):
            self.log_root = np.log(model.ins_prob) + np.log(model.cpt_weight)[:, None]
        self.l_sub = pre_multiply(l_pwm, l_log.log_sub_prob)  # [L, C, A]
        self.r_sub = pre_multiply(r_pwm, r_log.log_sub_prob)
        self.l_emit = calc_ins_probs(l_pwm, l_log.log_ins_prob, l_log.log_cpt_weight)
        self.r_emit = calc_ins_probs(r_pwm, r_log.log_ins_prob, r_log.log_cpt_weight)
        self.x_size = len(l_pwm) + 1
        self.y_size = len(r_pwm) + 1

        # envelope mask
        mask = np.zeros((self.x_size, self.y_size), dtype=bool)
        if env.initialized:
            m1 = env.cumulative_matches[env.row1_pos_to_col[np.asarray(l_env_pos)]]
            m2 = env.cumulative_matches[env.row2_pos_to_col[np.asarray(r_env_pos)]]
            mask[:, :] = np.abs(m1[:, None] - m2[None, :]) <= env.max_distance
        else:
            mask[:, :] = True
        mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
        self.mask = mask

        # match emission matrix [X, Y] (1-based positions):
        # lse_{c,a}(logRoot[c,a] + lSub[x,c,a] + rSub[y,c,a]), evaluated as
        # an exp-shifted matmul (BLAS / MXU work) instead of a logsumexp
        # over the full [L, R, C, A] tensor -- the L x R pair axes never
        # materialize, and the inner product rides dgemm.  Equal to the
        # tensor logsumexp up to summation reassociation.
        self.match_emit = np.full((self.x_size, self.y_size), NEG)
        if len(l_pwm) and len(r_pwm):
            z = self.log_root[None, :, :] + self.l_sub  # [L, C, A]
            mx = z.max(axis=(1, 2), keepdims=True)
            my = self.r_sub.max(axis=(1, 2), keepdims=True)
            sx = np.where(np.isfinite(mx), mx, 0.0)
            sy = np.where(np.isfinite(my), my, 0.0)
            ex = np.exp(z - sx).reshape(len(l_pwm), -1)
            ey = np.exp(self.r_sub - sy).reshape(len(r_pwm), -1)
            with np.errstate(divide="ignore"):
                self.match_emit[1:, 1:] = (
                    np.log(ex @ ey.T) + sx[:, 0, 0][:, None] + sy[:, 0, 0][None, :]
                )

        self._t_raw: dict | None = None
        self._init_transitions()
        if not defer_fill:
            self._fill()

    # ------------------------------------------------------------ transitions
    def idd_self_loop_prob(self) -> float:
        return root_ext_prob(self.model) * self.l_prob.del_ext * self.r_prob.del_ext

    def lp_trans(self, src: int, dest: int) -> float:
        """Raw 35-transition table (sampler.cpp:1460-1577), built once."""
        if self._t_raw is None:
            self._t_raw = self._build_raw_table()
        return self._t_raw.get((src, dest), NEG)

    def _build_raw_table(self) -> dict:
        l, r = self.l_prob, self.r_prob
        re = root_ext_prob(self.model)
        t = {
            (IMM, WWW): _lg(1 - l.ins) + _lg(1 - r.ins),
            (IMM, IMI): _lg(r.ins),
            (IMM, IIW): _lg(l.ins) + _lg(1 - r.ins),
            (IMD, WWX): _lg(1 - l.ins),
            (IMD, IIX): _lg(l.ins),
            (IDM, WXW): _lg(1 - r.ins),
            (IDM, IDI): _lg(r.ins),
            (IDD, IDD): _lg(self.idd_self_loop_prob()),
            (IDD, IMM): _lg(re) + _lg(1 - l.del_ext) + _lg(1 - r.del_ext),
            (IDD, IMD): _lg(re) + _lg(1 - l.del_ext) + _lg(r.del_ext),
            (IDD, IDM): _lg(re) + _lg(l.del_ext) + _lg(1 - r.del_ext),
            (IDD, EEE): _lg(1 - re) + _lg(1 - l.del_ext) + _lg(1 - r.del_ext),
            (WWW, IMM): _lg(re) + _lg(1 - l.del_) + _lg(1 - r.del_),
            (WWW, IMD): _lg(re) + _lg(1 - l.del_) + _lg(r.del_),
            (WWW, IDM): _lg(re) + _lg(l.del_) + _lg(1 - r.del_),
            (WWW, IDD): _lg(re) + _lg(l.del_) + _lg(r.del_),
            (WWW, EEE): 0.0,
            (WWX, IMM): _lg(re) + _lg(1 - l.del_) + _lg(1 - r.del_ext),
            (WWX, IMD): _lg(re) + _lg(1 - l.del_) + _lg(r.del_ext),
            (WWX, IDM): _lg(re) + _lg(l.del_) + _lg(1 - r.del_ext),
            (WWX, IDD): _lg(re) + _lg(l.del_) + _lg(r.del_ext),
            (WWX, EEE): _lg(1 - r.del_ext),
            (WXW, IMM): _lg(re) + _lg(1 - l.del_ext) + _lg(1 - r.del_),
            (WXW, IMD): _lg(re) + _lg(1 - l.del_ext) + _lg(r.del_),
            (WXW, IDM): _lg(re) + _lg(l.del_ext) + _lg(1 - r.del_),
            (WXW, IDD): _lg(re) + _lg(l.del_ext) + _lg(r.del_),
            (WXW, EEE): _lg(1 - l.del_ext),
            (IMI, WWW): _lg(1 - l.ins) + _lg(1 - r.ins_ext),
            (IMI, IMI): _lg(r.ins_ext),
            (IMI, IIW): _lg(l.ins) + _lg(1 - r.ins_ext),
            (IIW, WWW): _lg(1 - l.ins_ext),
            (IIW, IIW): _lg(l.ins_ext),
            (IDI, WXW): _lg(1 - r.ins_ext),
            (IDI, IDI): _lg(r.ins_ext),
            (IIX, WWX): _lg(1 - l.ins_ext),
            (IIX, IIX): _lg(l.ins_ext),
        }
        return t

    def lp_trans_elim_idd(self, src: int, dest: int) -> float:
        if src == IDD:
            if dest == IDD:
                return NEG
            return self.lp_trans(src, dest) + self.idd_exit()
        return self.lp_trans(src, dest)

    def idd_exit(self) -> float:
        return math.log(1.0 / (1.0 - self.idd_self_loop_prob()))

    def lp_trans_elim_wait(self, src: int, dest: int) -> float:
        return logsumexp(
            [
                self.lp_trans(src, dest),
                self.lp_trans(src, WWW) + self.lp_trans(WWW, dest),
                self.lp_trans(src, WWX) + self.lp_trans(WWX, dest),
                self.lp_trans(src, WXW) + self.lp_trans(WXW, dest),
            ]
        )

    def _init_transitions(self) -> None:
        e = self.lp_trans_elim_idd
        self.t = {}
        for src in range(N_STATES):
            for dest in list(range(N_STATES)) + [EEE]:
                self.t[(src, dest)] = e(src, dest)

    # ------------------------------------------------------------------- fill
    def _fill(self) -> None:
        if self._want_device():
            self._fill_device()
            FILLS["device"] += 1
        elif self._fill_native():
            FILLS["host"] += 1
        else:
            self._fill_host()
            FILLS["python"] += 1

    @staticmethod
    def batch_arrays(mats: "list[SiblingMatrix]") -> tuple:
        """The inputs of ops/siblingdp.py `sibling_forward_batch` for `mats`
        (numpy): each grid padded to the largest one's shape with masked
        cells, -1e30 for -inf, its transitions and its corner beside it."""
        from historian_tpu_torch.ops.siblingdp import pack_sibling_transitions

        X1 = max(m.x_size for m in mats)
        Y1 = max(m.y_size for m in mats)
        K = len(mats)
        l_emit = np.full((K, X1 - 1), -1e30)
        r_emit = np.full((K, Y1 - 1), -1e30)
        match = np.full((K, X1, Y1), -1e30)
        mask = np.zeros((K, X1, Y1), dtype=bool)
        trans = np.empty((K, 35))
        ends = np.empty((K, 2), dtype=np.int32)
        for k, m in enumerate(mats):
            sx, sy = m.x_size, m.y_size
            l_emit[k, : sx - 1] = m.l_emit
            r_emit[k, : sy - 1] = m.r_emit
            match[k, :sx, :sy] = np.where(np.isfinite(m.match_emit), m.match_emit, -1e30)
            mask[k, :sx, :sy] = m.mask
            trans[k] = pack_sibling_transitions(m)
            ends[k] = (sx - 1, sy - 1)
        return l_emit, r_emit, match, mask, trans, ends

    @classmethod
    def fill_batch(cls, mats: "list[SiblingMatrix]") -> bool:
        """Fill K deferred proposal grids at once (ops/siblingdp.py
        `sibling_forward_batch`) on the current device, from `batch_arrays`;
        then each matrix's cells (-inf where no path reaches) and lp_end.
        On the card kernel (d') in one launch, on the CPU the plain version.
        Returns True; unlike the JAX package's, a failure raises (its
        `except Exception: return False` hid the kernel's failures)."""
        if not mats:
            return True
        from historian_tpu_torch.ops.siblingdp import sibling_forward_batch

        dev = devmod.current()
        cells, lp_end = sibling_forward_batch(
            *(torch.from_numpy(a).to(dev) for a in cls.batch_arrays(mats)))
        cells = cells.cpu().numpy()
        lp_end = lp_end.cpu().numpy()
        for k, m in enumerate(mats):
            ck = cells[k, : m.x_size, : m.y_size]
            m.cells = np.where(ck < -1e29, NEG, ck)
            m.lp_end = float(lp_end[k])
        return True

    def _want_device(self) -> bool:
        """HISTORIAN_DEVICE_SIBLING=1/0 forces; otherwise kernel (d) on the
        card for more than DEVICE_MIN_CELLS in-mask state-cells, the host
        for the rest and for every fill under -platform cpu."""
        env = os.environ.get("HISTORIAN_DEVICE_SIBLING", "auto")
        if env in ("0", "1"):
            return env == "1"
        return (devmod.current().type == "cuda"
                and np.count_nonzero(self.mask) * N_STATES > DEVICE_MIN_CELLS)

    def _fill_native(self) -> bool:
        """Native host-runtime fill (csrc/fill.cpp sibling_fill):
        bit-identical to _fill_host -- same lse formulation, operation
        order, and libm -- so it is the default when the library builds.
        HISTORIAN_NATIVE=0 forces the python fill."""
        from historian_tpu_torch.ops.siblingdp import transition_table

        out = native_fill(self.l_emit, self.r_emit, self.match_emit, self.mask,
                          transition_table(self))
        if out is None:
            return False
        self.cells, self.lp_end = out
        return True

    def _fill_device(self) -> None:
        """Kernel (d) on the band of the mask (ops/siblingdp.py): each
        row's hull from the mask, the band's inputs up in one copy, the
        filled band and lp_end back in one; `cells` is then a BandCells
        (-inf outside the band, as outside the mask).  On the CPU the band
        entry's plain version."""
        from historian_tpu_torch.ops import branchdp, siblingdp

        lo, hi = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(self.mask)))
        layout = branchdp.band_layout(lo, hi, self.x_size, self.y_size)
        inp = siblingdp.upload_band(layout, self.match_emit, self.mask, self.l_emit,
                                    self.r_emit, siblingdp.transition_table(self),
                                    devmod.current())
        self.cells, self.lp_end = siblingdp.read_band(*siblingdp.sibling_fill_band(inp), layout)

    def _fill_host(self) -> None:
        t = self.t
        sx, sy = self.x_size, self.y_size
        cells = np.full((sx, sy, N_STATES), NEG)
        cells[0, 0, IMM] = 0.0  # start (SSS aliases IMM)
        cells[0, 0, WWW] = t[(IMM, WWW)]
        with np.errstate(divide="ignore", invalid="ignore"):
            for x in range(sx):
                for y in range(sy):
                    if not self.mask[x, y]:
                        continue
                    dest = cells[x, y]
                    if x > 0 and self.mask[x - 1, y]:
                        l_src = cells[x - 1, y]
                        le = self.l_emit[x - 1]
                        dest[IIW] = le + logsumexp(
                            [l_src[IMM] + t[(IMM, IIW)], l_src[IMI] + t[(IMI, IIW)], l_src[IIW] + t[(IIW, IIW)]]
                        )
                        dest[IIX] = le + np.logaddexp(
                            l_src[IMD] + t[(IMD, IIX)], l_src[IIX] + t[(IIX, IIX)]
                        )
                        dest[IMD] = le + logsumexp(
                            [l_src[WWW] + t[(WWW, IMD)], l_src[WWX] + t[(WWX, IMD)],
                             l_src[WXW] + t[(WXW, IMD)], l_src[IDD] + t[(IDD, IMD)]]
                        )
                        dest[WWW] = dest[IIW] + t[(IIW, WWW)]
                        dest[WWX] = np.logaddexp(
                            dest[IIX] + t[(IIX, WWX)], dest[IMD] + t[(IMD, WWX)]
                        )
                    if y > 0 and self.mask[x, y - 1]:
                        r_src = cells[x, y - 1]
                        ren = self.r_emit[y - 1]
                        dest[IMI] = ren + np.logaddexp(
                            r_src[IMM] + t[(IMM, IMI)], r_src[IMI] + t[(IMI, IMI)]
                        )
                        dest[IDI] = ren + np.logaddexp(
                            r_src[IDM] + t[(IDM, IDI)], r_src[IDI] + t[(IDI, IDI)]
                        )
                        dest[IDM] = ren + logsumexp(
                            [r_src[WWW] + t[(WWW, IDM)], r_src[WWX] + t[(WWX, IDM)],
                             r_src[WXW] + t[(WXW, IDM)], r_src[IDD] + t[(IDD, IDM)]]
                        )
                        dest[WWW] = np.logaddexp(dest[WWW], dest[IMI] + t[(IMI, WWW)])
                        dest[WXW] = np.logaddexp(
                            dest[IDI] + t[(IDI, WXW)], dest[IDM] + t[(IDM, WXW)]
                        )
                    if x > 0 and y > 0 and self.mask[x - 1, y - 1]:
                        lr_src = cells[x - 1, y - 1]
                        dest[IMM] = self.match_emit[x, y] + logsumexp(
                            [lr_src[WWW] + t[(WWW, IMM)], lr_src[WWX] + t[(WWX, IMM)],
                             lr_src[WXW] + t[(WXW, IMM)], lr_src[IDD] + t[(IDD, IMM)]]
                        )
                        dest[WWW] = np.logaddexp(dest[WWW], dest[IMM] + t[(IMM, WWW)])
                    if (x, y) == (0, 0):
                        dest[IMM] = 0.0
                        dest[WWW] = t[(IMM, WWW)]
                    dest[IDD] = logsumexp(
                        [dest[WWW] + t[(WWW, IDD)], dest[WWX] + t[(WWX, IDD)], dest[WXW] + t[(WXW, IDD)]]
                    )
        self.cells = cells
        end = cells[sx - 1, sy - 1]
        self.lp_end = float(
            logsumexp(
                [end[IDD] + t[(IDD, EEE)], end[WWW] + t[(WWW, EEE)],
                 end[WWX] + t[(WWX, EEE)], end[WXW] + t[(WXW, EEE)]]
            )
        )

    # ------------------------------------------------------------- traceback
    @staticmethod
    def get_state(src: int, l_ungapped: bool, r_ungapped: bool, p_ungapped: bool) -> int:
        if p_ungapped:
            return IMM if l_ungapped and r_ungapped else (IMD if l_ungapped else (IDM if r_ungapped else IDD))
        if l_ungapped:
            return IIX if src in (IMD, IIX) else IIW
        if r_ungapped:
            return IDI if src in (IDM, IDI) else IMI
        if src in (IDM, IDD, IDI):
            return WXW
        if src in (IMD, IIX):
            return WWX
        return WWW

    @staticmethod
    def _column(state: int, x: int, y: int):
        l = r = p = False
        if state == IMM:
            if x > 0 and y > 0:
                l = r = p = True
        elif state == IMD:
            p = l = True
        elif state == IDM:
            p = r = True
        elif state == IDD:
            p = True
        elif state in (IIW, IIX):
            if x > 0:
                l = True
        elif state in (IMI, IDI):
            if y > 0:
                r = True
        return l, r, p

    def lp_emit(self, x: int, y: int, state: int) -> float:
        if state == IMM:
            return self.match_emit[x, y] if (x > 0 and y > 0) else NEG
        if state in (IDM, IMI, IDI):
            return self.r_emit[y - 1] if y > 0 else NEG
        if state in (IMD, IIW, IIX):
            return self.l_emit[x - 1] if x > 0 else NEG
        return 0.0

    def sample(self, rng: MT19937) -> AlignPath:
        x, y, state = self.x_size - 1, self.y_size - 1, EEE
        l_path: list[bool] = []
        r_path: list[bool] = []
        p_path: list[bool] = []
        idd_p = self.idd_self_loop_prob()
        while x > 0 or y > 0:
            l, r, p = self._column(state, x, y) if state != EEE else (False, False, False)
            if l or r or p:
                l_path.append(l)
                r_path.append(r)
                p_path.append(p)
            if state == IDD:
                # geometric number of IDD self-loops (std::geometric_distribution)
                u = rng.uniform()
                n_loops = int(math.floor(math.log1p(-u) / math.log(idd_p))) if idd_p > 0 else 0
                for _ in range(n_loops):
                    l_path.append(l)
                    r_path.append(r)
                    p_path.append(p)
            sx = x - 1 if l else x
            sy = y - 1 if r else y
            if state == EEE:
                sx, sy = x, y
            e = self.lp_emit(x, y, state) if state != EEE else 0.0
            cands = {}
            for s in range(N_STATES):
                cands[s] = self.cells[sx, sy, s] + self.t[(s, state)] + e
            state = self._sample_state(cands, rng)
            x, y = sx, sy
        l_path.reverse()
        r_path.reverse()
        p_path.reverse()
        return {
            self.l_row: np.array(l_path, dtype=bool),
            self.r_row: np.array(r_path, dtype=bool),
            self.p_row: np.array(p_path, dtype=bool),
        }

    @staticmethod
    def _sample_state(cands: dict, rng: MT19937) -> int:
        items = sorted(cands.items())
        lpmax = max(v for _, v in items)
        if lpmax == NEG:
            raise RuntimeError("traceback state has zero probability")
        weights = [math.exp(v - lpmax) for _, v in items]
        total = sum(weights)
        p = rng.uniform(0, total)
        for (s, _), w in zip(items, weights):
            p -= w
            if p <= 0:
                return s
        return items[-1][0]

    def log_post_prob(self, lrp_path: AlignPath) -> float:
        cols = align_path_columns(lrp_path)
        lp = 0.0
        x = y = 0
        state = SSS
        lr = np.asarray(lrp_path[self.l_row], dtype=bool)
        rr = np.asarray(lrp_path[self.r_row], dtype=bool)
        pr = np.asarray(lrp_path[self.p_row], dtype=bool)
        for col in range(cols):
            dl, dr, dp = bool(lr[col]), bool(rr[col]), bool(pr[col])
            if dl:
                x += 1
            if dr:
                y += 1
            prev = state
            state = self.get_state(prev, dl, dr, dp)
            if not self.mask[x, y]:
                return NEG
            lp += self.lp_trans_elim_wait(prev, state) + self.lp_emit(x, y, state)
            lp = min(lp, float(self.cells[x, y, state]))
        lp += self.lp_trans_elim_wait(state, EEE)
        lp = min(lp, self.lp_end)
        return lp - self.lp_end

    def parent_seq(self, lrp_path: AlignPath) -> np.ndarray:
        """Parent PWM = normalized product of child messages
        (sampler.cpp:1576-1606)."""
        lr = np.asarray(lrp_path[self.l_row], dtype=bool)
        rr = np.asarray(lrp_path[self.r_row], dtype=bool)
        pr = np.asarray(lrp_path[self.p_row], dtype=bool)
        c, a = self.model.components, self.model.alphabet_size
        sel = np.nonzero(pr)[0]
        if not len(sel):
            return np.zeros((0, c, a))
        # note: position counters advance only within parent-emitting columns,
        # exactly as in the reference (sampler.cpp:1583-1594)
        l_here = lr[sel]
        r_here = rr[sel]
        l_idx = np.cumsum(l_here) - 1
        r_idx = np.cumsum(r_here) - 1
        prof = np.zeros((len(sel), c, a))
        if np.any(l_here):
            prof[l_here] += self.l_sub[l_idx[l_here]]
        if np.any(r_here):
            prof[r_here] += self.r_sub[r_idx[r_here]]
        # one batched scipy call: bit-identical per column to the
        # reference's per-column logsumexp normalization
        return prof - logsumexp_nd(prof, axis=(1, 2), keepdims=True)
