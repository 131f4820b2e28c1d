"""Transducer-composition Forward/Backward DP over profile pairs.

The port's copy of historian_tpu/engine/forward.py: compose two child
profiles through the two-branch PairHMM, in a banded envelope, producing
the ancestral profile by stochastic/best traceback and chain-collapsed
state selection, plus posterior-expected event counts (reference
forward.h:11-227, forward.cpp).

- cells live in one dense [Sx, Sy, 5] float64 array with an envelope
  mask; out-of-band cells are -inf, matching sparse-storage semantics;
- emission scores are precomputed for ALL states at once: insx/rootsubx
  as [S] vectors and the xy-absorb matrix as a single exp-space matmul
  over [Sx, C*A] x [C*A, Sy];
- the host fill vectorizes whole y-rows per x-state: x-edge
  contributions are numpy vector ops + a segment logaddexp over the flat
  y-edge list; only the within-row (y-direction) recursion walks
  sequentially.

A merge fills in one of three ways, tried in order:

- `_fill_device`: every chain-x merge fills on the selected device (K1
  or K2 of ops/devicedp.py on the card, their plain PyTorch versions on
  the CPU).  A merge whose traces alone are wanted (`defer_cells`, no
  `sumprod`) keeps its planes there and walks them there (the resident
  route); a merge whose whole band the host reads (the BackwardMatrix,
  counts) gets its in-envelope cells back in one copy and then runs on
  the host like a host fill (the full-band route, in float64: see
  `device.FULLBAND_DTYPE`);
- `_fill_native`: the native host fill (csrc/fill.cpp), for merges whose
  x is not a chain (a sampled or posterior profile: the JAX package
  keeps DAG x DAG merges on the host by default) or with an empty
  profile; their traces are walked on the host (`sample_trace`,
  `best_trace`);
- the python fill below, when the native runtime is off.

`FILLS` counts the fills on each route.  Every route's sampled traces
take the run's mt19937 draws in the reference's order.  The JAX
package's fill router (its dispatch probes, host-rate bookkeeping, the
cost model `merge_on_device` and the mesh-sharded `_fill_sp`) is not
ported: on the device, every chain-x merge fills there.  Graph surgery
(profile construction, chain collapse) and the BackwardMatrix stay on
the host.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.special import logsumexp

from historian_tpu_torch import device as devmod
from historian_tpu_torch.core.alignpath import (
    AlignPath,
    GuideAlignmentEnvelope,
    align_path_concat,
    align_path_union,
    ensure_align_path_has_row,
)
from historian_tpu_torch.core.tree import Tree
from historian_tpu_torch.engine import bufpool
from historian_tpu_torch.engine.pairhmm import EEE, IDM, IIW, IMD, IMI, IMM, PairHMM, state_name
from historian_tpu_torch.engine.profile import (
    ProfState,
    ProfTrans,
    Profile,
    _cpp_to_string,
    assert_seq_coords_consistent,
)
from historian_tpu_torch.models.counts import EigenCounts
from historian_tpu_torch.native import (
    csr_in_edges,
    csr_in_edges_idx,
    csr_out_edges,
    get_native,
)
from historian_tpu_torch.ops import devicedp
from historian_tpu_torch.utils.logging import ProgressLogger, log_this_at
from historian_tpu_torch.utils.rng import MT19937

NEG_INF = -np.inf

#: fills of ForwardMatrix by route (`ForwardMatrix.route`), band-doubling
#: retries included: "device" (K1 or K2 with the planes kept resident, and
#: the walker), "fullband" (K1 or K2, the band read back to the host),
#: "host" (csrc/fill.cpp, or the python fill) or "oversized" (a chain-x
#: merge too large for the card, filled on the host as a "host" fill); the
#: last three walk on the host
FILLS = {"device": 0, "fullband": 0, "host": 0, "oversized": 0}
#: sampled traces walked on each route, and the mt19937 uniforms that
#: sample_profile consumed for them
SAMPLED = {"device_walks": 0, "host_walks": 0, "draws": 0}

# ProfilingStrategy flags (reference forward.h:42-46)
KEEP_ALL = 0
COLLAPSE_CHAINS = 1
COUNT_SUBST_EVENTS = 2
COUNT_INDEL_EVENTS = 4
INCLUDE_BEST_TRACE = 8
KEEP_GAPS_OPEN = 16


def _profile_token_columns(profile: Profile, alphabet, n_nodes: int) -> np.ndarray:
    """[n_states, n_nodes] int32 token matrix of every state's alignment
    column: -1 = gap (row absent from the column), -2 = wildcard/invalid
    ('*' ancestor rows), >=0 = alphabet token.  Memoized on the profile --
    count extraction requests these columns for every posterior cell."""
    cached = profile.__dict__.get("_token_columns")
    if cached is not None and cached.shape[1] == n_nodes:
        return cached
    toks = alphabet.tokenize_bytes(np.arange(256, dtype=np.uint8))
    lut = np.where(toks >= 0, toks, -2).astype(np.int32)
    lut[ord("-")] = -1
    lut[ord(".")] = -1
    out = np.full((len(profile.states), n_nodes), -1, dtype=np.int32)
    for s in range(len(profile.states)):
        for row, ch in profile.align_column(s).items():
            out[s, row] = lut[ord(ch)]
    profile.__dict__["_token_columns"] = out
    return out


def _edge_arrays(profile: Profile):
    """Per-state in-edge arrays: (srcs[j], lps[j]) lists of numpy arrays."""
    srcs = []
    lps = []
    for st in profile.states:
        srcs.append(np.array([profile.trans[t].src for t in st.in_trans], dtype=np.int64))
        lps.append(np.array([profile.trans[t].lp for t in st.in_trans]))
    return srcs, lps


def _emit_row(rows: np.ndarray, state: int) -> int:
    """rows[state], the state's row among the emit states; -1 marks a
    state that emits nothing, and looking one up is a fault."""
    r = int(rows[state])
    if r < 0:
        raise IndexError(f"state {state} emits nothing: it has no absorb row")
    return r


def _lse_rows(*rows):
    out = rows[0]
    for r in rows[1:]:
        out = np.logaddexp(out, r)
    return out


def _subbed_absorb(profile: Profile, sub_mats: np.ndarray):
    """Array form of the reference's leftMultiply (profile.cpp:78-91):
    returns (emit_idx [E] int64, raw [E, C, A], subbed [E, C, A]) with
    subbed = log(subMat @ exp(raw)), same max-shift formulation (and so
    bit-identical values) as Profile.left_multiply -- without copying
    the profile's states, transitions, and metadata per merge."""
    emit_idx = profile.emit_state_indices()
    C = profile.components
    A = profile.alph_size
    if not len(emit_idx):
        z = np.zeros((0, C, A))
        return emit_idx, z, z
    raw = np.stack([profile.states[i].lp_absorb for i in emit_idx])  # [E, C, A]
    mx = raw.max(axis=2, keepdims=True)
    safe_mx = np.where(np.isfinite(mx), mx, 0.0)
    p = np.exp(raw - safe_mx)
    with np.errstate(divide="ignore"):
        subbed = np.log(np.einsum("cad,ecd->eca", sub_mats, p)) + safe_mx
    return emit_idx, raw, subbed


def _affine_chain(u_prev: float, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve u[k] = a[k] lse (u[k-1] + b[k]) with u[-1] = u_prev, vectorized:
    with B = cumsum(b), v[k] = u[k] - B[k] satisfies v[k] = (a[k]-B[k]) lse
    v[k-1], i.e. a running logaddexp."""
    B = np.cumsum(b)
    vals = np.concatenate([[u_prev], a - B])
    v = np.logaddexp.accumulate(vals)[1:]
    return v + B


class DPMatrix:
    #: bufpool role for the cell tensor; distinct per subclass so a
    #: forward and a backward matrix can be alive at the same time
    _pool_role = "dp-cells"

    def __init__(self, x: Profile, y: Profile, hmm: PairHMM, env: GuideAlignmentEnvelope | None = None, share_from: "DPMatrix | None" = None):
        self.x = x
        self.y = y
        self.hmm = hmm
        self.env = env or GuideAlignmentEnvelope()
        self.alph_size = hmm.alphabet_size
        self.x_size = x.size
        self.y_size = y.size
        self.x_empty = x.is_empty()
        self.y_empty = y.is_empty()

        if share_from is not None:
            # reuse the sibling matrix's precomputed emission/envelope
            # tensors (identical inputs -> identical values); only the
            # cell storage below is per-matrix
            for attr in (
                "subx_idx", "subx_lp", "_subx_row",
                "suby_idx", "suby_lp", "_suby_row",
                "x_null", "y_null", "x_ready", "y_ready",
                "x_emit_or_start", "insx", "rootsubx", "insy", "rootsuby",
                "_absorb", "_absorb_factors",
                "x_closest_pos", "y_closest_pos", "x_near_start",
                "y_near_end", "env_mask", "env_mask_u8",
            ):
                setattr(self, attr, getattr(share_from, attr))
            self.cells = None
            self.lp_end = NEG_INF
            self._trace_cache = {}
            return

        # precomputed emission tensors.  The subbed absorbs (reference
        # leftMultiply, profile.cpp:78-91) live as ARRAYS [E, C, A]
        # indexed by emit-state row, not as copied Profile objects: the
        # old per-merge shallow profile copies were ~0.4 s of pure
        # object churn on 6k-state merges (round-5 long12 profile).
        sub_l = hmm.l.sub_mat  # [C, A, A]
        sub_r = hmm.r.sub_mat
        self.subx_idx, raw_x, self.subx_lp = _subbed_absorb(x, sub_l)
        self.suby_idx, raw_y, self.suby_lp = _subbed_absorb(y, sub_r)
        self._subx_row = np.full(self.x_size, -1, dtype=np.int64)
        self._subx_row[self.subx_idx] = np.arange(len(self.subx_idx))
        self._suby_row = np.full(self.y_size, -1, dtype=np.int64)
        self._suby_row[self.suby_idx] = np.arange(len(self.suby_idx))

        self.x_null = np.array([s.is_null for s in x.states])
        self.y_null = np.array([s.is_null for s in y.states])
        self.x_ready = np.array([s.is_ready for s in x.states])
        self.y_ready = np.array([s.is_ready for s in y.states])
        self.x_emit_or_start = np.array([s.is_emit_or_start for s in x.states])

        # per-state emission scores, vectorized over all emit states at once
        logl, logr = hmm.logl, hmm.logr

        def emit_scores(raw, subbed, emit_idx, log_wins, log_root, size):
            ins = np.full(size, NEG_INF)
            rootsub = np.full(size, NEG_INF)
            if len(emit_idx):
                ins[emit_idx] = logsumexp(raw + log_wins[None, :, :], axis=(1, 2))
                rootsub[emit_idx] = logsumexp(subbed + log_root[None, :, :], axis=(1, 2))
            return ins, rootsub

        self.insx, self.rootsubx = emit_scores(
            raw_x, self.subx_lp, self.subx_idx,
            logl.log_cpt_weight[:, None] + logl.log_ins_prob, hmm.log_root, self.x_size
        )
        self.insy, self.rootsuby = emit_scores(
            raw_y, self.suby_lp, self.suby_idx,
            logr.log_cpt_weight[:, None] + logr.log_ins_prob, hmm.log_root, self.y_size
        )

        # xy-absorb matrix: lse_{c,a}(logRoot + subx_i + suby_j) for all (i, j)
        # as an exp-space matmul with per-state max shifts (MXU-shaped work).
        # LAZY (see the `absorb` property): device-resident merges derive
        # emission on device from the O(L*CA) factors and never read the
        # dense host matrix -- a 6144^2 merge's is 300 MB / ~0.7 s.
        self._absorb: np.ndarray | None = None
        self._absorb_factors = None

        # envelope coordinates
        self.x_closest_pos = np.zeros(self.x_size, dtype=np.int64)
        self.y_closest_pos = np.zeros(self.y_size, dtype=np.int64)
        if self.env.initialized:
            for i in range(1, self.x_size):
                self.x_closest_pos[i] = x.states[i].seq_coords[self.env.row1]
            for j in range(1, self.y_size):
                self.y_closest_pos[j] = y.states[j].seq_coords[self.env.row2]

        self.x_near_start = np.zeros(self.x_size, dtype=bool)
        self.x_near_start[0] = True
        for i in range(self.x_size):
            if self.x_near_start[i]:
                for t in x.states[i].null_out:
                    self.x_near_start[x.trans[t].dest] = True
        self.y_near_end = np.zeros(self.y_size, dtype=bool)
        for t in y.end.in_trans:
            self.y_near_end[y.trans[t].src] = True

        self.env_mask_u8 = self._envelope_mask()  # [Sx, Sy] uint8, pooled
        self.env_mask = self.env_mask_u8.view(bool)
        # allocated by the fill paths: the native forward fill writes every
        # cell itself, so it takes uninitialized storage; all other paths
        # start from a -inf-filled tensor
        self.cells: np.ndarray | None = None
        self.lp_end = NEG_INF
        self._trace_cache: dict = {}  # dest -> (cells, weights, ptot, best)

    @property
    def absorb_factors(self):
        """O(S x CA) emission factors (ex, shift_x, ey, shift_y): the
        device route ships these and runs the exp-space matmul on the
        accelerator instead of uploading O(band) absorb values
        (ops/devicedp _factored_absorb)."""
        if self._absorb_factors is None:
            sx = np.full((self.x_size, self.hmm.components, self.alph_size), NEG_INF)
            sy = np.full((self.y_size, self.hmm.components, self.alph_size), NEG_INF)
            if len(self.subx_idx):
                sx[self.subx_idx] = self.subx_lp
            if len(self.suby_idx):
                sy[self.suby_idx] = self.suby_lp
            lx = sx + self.hmm.log_root[None, :, :]  # [Sx, C, A]
            mx = np.max(lx, axis=(1, 2), keepdims=True)
            my = np.max(sy, axis=(1, 2), keepdims=True)
            mx_s = np.where(np.isfinite(mx), mx, 0.0)
            my_s = np.where(np.isfinite(my), my, 0.0)
            ex = np.exp(lx - mx_s).reshape(self.x_size, -1)
            ey = np.exp(sy - my_s).reshape(self.y_size, -1)
            self._absorb_factors = (ex, mx_s[:, 0, 0], ey, my_s[:, 0, 0])
        return self._absorb_factors

    @property
    def absorb(self) -> np.ndarray:
        """Dense [Sx, Sy] xy-absorb matrix, computed on first access:
        lse_{c,a}(logRoot + subx_i + suby_j) as an exp-space matmul with
        per-state max shifts (MXU-shaped work).  Device-resident merges
        never touch it (a 6144^2 merge's is 300 MB / ~0.7 s host time)."""
        if self._absorb is None:
            ex, shift_x, ey, shift_y = self.absorb_factors
            # pooled output + in-place left-fold: same operation order as
            # log(ex@ey.T) + mx + my, so bitwise-identical results
            out = bufpool.get("absorb", (self.x_size, self.y_size), self)
            np.matmul(ex, ey.T, out=out)
            with np.errstate(divide="ignore"):
                np.log(out, out=out)
            out += shift_x[:, None]
            out += shift_y[None, :]
            self._absorb = out
        return self._absorb

    def _envelope_mask(self) -> np.ndarray:
        """Envelope mask as a pooled uint8 [Sx, Sy] tensor.

        The native path writes it in one fused parallel pass; the numpy
        broadcast path allocates several grid-size temporaries, which is
        expensive on hosts with slow first-touch page faults."""
        out = bufpool.get("env-mask", (self.x_size, self.y_size), self, dtype=np.uint8)
        if not self.env.initialized:
            self.env_vectors = None  # mask is all-True
            out.fill(1)
            return out
        m1 = np.ascontiguousarray(
            self.env.cumulative_matches[self.env.row1_pos_to_col[self.x_closest_pos]],
            dtype=np.int64,
        )
        m2 = np.ascontiguousarray(
            self.env.cumulative_matches[self.env.row2_pos_to_col[self.y_closest_pos]],
            dtype=np.int64,
        )
        # the mask in factored O(L) form, for device routes that rebuild
        # it on-chip instead of shipping O(band) indices (ops/devicedp)
        self.env_vectors = (m1, m2, int(self.env.max_distance))
        lib = get_native()
        if lib is not None:
            lib.envelope_mask(
                self.x_size, self.y_size, m1, m2,
                int(self.env.max_distance),
                np.ascontiguousarray(self.x_near_start).view(np.uint8),
                np.ascontiguousarray(self.y_near_end).view(np.uint8),
                out,
            )
            return out
        at_edge = self.x_near_start[:, None] | self.y_near_end[None, :]
        in_range = np.abs(m1[:, None] - m2[None, :]) <= self.env.max_distance
        np.copyto(out, (at_edge | in_range).view(np.uint8))
        return out

    # ----------------------------------------------------------------- helpers
    def in_envelope(self, i: int, j: int) -> bool:
        return bool(self.env_mask[i, j])

    def cell(self, i: int, j: int, s: int) -> float:
        return self.cells[i, j, s]

    def cell_name(self, c) -> str:
        i, j, s = c
        return f"({state_name(s, i == 0, j == 0)},{self.x.states[i].name},{self.y.states[j].name})"

    def is_absorbing(self, c) -> bool:
        i, j, s = c
        return (
            (s == IMM and not self.x_null[i] and not self.y_null[j])
            or (s == IMD and not self.x_null[i])
            or (s == IDM and not self.y_null[j])
        )

    def changes_x(self, c) -> bool:
        i, j, s = c
        return (
            (s == IMM and (self.x_null[i] or not self.y_null[j]))
            or s in (IMD, IIW, EEE)
        )

    def changes_y(self, c) -> bool:
        i, j, s = c
        return (s == IMM and self.x_emit_or_start[i]) or s in (IDM, IMI, EEE)

    def equiv_absorb_cells(self, c) -> list:
        i, j, s = c
        if s == IIW and not self.x_null[i]:
            return [(i, j, IMD)]
        if s == IMI and not self.y_null[j]:
            return [(i, j, IDM)]
        if self.changes_x(c) and self.x_null[i] and i in self.x.equiv_absorb_state:
            return [(self.x.equiv_absorb_state[i], j, IMD)]
        if self.changes_y(c) and self.y_null[j] and j in self.y.equiv_absorb_state:
            return [(i, self.y.equiv_absorb_state[j], IDM)]
        return []

    def lp_cell_emit_or_absorb(self, c) -> float:
        i, j, s = c
        if s == IMD and not self.x_null[i]:
            return self.rootsubx[i]
        if s == IIW and not self.x_null[i]:
            return self.insx[i]
        if s == IDM and not self.y_null[j]:
            return self.rootsuby[j]
        if s == IMI and not self.y_null[j]:
            return self.insy[j]
        if s == IMM and not self.x_null[i] and not self.y_null[j]:
            return self.absorb[i, j]
        return 0.0

    def sample_cell(self, cell_lp: dict, rng: MT19937):
        """Reference sampleCell: normalize by max, draw uniform, walk in
        CellCoords order (forward.cpp:225-243)."""
        items = sorted(cell_lp.items())
        lpmax = max(lp for _, lp in items)
        weights = [np.exp(lp - lpmax) for _, lp in items]
        ptot = sum(weights)
        p = rng.uniform(0, ptot)
        for (c, _), w in zip(items, weights):
            p -= w
            if p <= 0:
                return c
        raise RuntimeError(f"sample_cell failed (ptot={ptot})")

    @staticmethod
    def best_cell(cell_lp: dict):
        assert cell_lp, "traceback failure: no source cells"
        best, best_lp = None, NEG_INF
        for c, lp in sorted(cell_lp.items()):
            if lp > best_lp:
                best, best_lp = c, lp
        return best


class ForwardMatrix(DPMatrix):
    _pool_role = "fwd-cells"

    def __init__(self, x, y, hmm, parent_row: int, env=None, sumprod=None,
                 defer_cells: bool = False):
        super().__init__(x, y, hmm, env)
        self.parent_row = parent_row
        self.sumprod = sumprod  # SumProductEngine over the subtree (counts)
        self.x_insert_counts: dict[int, EigenCounts] = {}
        self.y_insert_counts: dict[int, EigenCounts] = {}
        self._cell_counts: dict = {}  # absorbing cell -> EigenCounts
        #: defer_cells: the caller will only sample/best-trace profiles, so
        #: the fill may stay device-resident (ops/devicedp.DeviceTraceFill)
        #: with tracebacks walked on device; cells stays None unless a
        #: full-band consumer calls ensure_cells()
        self._defer_cells = defer_cells
        self._trace_handle = None
        self._trace_values: dict = {}
        self._fill()

    #: lp_end is a plain attribute on every path except the device-
    #: resident one, where it stays lazy so a caller can dispatch a whole
    #: tree level of fills before blocking on any one end-gather
    #: (recon.py level pipeline)
    @property
    def lp_end(self) -> float:
        if self._lp_end is None:
            self._lp_end = self._trace_handle.lp_end
        return self._lp_end

    @lp_end.setter
    def lp_end(self, v) -> None:
        self._lp_end = v

    def dispatch_lp_end(self) -> None:
        """Enqueue the device end-gather without blocking (no-op unless
        the fill is device-resident)."""
        if self._lp_end is None:
            self._trace_handle.dispatch_lp_end()

    def _trans18(self) -> np.ndarray:
        h = self.hmm
        return np.array(
            [h.imm_imm, h.imm_imd, h.imm_idm, h.imm_imi, h.imm_iiw,
             h.imd_imm, h.imd_imd, h.imd_idm,
             h.idm_imm, h.idm_imd, h.idm_idm,
             h.imi_imm, h.imi_imd, h.imi_imi, h.imi_iiw,
             h.iiw_imm, h.iiw_idm, h.iiw_iiw]
        )

    def _fill_device(self) -> bool:
        """The fill on the selected device, for every merge whose x is a
        chain (every leaf merge, every `-fast` merge, and a chain x against
        a sampled or posterior y).  With `defer_cells` and no `sumprod`,
        the planes stay on the device, tracebacks are walked there, and
        only the visited cells come back (`_device_traces`); otherwise the
        band comes back to the host grid in one copy and the merge goes on
        as a host fill (the JAX package's `col_forward_cells` and
        `chain_forward_cells`).  False for an empty profile, which has no
        grid, and for an x that is not a chain, as the JAX package routes
        DAG x DAG merges by default: the merge then fills on the host and
        walks there.  False too for a merge that does not fit the card
        (`devicedp.merge_fits`), which then fills on the host as the JAX
        package's does past its device budget (route "oversized")."""
        if self.x_empty or self.y_empty or self.x.as_chain() is None:
            return False
        dev = devmod.current()
        resident = self._defer_cells and self.sumprod is None
        dtype = devmod.fill_dtype(dev) if resident else devmod.FULLBAND_DTYPE
        if not devicedp.merge_fits(self, dev, dtype):
            log_this_at(1, f"merge of {self.x_size - 1} x {self.y_size - 1} cells does not fit "
                           f"{dev}: filled on the host")
            self.route = "oversized"
            return False
        self.start_cell = (0, 0, IMM)
        self.end_cell = (self.x_size - 1, self.y_size - 1, EEE)
        if resident:
            self.route = "device"
            self._trace_handle = devicedp.col_forward_device(self, dev, dtype)
            self.cells = None
            self._lp_end = None  # lazy: the handle's end gather on first access
            return True
        self.route = "fullband"
        self.cells = self._empty_cells()
        devicedp.col_forward_cells(self, dev, dtype, self.cells)
        self._finish_fill()
        return True

    def _empty_cells(self) -> np.ndarray:
        """The pooled host grid [x_size, y_size, 5], every cell -inf."""
        cells = bufpool.get(self._pool_role, (self.x_size, self.y_size, 5), self)
        cells.fill(NEG_INF)
        return cells

    def _fill_native(self) -> bool:
        """Run the fill through the native host runtime; False if unavailable."""
        lib = get_native()
        if lib is None:
            return False
        self.cells = bufpool.get(self._pool_role, (self.x_size, self.y_size, 5), self)
        x_ptr, x_src, x_lp = csr_in_edges(self.x)
        y_ptr, y_src, y_lp = csr_in_edges(self.y)
        lib.forward_fill(
            self.x_size, self.y_size,
            x_ptr, x_src, x_lp, y_ptr, y_src, y_lp,
            self.x_null.astype(np.uint8), self.y_null.astype(np.uint8),
            self.x_ready.astype(np.uint8), self.y_ready.astype(np.uint8),
            self.x_emit_or_start.astype(np.uint8),
            np.uint8(self.x_empty), np.uint8(self.y_empty),
            self.insx, self.rootsubx, self.insy, self.rootsuby,
            np.ascontiguousarray(self.absorb), self.env_mask_u8,
            self._trans18(), self.cells,
        )
        self._finish_fill()
        return True

    def _finish_fill(self) -> None:
        """End-transition gather into lp_end (shared by both fill paths)."""
        hmm = self.hmm
        x, y = self.x, self.y
        cells = self.cells
        lp_end = NEG_INF
        for xt in x.end.in_trans:
            x_trans = x.trans[xt]
            for yt in y.end.in_trans:
                y_trans = y.trans[yt]
                src = cells[x_trans.src, y_trans.src]
                lp_end = np.logaddexp(
                    lp_end,
                    _lse_rows(
                        src[IMM] + hmm.imm_eee,
                        src[IMD] + hmm.imd_eee,
                        src[IDM] + hmm.idm_eee,
                        src[IMI] + hmm.imi_eee,
                        src[IIW] + hmm.iiw_eee,
                    )
                    + x_trans.lp
                    + y_trans.lp,
                )
        self.lp_end = float(lp_end)
        self.start_cell = (0, 0, IMM)
        self.end_cell = (self.x_size - 1, self.y_size - 1, EEE)

    # ------------------------------------------------------------------- fill
    def _fill(self) -> None:
        self.route = "host"
        filled = self._fill_device() or self._fill_native()
        FILLS[self.route] += 1
        if filled:
            return
        self.cells = self._empty_cells()
        hmm = self.hmm
        x, y = self.x, self.y
        sx, sy = self.x_size, self.y_size
        cells = self.cells
        cells[0, 0, IMM] = 0.0  # start

        x_in_src, x_in_lp = _edge_arrays(x)
        y_in_src, y_in_lp = _edge_arrays(y)
        # flat y-edge arrays for segment reductions
        flat_y_dest, flat_y_src, flat_y_lp = [], [], []
        for j in range(sy - 1):
            for t in y.states[j].in_trans:
                flat_y_dest.append(j)
                flat_y_src.append(y.trans[t].src)
                flat_y_lp.append(y.trans[t].lp)
        flat_y_dest = np.array(flat_y_dest, dtype=np.int64)
        flat_y_src = np.array(flat_y_src, dtype=np.int64)
        flat_y_lp = np.array(flat_y_lp)
        y_emit_flat = ~self.y_null[flat_y_dest] if len(flat_y_dest) else flat_y_dest.astype(bool)

        ready_y = self.y_ready[: sy - 1] | self.y_empty  # [Sy-1]
        y_null = self.y_null
        x_null = self.x_null

        # chain-emit y states: single in-edge from the previous index with
        # finite edge/emission scores -> the within-row IDM/IMI recurrence
        # vectorizes as an affine (log,+,lse) scan
        self._y_chain_emit = np.zeros(sy, dtype=bool)
        self._y_chain_lp = np.full(sy, NEG_INF)
        for jj in range(1, sy - 1):
            st = y.states[jj]
            if (
                st.is_emit
                and len(st.in_trans) == 1
                and y.trans[st.in_trans[0]].src == jj - 1
            ):
                lp_e = y.trans[st.in_trans[0]].lp
                if (
                    np.isfinite(lp_e)
                    and np.isfinite(self.rootsuby[jj])
                    and np.isfinite(self.insy[jj])
                ):
                    self._y_chain_emit[jj] = True
                    self._y_chain_lp[jj] = lp_e

        # per-j sequential lists (y in-edges)
        progress = ProgressLogger(f"Forward ({x.name} vs {y.name})", level=5)

        for i in range(sx - 1):
            progress.update(i / max(1, sx - 2), f"state {i + 1}/{sx}")
            mask_row = self.env_mask[i, : sy - 1]
            if not mask_row.any():
                continue
            imd_row = np.full(sy - 1, NEG_INF)
            iiw_row = np.full(sy - 1, NEG_INF)
            imm_row = np.full(sy - 1, NEG_INF)

            # --- x-direction contributions (all read rows < i) ------------
            if not x_null[i]:
                for xt, lp_xt in zip(x_in_src[i], x_in_lp[i]):
                    src = cells[xt, : sy - 1]  # [Sy-1, 5]
                    imd_row = np.logaddexp(
                        imd_row,
                        _lse_rows(
                            src[:, IMM] + hmm.imm_imd,
                            src[:, IMD] + hmm.imd_imd,
                            src[:, IDM] + hmm.idm_imd,
                            src[:, IMI] + hmm.imi_imd,
                        )
                        + lp_xt,
                    )
                    iiw_row = np.logaddexp(
                        iiw_row,
                        _lse_rows(
                            src[:, IMM] + hmm.imm_iiw,
                            src[:, IMI] + hmm.imi_iiw,
                            src[:, IIW] + hmm.iiw_iiw,
                        )
                        + lp_xt,
                    )
                imd_row = np.where(ready_y, imd_row + self.rootsubx[i], NEG_INF)
                iiw_row = np.where(ready_y, iiw_row + self.insx[i], NEG_INF)
            else:
                for xt, lp_xt in zip(x_in_src[i], x_in_lp[i]):
                    imd_row = np.logaddexp(imd_row, cells[xt, : sy - 1, IMD] + lp_xt)
                    iiw_row = np.logaddexp(iiw_row, cells[xt, : sy - 1, IIW] + lp_xt)
                imd_row = np.where(ready_y, imd_row, NEG_INF)
                iiw_row = np.where(ready_y, iiw_row, NEG_INF)

            # --- IMM contributions from x direction -----------------------
            both_emit = (~x_null[i]) & (~y_null[: sy - 1])
            if not x_null[i] and len(flat_y_dest):
                # xy-absorbing: segment-logaddexp over flat y edges per xt
                for xt, lp_xt in zip(x_in_src[i], x_in_lp[i]):
                    t_vals = _lse_rows(
                        cells[xt, :, IMM] + hmm.imm_imm,
                        cells[xt, :, IMD] + hmm.imd_imm,
                        cells[xt, :, IDM] + hmm.idm_imm,
                        cells[xt, :, IMI] + hmm.imi_imm,
                        cells[xt, :, IIW] + hmm.iiw_imm,
                    )  # [Sy] over y src states
                    sel = y_emit_flat
                    if sel.any():
                        vals = t_vals[flat_y_src[sel]] + flat_y_lp[sel] + lp_xt
                        acc = np.full(sy - 1, NEG_INF)
                        np.logaddexp.at(acc, flat_y_dest[sel], vals)
                        imm_row = np.logaddexp(imm_row, acc)
                imm_row = np.where(both_emit, imm_row + self.absorb[i, : sy - 1], NEG_INF)
            elif x_null[i]:
                acc = np.full(sy - 1, NEG_INF)
                for xt, lp_xt in zip(x_in_src[i], x_in_lp[i]):
                    acc = np.logaddexp(acc, cells[xt, : sy - 1, IMM] + lp_xt)
                imm_row = np.where(ready_y, acc, NEG_INF)
            # (x emit, y null) IMM handled in the sequential pass below

            if i == 0:
                imm_row[0] = 0.0  # keep the start cell

            cells[i, : sy - 1, IMD] = np.where(mask_row, imd_row, NEG_INF)
            cells[i, : sy - 1, IIW] = np.where(mask_row, iiw_row, NEG_INF)
            cells[i, : sy - 1, IMM] = np.where(mask_row, imm_row, NEG_INF)

            # --- sequential y pass: IDM, IMI, and IMM through null y ------
            # maximal runs of in-envelope chain-emit y states (single
            # in-edge from j-1) vectorize as (log,+,lse)-semiring affine
            # recurrences via cumsum + logaddexp.accumulate; other states
            # fall back to the per-state walk.
            x_ready_or_empty = self.x_ready[i] or self.x_empty
            j = 0
            chain_ok = self._y_chain_emit[: sy - 1] & mask_row
            while j < sy - 1:
                if chain_ok[j] and x_ready_or_empty and j > 0:
                    j1 = j
                    while j1 + 1 < sy - 1 and chain_ok[j1 + 1]:
                        j1 += 1
                    seg = slice(j, j1 + 1)
                    lp_edge = self._y_chain_lp[seg]
                    prev = cells[i, j - 1 : j1]  # rows j-1 .. j1-1, [n, 5]
                    # IDM: u[k] = a[k] lse (u[k-1] + b[k])
                    a_idm = (
                        _lse_rows(
                            prev[:, IMM] + hmm.imm_idm,
                            prev[:, IMD] + hmm.imd_idm,
                            prev[:, IIW] + hmm.iiw_idm,
                        )
                        + lp_edge
                        + self.rootsuby[seg]
                    )
                    b_idm = hmm.idm_idm + lp_edge + self.rootsuby[seg]
                    cells[i, seg, IDM] = _affine_chain(cells[i, j - 1, IDM], a_idm, b_idm)
                    # IMI: sources IMM (prev col) and IMI self
                    a_imi = prev[:, IMM] + hmm.imm_imi + lp_edge + self.insy[seg]
                    b_imi = hmm.imi_imi + lp_edge + self.insy[seg]
                    cells[i, seg, IMI] = _affine_chain(cells[i, j - 1, IMI], a_imi, b_imi)
                    j = j1 + 1
                    continue
                if not mask_row[j]:
                    j += 1
                    continue
                if not y_null[j]:
                    if x_ready_or_empty:
                        idm = imi = NEG_INF
                        for yt, lp_yt in zip(y_in_src[j], y_in_lp[j]):
                            src = cells[i, yt]
                            idm = np.logaddexp(
                                idm,
                                _lse_rows(
                                    src[IMM] + hmm.imm_idm,
                                    src[IMD] + hmm.imd_idm,
                                    src[IDM] + hmm.idm_idm,
                                    src[IIW] + hmm.iiw_idm,
                                )
                                + lp_yt,
                            )
                            imi = np.logaddexp(
                                imi,
                                np.logaddexp(src[IMM] + hmm.imm_imi, src[IMI] + hmm.imi_imi)
                                + lp_yt,
                            )
                        cells[i, j, IDM] = idm + self.rootsuby[j]
                        cells[i, j, IMI] = imi + self.insy[j]
                    j += 1
                    continue
                # y-null state: propagate IDM/IMI (and IMM when x emit/start)
                idm = imi = NEG_INF
                for yt, lp_yt in zip(y_in_src[j], y_in_lp[j]):
                    idm = np.logaddexp(idm, cells[i, yt, IDM] + lp_yt)
                    imi = np.logaddexp(imi, cells[i, yt, IMI] + lp_yt)
                cells[i, j, IDM] = idm
                cells[i, j, IMI] = imi
                if self.x_emit_or_start[i]:
                    imm = NEG_INF
                    for yt, lp_yt in zip(y_in_src[j], y_in_lp[j]):
                        imm = np.logaddexp(imm, cells[i, yt, IMM] + lp_yt)
                    cells[i, j, IMM] = imm if (i, j) != (0, 0) else 0.0
                j += 1

        self._finish_fill()

    # ------------------------------------------------- device-resident fills
    def ensure_cells(self) -> None:
        """Read the band of a device-resident fill into the host grid, for
        full-band consumers (BackwardMatrix, host traceback walks)."""
        if self.cells is not None or self._trace_handle is None:
            return
        cells = self._empty_cells()
        devicedp.read_band(self._trace_handle.planes, self, cells)
        self.cells = cells

    def _cell_value(self, c) -> float:
        """cells[c], answered from the device-trace readback when the
        fill never left the device (make_profile reads values only at
        retained trace cells)."""
        if self.cells is not None:
            return self.cells[c[0], c[1], c[2]]
        return self._trace_values[c]

    def _device_traces(self, n_samples: int, include_best: bool, rng) -> list:
        """Walk traces on device (ops/tracedp.py).  Returns host paths in
        the host layout: [(i, j, s), ..., end_cell], start->end, the best
        first.  Visited cell values land in _trace_values for make_profile.
        The sampled walks take the generator's next uniforms in order, as
        n_samples host walks would (a walk draws len(path) - 1 times), but
        the generator is not moved: the caller advances it by the draws of
        the walks it keeps."""
        uniforms = rng.uniforms_ahead(n_samples * self._trace_handle.n_steps_max) \
            if n_samples else None
        _, traces = self._trace_handle.lp_end_and_traces(n_samples, include_best, uniforms)
        out = []
        for cells_, vals in traces:
            path = [tuple(c) for c in cells_] + [self.end_cell]
            for c, v in zip(path, vals):
                self._trace_values[c] = float(v)
            out.append(path)
        return out

    # --------------------------------------------------------- source lookups
    def source_transitions_without_emit_or_absorb(self, dest) -> dict:
        """Reference sourceTransitionsWithoutEmitOrAbsorb (forward.cpp:326-398)."""
        i, j, s = dest
        x, y, hmm = self.x, self.y, self.hmm
        x_state = x.states[i]
        y_state = y.states[j]
        clp: dict = {}
        if s in (IMD, IIW):
            if x_state.is_null:
                if (y_state.is_ready or self.y_empty) and i < self.x_size - 1:
                    for t in x_state.in_trans:
                        clp[(x.trans[t].src, j, s)] = x.trans[t].lp
            elif y_state.is_ready or self.y_empty:
                for t in x_state.in_trans:
                    for src_s in PairHMM.sources(s):
                        clp[(x.trans[t].src, j, src_s)] = hmm.lp_trans(src_s, s) + x.trans[t].lp
        elif s in (IDM, IMI):
            if y_state.is_null:
                if j < self.y_size - 1:
                    for t in y_state.in_trans:
                        clp[(i, y.trans[t].src, s)] = y.trans[t].lp
            elif x_state.is_ready or self.x_empty:
                for t in y_state.in_trans:
                    for src_s in PairHMM.sources(s):
                        clp[(i, y.trans[t].src, src_s)] = hmm.lp_trans(src_s, s) + y.trans[t].lp
        elif s == IMM:
            if y_state.is_null and x_state.is_emit_or_start:
                if j < self.y_size - 1:
                    for t in y_state.in_trans:
                        clp[(i, y.trans[t].src, s)] = y.trans[t].lp
            elif x_state.is_null:
                if (y_state.is_ready or self.y_empty) and i < self.x_size - 1:
                    for t in x_state.in_trans:
                        clp[(x.trans[t].src, j, s)] = x.trans[t].lp
            elif not x_state.is_null and not y_state.is_null:
                for xt in x_state.in_trans:
                    for yt in y_state.in_trans:
                        for src_s in PairHMM.sources(s):
                            clp[(x.trans[xt].src, y.trans[yt].src, src_s)] = (
                                hmm.lp_trans(src_s, s) + x.trans[xt].lp + y.trans[yt].lp
                            )
        elif s == EEE:
            if i == self.x_size - 1 and j == self.y_size - 1:
                for xt in x.end.in_trans:
                    for yt in y.end.in_trans:
                        for src_s in PairHMM.sources(s):
                            clp[(x.trans[xt].src, y.trans[yt].src, src_s)] = (
                                hmm.lp_trans(src_s, s) + x.trans[xt].lp + y.trans[yt].lp
                            )
        else:
            raise ValueError(f"bad state {s}")
        return clp

    def source_transitions(self, dest) -> dict:
        clp = self.source_transitions_without_emit_or_absorb(dest)
        lp_abs = self.lp_cell_emit_or_absorb(dest)
        return {c: lp + lp_abs for c, lp in clp.items()}

    def source_cells(self, dest) -> dict:
        return {
            c: lp + self.cells[c[0], c[1], c[2]]
            for c, lp in self.source_transitions(dest).items()
        }

    # ------------------------------------------------------------- tracebacks
    def _trace_entry(self, dest):
        """Cached per-cell traceback distribution.

        The cells array is fixed once the fill completes, so the sorted
        candidate list, its exp-weights, the weight total, and the argmax
        depend only on `dest`; sampled paths overlap heavily, making this
        cache the traceback hot path.  The arithmetic mirrors sample_cell /
        best_cell exactly (same sort order, same float accumulation), so
        the mt19937 draw sequence -- and thus every sampled profile -- is
        bit-identical to the uncached walk.
        """
        self.ensure_cells()  # host walks need the full band
        cache = self._trace_cache
        entry = cache.get(dest)
        if entry is None:
            items = sorted(self.source_cells(dest).items())
            lpmax = max(lp for _, lp in items)
            weights = [np.exp(lp - lpmax) for _, lp in items]
            ptot = sum(weights)
            best, best_lp = None, NEG_INF
            for c, lp in items:
                if lp > best_lp:
                    best, best_lp = c, lp
            entry = ([c for c, _ in items], weights, ptot, best)
            cache[dest] = entry
        return entry

    def sample_trace(self, rng: MT19937) -> list:
        assert self.lp_end > NEG_INF, "Forward likelihood is zero; traceback fail"
        path = [self.end_cell]
        current = self.end_cell
        while True:
            cells_, weights, ptot, _ = self._trace_entry(current)
            p = rng.uniform(0, ptot)
            current = None
            for c, w in zip(cells_, weights):
                p -= w
                if p <= 0:
                    current = c
                    break
            if current is None:
                raise RuntimeError(f"sample_cell failed (ptot={ptot})")
            path.insert(0, current)
            if current[0] == 0 and current[1] == 0:
                break
        return path

    def best_trace(self, end=None, stop_at=None) -> list:
        """Best path from the start cell to `end`, in start->end order.

        `stop_at`: optional set of cells at which to truncate the walk.
        add_cells discards everything before the first already-retained
        cell anyway, so stopping there is exactly equivalent and skips
        re-walking shared trace prefixes (the postProbProfile hot path).
        """
        if end is None:
            assert self.lp_end > NEG_INF, "Forward likelihood is zero; traceback fail"
            end = self.end_cell
        path = [end]
        if (end[0] > 0 or end[1] > 0) and not (stop_at and end in stop_at):
            current = end
            while True:
                current = self._trace_entry(current)[3]
                path.append(current)
                if current[0] == 0 and current[1] == 0:
                    break
                if stop_at is not None and current in stop_at:
                    break
        path.reverse()
        return path

    def best_align_path(self) -> AlignPath:
        if self._trace_handle is not None:
            return self.trace_align_path(self._device_best_path())
        return self.trace_align_path(self.best_trace())

    # --------------------------------------------------------- cell -> paths
    def cell_seq_coords(self, c) -> dict[int, int]:
        coords = dict(self.x.states[c[0]].seq_coords)
        coords.update(self.y.states[c[1]].seq_coords)
        return coords

    def cell_align_path(self, c) -> AlignPath:
        i, j, s = c
        x_state, y_state = self.x.states[i], self.y.states[j]
        if s == IMM:
            if not x_state.is_null and not y_state.is_null:
                path = align_path_union(x_state.align_path, y_state.align_path)
            elif x_state.is_emit_or_start:
                path = dict(y_state.align_path)
            else:
                path = dict(x_state.align_path)
        elif s in (IMD, IIW):
            path = dict(x_state.align_path)
        elif s in (IDM, IMI):
            path = dict(y_state.align_path)
        elif s == EEE:
            path = {}
        else:
            raise ValueError(f"bad state {s}")
        if self.is_absorbing(c):
            prev = path.get(self.parent_row, np.zeros(0, dtype=bool))
            path[self.parent_row] = np.append(prev, True)
        return path

    def transition_align_path(self, src, dest) -> AlignPath:
        path: AlignPath = {}
        if src[0] != dest[0]:
            path = self.x.get_trans(src[0], dest[0]).align_path
        if src[1] != dest[1]:
            path = align_path_concat(path, self.y.get_trans(src[1], dest[1]).align_path)
        return path

    def trace_align_path(self, path: list) -> AlignPath:
        p: AlignPath = {}
        for n in range(len(path) - 1):
            cap = self.cell_align_path(path[n])
            tap = self.transition_align_path(path[n], path[n + 1])
            p = align_path_concat(p, cap, tap)
        p = align_path_concat(p, self.cell_align_path(path[-1]))
        ensure_align_path_has_row(p, self.parent_row)
        ensure_align_path_has_row(p, self.x.root_row)
        ensure_align_path_has_row(p, self.y.root_row)
        return p

    # --------------------------------------------------------------- counts
    def eliminated_lp_insert(self, c) -> float:
        i, j, s = c
        if s == IIW:
            return 0.0 if self.x_null[i] else self.insx[i]
        if s == IMI:
            return 0.0 if self.y_null[j] else self.insy[j]
        return 0.0

    def transition_eigen_counts(self, src, dest) -> EigenCounts:
        """Indel-event bookkeeping per transition (forward.cpp:579-652)."""
        c = EigenCounts()
        if src[0] != dest[0]:
            t = self.x.get_trans(src[0], dest[0])
            if t.counts is not None:
                c += t.counts
        if src[1] != dest[1]:
            t = self.y.get_trans(src[1], dest[1])
            if t.counts is not None:
                c += t.counts
        self._transition_indel_scalars(src, dest, c.indel, 1.0)
        return c

    def accumulate_transition_counts(self, acc: EigenCounts, src, dest, w: float) -> None:
        """acc += transition_eigen_counts(src, dest) * w, fused: the
        profile-transition count arrays are axpy'd directly into the
        accumulator and the indel scalars added inline, with no
        per-transition EigenCounts object or array temporaries (the
        get_counts posterior walk touches hundreds of thousands of
        transitions)."""
        if src[0] != dest[0]:
            t = self.x.get_trans(src[0], dest[0])
            if t.counts is not None:
                acc.add_scaled(t.counts, w)
        if src[1] != dest[1]:
            t = self.y.get_trans(src[1], dest[1])
            if t.counts is not None:
                acc.add_scaled(t.counts, w)
        self._transition_indel_scalars(src, dest, acc.indel, w)

    def _transition_indel_scalars(self, src, dest, ic, w: float) -> None:
        """Scalar indel-event bookkeeping for one transition
        (forward.cpp:579-652), scaled by w."""
        i, j, s = dest
        self._indel_scalars_cat(
            self.hmm, src[2], s, bool(self.x_null[i]), bool(self.y_null[j]), ic, w
        )

    @staticmethod
    def _indel_scalars_cat(hmm, ss: int, s: int, x_null: bool, y_null: bool, ic, w: float) -> None:
        """The same bookkeeping keyed by its actual inputs -- (src state,
        dest state, x_null[dest.i], y_null[dest.j]) -- so natively pooled
        per-category weights apply it once per category."""
        if s == IMM:
            if not x_null and not y_null:
                if ss in (IMM, IMD):
                    ic.ins_time += hmm.l.t * w
                    ic.del_time += hmm.l.t * w
                if ss in (IMM, IDM):
                    ic.ins_time += hmm.r.t * w
                    ic.del_time += hmm.r.t * w
        elif s == IMD:
            if not x_null:
                if ss in (IMM, IMD):
                    ic.ins_time += hmm.l.t * w
                    ic.del_time += hmm.l.t * w
                if ss == s:
                    ic.del_ext += w
                else:
                    ic.del_ += w
                    ic.del_time += hmm.r.del_wait * w
        elif s == IIW:
            if not x_null:
                if ss == s:
                    ic.ins_ext += w
                else:
                    ic.ins += w
                    ic.ins_time += hmm.l.ins_wait * w
        elif s == IDM:
            if not y_null:
                if ss in (IMM, IDM):
                    ic.ins_time += hmm.r.t * w
                    ic.del_time += hmm.r.t * w
                if ss == s:
                    ic.del_ext += w
                else:
                    ic.del_ += w
                    ic.del_time += hmm.l.del_wait * w
        elif s == IMI:
            if not y_null:
                if ss == s:
                    ic.ins_ext += w
                else:
                    ic.ins += w
                    ic.ins_time += hmm.r.ins_wait * w

    def get_alignment_column(self, c) -> dict[int, str]:
        """Characters at this cell's column (forward.cpp:938-973)."""
        i, j, s = c
        col: dict[int, str] = {}
        if 0 < i < self.x_size - 1 and 0 < j < self.y_size - 1:
            if s == IMM:
                if not self.x_null[i] and not self.y_null[j]:
                    col = self.x.align_column(i)
                    col.update(self.y.align_column(j))
                    col[self.parent_row] = "*"
                elif self.x_emit_or_start[i] and self.y_null[j]:
                    col = self.y.align_column(j)
                elif self.x_null[i]:
                    col = self.x.align_column(i)
            elif s == IMD:
                col = self.x.align_column(i)
                if not self.x_null[i]:
                    col[self.parent_row] = "*"
            elif s == IDM:
                col = self.y.align_column(j)
                if not self.y_null[j]:
                    col[self.parent_row] = "*"
            elif s == IIW:
                col = self.x.align_column(i)
            elif s == IMI:
                col = self.y.align_column(j)
        return col

    def cell_eigen_counts(self, c) -> EigenCounts:
        counts = EigenCounts(self.hmm.components, self.hmm.alphabet_size)
        col = self.get_alignment_column(c)
        if col and self.sumprod is not None:
            fill = self.sumprod.fill_column(col)
            fill.accumulate_eigen_counts(counts.root_count, counts.eigen_count, 1.0)
        return counts

    def cached_cell_eigen_counts(self, c) -> EigenCounts:
        if not self.is_absorbing(c):
            if self.changes_x(c):
                if c[0] not in self.x_insert_counts:
                    self.x_insert_counts[c[0]] = self.cell_eigen_counts(c)
                return self.x_insert_counts[c[0]]
            if self.changes_y(c):
                if c[1] not in self.y_insert_counts:
                    self.y_insert_counts[c[1]] = self.cell_eigen_counts(c)
                return self.y_insert_counts[c[1]]
        elif c in self._cell_counts:
            return self._cell_counts[c]
        return self.cell_eigen_counts(c)

    def precompute_cell_counts(self, cells) -> None:
        """Batch the column sum-products for many cells' substitution
        counts into ONE fill (vs one single-column fill per cell).

        Pools cells by their count key exactly as cached_cell_eigen_counts
        does (x-insert column by x state, y-insert by y state, absorbing
        cells individually), runs every distinct non-empty column through
        one batched Felsenstein fill, and seeds the per-key caches."""
        if self.sumprod is None:
            return
        key_cell: dict = {}
        for c in cells:
            if not self.is_absorbing(c):
                if self.changes_x(c):
                    if c[0] in self.x_insert_counts:
                        continue
                    key = ("x", c[0])
                elif self.changes_y(c):
                    if c[1] in self.y_insert_counts:
                        continue
                    key = ("y", c[1])
                else:
                    continue  # no column: cell_eigen_counts is zero anyway
            else:
                if c in self._cell_counts:
                    continue
                key = ("cell", c)
            key_cell.setdefault(key, c)

        def store(key, ec):
            kind, v = key
            if kind == "x":
                self.x_insert_counts[v] = ec
            elif kind == "y":
                self.y_insert_counts[v] = ec
            else:
                self._cell_counts[v] = ec

        C, A = self.hmm.components, self.hmm.alphabet_size
        nonempty = []
        cols = []
        for key, c in key_cell.items():
            col = self.get_alignment_column(c)
            if col:
                nonempty.append(key)
                cols.append(col)
            else:
                store(key, EigenCounts(C, A))
        if not nonempty:
            return
        n_nodes = self.sumprod.arrays.n_nodes
        alphabet = self.sumprod.model.alphabet
        tokens = np.full((n_nodes, len(nonempty)), -1, dtype=np.int32)
        for idx, col in enumerate(cols):
            for node, ch in col.items():
                if ch in "-.":
                    continue
                tok = alphabet.tokenize_char(ch)
                tokens[node, idx] = tok if tok >= 0 else -2
        fill = self.sumprod.fill_tokens(tokens)
        root_l, eigen_l = fill.per_column_eigen_counts()
        for idx, key in enumerate(nonempty):
            ec = EigenCounts(C, A)
            ec.root_count += root_l[idx]
            ec.eigen_count += eigen_l[idx]
            store(key, ec)

    # ------------------------------------------------------ profile builders
    def _materialize_best_chain(self, src, chain, cap_cache: dict) -> AlignPath:
        """Align path of a best chain src -> c1 -> ... -> dest: the flat
        concat tap(src,c1)+cap(c1)+tap(c1,c2)+...+tap(ck,dest), identical
        (incl. row insertion order) to the old incremental right fold."""
        if chain is None:
            return {}
        parts = []
        cur = src
        while chain is not None:
            cell, rest = chain
            parts.append(self.transition_align_path(cur, cell))
            if rest is not None:
                cap = cap_cache.get(cell)
                if cap is None:
                    cap = self.cell_align_path(cell)
                    cap_cache[cell] = cap
                parts.append(cap)
            cur = cell
            chain = rest
        if len(parts) == 1:
            return parts[0]
        return align_path_concat(*parts)

    def make_profile(self, cells: set, strategy: int = COLLAPSE_CHAINS) -> Profile:
        """Select retained cells, sum out the rest into effective
        transitions (forward.cpp:686-843)."""
        hmm = self.hmm
        prof = Profile(hmm.components, self.alph_size, self.parent_row)
        prof.name = Tree.pair_parent_name(self.x.name, hmm.l.t, self.y.name, hmm.r.t)
        prof.meta["node"] = str(self.parent_row)

        assert self.start_cell in cells, "missing SSS"
        assert self.end_cell in cells, "missing EEE"

        sorted_cells = sorted(cells)
        # raw source-transition dicts, computed once and reused by the
        # elimination loop below (keys match source_transitions; the
        # emit/absorb term is irrelevant for out-degree counting)
        slp_cache: dict = {}
        out_count: dict = {}
        for dest in sorted_cells:
            slp_cache[dest] = slp = self.source_transitions_without_emit_or_absorb(dest)
            for src in slp:
                out_count[src] = out_count.get(src, 0) + 1

        prof_state_index: dict = {}
        for c in sorted_cells:
            if (
                self.is_absorbing(c)
                or c == self.start_cell
                or c == self.end_cell
                or out_count.get(c, 0) > 1
                or (strategy & KEEP_GAPS_OPEN)
                or not (strategy & COLLAPSE_CHAINS)
            ):
                idx = len(prof.states)
                prof_state_index[c] = idx
                st = ProfState()
                if self.is_absorbing(c):
                    i, j, s = c
                    if s == IMM:
                        st.lp_absorb = (
                            self.subx_lp[_emit_row(self._subx_row, i)]
                            + self.suby_lp[_emit_row(self._suby_row, j)]
                        )
                    elif s == IMD:
                        st.lp_absorb = self.subx_lp[_emit_row(self._subx_row, i)].copy()
                    elif s == IDM:
                        st.lp_absorb = self.suby_lp[_emit_row(self._suby_row, j)].copy()
                st.align_path = self.cell_align_path(c)
                st.seq_coords = self.cell_seq_coords(c)
                st.name = self.cell_name(c)
                st.meta["fwdLogProb"] = _cpp_to_string(
                    self.lp_end if c[2] == EEE else self._cell_value(c)
                )
                prof.states.append(st)

        if strategy & KEEP_GAPS_OPEN:
            for c in sorted_cells:
                if not self.is_absorbing(c) and c in prof_state_index:
                    equiv = self.equiv_absorb_cells(c)
                    if equiv and equiv[0] in prof_state_index:
                        prof.equiv_absorb_state[prof_state_index[c]] = prof_state_index[equiv[0]]

        want_counts = strategy & (COUNT_SUBST_EVENTS | COUNT_INDEL_EVENTS)
        if (strategy & COUNT_SUBST_EVENTS) and self.sumprod is not None:
            # eliminated cells each need their column's substitution
            # counts; batch all those columns through one fill up front.
            # REVERSED: the elimination loop below iterates cells in
            # reverse toposort order, and the reference's lazy x/y-insert
            # caches keep the FIRST cell requested in that order -- seed
            # the caches with the same representatives.
            self.precompute_cell_counts(
                c for c in reversed(sorted_cells) if c not in prof_state_index
            )

        # effective transitions: effTrans[srcCell][destStateIdx]
        eff_trans: dict = {}
        for iter_cell in reversed(sorted_cells):
            slp = slp_cache[iter_cell]
            cell_lp_insert = self.eliminated_lp_insert(iter_cell)
            if iter_cell in prof_state_index:
                cell_idx = prof_state_index[iter_cell]
                for src, lp_trans in slp.items():
                    eff = eff_trans.setdefault(src, {}).setdefault(
                        cell_idx, _EffectiveTransition()
                    )
                    eff.lp_path = eff.lp_best = lp_trans + cell_lp_insert
                    eff.best_chain = (iter_cell, None)
                    if want_counts:
                        eff.counts = self.transition_eigen_counts(src, iter_cell)
            else:
                cell_eff = eff_trans.get(iter_cell, {})
                cell_counts = None
                if (strategy & COUNT_SUBST_EVENTS) and self.sumprod is not None:
                    cell_counts = self.cached_cell_eigen_counts(iter_cell)
                for src, lp_trans in slp.items():
                    if want_counts:
                        src_cell_counts = self.transition_eigen_counts(src, iter_cell)
                        if cell_counts is not None:
                            src_cell_counts += cell_counts
                    src_eff = eff_trans.setdefault(src, {})
                    for dest_idx, cell_dest_eff in cell_eff.items():
                        sd = src_eff.setdefault(dest_idx, _EffectiveTransition())
                        lp_path = lp_trans + cell_lp_insert + cell_dest_eff.lp_path
                        new_lp = np.logaddexp(sd.lp_path, lp_path)
                        if want_counts:
                            pp_path = np.exp(lp_path - new_lp) if new_lp > NEG_INF else 0.0
                            merged = (src_cell_counts + cell_dest_eff.counts) if cell_dest_eff.counts is not None else src_cell_counts
                            if sd.counts is None:
                                sd.counts = merged.copy()
                                sd.counts *= pp_path
                            else:
                                sd.counts *= 1 - pp_path
                                scaled = merged.copy()
                                scaled *= pp_path
                                sd.counts += scaled
                        sd.lp_path = new_lp
                        lp_best = lp_trans + cell_lp_insert + cell_dest_eff.lp_best
                        if lp_best > sd.lp_best:
                            sd.lp_best = lp_best
                            # cons-chain: align path materialized only for
                            # transitions that survive into the profile
                            sd.best_chain = (iter_cell, cell_dest_eff.best_chain)

        # populate transitions (reference iterates profStateIndex in
        # CellCoords order and effTrans in dest-index order)
        cap_cache: dict = {}
        for c, src_idx in prof_state_index.items():
            for dest_idx, eff in sorted(eff_trans.get(c, {}).items()):
                trans_idx = len(prof.trans)
                t = ProfTrans(src=src_idx, dest=dest_idx, lp=eff.lp_path)
                t.align_path = self._materialize_best_chain(c, eff.best_chain, cap_cache)
                if want_counts and eff.counts is not None:
                    t.counts = eff.counts
                prof.trans.append(t)
                if prof.states[dest_idx].is_null:
                    prof.states[src_idx].null_out.append(trans_idx)
                else:
                    prof.states[src_idx].absorb_out.append(trans_idx)
                prof.states[dest_idx].in_trans.append(trans_idx)

        prof.seqs = dict(self.x.seqs)
        prof.seqs.update(self.y.seqs)

        prof.assert_transitions_consistent()
        prof.assert_path_to_end_exists()
        prof = prof.add_ready_states()
        prof.assert_seq_coords_consistent()
        return prof

    def sample_profile(self, rng: MT19937, profile_samples: int, max_cells: int = 0, strategy: int = COLLAPSE_CHAINS, min_len: int = 0, max_len: int = 1 << 62) -> Profile:
        """N stochastic tracebacks -> retained cell set (forward.cpp:845-889)."""
        cell_count: dict = {}
        assert (strategy & INCLUDE_BEST_TRACE) or profile_samples > 0
        n_traces = 0
        if self._trace_handle is not None:
            # device-resident fill: the best and all sampled traces walked
            # in one launch on the generator's next draws, then the host
            # loop's acceptance below in trace order (the max_cells early
            # stop and the length break discard the surplus walks), and
            # the generator moved past the draws of exactly the walks the
            # host loop would have made, the rejected one included.
            # max_cells == 1 with a best trace is the -fast preset: the
            # best trace alone fills the budget, so the host loop samples
            # nothing -- walk no sampled trace and draw nothing.
            include_best = bool(strategy & INCLUDE_BEST_TRACE)
            n_eff = 0 if (max_cells == 1 and include_best) else profile_samples
            paths = self._device_traces(n_eff, include_best, rng)
            k0 = 0
            if include_best:
                for c in paths[0]:
                    cell_count[c] = 2
                n_traces += 1
                k0 = 1
            n_accepted = 0
            n_draws = 0
            for sampled in paths[k0:]:
                if n_accepted >= profile_samples or (
                    max_cells != 0 and len(cell_count) >= max_cells
                ):
                    break
                n_draws += len(sampled) - 1
                anc_len = sum(1 for c in sampled if c[2] in (IMM, IDM, IMD))
                if anc_len < min_len or anc_len > max_len:
                    break
                for c in sampled:
                    cell_count[c] = cell_count.get(c, 0) + 1
                n_traces += 1
                n_accepted += 1
            if n_draws:
                rng.advance_uniforms(n_draws)
            SAMPLED["device_walks"] += len(paths) - k0
            SAMPLED["draws"] += n_draws
        else:
            if strategy & INCLUDE_BEST_TRACE:
                for c in self.best_trace():
                    cell_count[c] = 2
                n_traces += 1
            n_accepted = 0
            while n_accepted < profile_samples and (max_cells == 0 or len(cell_count) < max_cells):
                sampled = self.sample_trace(rng)
                SAMPLED["host_walks"] += 1
                SAMPLED["draws"] += len(sampled) - 1
                anc_len = sum(1 for c in sampled if c[2] in (IMM, IDM, IMD))
                if anc_len < min_len or anc_len > max_len:
                    break
                for c in sampled:
                    cell_count[c] = cell_count.get(c, 0) + 1
                n_traces += 1
                n_accepted += 1
        threshold = 2 if (n_traces > 1 and max_cells > 0 and len(cell_count) >= max_cells) else 1
        prof_cells = {c for c, n in cell_count.items() if n >= threshold}
        return self.make_profile(prof_cells, strategy)

    def best_profile(self, strategy: int = COLLAPSE_CHAINS) -> Profile:
        if self._trace_handle is not None:
            return self.make_profile(set(self._device_best_path()), strategy)
        return self.make_profile(set(self.best_trace()), strategy)

    def _device_best_path(self) -> list:
        """Best trace via the device walker, cached (best_align_path and
        best_profile both want it at the root)."""
        cached = self.__dict__.get("_best_path")
        if cached is None:
            cached = self._device_traces(0, True, None)[0]
            self.__dict__["_best_path"] = cached
        return cached


class _EffectiveTransition:
    __slots__ = ("lp_path", "lp_best", "best_chain", "counts")

    def __init__(self):
        self.lp_path = NEG_INF
        self.lp_best = NEG_INF
        # cons list (cell, rest) of the best path's cells after the source;
        # terminal element has rest=None and is the retained dest cell
        self.best_chain = None
        self.counts = None


class _PythonForwardMatrix(ForwardMatrix):
    """The python fill alone, with neither the device nor the native
    runtime: the Forward/Backward mismatch diagnostic's reference."""

    def _fill_device(self) -> bool:
        return False

    def _fill_native(self) -> bool:
        return False


class BackwardMatrix(DPMatrix):
    _pool_role = "bwd-cells"

    def __init__(self, fwd: ForwardMatrix):
        fwd.ensure_cells()  # posterior consumers read the full fwd band
        super().__init__(fwd.x, fwd.y, fwd.hmm, fwd.env, share_from=fwd)
        self.fwd = fwd
        self._best_dest_cache: dict = {}
        self._fill()
        # forward/backward agreement check (forward.cpp:1091-1096)
        back_ll = self.lp_start
        if np.isfinite(back_ll) or np.isfinite(fwd.lp_end):
            rel = abs(back_ll - fwd.lp_end) / max(abs(back_ll), abs(fwd.lp_end), 1e-12)
            if rel > 0.01:
                self._diagnose_mismatch(back_ll)

    #: grids above this cell count skip the python slow re-fill (the
    #: diagnostic is O(cells) interpreted python, like the reference's)
    SLOW_FILL_DIAG_MAX_CELLS = 4_000_000

    def _diagnose_mismatch(self, back_ll: float) -> None:
        """Fwd/Bwd disagreement diagnostic (the reference's slowFillTest,
        forward.cpp:1099-1170): re-fill the Forward matrix through the
        pure-python reference path -- no native runtime, no device
        kernels -- and report where the production fill diverges.  This
        is the tool that catches the next kernel-routing bug, so it
        prints unconditionally to stderr."""
        fwd = self.fwd
        lines = [
            f"historian-tpu: WARNING: Forward log-likelihood {fwd.lp_end} != "
            f"Backward log-likelihood {back_ll}; running slow-fill diagnostic"
        ]
        n_grid = fwd.x_size * fwd.y_size * 5
        if n_grid > self.SLOW_FILL_DIAG_MAX_CELLS:
            lines.append(
                f"  (grid of {n_grid} state-cells exceeds the slow-fill "
                "diagnostic budget)"
            )
        else:
            slow = _PythonForwardMatrix(fwd.x, fwd.y, fwd.hmm, fwd.parent_row, fwd.env)
            got, want = fwd.cells, slow.cells
            both = np.isfinite(got) & np.isfinite(want)
            pattern = np.isfinite(got) != np.isfinite(want)
            delta = np.zeros_like(got)
            delta[both] = np.abs(got[both] - want[both])
            bad = (delta > 1e-6) | pattern
            n_bad = int(np.count_nonzero(bad))
            lines.append(
                f"  slow fill: lp_end got {fwd.lp_end} want {slow.lp_end}; "
                f"{n_bad} of {n_grid} state-cells differ (>1e-6 or "
                f"finiteness flips)"
            )
            if n_bad:
                flat = np.argmax(np.where(pattern, np.inf, delta))
                i, j, s = np.unravel_index(flat, got.shape)
                lines.append(
                    f"  worst cell (i={i}, j={j}, state={s}): "
                    f"got {got[i, j, s]} want {want[i, j, s]}"
                )
        sys.stderr.write("\n".join(lines) + "\n")
        log_this_at(1, lines[0])

    @property
    def lp_start(self) -> float:
        return float(self.cells[0, 0, IMM])

    def _fill_native_backward(self) -> bool:
        lib = get_native()
        if lib is None:
            return False
        xa_ptr, xa_dest, xa_lp = csr_out_edges(self.x, "absorb_out")
        xn_ptr, xn_dest, xn_lp = csr_out_edges(self.x, "null_out")
        ya_ptr, ya_dest, ya_lp = csr_out_edges(self.y, "absorb_out")
        yn_ptr, yn_dest, yn_lp = csr_out_edges(self.y, "null_out")
        h = self.hmm
        trans18 = np.array(
            [h.imm_imm, h.imm_imd, h.imm_idm, h.imm_imi, h.imm_iiw,
             h.imd_imm, h.imd_imd, h.imd_idm,
             h.idm_imm, h.idm_imd, h.idm_idm,
             h.imi_imm, h.imi_imd, h.imi_imi, h.imi_iiw,
             h.iiw_imm, h.iiw_idm, h.iiw_iiw]
        )
        lib.backward_fill(
            self.x_size, self.y_size,
            xa_ptr, xa_dest, xa_lp, xn_ptr, xn_dest, xn_lp,
            ya_ptr, ya_dest, ya_lp, yn_ptr, yn_dest, yn_lp,
            self.x_ready.astype(np.uint8), self.y_ready.astype(np.uint8),
            self.x_emit_or_start.astype(np.uint8),
            np.uint8(self.x_empty), np.uint8(self.y_empty),
            self.insx, self.rootsubx, self.insy, self.rootsuby,
            np.ascontiguousarray(self.absorb),
            self.env_mask_u8,
            trans18, self.cells,
        )
        return True

    def _fill(self) -> None:
        self.cells = bufpool.get(self._pool_role, (self.x_size, self.y_size, 5), self)
        self.cells.fill(NEG_INF)
        hmm = self.hmm
        x, y = self.x, self.y
        sx, sy = self.x_size, self.y_size
        cells = self.cells
        self.lp_end = 0.0

        # transitions into EEE seed the final cells
        for xt in x.end.in_trans:
            x_trans = x.trans[xt]
            for yt in y.end.in_trans:
                y_trans = y.trans[yt]
                i, j = x_trans.src, y_trans.src
                if self.env_mask[i, j]:
                    base = x_trans.lp + y_trans.lp
                    cells[i, j, IMM] = base + hmm.imm_eee
                    cells[i, j, IMD] = base + hmm.imd_eee
                    cells[i, j, IDM] = base + hmm.idm_eee
                    cells[i, j, IMI] = base + hmm.imi_eee
                    cells[i, j, IIW] = base + hmm.iiw_eee

        if self._fill_native_backward():
            return

        # out-edge arrays
        def out_arrays(profile, attr):
            dests, lps = [], []
            for st in profile.states:
                idxs = getattr(st, attr)
                dests.append(np.array([profile.trans[t].dest for t in idxs], dtype=np.int64))
                lps.append(np.array([profile.trans[t].lp for t in idxs]))
            return dests, lps

        x_abs_dest, x_abs_lp = out_arrays(x, "absorb_out")
        x_null_dest, x_null_lp = out_arrays(x, "null_out")
        y_abs_dest, y_abs_lp = out_arrays(y, "absorb_out")
        y_null_dest, y_null_lp = out_arrays(y, "null_out")

        ready_y = self.y_ready[: sy - 1] | self.y_empty

        for i in range(sx - 2, -1, -1):
            x_state = x.states[i]
            mask_row = self.env_mask[i, : sy - 1]
            if not mask_row.any():
                continue
            add = np.full((sy - 1, 5), NEG_INF)

            # build flat y absorb edges once
            if not hasattr(self, "_flat_y_abs"):
                fd, fs, fl = [], [], []
                for j in range(sy):
                    for t in y.states[j].absorb_out:
                        fs.append(j)
                        fd.append(y.trans[t].dest)
                        fl.append(y.trans[t].lp)
                self._flat_y_abs = (
                    np.array(fs, dtype=np.int64),
                    np.array(fd, dtype=np.int64),
                    np.array(fl),
                )
            f_src, f_dest, f_lp = self._flat_y_abs

            for xd, lp_xt in zip(x_abs_dest[i], x_abs_lp[i]):
                if len(f_src):
                    dest_imm_vals = (
                        lp_xt
                        + f_lp
                        + self.absorb[xd, f_dest]
                        + cells[xd, f_dest, IMM]
                    )
                    acc = np.full(sy - 1, NEG_INF)
                    sel = f_src < sy - 1
                    np.logaddexp.at(acc, f_src[sel], dest_imm_vals[sel])
                    for s_idx, tcoef in (
                        (IMM, hmm.imm_imm),
                        (IMD, hmm.imd_imm),
                        (IDM, hmm.idm_imm),
                        (IMI, hmm.imi_imm),
                        (IIW, hmm.iiw_imm),
                    ):
                        add[:, s_idx] = np.logaddexp(add[:, s_idx], tcoef + acc)

                # x-absorbing into IMD, IIW (same j)
                dest_imd = lp_xt + self.rootsubx[xd] + cells[xd, : sy - 1, IMD]
                dest_iiw = lp_xt + self.insx[xd] + cells[xd, : sy - 1, IIW]
                dest_imd = np.where(ready_y, dest_imd, NEG_INF)
                dest_iiw = np.where(ready_y, dest_iiw, NEG_INF)
                for s_idx, tcoef in (
                    (IMM, hmm.imm_imd),
                    (IMD, hmm.imd_imd),
                    (IDM, hmm.idm_imd),
                    (IMI, hmm.imi_imd),
                ):
                    add[:, s_idx] = np.logaddexp(add[:, s_idx], tcoef + dest_imd)
                for s_idx, tcoef in (
                    (IMM, hmm.imm_iiw),
                    (IMI, hmm.imi_iiw),
                    (IIW, hmm.iiw_iiw),
                ):
                    add[:, s_idx] = np.logaddexp(add[:, s_idx], tcoef + dest_iiw)

            # x-nonabsorbing (null) edges: IMD, IIW, IMM propagate at same j
            for xd, lp_xt in zip(x_null_dest[i], x_null_lp[i]):
                if xd >= sx:  # safety
                    continue
                prop_imd = np.where(ready_y, lp_xt + cells[xd, : sy - 1, IMD], NEG_INF)
                prop_iiw = np.where(ready_y, lp_xt + cells[xd, : sy - 1, IIW], NEG_INF)
                prop_imm = np.where(ready_y, lp_xt + cells[xd, : sy - 1, IMM], NEG_INF)
                add[:, IMD] = np.logaddexp(add[:, IMD], prop_imd)
                add[:, IIW] = np.logaddexp(add[:, IIW], prop_iiw)
                add[:, IMM] = np.logaddexp(add[:, IMM], prop_imm)

            # merge row-level contributions into cells (respect existing seeds)
            row = cells[i, : sy - 1]
            np.logaddexp(row, add, out=row, where=mask_row[:, None])

            # sequential y pass (descending): y-absorbing + y-null edges
            x_ready_or_empty = self.x_ready[i] or self.x_empty
            for j in range(sy - 2, -1, -1):
                if not mask_row[j]:
                    continue
                cell_ij = cells[i, j]
                if x_ready_or_empty:
                    for yd, lp_yt in zip(y_abs_dest[j], y_abs_lp[j]):
                        dest_idm = lp_yt + self.rootsuby[yd] + cells[i, yd, IDM]
                        dest_imi = lp_yt + self.insy[yd] + cells[i, yd, IMI]
                        for s_idx, tcoef in (
                            (IMM, hmm.imm_idm),
                            (IMD, hmm.imd_idm),
                            (IDM, hmm.idm_idm),
                            (IIW, hmm.iiw_idm),
                        ):
                            cell_ij[s_idx] = np.logaddexp(cell_ij[s_idx], tcoef + dest_idm)
                        for s_idx, tcoef in ((IMM, hmm.imm_imi), (IMI, hmm.imi_imi)):
                            cell_ij[s_idx] = np.logaddexp(cell_ij[s_idx], tcoef + dest_imi)
                for yd, lp_yt in zip(y_null_dest[j], y_null_lp[j]):
                    if yd >= sy - 1:
                        continue
                    cell_ij[IDM] = np.logaddexp(cell_ij[IDM], lp_yt + cells[i, yd, IDM])
                    cell_ij[IMI] = np.logaddexp(cell_ij[IMI], lp_yt + cells[i, yd, IMI])
                    if x_state.is_emit_or_start:
                        cell_ij[IMM] = np.logaddexp(cell_ij[IMM], lp_yt + cells[i, yd, IMM])

    # ------------------------------------------------------------- posteriors
    def cell_post_prob(self, c) -> float:
        return float(np.exp(self.fwd.cells[c[0], c[1], c[2]] + self.cells[c[0], c[1], c[2]] - self.fwd.lp_end))

    def trans_post_prob(self, src, dest) -> float:
        src_trans = self.fwd.source_transitions(dest)
        if src in src_trans:
            dlp = 0.0 if dest[2] == EEE else self.cells[dest[0], dest[1], dest[2]]
            return float(
                np.exp(self.fwd.cells[src[0], src[1], src[2]] + src_trans[src] + dlp - self.fwd.lp_end)
            )
        return 0.0

    def get_counts(self) -> EigenCounts:
        """Posterior-expected counts: sum over cells & transitions
        (forward.cpp:1183-1214).

        Restructured for batching: cell substitution counts are linear in
        the posterior weight, so cells sharing an alignment column
        (x-insert columns keyed by xpos, y-insert by ypos) pool their
        weights, and ALL distinct columns run through ONE batched
        sum-product fill with per-column weights.  Only the
        indel-bookkeeping transition walk stays per-transition on host.

        The column representing an x/y key replicates the reference's
        cache-population order: accumulateCachedEigenCounts runs over ALL
        in-envelope cells (weight 0 included) in (i, j, s) scan order, and
        every (i, j) has a qualifying changesX state, so xInsertCounts[i]
        caches the column of cell (i, j_first(i)) where j_first is the
        first in-envelope column of row i -- EMPTY when that cell sits on
        the j=0 border (getAlignmentColumn's range guard).  Mirrored for
        y keys.
        """
        fwd = self.fwd
        counts = EigenCounts(self.hmm.components, self.hmm.alphabet_size)
        counts.indel.lp = fwd.lp_end

        ijs, wts = self._positive_posterior_cell_arrays()  # (i, j, s) scan order

        if fwd.sumprod is not None and len(wts):
            # pool weights per distinct alignment column, fully vectorized:
            # classify every cell (absorbing / changes-x / changes-y), map it
            # to an integer key id, pool weights per key in scan order
            # (bincount adds left-to-right, matching the dict accumulation),
            # and keep keys in first-encounter order so the column batch --
            # and therefore the float accumulation order downstream -- is
            # identical to the per-cell walk.
            i_a, j_a, s_a = ijs[:, 0], ijs[:, 1], ijs[:, 2]
            xn = self.x_null[i_a]
            yn = self.y_null[j_a]
            absorbing = (
                ((s_a == IMM) & ~xn & ~yn)
                | ((s_a == IMD) & ~xn)
                | ((s_a == IDM) & ~yn)
            )
            chx = ((s_a == IMM) & (xn | ~yn)) | (s_a == IMD) | (s_a == IIW)
            chy = ((s_a == IMM) & self.x_emit_or_start[i_a]) | (s_a == IDM) | (s_a == IMI)
            nx, ny = self.x_size, self.y_size
            base_x = nx * ny * 5
            base_y = base_x + nx
            keyid = np.where(
                absorbing,
                (i_a * ny + j_a) * 5 + s_a,
                np.where(chx, base_x + i_a, np.where(chy, base_y + j_a, -1)),
            )
            keep = keyid >= 0
            keyid = keyid[keep]
            uniq, inv = np.unique(keyid, return_inverse=True)
            first = np.full(len(uniq), len(keyid), dtype=np.int64)
            np.minimum.at(first, inv, np.arange(len(keyid)))
            order = np.argsort(first, kind="stable")
            rank = np.empty(len(uniq), dtype=np.int64)
            rank[order] = np.arange(len(uniq))
            uniq = uniq[order]
            weights = np.bincount(rank[inv], weights=wts[keep], minlength=len(uniq))

            # reference cache-representative columns (see docstring)
            m = self.env_mask[: self.x_size - 1, : self.y_size - 1]
            any_j = m.any(axis=1)
            j_first = np.where(any_j, m.argmax(axis=1), -1)
            any_i = m.any(axis=0)
            i_first = np.where(any_i, m.argmax(axis=0), -1)

            n_nodes = fwd.sumprod.arrays.n_nodes
            alphabet = fwd.sumprod.model.alphabet
            tok_x = _profile_token_columns(fwd.x, alphabet, n_nodes)
            tok_y = _profile_token_columns(fwd.y, alphabet, n_nodes)

            cols_mat = np.full((len(uniq), n_nodes), -1, dtype=np.int32)
            kind_x = (uniq >= base_x) & (uniq < base_y)
            kind_y = uniq >= base_y
            kind_cell = uniq < base_x
            # x-insert representative columns (range guards as in key_column)
            rx = np.where(kind_x)[0]
            xi = uniq[rx] - base_x
            okx = (xi > 0) & (j_first[xi] > 0)
            cols_mat[rx[okx]] = tok_x[xi[okx]]
            # y-insert representative columns
            ry = np.where(kind_y)[0]
            yj = uniq[ry] - base_y
            oky = (yj > 0) & (i_first[yj] > 0)
            cols_mat[ry[oky]] = tok_y[yj[oky]]
            # absorbing-cell columns (getAlignmentColumn, forward.cpp:938-973;
            # cell keys are absorbing by construction, so the null-state
            # branches never apply and the parent row is always wildcard)
            rc = np.where(kind_cell)[0]
            cs = uniq[rc] % 5
            cij = uniq[rc] // 5
            ci = cij // ny
            cj = cij % ny
            guard = (ci > 0) & (ci < nx - 1) & (cj > 0) & (cj < ny - 1)
            m_imm = guard & (cs == IMM)
            cols_mat[rc[m_imm]] = np.where(
                tok_x[ci[m_imm]] != -1, tok_x[ci[m_imm]], tok_y[cj[m_imm]]
            )
            m_imd = guard & (cs == IMD)
            cols_mat[rc[m_imd]] = tok_x[ci[m_imd]]
            m_idm = guard & (cs == IDM)
            cols_mat[rc[m_idm]] = tok_y[cj[m_idm]]
            cols_mat[rc[guard], fwd.parent_row] = -2

            nonempty = (cols_mat != -1).any(axis=1)
            if np.any(nonempty):
                tokens = np.ascontiguousarray(cols_mat[nonempty].T)
                weights = weights[nonempty]
                if tokens.shape[1] >= 512:
                    # Counts are linear in the per-column weight, so columns
                    # with identical token content (common: absorbing cells at
                    # neighbouring grid positions often expose the same
                    # residue column) collapse into one fill column with the
                    # weights pooled.  Only on the large-batch device path --
                    # the small-batch host path stays byte-exact with the
                    # reference's per-key accumulation order.
                    tokens, dinv = np.unique(tokens, axis=1, return_inverse=True)
                    weights = np.bincount(
                        dinv.ravel(), weights=weights, minlength=tokens.shape[1]
                    )
                fill = fwd.sumprod.fill_tokens(tokens)
                fill.accumulate_eigen_counts(counts.root_count, counts.eigen_count, weights)

        # transition indel counts: natively pooled per profile edge and per
        # (src state, dest state, null-flag) category when the host runtime
        # is available; otherwise the per-transition walk
        lib = get_native()
        if lib is not None:
            self._accumulate_transition_counts_native(lib, counts)
            return counts
        cells = fwd.cells
        lp_end = fwd.lp_end
        for i, j, s in ijs.tolist():
            dest = (i, j, s)
            lp_dest = self.cells[i, j, s]
            for src, lp_trans in fwd.source_transitions(dest).items():
                w = np.exp(cells[src[0], src[1], src[2]] + lp_trans + lp_dest - lp_end)
                if w > 0:
                    fwd.accumulate_transition_counts(counts, src, dest, float(w))
        return counts

    def _accumulate_transition_counts_native(self, lib, counts) -> None:
        """Pooled-weight form of the transition walk: the native runtime
        sums posterior transition weights per x/y profile edge and per
        (src state, dest state, x_null, y_null) category (the only inputs
        of the scalar indel bookkeeping), so the python side applies each
        edge's count payload and each category's formulas exactly once."""
        fwd = self.fwd
        x_ptr, x_src, x_lp, x_edge = csr_in_edges_idx(fwd.x)
        y_ptr, y_src, y_lp, y_edge = csr_in_edges_idx(fwd.y)
        wx = np.zeros(len(fwd.x.trans))
        wy = np.zeros(len(fwd.y.trans))
        wcat = np.zeros(5 * 5 * 2 * 2)
        lib.transition_pool(
            self.x_size, self.y_size,
            fwd.cells, self.cells, self.env_mask_u8, float(fwd.lp_end),
            x_ptr, x_src, x_lp, x_edge, y_ptr, y_src, y_lp, y_edge,
            self.x_null.astype(np.uint8), self.y_null.astype(np.uint8),
            self.x_ready.astype(np.uint8), self.y_ready.astype(np.uint8),
            self.x_emit_or_start.astype(np.uint8),
            np.uint8(self.x_empty), np.uint8(self.y_empty),
            self.insx, self.rootsubx, self.insy, self.rootsuby,
            np.ascontiguousarray(self.absorb), self.hmm.trans_table,
            len(fwd.x.trans), len(fwd.y.trans),
            wx, wy, wcat,
        )
        for prof, w_edge in ((fwd.x, wx), (fwd.y, wy)):
            for t in np.nonzero(w_edge)[0]:
                tr = prof.trans[t]
                if tr.counts is not None:
                    counts.add_scaled(tr.counts, float(w_edge[t]))
        for k in np.nonzero(wcat)[0]:
            ss, rem = divmod(int(k), 20)
            s, flags = divmod(rem, 4)
            xn, yn = divmod(flags, 2)
            fwd._indel_scalars_cat(
                self.hmm, ss, s, bool(xn), bool(yn), counts.indel, float(wcat[k])
            )

    def _positive_posterior_cell_arrays(self) -> tuple:
        """(ijs [n, 3] int64, w [n] float64) for every in-band cell with
        posterior weight w = exp(fwd + bwd - lp_end) > 0, in (i, j, s)
        scan order -- the same selection and order as nonzero(post > 0) +
        lexsort on the dense posterior tensor, without materializing it."""
        lib = get_native()
        if lib is not None:
            cap = 1 << 18
            while True:
                out_ijs = np.empty((cap, 3), dtype=np.int64)
                out_w = np.empty(cap, dtype=np.float64)
                n = lib.posterior_cells(
                    self.x_size, self.y_size,
                    self.cells, self.fwd.cells, self.env_mask_u8,
                    float(self.fwd.lp_end), cap, out_ijs, out_w,
                )
                if n <= cap:
                    break
                cap = int(n)
            return out_ijs[:n], out_w[:n]
        with np.errstate(invalid="ignore", over="ignore"):
            post = np.exp(
                self.fwd.cells[: self.x_size - 1, : self.y_size - 1]
                + self.cells[: self.x_size - 1, : self.y_size - 1]
                - self.fwd.lp_end
            )
        post = np.where(
            self.env_mask[: self.x_size - 1, : self.y_size - 1, None], post, 0.0
        )
        post = np.nan_to_num(post, nan=0.0)
        ii, jj, ss = np.nonzero(post > 0)
        return np.stack([ii, jj, ss], axis=1).astype(np.int64), post[ii, jj, ss]

    def _positive_posterior_cells(self) -> list:
        """[(i, j, s, w)] form of _positive_posterior_cell_arrays."""
        ijs, w = self._positive_posterior_cell_arrays()
        return [
            (i, j, s, wv) for (i, j, s), wv in zip(ijs.tolist(), w.tolist())
        ]

    # ----------------------------------------------------------- traceforward
    def dest_transitions(self, src_cell) -> dict:
        i, j, s = src_cell
        x, y, hmm = self.x, self.y, self.hmm
        x_state, y_state = x.states[i], y.states[j]
        clp: dict = {}
        for xt in x_state.absorb_out:
            x_trans = x.trans[xt]
            for yt in y_state.absorb_out:
                y_trans = y.trans[yt]
                clp[(x_trans.dest, y_trans.dest, IMM)] = (
                    hmm.lp_trans(s, IMM) + x_trans.lp + y_trans.lp
                )
        if y_state.is_ready or self.y_empty:
            for xt in x_state.absorb_out:
                x_trans = x.trans[xt]
                clp[(x_trans.dest, j, IMD)] = hmm.lp_trans(s, IMD) + x_trans.lp
                clp[(x_trans.dest, j, IIW)] = hmm.lp_trans(s, IIW) + x_trans.lp
        if x_state.is_ready or self.x_empty:
            for yt in y_state.absorb_out:
                y_trans = y.trans[yt]
                clp[(i, y_trans.dest, IDM)] = hmm.lp_trans(s, IDM) + y_trans.lp
                clp[(i, y_trans.dest, IMI)] = hmm.lp_trans(s, IMI) + y_trans.lp
        if (y_state.is_ready or self.y_empty) and s in (IMD, IIW, IMM):
            for xt in x_state.null_out:
                x_trans = x.trans[xt]
                if x_trans.dest != self.x_size - 1:
                    clp[(x_trans.dest, j, s)] = x_trans.lp
        if s in (IDM, IMI) or (x_state.is_emit_or_start and s == IMM):
            for yt in y_state.null_out:
                y_trans = y.trans[yt]
                if y_trans.dest != self.y_size - 1:
                    clp[(i, y_trans.dest, s)] = y_trans.lp
        for xt in x_state.null_out:
            x_trans = x.trans[xt]
            if x_trans.dest == self.x_size - 1:
                for yt in y_state.null_out:
                    y_trans = y.trans[yt]
                    if y_trans.dest == self.y_size - 1:
                        clp[(x_trans.dest, y_trans.dest, EEE)] = (
                            x_trans.lp + y_trans.lp + hmm.lp_trans(s, EEE)
                        )
        return {c: lp + self.lp_cell_emit_or_absorb(c) for c, lp in clp.items()}

    def dest_cells(self, src_cell) -> dict:
        out = {}
        for c, lp in self.dest_transitions(src_cell).items():
            if c[2] != EEE:
                lp = lp + self.cells[c[0], c[1], c[2]]
            out[c] = lp
        return out

    def _best_dest(self, src):
        """Cached best_cell(dest_cells(src)): the cells array is fixed
        after the fill, and postProbProfile's many per-seed traceforwards
        overlap heavily.  Same sort order and comparison as best_cell, so
        paths are identical to the uncached walk."""
        cache = self._best_dest_cache
        best = cache.get(src)
        if best is None:
            best = self.best_cell(self.dest_cells(src))
            cache[src] = best
        return best

    def best_trace(self, trace_start, stop_at=None) -> list:
        """Best path forward from `trace_start` to the end cell, in walk
        order.  `stop_at` truncates at the first already-retained cell
        (equivalent: add_cells breaks there and ignores the rest)."""
        path = []
        current = trace_start
        while current[0] < self.x_size - 1 and current[1] < self.y_size - 1:
            current = self._best_dest(current)
            path.append(current)
            if stop_at is not None and current in stop_at:
                return path
        path.append(self.fwd.end_cell)
        return path

    def cells_above_post_prob_threshold(self, min_post_prob: float) -> list:
        """[(lpp, cell)] sorted descending (reference priority queue),
        selected with one vectorized pass over the cell tensor."""
        lpp_threshold = np.log(min_post_prob)
        native = self._postprob_select_native(lpp_threshold)
        if native is not None:
            return native
        # row-chunked pass: the cell tensors can be multi-GB, so avoid
        # materializing full-size temporaries
        chunk = max(1, (1 << 27) // max(1, self.y_size * 5 * 8))
        parts_i, parts_j, parts_s, parts_v = [], [], [], []
        for lo in range(0, self.x_size - 1, chunk):
            hi = min(lo + chunk, self.x_size - 1)
            lpp_c = (
                self.cells[lo:hi, : self.y_size - 1]
                + self.fwd.cells[lo:hi, : self.y_size - 1]
                - self.fwd.lp_end
            )
            with np.errstate(invalid="ignore"):
                sel_c = (lpp_c >= lpp_threshold) & self.env_mask[lo:hi, : self.y_size - 1, None]
            ic, jc, sc = np.nonzero(sel_c)
            parts_i.append(ic + lo)
            parts_j.append(jc)
            parts_s.append(sc)
            parts_v.append(lpp_c[ic, jc, sc])
        ii = np.concatenate(parts_i) if parts_i else np.array([], dtype=np.int64)
        jj = np.concatenate(parts_j) if parts_j else np.array([], dtype=np.int64)
        ss = np.concatenate(parts_s) if parts_s else np.array([], dtype=np.int64)
        vals = np.concatenate(parts_v) if parts_v else np.array([], dtype=np.float64)
        # same order as sorting (-lpp, (i, j, s)) tuples, without building
        # and comparing millions of python tuples
        order = np.lexsort((ss, jj, ii, -vals))
        return [
            (v, (i, j, s))
            for v, i, j, s in zip(
                vals[order].tolist(), ii[order].tolist(), jj[order].tolist(), ss[order].tolist()
            )
        ]

    def _postprob_select_native(self, lpp_threshold: float) -> list | None:
        """Fused native pass over both cell tensors (fill.cpp
        postprob_select); same values and ordering as the numpy path."""
        lib = get_native()
        if lib is None:
            return None
        env_mask_u8 = self.env_mask_u8
        cap = 1 << 20
        while True:
            out_ijs = np.empty((cap, 3), dtype=np.int64)
            out_lpp = np.empty(cap, dtype=np.float64)
            n = lib.postprob_select(
                self.x_size, self.y_size,
                self.cells, self.fwd.cells, env_mask_u8,
                float(self.fwd.lp_end), float(lpp_threshold),
                cap, out_ijs, out_lpp,
            )
            if n <= cap:
                break
            cap = int(n)
        return [
            (v, (i, j, s))
            for v, (i, j, s) in zip(
                out_lpp[:n].tolist(), out_ijs[:n].tolist()
            )
        ]

    def add_cells(self, cells: set, max_cells: int, fwd_trace: list, back_trace: list, keep_gaps_open: bool) -> bool:
        new_cells = []
        for c in reversed(fwd_trace):
            if c in cells:
                break
            new_cells.append(c)
        for c in back_trace:
            if c in cells:
                break
            new_cells.append(c)
        if max_cells > 0 and len(cells) > 0 and len(cells) + len(new_cells) > max_cells:
            return False
        cells.update(new_cells)
        if keep_gaps_open:
            for c in new_cells:
                for eqv in self.equiv_absorb_cells(c):
                    if (
                        eqv not in cells
                        and self.cell_post_prob(eqv) > 0
                        and self.env_mask[eqv[0], eqv[1]]
                    ):
                        self.add_trace(eqv, cells, max_cells, False)
        return True

    def add_trace(self, cell, cells: set, max_cells: int, keep_gaps_open: bool) -> bool:
        fwd_trace = self.fwd.best_trace(cell, stop_at=cells)
        back_trace = self.best_trace(cell, stop_at=cells)
        return self.add_cells(cells, max_cells, fwd_trace, back_trace, keep_gaps_open)

    def post_prob_profile(self, min_post_prob: float, max_cells: int = 0, strategy: int = COLLAPSE_CHAINS) -> Profile:
        bc = self.cells_above_post_prob_threshold(min_post_prob)
        cells: set = set()
        if not bc or (strategy & INCLUDE_BEST_TRACE):
            self.add_cells(cells, 0, self.fwd.best_trace(), [], bool(strategy & KEEP_GAPS_OPEN))
        pos = 0
        while (max_cells == 0 or len(cells) < max_cells) and pos < len(bc):
            best = bc[pos][1]
            if best in cells:
                pos += 1
            else:
                if not self.add_trace(best, cells, max_cells, bool(strategy & KEEP_GAPS_OPEN)):
                    break
        return self.fwd.make_profile(cells, strategy)

    def best_profile(self, strategy: int = COLLAPSE_CHAINS) -> Profile:
        cells: set = set()
        self.add_trace(self.fwd.end_cell, cells, 0, bool(strategy & KEEP_GAPS_OPEN))
        return self.fwd.make_profile(cells, strategy)
