"""Weighted finite-state profiles over alignment columns.

Counterpart of the reference's Profile
(reference src/profile.h:13-76): the ancestral-sequence data
structure.  States are toposorted; each is either null or emits with a
[C, A] log-absorption tensor; transitions carry a log-probability, a best
alignment fragment, and (optionally) expected event counts.  States obey
the Wait/Ready normal form (a state may have null-out or absorb-out
transitions, not both; add_ready_states splits irregular states,
profile.cpp:268-319).

Design difference from the reference: emission tensors live in one dense
[S, C, A] array (emit states indexed) so the DP's emission inner products
batch into single einsums on device; the transition graph stays a
host-side structure (state counts are 10^2-10^4; graph surgery is
latency-bound, not FLOP-bound).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.special import logsumexp

from historian_tpu_torch.core.alignpath import AlignPath, residues_in_row
from historian_tpu_torch.core.alphabet import is_wildcard
from historian_tpu_torch.core.seqs import FastSeq

WAIT_SUFFIX = ";"
READY_SUFFIX = "."


def _fmt_lp(v: float) -> str:
    """Reference JSON number format (std::to_string / '-inf')."""
    if v == -np.inf:
        return '"-inf"'
    if v == np.inf:
        return '"inf"'
    return f"{v:.6f}"


@dataclass
class ProfState:
    name: str = ""
    meta: dict = field(default_factory=dict)
    in_trans: list[int] = field(default_factory=list)
    null_out: list[int] = field(default_factory=list)
    absorb_out: list[int] = field(default_factory=list)
    lp_absorb: np.ndarray | None = None  # [C, A] or None for null states
    align_path: AlignPath = field(default_factory=dict)
    seq_coords: dict[int, int] = field(default_factory=dict)

    @property
    def is_null(self) -> bool:
        return self.lp_absorb is None

    @property
    def is_emit(self) -> bool:
        return self.lp_absorb is not None

    @property
    def is_start(self) -> bool:
        return not self.in_trans

    @property
    def is_emit_or_start(self) -> bool:
        return self.is_emit or self.is_start

    @property
    def is_ready(self) -> bool:
        return not self.null_out

    @property
    def is_wait(self) -> bool:
        return not self.absorb_out


@dataclass
class ProfTrans:
    src: int
    dest: int
    lp: float = -np.inf
    align_path: AlignPath = field(default_factory=dict)
    counts: object = None  # EigenCounts | None


class Profile:
    def __init__(self, components: int, alph_size: int, root_row: int):
        self.components = components
        self.alph_size = alph_size
        self.root_row = root_row
        self.name = ""
        self.meta: dict[str, str] = {}
        self.states: list[ProfState] = []
        self.trans: list[ProfTrans] = []
        self.seqs: dict[int, str] = {}
        self.equiv_absorb_state: dict[int, int] = {}

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_sequence(cls, components: int, alphabet, seq: FastSeq, row: int) -> "Profile":
        """Leaf profile: a linear chain of emit states, one per residue
        (profile.cpp:23-76).  Wildcard/invalid chars absorb uniformly."""
        p = cls(components, alphabet.size, row)
        p.name = seq.name
        n = len(seq.seq)
        start = ProfState(name="START")
        start.seq_coords[row] = 0
        p.states.append(start)
        invalid = 0
        for pos, ch in enumerate(seq.seq):
            lp = np.full((components, alphabet.size), -np.inf)
            if is_wildcard(ch):
                lp[:] = 0.0
            else:
                tok = alphabet.tokenize_char(ch)
                if tok < 0:
                    invalid += 1
                    lp[:] = 0.0
                else:
                    lp[:, tok] = 0.0
            st = ProfState(name=f"{ch}{pos + 1}", lp_absorb=lp)
            st.align_path = {row: np.array([True])}
            st.seq_coords[row] = pos + 1
            p.states.append(st)
        end = ProfState(name="END")
        end.seq_coords[row] = n
        p.states.append(end)
        for pos in range(n + 1):
            t = ProfTrans(src=pos, dest=pos + 1, lp=0.0)
            p.trans.append(t)
            if pos == n:
                p.states[pos].null_out.append(pos)
            else:
                p.states[pos].absorb_out.append(pos)
            p.states[pos + 1].in_trans.append(pos)
        p.seqs[row] = seq.seq
        return p

    # --------------------------------------------------------------- accessors
    @property
    def size(self) -> int:
        return len(self.states)

    @property
    def start(self) -> ProfState:
        return self.states[0]

    @property
    def end(self) -> ProfState:
        return self.states[-1]

    def is_empty(self) -> bool:
        return all(s.is_null for s in self.states)

    def get_trans(self, src: int, dest: int) -> ProfTrans | None:
        for t in self.states[dest].in_trans:
            if self.trans[t].src == src:
                return self.trans[t]
        return None

    def emit_state_indices(self) -> np.ndarray:
        return np.array([i for i, s in enumerate(self.states) if s.is_emit], dtype=np.int64)

    def absorb_tensor(self) -> np.ndarray:
        """[S, C, A] dense log-absorption; null states -inf."""
        out = np.full((self.size, self.components, self.alph_size), -np.inf)
        for i, s in enumerate(self.states):
            if s.is_emit:
                out[i] = s.lp_absorb
        return out

    def align_column(self, s: int) -> dict[int, str]:
        """Characters emitted by state s, wildcard for the un-sequenced
        ancestor rows (profile.cpp:100-110).

        Memoized per state -- count extraction requests the same columns
        for hundreds of thousands of cells; callers mutate the result, so
        a fresh dict is returned each time."""
        cache = self.__dict__.get("_align_col_cache")
        if cache is None:
            cache = self.__dict__["_align_col_cache"] = {}
        hit = cache.get(s)
        if hit is None:
            col: dict[int, str] = {}
            st = self.states[s]
            for row, rp in st.align_path.items():
                if len(rp) and rp[0]:
                    if row in st.seq_coords:
                        col[row] = self.seqs[row][st.seq_coords[row] - 1]
                    else:
                        col[row] = "*"
            hit = cache[s] = col
        return dict(hit)

    def as_chain(self) -> np.ndarray | None:
        """[size] per-state incoming-transition log-probs if this profile
        is a PURE EMIT CHAIN (START -> emit_1 -> ... -> emit_n -> END with
        exactly one transition between consecutive states and no interior
        null states), else None.

        Leaf profiles (from_sequence) and best-trace profiles under
        COLLAPSE_CHAINS (the -fast mode, where every interior non-fork
        cell is summed out) have exactly this shape, which is what lets
        the banded scan kernel (ops/pairforward.py) run the composition
        DP on device: the DAG recurrence degenerates to the classic
        pair-HMM grid.  Memoized on the profile."""
        cached = self.__dict__.get("_as_chain", False)
        if cached is not False:
            return cached
        out = self._as_chain_uncached()
        self.__dict__["_as_chain"] = out
        return out

    def _as_chain_uncached(self) -> np.ndarray | None:
        n = self.size - 2
        if n < 1 or len(self.trans) != n + 1:
            return None
        edge_lp = np.zeros(self.size)
        for s in range(1, self.size):
            st = self.states[s]
            if len(st.in_trans) != 1:
                return None
            t = self.trans[st.in_trans[0]]
            if t.src != s - 1:
                return None
            if (s < self.size - 1) != st.is_emit:
                return None  # interior states must emit; END must be null
            edge_lp[s] = t.lp
        if self.states[0].in_trans or not self.states[0].is_null:
            return None
        return edge_lp

    # ------------------------------------------------------------- operations
    def left_multiply(self, sub_mats: np.ndarray) -> "Profile":
        """New profile with lpAbsorb' = log(subMat @ exp(lpAbsorb)),
        vectorized across all emit states (profile.cpp:78-91)."""
        out = self._shallow_copy()
        emit_idx = self.emit_state_indices()
        if len(emit_idx):
            lp = np.stack([self.states[i].lp_absorb for i in emit_idx])  # [E, C, A]
            mx = lp.max(axis=2, keepdims=True)  # [E, C, 1]
            safe_mx = np.where(np.isfinite(mx), mx, 0.0)
            p = np.exp(lp - safe_mx)
            with np.errstate(divide="ignore"):
                new_lp = np.log(np.einsum("cad,ecd->eca", sub_mats, p)) + safe_mx
            for k, i in enumerate(emit_idx):
                out.states[i].lp_absorb = new_lp[k]
        return out

    def _shallow_copy(self) -> "Profile":
        out = Profile(self.components, self.alph_size, self.root_row)
        out.name = self.name
        out.meta = dict(self.meta)
        out.seqs = dict(self.seqs)
        out.equiv_absorb_state = dict(self.equiv_absorb_state)
        out.trans = [ProfTrans(t.src, t.dest, t.lp, t.align_path, t.counts) for t in self.trans]
        for s in self.states:
            out.states.append(
                ProfState(
                    name=s.name,
                    meta=dict(s.meta),
                    in_trans=list(s.in_trans),
                    null_out=list(s.null_out),
                    absorb_out=list(s.absorb_out),
                    lp_absorb=None if s.lp_absorb is None else s.lp_absorb.copy(),
                    align_path=s.align_path,
                    seq_coords=dict(s.seq_coords),
                )
            )
        return out

    def calc_sum_path_absorb_probs(self, log_cpt_weight: np.ndarray, log_ins_prob: np.ndarray, tag: str | None = "cumLogProb") -> float:
        """Total path likelihood through the profile (profile.cpp:112-131)."""
        lp_cum = np.full(self.size, -np.inf)
        lp_cum[0] = 0.0
        for pos in range(1, self.size):
            st = self.states[pos]
            if st.is_null:
                lp_abs = 0.0
            else:
                lp_abs = logsumexp(log_cpt_weight[:, None] + log_ins_prob + st.lp_absorb)
            acc = -np.inf
            for ti in st.in_trans:
                t = self.trans[ti]
                if t.src >= pos:
                    raise AssertionError(f"transition {t.src}->{t.dest} is not toposorted")
                acc = np.logaddexp(acc, lp_cum[t.src] + t.lp + lp_abs)
            lp_cum[pos] = acc
            if tag is not None:
                st.meta[tag] = _cpp_to_string(acc)
        return float(lp_cum[-1])

    # -------------------------------------------------------- normal-form fixup
    def add_ready_states(self) -> "Profile":
        """Split irregular states (both null-out and absorb-out) into a
        Wait state (keeps null-out) + a Ready state (takes absorb-out)
        linked by a free transition (profile.cpp:268-319)."""
        old2new: list[int] = [0] * self.size
        prof = self._shallow_copy()
        prof_states = prof.states
        n = 0
        appended: list[ProfState] = []
        for s in range(self.size):
            old2new[s] = n
            n += 1
            st = self.states[s]
            if not st.is_ready and not st.is_wait:
                ready = ProfState(
                    name=st.name + READY_SUFFIX,
                    meta=dict(st.meta),
                    seq_coords=dict(st.seq_coords),
                )
                old_ready_idx = len(prof_states) + len(appended)
                new_ready_idx = n
                n += 1
                ready_trans_idx = len(prof.trans)
                prof_states[s].name += WAIT_SUFFIX
                ready.absorb_out = prof_states[s].absorb_out
                prof_states[s].absorb_out = []
                for t in ready.absorb_out:
                    prof.trans[t].src = old_ready_idx
                prof.trans.append(ProfTrans(src=s, dest=old_ready_idx, lp=0.0))
                prof_states[s].null_out.append(ready_trans_idx)
                ready.in_trans.append(ready_trans_idx)
                appended.append(ready)
                old2new.append(new_ready_idx)
        all_states = prof_states + appended
        reordered: list[ProfState] = [None] * len(all_states)
        for old_idx, new_idx in enumerate(old2new):
            reordered[new_idx] = all_states[old_idx]
        prof.states = reordered
        for t in prof.trans:
            t.src = old2new[t.src]
            t.dest = old2new[t.dest]
        prof.equiv_absorb_state = {
            old2new[k]: old2new[v] for k, v in self.equiv_absorb_state.items()
        }
        prof.assert_transitions_consistent()
        prof.assert_all_states_wait_or_ready()
        prof.assert_path_to_end_exists()
        return prof

    # ------------------------------------------------------------- assertions
    def assert_transitions_consistent(self) -> None:
        for i, s in enumerate(self.states):
            for t in s.in_trans:
                assert self.trans[t].dest == i, "incoming transition dest mismatch"
            for t in s.null_out:
                assert self.trans[t].src == i, "null-out transition src mismatch"
            for t in s.absorb_out:
                assert self.trans[t].src == i, "absorb-out transition src mismatch"

    def assert_all_states_wait_or_ready(self) -> None:
        for s in self.states:
            assert s.is_ready or s.is_wait, f"state {s.name} is neither Wait nor Ready"

    def assert_path_to_end_exists(self) -> None:
        self.example_path_to_end()

    def example_path_to_end(self) -> list[int]:
        from_start = [False] * self.size
        prev = [0] * self.size
        from_start[0] = True
        for i in range(self.size):
            if from_start[i]:
                for t in self.states[i].null_out + self.states[i].absorb_out:
                    dest = self.trans[t].dest
                    assert dest > i, "transition violates toposort"
                    from_start[dest] = True
                    prev[dest] = i
        assert from_start[-1], "no path from start to end"
        path = []
        j = self.size - 1
        while j != 0:
            path.append(j)
            j = prev[j]
        path.append(0)
        return list(reversed(path))

    def assert_seq_coords_consistent(self) -> None:
        for t in self.trans:
            assert_seq_coords_consistent(
                self.states[t.src].seq_coords,
                self.states[t.dest].seq_coords,
                t.align_path,
                self.states[t.dest].align_path,
            )

    # ------------------------------------------------------------------- JSON
    def to_json(self) -> str:
        out = ["{"]
        if self.name:
            out.append(f' "name": "{self.name}",')
        if self.meta:
            out.append(' "meta": ' + _meta_json(self.meta, 2) + ",")
        out.append(f' "alphSize": {self.alph_size},')
        out.append(' "state": [')
        for s_idx, st in enumerate(self.states):
            out.append("  {")
            out.append(f'   "n": {s_idx},')
            if st.name:
                out.append(f'   "name": "{st.name}",')
            if st.meta:
                out.append('   "meta": ' + _meta_json(st.meta, 4) + ",")
            if st.align_path:
                out.append('   "path": ' + _align_path_json(st.align_path) + ",")
            if st.seq_coords:
                cells = ", ".join(f"[ {r}, {c} ]" for r, c in sorted(st.seq_coords.items()))
                out.append(f'   "seqPos": [ {cells} ],')
            if st.is_emit:
                cpts = ", ".join(
                    "[ " + ", ".join(_fmt_lp(v) for v in st.lp_absorb[c]) + " ]"
                    for c in range(self.components)
                )
                out.append(f'   "lpAbsorb": [{cpts}],')
            trans_strs = []
            for ti in sorted(set(st.null_out) | set(st.absorb_out)):
                t = self.trans[ti]
                s = f' {{ "to": {t.dest}, "lpTrans": {_fmt_lp(t.lp)}'
                if t.align_path:
                    s += ', "path": ' + _align_path_json(t.align_path)
                s += " }"
                trans_strs.append(s)
            out.append('   "trans": [' + ",\n             ".join(trans_strs) + " ]")
            out.append("  }" + ("," if s_idx < self.size - 1 else ""))
        out.append(" ]")
        out.append("}")
        return "\n".join(out) + "\n"


def _align_path_json(path: AlignPath) -> str:
    parts = []
    for row in sorted(path):
        body = "".join("*" if b else "-" for b in path[row])
        parts.append(f' [ {row}, "{body}" ]')
    return "[" + ",".join(parts) + " ]"


def _meta_json(meta: dict, indent: int) -> str:
    """Reference JsonUtil::toString(map<string,string>) layout: single
    entry inline, multiple entries one per line at the given indent."""
    if not meta:
        return "{ }"
    items = sorted(meta.items())
    if len(items) == 1:
        k, v = items[0]
        return f'{{ "{k}": "{v}" }}'
    ind = " " * indent
    body = ",".join(f'\n{ind} "{k}": "{v}"' for k, v in items)
    return "\n" + ind + "{" + body + "\n" + ind + "}"


def _cpp_to_string(v: float) -> str:
    """std::to_string(double): fixed 6 decimals (used in meta tags)."""
    if v == -np.inf:
        return "-inf"
    if v == np.inf:
        return "inf"
    return f"{v:.6f}"


def assert_seq_coords_consistent(src_coords, dest_coords, trans_path, dest_path) -> None:
    """Reference consistency check (profile.cpp:245-261)."""
    coords = dict(src_coords)
    get = coords.get
    for row, rp in trans_path.items():
        coords[row] = get(row, 0) + int(np.count_nonzero(rp))
    for row, rp in dest_path.items():
        coords[row] = get(row, 0) + int(np.count_nonzero(rp))
    for row, c in dest_coords.items():
        assert row in coords, f"missing coordinate for sequence {row}"
        assert coords[row] == c, (
            f"sequence coord {row}: accumulated {coords[row]} != dest {c}"
        )
