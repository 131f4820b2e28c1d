"""Continuous-time substitution + indel rate models.

Counterpart of the reference's model layer
(reference src/model.h:43-163).  A RateModel is a mixture of
components, each with a root/insert probability vector and a rate matrix,
plus four global indel parameters.  All arrays are dense numpy float64
[C, A] / [C, A, A] tensors (alphabet <= 64), so the whole model ships to
device as two small tensors; the host keeps f64 masters for parity with
the reference's GSL double math.

JSON read/write matches the reference format exactly
(model.cpp:172-280): off-diagonal "subrate" entries with implicit
diagonal, optional "rootprob" (else equilibrium solve), optional
"mixture" array with per-component "weight".
"""

from __future__ import annotations

import json
import math
from typing import IO

import numpy as np
import scipy.linalg

from historian_tpu_torch.core.alphabet import WILDCARD_CHAR, Alphabet

DEFAULT_DISTANCE_MATRIX_ITERATIONS = 100


def equilibrium_prob_vector(sub_rate: np.ndarray) -> np.ndarray:
    """Solve pi Q = 0, sum(pi) = 1 by least squares (model.cpp:282-320)."""
    a = sub_rate.shape[0]
    m = np.zeros((a + 1, a))
    m[:a, :] = sub_rate.T
    m[a, :] = 1.0
    b = np.zeros(a + 1)
    b[a] = 1.0
    eqm, *_ = np.linalg.lstsq(m, b, rcond=None)
    eqm = np.maximum(eqm, 0.0)
    eqm[eqm < 1e-12] = 0.0  # snap least-squares noise so output prints exact zeros
    return eqm / eqm.sum()


def expm(rate_matrix: np.ndarray, t: float) -> np.ndarray:
    """Matrix exponential by scaling-and-squaring (host f64 path)."""
    return scipy.linalg.expm(rate_matrix * t)


def decay_wait_time(decay_rate: float, time_interval: float) -> float:
    """Expected wait before an irreversible decay event, conditioned on the
    event having occurred within the interval (model.cpp:1106-1108)."""
    x = decay_rate * time_interval
    if x > 700:  # e^x overflows double; the correction term vanishes
        return 1.0 / decay_rate
    return 1.0 / decay_rate - time_interval / math.expm1(x)


class RateModel:
    def __init__(
        self,
        alphabet: str | Alphabet,
        ins_rate: float = 0.0,
        del_rate: float = 0.0,
        ins_ext_prob: float = 0.0,
        del_ext_prob: float = 0.0,
        cpt_weight: np.ndarray | None = None,
        ins_prob: np.ndarray | None = None,
        sub_rate: np.ndarray | None = None,
        wildcard: str = WILDCARD_CHAR,
    ):
        self.alphabet = alphabet if isinstance(alphabet, Alphabet) else Alphabet(alphabet, wildcard)
        a = self.alphabet.size
        self.ins_rate = float(ins_rate)
        self.del_rate = float(del_rate)
        self.ins_ext_prob = float(ins_ext_prob)
        self.del_ext_prob = float(del_ext_prob)
        if sub_rate is None:
            sub_rate = np.zeros((1, a, a))
        self.sub_rate = np.asarray(sub_rate, dtype=np.float64)
        c = self.sub_rate.shape[0]
        if ins_prob is None:
            ins_prob = np.stack([equilibrium_prob_vector(self.sub_rate[i]) for i in range(c)])
        self.ins_prob = np.asarray(ins_prob, dtype=np.float64)
        if cpt_weight is None:
            cpt_weight = np.full(c, 1.0 / c)
        self.cpt_weight = np.asarray(cpt_weight, dtype=np.float64)

    # ------------------------------------------------------------- accessors
    @property
    def components(self) -> int:
        return len(self.cpt_weight)

    @property
    def alphabet_size(self) -> int:
        return self.alphabet.size

    @property
    def wildcard(self) -> str:
        return self.alphabet.wildcard

    # ---------------------------------------------------------------- JSON IO
    @classmethod
    def from_json(cls, obj: dict) -> "RateModel":
        alphabet = Alphabet(obj["alphabet"], obj.get("wildcard", WILDCARD_CHAR))
        a = alphabet.size

        def read_component(jm: dict):
            sr = np.zeros((a, a))
            rate_matrix = jm["subrate"]
            for i in range(a):
                si = alphabet.symbol(i)
                row = rate_matrix.get(si)
                if row is None:
                    continue
                for j in range(a):
                    if j == i:
                        continue
                    sj = alphabet.symbol(j)
                    if sj in row:
                        rate = float(row[sj])
                        sr[i, j] += rate
                        sr[i, i] -= rate
            if "rootprob" in jm:
                ip = np.zeros(a)
                for i in range(a):
                    si = alphabet.symbol(i)
                    if si in jm["rootprob"]:
                        ip[i] = float(jm["rootprob"][si])
            else:
                ip = equilibrium_prob_vector(sr)
            weight = float(jm["weight"]) if isinstance(jm.get("weight"), (int, float)) else 1.0
            return sr, ip, weight

        if isinstance(obj.get("mixture"), list):
            parts = [read_component(c) for c in obj["mixture"]]
        else:
            parts = [read_component(obj)]
        sub_rate = np.stack([p[0] for p in parts])
        ins_prob = np.stack([p[1] for p in parts])
        weights = np.array([p[2] for p in parts])
        weights = weights / weights.sum()
        return cls(
            alphabet=alphabet,
            ins_rate=float(obj["insrate"]),
            del_rate=float(obj["delrate"]),
            ins_ext_prob=float(obj["insextprob"]),
            del_ext_prob=float(obj["delextprob"]),
            cpt_weight=weights,
            ins_prob=ins_prob,
            sub_rate=sub_rate,
        )

    @classmethod
    def from_json_string(cls, text: str) -> "RateModel":
        return cls.from_json(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "RateModel":
        with open(path) as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"can't parse model file {path!r} as JSON: {e}") from e
        return cls.from_json(data)

    def _write_component(self, cpt: int, out: list[str]) -> None:
        ind = "   " if self.components > 1 else " "
        a = self.alphabet_size
        if self.components > 1:
            out.append(f'{ind}"weight": {self.cpt_weight[cpt]:g},')
        out.append(f'{ind}"rootprob":')
        out.append(f"{ind}{{")
        for i in range(a):
            sep = "," if i < a - 1 else ""
            out.append(f'{ind} "{self.alphabet.symbol(i)}": {self.ins_prob[cpt, i]:g}{sep}')
        out.append(f"{ind}}},")
        out.append(f'{ind}"subrate":')
        out.append(f"{ind}{{")
        for i in range(a):
            cells = []
            for j in range(a):
                if i != j:
                    cells.append(f'"{self.alphabet.symbol(j)}": {self.sub_rate[cpt, i, j]:g}')
            row = f'{ind} "{self.alphabet.symbol(i)}": {{ ' + ", ".join(cells) + " }"
            out.append(row + ("," if i < a - 1 else ""))
        out.append(f"{ind}}}")

    def to_json_string(self) -> str:
        out: list[str] = ["{"]
        out.append(f' "alphabet": "{self.alphabet.symbols}",')
        if self.wildcard != WILDCARD_CHAR:
            out.append(f' "wildcard": "{self.wildcard}",')
        out.append(f' "insrate": {self.ins_rate:g},')
        out.append(f' "insextprob": {self.ins_ext_prob:g},')
        out.append(f' "delrate": {self.del_rate:g},')
        out.append(f' "delextprob": {self.del_ext_prob:g},')
        if self.components > 1:
            out.append(' "mixture": [')
            for c in range(self.components):
                out.append("  {")
                self._write_component(c, out)
                out.append("  }" + ("," if c < self.components - 1 else ""))
            out.append(" ]")
        else:
            self._write_component(0, out)
        out.append("}")
        return "\n".join(out) + "\n"

    def write(self, out: IO[str]) -> None:
        out.write(self.to_json_string())

    # ------------------------------------------------------------ derivations
    def sub_prob_matrix(self, t: float) -> np.ndarray:
        """[C, A, A] substitution probabilities exp(Q t) per component."""
        return np.stack([expm(self.sub_rate[c], t) for c in range(self.components)])

    def expected_substitution_rate(self) -> float:
        r = 0.0
        for c in range(self.components):
            eqm = equilibrium_prob_vector(self.sub_rate[c])
            off = self.sub_rate[c].copy()
            np.fill_diagonal(off, 0.0)
            r += self.cpt_weight[c] * float(eqm @ off.sum(axis=1))
        return r

    def expected_insertion_length(self) -> float:
        return 1.0 / (1.0 - self.ins_ext_prob)

    def expected_deletion_length(self) -> float:
        return 1.0 / (1.0 - self.del_ext_prob)

    def scale_rates(self, subst_multiplier: float, indel_multiplier: float | None = None) -> "RateModel":
        if indel_multiplier is None:
            indel_multiplier = subst_multiplier
        return RateModel(
            alphabet=self.alphabet,
            ins_rate=self.ins_rate * indel_multiplier,
            del_rate=self.del_rate * indel_multiplier,
            ins_ext_prob=self.ins_ext_prob,
            del_ext_prob=self.del_ext_prob,
            cpt_weight=self.cpt_weight.copy(),
            ins_prob=self.ins_prob.copy(),
            sub_rate=self.sub_rate * subst_multiplier,
        )

    def normalize_substitution_rate(self) -> "RateModel":
        return self.scale_rates(1.0 / self.expected_substitution_rate())

    def copy_indel_params(self, other: "RateModel") -> "RateModel":
        out = self.scale_rates(1.0)
        out.ins_rate = other.ins_rate
        out.del_rate = other.del_rate
        out.ins_ext_prob = other.ins_ext_prob
        out.del_ext_prob = other.del_ext_prob
        return out

    # ----------------------------------------------------------- ML distances
    def pair_count_matrix(self, x_gapped: str, y_gapped: str) -> np.ndarray:
        """[A, A] aligned-pair counts, skipping gaps/wildcards/invalid."""
        if len(x_gapped) != len(y_gapped):
            raise ValueError("sequences have different lengths")
        tx = self.alphabet.tokenize(x_gapped)
        ty = self.alphabet.tokenize(y_gapped)
        ok = (tx >= 0) & (ty >= 0)
        a = self.alphabet_size
        counts = np.zeros((a, a))
        np.add.at(counts, (tx[ok], ty[ok]), 1)
        return counts

    def neg_log_like_distance(self, t: float, pair_counts: np.ndarray) -> float:
        sub = self.sub_prob_matrix(t)
        p = np.einsum("c,cij->ij", self.cpt_weight, sub)
        with np.errstate(divide="ignore"):
            lp = np.log(p)
        mask = pair_counts > 0
        return -float((pair_counts[mask] * lp[mask]).sum())

    def jukes_cantor_distance(self, pair_counts: np.ndarray) -> float:
        same = float(np.trace(pair_counts))
        diff = float(pair_counts.sum() - same)
        total = same + diff
        if total == 0:
            return math.nan  # matches the reference's 0/0 division result
        p_diff = diff / total
        a = float(self.alphabet_size)
        if p_diff >= (a - 1) / a:
            return math.inf
        return -((a - 1) / a) * math.log(1 - (a / (a - 1)) * p_diff) / self.expected_substitution_rate()

    def ml_distance_from_counts(self, pair_counts: np.ndarray, max_iterations: int = DEFAULT_DISTANCE_MATRIX_ITERATIONS) -> float:
        """Golden-section ML branch length (model.cpp:584-655 semantics)."""
        t_min, t_max = 1e-9, 10.0
        jc = self.jukes_cantor_distance(pair_counts)
        # std::min/max NaN semantics: NaN comparisons are false, so a NaN
        # tJC (no aligned residue pairs) clamps to t_min like the reference
        tjc = t_min if math.isnan(jc) else min(t_max, max(t_min, jc))
        if max_iterations <= 0:
            return tjc
        nll = lambda t: self.neg_log_like_distance(t, pair_counts)
        t_lower = min(t_min, tjc / 2)
        t_upper = max(t_max, tjc * 2)
        ll_lower, ll_upper = nll(t_lower), nll(t_upper)
        lljc = nll(tjc)
        if lljc < ll_lower and lljc < ll_upper:
            t = tjc
        else:
            # bracket by bisective scanning (reference fallback)
            found = False
            scan_lo, scan_hi = t_lower, t_upper
            t = tjc
            while not found and scan_hi - scan_lo > t_lower:
                step = (scan_hi - scan_lo) / 4
                x = scan_lo
                while x < scan_hi and not found:
                    if nll(x) < ll_lower and nll(x) < ll_upper:
                        found = True
                        t = x
                    x += step
                if not found:
                    if ll_lower < ll_upper:
                        scan_hi = (scan_lo + scan_hi) / 2
                    else:
                        scan_lo = (scan_lo + scan_hi) / 2
            if not found:
                return t_lower if ll_lower < ll_upper else t_upper
        # GSL goldensection minimizer, replicated step-for-step for parity
        # with the reference (model.cpp:584-655 uses
        # gsl_min_fminimizer_goldensection with a 1% interval test).
        golden = 0.3819660  # (3 - sqrt(5)) / 2
        x_min, f_min = t, nll(t)
        x_lo, x_hi = t_lower, t_upper
        for _ in range(max_iterations):
            w_lower = x_min - x_lo
            w_upper = x_hi - x_min
            x_new = x_min + golden * (w_upper if w_upper > w_lower else -w_lower)
            f_new = nll(x_new)
            if f_new < f_min:
                x_min, f_min = x_new, f_new
            elif x_new < x_min and f_new > f_min:
                x_lo = x_new
            elif x_new > x_min and f_new > f_min:
                x_hi = x_new
            else:
                break  # can't improve (GSL_FAILURE)
            # gsl_min_test_interval(a, b, 0, 0.01)
            min_abs = min(abs(x_lo), abs(x_hi)) if x_lo * x_hi > 0 else 0.0
            if x_hi - x_lo < 0.01 * min_abs:
                break
        return x_min

    def ml_distance(self, x_gapped: str, y_gapped: str, max_iterations: int = DEFAULT_DISTANCE_MATRIX_ITERATIONS) -> float:
        return self.ml_distance_from_counts(self.pair_count_matrix(x_gapped, y_gapped), max_iterations)

    def distance_matrix(self, gapped_seqs, max_iterations: int = DEFAULT_DISTANCE_MATRIX_ITERATIONS, use_device: bool = True) -> np.ndarray:
        """All-pairs ML distance matrix.

        With use_device and more than two sequences, every pair is solved
        at once on the selected device (historian_tpu_torch/ops/distance.py);
        otherwise each pair runs its own golden-section loop, as the
        reference does (model.cpp:531-549).
        """
        n = len(gapped_seqs)
        if use_device and n > 2:
            from historian_tpu_torch import device as devmod
            from historian_tpu_torch.ops.distance import batched_ml_distances

            return batched_ml_distances(self, gapped_seqs, max_iterations, devmod.current())
        dist = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                dist[i, j] = dist[j, i] = self.ml_distance(
                    gapped_seqs[i].seq, gapped_seqs[j].seq, max_iterations
                )
        return dist


class CachingRateModel(RateModel):
    """Memoizes sub_prob_matrix(t) keyed by t at 5-sig-fig precision,
    caching on second use and flushing at 1000 entries, computing through
    the eigendecomposition (reference CachingRateModel,
    model.cpp:1429-1466).  Used by the MCMC sampler, where the same
    branch lengths recur across proposals."""

    PRECISION = 5
    FLUSH_SIZE = 1000

    def __init__(self, model: RateModel):
        super().__init__(
            alphabet=model.alphabet,
            ins_rate=model.ins_rate,
            del_rate=model.del_rate,
            ins_ext_prob=model.ins_ext_prob,
            del_ext_prob=model.del_ext_prob,
            cpt_weight=model.cpt_weight.copy(),
            ins_prob=model.ins_prob.copy(),
            sub_rate=model.sub_rate.copy(),
        )
        from historian_tpu_torch.models.eigen import EigenModel

        self._eigen = EigenModel(self)
        self._cache: dict[str, np.ndarray] = {}
        self._count: dict[str, int] = {}

    def _time_key(self, t: float) -> str:
        return f"{t:.{self.PRECISION}e}"

    def sub_prob_matrix(self, t: float) -> np.ndarray:
        key = self._time_key(t)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        m = self._eigen.sub_prob_matrix(t)
        self._count[key] = self._count.get(key, 0) + 1
        if self._count[key] > 1:  # cache on 2nd evaluation
            if len(self._cache) >= self.FLUSH_SIZE:
                self._cache.clear()
                self._count.clear()
            self._cache[key] = m
        return m


class ProbModel:
    """Branch-conditioned probabilities at time t (model.cpp:374-447).

    States: Match=0, Insert=1, Delete=2, End=3 (Start aliases Match).
    """

    MATCH, INSERT, DELETE, END = 0, 1, 2, 3

    def __init__(self, model: RateModel, t: float):
        self.model = model
        self.alphabet = model.alphabet
        self.t = float(t)
        self.ins = 1.0 - math.exp(-model.ins_rate * t)
        self.del_ = 1.0 - math.exp(-model.del_rate * t)
        self.ins_ext = model.ins_ext_prob
        self.del_ext = model.del_ext_prob
        self.ins_wait = decay_wait_time(model.ins_rate, t) if model.ins_rate > 0 else 0.0
        self.del_wait = decay_wait_time(model.del_rate, t) if model.del_rate > 0 else 0.0
        self.cpt_weight = model.cpt_weight.copy()
        self.ins_vec = model.ins_prob.copy()
        self.sub_mat = model.sub_prob_matrix(t)

    @property
    def components(self) -> int:
        return len(self.cpt_weight)

    def trans_prob(self, src: int, dest: int) -> float:
        ins, dele, ins_ext, del_ext = self.ins, self.del_, self.ins_ext, self.del_ext
        if src in (self.MATCH,):
            if dest == self.MATCH:
                return (1 - ins) * (1 - dele)
            if dest == self.INSERT:
                return ins
            if dest == self.DELETE:
                return (1 - ins) * dele
            if dest == self.END:
                return 1 - ins
        elif src == self.INSERT:
            if dest == self.MATCH:
                return (1 - ins_ext) * (1 - dele)
            if dest == self.INSERT:
                return ins_ext
            if dest == self.DELETE:
                return (1 - ins_ext) * dele
            if dest == self.END:
                return 1 - ins_ext
        elif src == self.DELETE:
            if dest in (self.MATCH, self.END):
                return 1 - del_ext
            if dest == self.INSERT:
                return 0.0
            if dest == self.DELETE:
                return del_ext
        return 0.0

    @staticmethod
    def get_state(parent_ungapped: bool, child_ungapped: bool) -> int:
        if parent_ungapped:
            return ProbModel.MATCH if child_ungapped else ProbModel.DELETE
        return ProbModel.INSERT if child_ungapped else ProbModel.END

    def to_json_string(self) -> str:
        a = self.model.alphabet_size
        sym = self.model.alphabet.symbol
        out = ["{"]
        out.append(f' "alphabet": "{self.model.alphabet.symbols}",')
        out.append(f' "insBegin": {self.ins:g},')
        out.append(f' "insExtend": {self.ins_ext:g},')
        out.append(f' "delBegin": {self.del_:g},')
        out.append(f' "delExtend": {self.del_ext:g},')

        def component(cpt: int, ind: str):
            out.append(f'{ind}"insVec": {{')
            for i in range(a):
                sep = "," if i < a - 1 else ""
                out.append(f'{ind} "{sym(i)}": {self.ins_vec[cpt, i]:g}{sep}')
            out.append(f"{ind}}},")
            out.append(f'{ind}"subMat": {{')
            for i in range(a):
                out.append(f'{ind} "{sym(i)}": {{')
                for j in range(a):
                    sep = "," if j < a - 1 else ""
                    out.append(f'{ind}  "{sym(j)}": {self.sub_mat[cpt, i, j]:g}{sep}')
                out.append(f"{ind} }}" + ("," if i < a - 1 else ""))
            out.append(f"{ind}}}")

        if self.components > 1:
            out.append(' "mixture": [')
            for c in range(self.components):
                out.append("  {")
                component(c, "   ")
                out.append("  }" + ("," if c < self.components - 1 else ""))
            out.append(" ]")
        else:
            component(0, " ")
        out.append("}")
        return "\n".join(out) + "\n"


class LogProbModel:
    """Log-space view of a ProbModel (model.cpp:492-504)."""

    def __init__(self, pm: ProbModel):
        with np.errstate(divide="ignore"):
            self.log_cpt_weight = np.log(pm.cpt_weight)
            self.log_ins_prob = np.log(pm.ins_vec)
            self.log_sub_prob = np.log(pm.sub_mat)
