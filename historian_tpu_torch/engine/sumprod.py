"""Tree sum-product engine: likelihoods, posteriors, eigencounts.

Port of historian_tpu/engine/sumprod.py (`SumProductEngine`,
`SumProductFill`, `get_engine`, `accumulate_alignment_eigen_counts`)
over the column-batched Felsenstein passes of ops/felsenstein.py, with
the JAX package's size rules:

- fill: the native host fill (csrc/fill.cpp `sumprod_fill`, up and down
  pass at once) for L x N <= 2^17 cells, else the torch up pass on the
  selected device in float64, its down pass run when first read;
- eigencounts: numpy below 512 columns, else the batched torch
  contraction on the selected device, real for an exactly-real
  eigensystem and complex128 otherwise.

`ROUTES` counts each route taken, keyed by what ran and where.  The
remote-tunnel machinery of the JAX package (the remote native ceiling,
the small-work CPU pin) and its mesh branch are not ported; a native
library that cannot build raises instead of taking another route.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from historian_tpu_torch import device as devmod
from historian_tpu_torch.core.tree import Tree
from historian_tpu_torch.models.counts import EigenCounts
from historian_tpu_torch.models.eigen import get_eigen_model
from historian_tpu_torch.models.ratemodel import RateModel
from historian_tpu_torch.ops import felsenstein
from historian_tpu_torch.ops.felsenstein import GAP_TOK, TreeArrays, tokenize_alignment

MIN_POST_PROB = 0.01

#: routes taken, counted by "<what>:<where>": fill:native, fill:cuda,
#: fill:cpu, down:<device>, post:<device>, counts:numpy,
#: counts:<device>:real and counts:<device>:complex
ROUTES: Counter = Counter()

# small LRU of engines keyed by (model content, tree, device): likelihood
# and count loops reuse one (model, tree) pair many times, and an engine
# computes per-branch matrix exponentials and eigencount integrals.  The
# key holds the exact branch lengths: Newick text rounds them to 6 digits,
# and a tree read back from a file must not find the engine of the tree
# it was written from.
_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 32


def _model_fingerprint(model) -> tuple:
    """Content key for the engine cache: every parameter the engine reads,
    recomputed per call because RateModels are mutable (EM's M-step
    updates them in place)."""
    return (
        type(model).__name__,
        model.alphabet.symbols,
        model.ins_rate,
        model.del_rate,
        model.ins_ext_prob,
        model.del_ext_prob,
        model.sub_rate.tobytes(),
        model.ins_prob.tobytes(),
        model.cpt_weight.tobytes(),
    )


def get_engine(model, tree) -> "SumProductEngine":
    lengths = tuple(float(tree.branch_length(n)) for n in range(tree.n_nodes()))
    key = (_model_fingerprint(model), tree.to_string(), lengths, str(devmod.current()))
    engine = _ENGINE_CACHE.pop(key, None)
    if engine is None:
        engine = SumProductEngine(model, tree)
        if len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    _ENGINE_CACHE[key] = engine  # re-insert as most recent
    return engine


class SumProductEngine:
    """Per-(model, tree) state: branch substitution matrices, eigencount
    integrals, and the fill entry points.  Torch work runs in float64 on
    `device` (default: the selected device)."""

    #: native host fill up to this many L x N cells
    NATIVE_FILL_MAX_CELLS = 1 << 17
    #: eigencounts of a fill this wide or wider run as the torch contraction
    DEVICE_COUNT_MIN_COLUMNS = 512
    #: columns a contraction takes at a time
    COUNT_CHUNK = 8192

    def __init__(self, model: RateModel, tree: Tree, device: torch.device | None = None):
        self.model = model
        self.tree = tree
        self.device = devmod.current() if device is None else device
        self.arrays = TreeArrays(tree)
        n = self.arrays.n_nodes
        c, a = model.components, model.alphabet_size
        sub = np.zeros((n, c, a, a))
        for node in range(n - 1):
            sub[node] = model.sub_prob_matrix(tree.branch_length(node))
        sub[n - 1] = np.eye(a)[None, :, :]  # the root has no branch
        self.branch_sub = sub
        self.eigen = get_eigen_model(model)
        with np.errstate(divide="ignore"):
            self.log_cpt_weight = np.log(model.cpt_weight)
        self.ins_prob = model.ins_prob
        self._tensors: tuple | None = None
        self._count_device_ok: bool | None = None
        self._col_ll_cache: dict[bytes, float] = {}
        self._branch_eigen_sub_count: np.ndarray | None = None

    def tensors(self) -> tuple:
        """(sub, ins_prob, log_cpt_weight) as float64 tensors on the device."""
        if self._tensors is None:
            self._tensors = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=self.device)
                for a in (self.branch_sub, self.ins_prob, self.log_cpt_weight)
            )
        return self._tensors

    @property
    def branch_eigen_sub_count(self) -> np.ndarray:
        """[N, C, A, A] complex J integrals per branch, computed lazily:
        only count extraction reads them."""
        if self._branch_eigen_sub_count is None:
            tree = self.tree
            n = self.arrays.n_nodes
            c, a = self.model.components, self.model.alphabet_size
            self._branch_eigen_sub_count = np.stack(
                [self.eigen.eigen_sub_count(tree.branch_length(node)) for node in range(n - 1)]
                + [np.zeros((c, a, a), dtype=np.complex128)]
            )
        return self._branch_eigen_sub_count

    @property
    def count_device_ok(self) -> bool:
        """True when the eigensystem is EXACTLY real (zero imaginary parts,
        not merely below epsilon), so the real contraction loses nothing."""
        if self._count_device_ok is None:
            e = self.eigen
            self._count_device_ok = bool(
                np.all(e.is_real)
                and not np.any(e.evec.imag)
                and not np.any(e.evec_inv.imag)
                and not np.any(self.branch_eigen_sub_count.imag)
            )
        return self._count_device_ok

    # ------------------------------------------------------------------ fills
    def fill(self, gapped_rows: list[str]) -> "SumProductFill":
        """Up and down passes for all columns at once."""
        return self.fill_tokens(tokenize_alignment(self.model.alphabet, gapped_rows))

    def fill_tokens(self, tokens: np.ndarray) -> "SumProductFill":
        if tokens.shape[1] * self.arrays.n_nodes <= self.NATIVE_FILL_MAX_CELLS:
            return self._native_fill(tokens)
        return self._torch_fill(tokens)

    def _native_fill(self, tokens: np.ndarray) -> "SumProductFill":
        from historian_tpu_torch.native import get_native

        lib = get_native()
        if lib is None:
            raise RuntimeError("the native host fill (historian_tpu_torch/csrc/fill.cpp) "
                               "is unavailable: it did not build, or HISTORIAN_NATIVE=0")
        arr = self.arrays
        n = arr.n_nodes
        L = tokens.shape[1]
        c, a = self.model.components, self.model.alphabet_size
        F, E, G = (np.empty((L, n, c, a)) for _ in range(3))
        logF, logE, logG = (np.empty((L, n, c)) for _ in range(3))
        cpt_ll = np.empty((L, c))
        col_ll = np.empty(L)
        lib.sumprod_fill(
            L, n, c, a,
            np.ascontiguousarray(tokens, dtype=np.int32),
            arr.parent, arr.left, arr.right, arr.sibling,
            np.ascontiguousarray(self.branch_sub),
            np.ascontiguousarray(self.ins_prob),
            np.ascontiguousarray(self.log_cpt_weight),
            np.uint8(1),
            F, logF, E, logE, G, logG, cpt_ll, col_ll,
        )
        ROUTES["fill:native"] += 1
        return SumProductFill(self, tokens, dict(F=F, logF=logF, E=E, logE=logE, G=G, logG=logG,
                                                 cpt_ll=cpt_ll, col_ll=col_ll))

    def _torch_fill(self, tokens: np.ndarray) -> "SumProductFill":
        sub, ins, lw = self.tensors()
        F, logF, E, logE, cpt_ll, col_ll = felsenstein.fill_up(tokens, self.arrays, sub, ins, lw)
        ROUTES[f"fill:{self.device.type}"] += 1
        return SumProductFill(self, tokens, dict(F=F, logF=logF, E=E, logE=logE,
                                                 cpt_ll=cpt_ll, col_ll=col_ll))

    _LAST_FILL: "tuple | None" = None  # (engine, tokens bytes, fill)

    def fill_cached(self, gapped_rows: list[str]) -> "SumProductFill":
        """One-entry fill memo: repeated requests for the messages of one
        alignment reuse its fill and its host copies.  A single global
        entry bounds the footprint ([L, N, C, A] tensors are multi-MB)."""
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)
        key = tokens.tobytes()
        ent = SumProductEngine._LAST_FILL
        if ent is not None and ent[0] is self and ent[1] == key:
            return ent[2]
        fill = self.fill_tokens(tokens)
        SumProductEngine._LAST_FILL = (self, key, fill)
        return fill

    def fill_column(self, col: dict[int, str]) -> "SumProductFill":
        """Single-column fill from a {node: char} map (absent nodes are
        gaps): the per-cell entry point of the Forward DP's count
        machinery (reference SumProduct::initColumn, sumprod.cpp:58-87)."""
        tokens = np.full((self.arrays.n_nodes, 1), GAP_TOK, dtype=np.int32)
        for node, ch in col.items():
            if ch == "-" or ch == ".":
                continue
            tok = self.model.alphabet.tokenize_char(ch)
            tokens[node, 0] = tok if tok >= 0 else felsenstein.WILD_TOK
        return self.fill_tokens(tokens)

    def column_log_likelihoods(self, gapped_rows: list[str]) -> np.ndarray:
        return np.asarray(self.fill(gapped_rows).col_ll)

    _COL_LL_CACHE_MAX = 100_000  # entries (~N bytes each); cleared when exceeded

    def column_log_likelihoods_cached(self, gapped_rows: list[str]) -> np.ndarray:
        """Per-column log-likelihoods memoized by column token content:
        moves that keep the tree fixed change a few columns at a time, and
        the misses run through one batched fill."""
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)  # [N, L]
        cache = self._col_ll_cache
        if len(cache) > self._COL_LL_CACHE_MAX:
            cache.clear()
        keys = [c.tobytes() for c in np.ascontiguousarray(tokens.T)]
        miss: dict[bytes, int] = {}
        for idx, k in enumerate(keys):
            if k not in cache and k not in miss:
                miss[k] = idx
        if miss:
            sel = np.fromiter(miss.values(), dtype=np.int64, count=len(miss))
            ll = self.fill_tokens(np.ascontiguousarray(tokens[:, sel])).col_ll
            for k, l in zip(miss, ll):
                cache[k] = float(l)
        return np.fromiter((cache[k] for k in keys), dtype=np.float64, count=len(keys))

    def log_likelihood_cached(self, gapped_rows: list[str]) -> float:
        return float(self.column_log_likelihoods_cached(gapped_rows).sum())

    def log_likelihood(self, gapped_rows: list[str]) -> float:
        return float(self.column_log_likelihoods(gapped_rows).sum())


class SumProductFill:
    """All messages for all columns; posterior and count extraction.

    `_t` holds the fill's tensors: numpy arrays from the native fill,
    torch tensors on the engine's device from the torch fill, whose "G"
    and "logG" (the down pass) are computed when first read.  Reading an
    attribute of the same name (`fill.F`, ...) gives a numpy copy, made
    once."""

    _NAMES = ("F", "logF", "E", "logE", "G", "logG", "cpt_ll", "col_ll")

    def __init__(self, engine: SumProductEngine, tokens: np.ndarray, tensors: dict):
        self.engine = engine
        self.tokens = tokens  # [N, L]
        self._t = tensors

    def tensor(self, name: str):
        """The fill's tensor `name` as it lies (numpy or torch)."""
        if name not in self._t and name in ("G", "logG"):
            eng = self.engine
            sub, ins, _ = eng.tensors()
            is_gap = torch.as_tensor(self.tokens.T == GAP_TOK, device=eng.device)
            self._t["G"], self._t["logG"] = felsenstein.fill_down(
                self._t["E"], self._t["logE"], is_gap, eng.arrays, sub, ins)
            ROUTES[f"down:{eng.device.type}"] += 1
        return self._t[name]

    def on_device(self, name: str) -> torch.Tensor:
        """The fill's tensor `name` on the engine's device."""
        t = self.tensor(name)
        if isinstance(t, np.ndarray):
            return torch.as_tensor(t, device=self.engine.device)
        return t

    def __getattr__(self, name):
        if name in SumProductFill._NAMES:
            t = self.tensor(name)
            arr = t if isinstance(t, np.ndarray) else t.cpu().numpy()
            setattr(self, name, arr)
            return arr
        raise AttributeError(name)

    @property
    def n_columns(self) -> int:
        return self.tokens.shape[1]

    def rows_at(self, name: str, cols: np.ndarray, node: int) -> np.ndarray:
        """tensor[cols, node] as numpy: gathered where the tensor lies, so
        that a device fill sends back only these rows (the conditional
        PWMs of engine/treealign.py read a few such slices)."""
        host = self.__dict__.get(name)
        if host is not None:
            return host[cols, node]
        t = self.tensor(name)
        if isinstance(t, np.ndarray):
            return t[cols, node]
        return t[torch.as_tensor(cols, device=t.device), int(node)].cpu().numpy()

    # -------------------------------------------------------------- posteriors
    def log_node_post_prob(self, col: int, node: int) -> np.ndarray:
        """[A] log posterior at node, mixture-marginalized."""
        return self.log_node_post_prob_all()[col, node]

    def log_node_post_prob_all(self) -> np.ndarray:
        """[L, N, A] log posteriors for every column and node, computed
        where the fill's tensors lie (the host for a native fill)."""
        if not hasattr(self, "_lnpp"):
            t = [self.tensor(k) for k in ("F", "logF", "G", "logG", "col_ll")]
            dev = t[0].device if isinstance(t[0], torch.Tensor) else torch.device("cpu")
            t = [torch.as_tensor(a, device=dev) for a in t]
            lw = torch.as_tensor(self.engine.log_cpt_weight, device=dev)
            self._lnpp = felsenstein.node_post_prob(*t, lw).cpu().numpy()
            ROUTES[f"post:{dev.type}"] += 1
        return self._lnpp

    def max_post_state(self, col: int, node: int) -> int:
        return int(np.argmax(self.log_node_post_prob_all()[col, node]))

    # ------------------------------------------------- ancestral reconstruction
    def ancestral_gapped_rows(self, gapped_rows: list[str]) -> list[str]:
        """Replace wildcard chars with MAP states (sumprod.cpp:401-413)."""
        map_states = np.argmax(self.log_node_post_prob_all(), axis=2)  # [L, N]
        alphabet = self.engine.model.alphabet
        out = []
        for n, row in enumerate(gapped_rows):
            chars = list(row)
            for col, ch in enumerate(chars):
                if ch == "*":
                    chars[col] = alphabet.symbol(map_states[col, n])
            out.append("".join(chars))
        return out

    def ancestral_post_probs(self, gapped_rows: list[str], min_prob: float = MIN_POST_PROB,
                             max_prob: float = 1.0):
        """{row: {col: {char: prob}}} for wildcard positions (sumprod.cpp:415-426)."""
        lnpp = self.log_node_post_prob_all()
        alphabet = self.engine.model.alphabet
        lp_min, lp_max = np.log(min_prob), np.log(max_prob)
        out: dict[int, dict[int, dict[str, float]]] = {}
        for n, row in enumerate(gapped_rows):
            for col, ch in enumerate(row):
                if ch == "*":
                    lp = lnpp[col, n]
                    sel = (lp >= lp_min) & (lp <= lp_max)
                    if np.any(sel):
                        out.setdefault(n, {})[col] = {
                            alphabet.symbol(i): float(np.exp(lp[i])) for i in np.nonzero(sel)[0]
                        }
        return out

    # ----------------------------------------------------------------- counts
    def _count_mask(self) -> tuple:
        """(mask [L, N], parent_safe, sib_safe): the ungapped nodes whose
        parent is ungapped, and the parent and sibling indices with -1
        clamped to 0."""
        arr = self.engine.arrays
        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent_safe = np.maximum(arr.parent, 0)
        mask = (~gap) & (arr.parent >= 0)[None, :] & ~gap[:, parent_safe]
        return mask, parent_safe, np.maximum(arr.sibling, 0)

    def column_root_array(self) -> np.ndarray:
        """[L] per-column root node (-1 if empty; asserts single root)."""
        arr = self.engine.arrays
        gap = self.tokens.T == GAP_TOK  # [L, N]
        parent_safe = np.maximum(arr.parent, 0)
        parent_gap = np.where(arr.parent[None, :] >= 0, gap[:, parent_safe], True)
        is_root = (~gap) & parent_gap  # [L, N]
        n_roots = is_root.sum(axis=1)
        if np.any(n_roots > 1):
            bad = int(np.argmax(n_roots > 1))
            raise ValueError(f"column {bad} has {n_roots[bad]} roots (expected 1)")
        roots = np.where(n_roots == 1, np.argmax(is_root, axis=1), -1)
        return roots.astype(np.int64)

    def accumulate_root_counts(self, root_counts: np.ndarray, weight=1.0) -> None:
        """root_counts[c,i] += w_l * insProb*F(root_l) * exp(logw+logF-colLL),
        vectorized over columns (sumprod.cpp:264-271); weight may be a
        scalar or a per-column [L] array."""
        eng = self.engine
        roots = self.column_root_array()
        sel = roots >= 0
        if not np.any(sel):
            return
        w = np.broadcast_to(np.asarray(weight, dtype=float), (self.n_columns,))[sel]
        r = roots[sel]
        cols = np.nonzero(sel)[0]
        norm = np.exp(
            eng.log_cpt_weight[None, :] + self.logF[cols, r] - self.col_ll[cols, None]
        )  # [l, C]
        root_counts += np.einsum("l,ci,lci,lc->ci", w, eng.ins_prob, self.F[cols, r], norm)

    def accumulate_eigen_counts(self, root_counts: np.ndarray, eigen_counts: np.ndarray,
                                weight=1.0) -> None:
        """Eigencounts over all columns and branches (sumprod.cpp:294-372):
        for each ungapped non-root node n,

          eigenCounts[c,k,l] += w * scale * (D0 . evec)_k J[n,c,k,l] (U0 . evecInv^T)_l

        with U0 = F[col,n], D0 = G[col,parent]*E[col,sibling] and
        scale = exp(logw_c + logF + logG + logE - colLogLike).

        Batches of DEVICE_COUNT_MIN_COLUMNS columns or more run as the
        torch contraction on the engine's device; smaller ones keep the
        numpy formulation, which pins byte-exact outputs."""
        if self.n_columns >= self.engine.DEVICE_COUNT_MIN_COLUMNS:
            self._accumulate_eigen_counts_device(root_counts, eigen_counts, weight)
            return
        ROUTES["counts:numpy"] += 1
        self.accumulate_root_counts(root_counts, weight)
        eng = self.engine
        L = self.n_columns
        mask, parent_safe, sib_safe = self._count_mask()
        if not np.any(mask):
            return
        U0 = self.F  # [L, N, C, A]
        D0 = self.G[:, parent_safe] * self.E[:, sib_safe]  # [L, N, C, A]
        log_scale = (
            eng.log_cpt_weight[None, None, :]
            + self.logF
            + self.logG[:, parent_safe]
            + self.logE[:, sib_safe]
            - self.col_ll[:, None, None]
        )  # [L, N, C]
        w_col = np.broadcast_to(np.asarray(weight, dtype=float), (L,))
        w = np.where(mask[:, :, None], np.exp(log_scale), 0.0) * w_col[:, None, None]
        db = np.einsum("lnca,cak->lnck", D0, eng.eigen.evec)
        ub = np.einsum("lncb,cmb->lncm", U0, eng.eigen.evec_inv)
        # einsum path search costs ~10s of ms -- worth it only for real
        # column batches, pure overhead for the single-column fills
        eigen_counts += np.einsum(
            "lnc,lnck,lncm,nckm->ckm", w, db, ub, eng.branch_eigen_sub_count, optimize=(L >= 8)
        )

    def _accumulate_eigen_counts_device(self, root_counts: np.ndarray, eigen_counts: np.ndarray,
                                        weight) -> None:
        """The torch contraction on the engine's device: real
        (`felsenstein.eigen_counts`) for an exactly-real eigensystem,
        complex128 (`eigen_counts_cplx`) otherwise; then the root counts."""
        eng = self.engine
        dev = eng.device
        mask, parent_safe, sib_safe = self._count_mask()
        w_col = np.broadcast_to(np.asarray(weight, dtype=float), (self.n_columns,))
        t = {k: self.on_device(k) for k in ("F", "logF", "E", "logE", "G", "logG", "col_ll")}
        e = eng.eigen
        real = eng.count_device_ok

        def dev_t(a):
            a = np.ascontiguousarray(a.real if real else a)
            return torch.as_tensor(a, device=dev)

        args = (t["F"], t["logF"], t["E"], t["logE"], t["G"], t["logG"], t["col_ll"],
                torch.as_tensor(parent_safe, device=dev), torch.as_tensor(sib_safe, device=dev),
                torch.as_tensor(mask, device=dev), torch.as_tensor(w_col.copy(), device=dev),
                torch.as_tensor(eng.log_cpt_weight, device=dev),
                dev_t(e.evec), dev_t(e.evec_inv), dev_t(eng.branch_eigen_sub_count))
        contract = felsenstein.eigen_counts if real else felsenstein.eigen_counts_cplx
        eigen_counts += contract(*args, chunk=eng.COUNT_CHUNK).cpu().numpy()
        ROUTES[f"counts:{dev.type}:{'real' if real else 'complex'}"] += 1

        roots = self.column_root_array()
        sel = roots >= 0
        if not np.any(sel):
            return
        cols = torch.as_tensor(np.nonzero(sel)[0], device=dev)
        r = torch.as_tensor(roots[sel], device=dev)
        root_counts += felsenstein.root_counts(
            t["F"][cols, r], t["logF"][cols, r], t["col_ll"][cols],
            torch.as_tensor(w_col[sel].copy(), device=dev),
            torch.as_tensor(eng.log_cpt_weight, device=dev),
            torch.as_tensor(eng.ins_prob, device=dev),
        ).cpu().numpy()

    def per_column_eigen_counts(self, chunk: int = 1024):
        """(root[L, C, A] real, eigen[L, C, A, A] complex): each column's
        unit-weight contribution -- the same per-column terms that
        accumulate_eigen_counts sums over l.  Chunked so the [l, N, C, A]
        temporaries stay bounded for large column batches."""
        eng = self.engine
        L = self.n_columns
        C, A = eng.model.components, eng.model.alphabet_size
        root = np.zeros((L, C, A))
        eigen = np.zeros((L, C, A, A), dtype=np.complex128)

        roots = self.column_root_array()
        sel = roots >= 0
        if np.any(sel):
            r = roots[sel]
            cols = np.nonzero(sel)[0]
            norm = np.exp(
                eng.log_cpt_weight[None, :] + self.logF[cols, r] - self.col_ll[cols, None]
            )
            root[cols] = np.einsum("ci,lci,lc->lci", eng.ins_prob, self.F[cols, r], norm)

        mask, parent_safe, sib_safe = self._count_mask()
        if np.any(mask):
            evec = eng.eigen.evec
            evec_inv = eng.eigen.evec_inv
            j = eng.branch_eigen_sub_count  # [N, C, A, A]
            for lo in range(0, L, chunk):
                hi = min(lo + chunk, L)
                U0 = self.F[lo:hi]
                D0 = self.G[lo:hi][:, parent_safe] * self.E[lo:hi][:, sib_safe]
                log_scale = (
                    eng.log_cpt_weight[None, None, :]
                    + self.logF[lo:hi]
                    + self.logG[lo:hi][:, parent_safe]
                    + self.logE[lo:hi][:, sib_safe]
                    - self.col_ll[lo:hi, None, None]
                )
                w = np.where(mask[lo:hi][:, :, None], np.exp(log_scale), 0.0)
                db = np.einsum("lnca,cak->lnck", D0, evec)
                ub = np.einsum("lncb,cmb->lncm", U0, evec_inv)
                eigen[lo:hi] = np.einsum(
                    "lnc,lnck,lncm,nckm->lckm", w, db, ub, j, optimize=True
                )
        return root, eigen

    def eigen_counts(self, weight: float = 1.0) -> EigenCounts:
        eng = self.engine
        out = EigenCounts(eng.model.components, eng.model.alphabet_size)
        self.accumulate_eigen_counts(out.root_count, out.eigen_count, weight)
        out.indel.lp = float(self.col_ll.sum()) * weight
        return out


def accumulate_alignment_eigen_counts(counts: EigenCounts, model: RateModel, tree: Tree,
                                      gapped_seqs, weight: float = 1.0) -> None:
    """Counterpart of EigenCounts::accumulateSubstitutionCounts
    (model.cpp:900-915): one batched fill, then the accumulation."""
    engine = SumProductEngine(model, tree)
    fill = engine.fill([s.seq for s in gapped_seqs])
    c = EigenCounts(model.components, model.alphabet_size)
    fill.accumulate_eigen_counts(c.root_count, c.eigen_count, 1.0)
    c.indel.lp = float(fill.col_ll.sum())
    c *= weight
    counts += c
