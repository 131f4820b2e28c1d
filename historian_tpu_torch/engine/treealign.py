"""Tree and alignment: the log-likelihood decomposition and the path
surgery of the refiner.

Port of historian_tpu/engine/treealign.py:

  logLik = root geometric length + sum over branches of the indel path
           + sum over columns of the substitution likelihood

The first two terms are host arithmetic over gap patterns (same walk,
same float order as the JAX package); the third is the sum of the
sum-product engine's per-column likelihoods (engine/sumprod.py, memoized
by column content as in the JAX package).  The branch helpers
(`pair_path`, `clade_path`, `branch_path`, `get_guide_seq_pos`) cut an
alignment into a branch's 2-row path and the clades on either side of
it; `get_conditional_pwms` reads each node's position-weight matrix with
one neighbour's message left out, and `pre_multiply` / `calc_ins_probs`
turn a child's PWM into the branch fill's emissions
(engine/branchmatrix.py).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import logsumexp

from historian_tpu_torch.core.alignpath import (
    AlignPath,
    Alignment,
    align_path_remove_empty_columns,
)
from historian_tpu_torch.engine.sumprod import get_engine
from historian_tpu_torch.models.ratemodel import ProbModel


def root_log_likelihood(model, gapped, tree) -> float:
    root_len = sum(1 for c in gapped[tree.root()].seq if c not in "-.")
    ext = model.ins_ext_prob
    if ext > 0:
        return math.log(1 - ext) + math.log(ext) * root_len
    return math.log(1 - ext) if root_len == 0 else -math.inf


def pair_path(path: AlignPath, node1: int, node2: int) -> AlignPath:
    """The 2-row subpath of node1 and node2 in canonical order: within
    each run between matches, inserts, then deferred deletions, then the
    closing match (sampler.cpp:150-189)."""
    row1 = np.asarray(path[node1], dtype=bool)
    row2 = np.asarray(path[node2], dtype=bool)
    keep = row1 | row2
    c1, c2 = row1[keep], row2[keep]
    is_match = c1 & c2
    is_del = c1 & ~c2
    seg = np.cumsum(is_match) - is_match
    kind = np.where(is_match, 2, np.where(is_del, 1, 0))
    order = np.lexsort((np.arange(len(c1)), kind, seg))
    return {node1: c1[order], node2: c2[order]}


def branch_path_states(prow: np.ndarray, crow: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) transition states of a 2-row path."""
    keep = prow | crow
    c1, c2 = prow[keep], crow[keep]
    states = np.where(c1 & c2, ProbModel.MATCH, np.where(c1, ProbModel.DELETE, ProbModel.INSERT))
    return (np.concatenate([[ProbModel.MATCH], states]),
            np.concatenate([states, [ProbModel.END]]))


def _log_trans_table(pm: ProbModel) -> np.ndarray:
    n = max(ProbModel.MATCH, ProbModel.INSERT, ProbModel.DELETE, ProbModel.END) + 1
    table = np.full((n, n), -np.inf)
    for s in (ProbModel.MATCH, ProbModel.INSERT, ProbModel.DELETE):
        for d in (ProbModel.MATCH, ProbModel.INSERT, ProbModel.DELETE, ProbModel.END):
            p = pm.trans_prob(s, d)
            table[s, d] = math.log(p) if p > 0 else -np.inf
    return table


def indel_log_likelihood(model, gapped, tree) -> float:
    path = Alignment.from_gapped(gapped).path
    lp = 0.0
    for node in range(tree.root()):
        parent = tree.parent(node)
        p = pair_path(path, parent, node)
        src, dst = branch_path_states(p[parent], p[node])
        terms = _log_trans_table(ProbModel(model, tree.branch_length(node)))[src, dst]
        if len(terms):
            lp += float(np.cumsum(terms)[-1])
    return lp


def log_likelihood(model, tree, gapped) -> float:
    subst = get_engine(model, tree).log_likelihood_cached([s.seq for s in gapped])
    return (
        root_log_likelihood(model, gapped, tree)
        + indel_log_likelihood(model, gapped, tree)
        + subst
    )


def clade_path(path: AlignPath, tree, clade_root: int, clade_root_parent: int,
               exclude: int = -1) -> AlignPath:
    """The rows of the clade rooted at clade_root, seen from
    clade_root_parent, with empty columns removed (sampler.cpp:136-148)."""
    rerooted_parent = tree.rerooted_parent(clade_root_parent)
    children_included = [False] * tree.n_nodes()
    children_included[clade_root_parent] = True
    p: AlignPath = {}
    for n in tree.rerooted_preorder(clade_root, clade_root_parent):
        if n != exclude and children_included[rerooted_parent[n]]:
            p[n] = path[n]
            children_included[n] = True
    return align_path_remove_empty_columns(p)


def branch_path(path: AlignPath, tree, node: int) -> AlignPath:
    parent = tree.parent(node)
    if parent < 0:
        raise ValueError("parent node not found")
    return pair_path(path, parent, node)


def get_guide_seq_pos(path: AlignPath, row: int, guide_row: int) -> np.ndarray:
    """guidePos[i]: the guide row's residues up to the i-th residue of
    `row` (sampler.cpp:118-133), the envelope's coordinates."""
    rowp = np.asarray(path[row], dtype=bool)
    cum = np.cumsum(np.asarray(path[guide_row], dtype=bool))
    return np.concatenate([[0], cum[rowp]]).astype(np.int64)


def get_conditional_pwms(model, tree, gapped, exclude: dict[int, int],
                         normalize: bool = True) -> dict[int, np.ndarray]:
    """{node: [L, C, A]} log-posteriors of each node's residues with the
    message of neighbour exclude[node] left out (getConditionalPWMs,
    sampler.cpp:356-370), from one fill over every column."""
    engine = get_engine(model, tree)
    fill = engine.fill_cached([s.seq for s in gapped])
    arr = engine.arrays
    c_, a_ = model.components, model.alphabet_size
    out: dict[int, np.ndarray] = {}
    for node, excl in exclude.items():
        row = gapped[node].seq
        cols = np.array([c for c in range(fill.n_columns) if row[c] not in "-."], dtype=np.int64)
        if len(cols) == 0:
            out[node] = np.zeros((0, c_, a_))
            continue
        toks = fill.tokens[node, cols]
        init = np.where(
            (toks >= 0)[:, None],
            np.where(np.arange(a_)[None, :] == toks[:, None], 0.0, -np.inf),
            0.0,
        )
        lpp = np.tile(init[:, None, :], (1, c_, 1))
        lpp += engine.log_cpt_weight[None, :, None]
        with np.errstate(divide="ignore"):
            for child in (arr.left[node], arr.right[node]):
                if child >= 0 and child != excl:
                    lpp += (
                        np.log(fill.rows_at("E", cols, child))
                        + fill.rows_at("logE", cols, child)[:, :, None]
                    )
            p = arr.parent[node]
            if p != excl and p >= 0:
                lpp += (
                    np.log(fill.rows_at("G", cols, node))
                    + fill.rows_at("logG", cols, node)[:, :, None]
                )
        if normalize:
            lpp -= logsumexp(lpp, axis=(1, 2), keepdims=True)
        out[node] = lpp
    return out


def pre_multiply(child_pwm: np.ndarray, log_sub_prob: np.ndarray) -> np.ndarray:
    """pwm'[l, c, i] = lse_j(logSubProb[c, i, j] + pwm[l, c, j])
    (sampler.cpp:452-464)."""
    mx = child_pwm.max(axis=2, keepdims=True)
    safe = np.where(np.isfinite(mx), mx, 0.0)
    p = np.exp(child_pwm - safe)
    with np.errstate(divide="ignore"):
        return np.log(np.einsum("cij,lcj->lci", np.exp(log_sub_prob), p)) + safe


def calc_ins_probs(child_pwm: np.ndarray, log_ins_prob: np.ndarray,
                   log_cpt_weight: np.ndarray) -> np.ndarray:
    """ins[l] = lse_{c,i}(log w_c + log insProb[c,i] + pwm[l,c,i])."""
    if len(child_pwm) == 0:  # scipy's logsumexp rejects tuple axes on empty arrays
        return np.zeros(0)
    return logsumexp(
        child_pwm + log_ins_prob[None, :, :] + log_cpt_weight[None, :, None], axis=(1, 2)
    )
