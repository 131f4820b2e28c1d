"""Log-likelihood of a tree and alignment, for the `#=GF LP` rescore.

Port of historian_tpu/engine/treealign.py::log_likelihood:

  logLik = root geometric length + sum over branches of the indel path
           + sum over columns of the substitution likelihood

The first two terms are host arithmetic over gap patterns (same walk,
same float order as the JAX package); the third is the float64
Felsenstein up pass (ops/felsenstein.py) on the selected device, with
the branch matrices of engine/sumprod.py's engine.
"""

from __future__ import annotations

import math

import numpy as np

from historian_tpu_torch.core.alignpath import Alignment
from historian_tpu_torch.models.ratemodel import ProbModel
from historian_tpu_torch.engine.sumprod import get_engine
from historian_tpu_torch.ops.felsenstein import column_log_likelihoods, tokenize_alignment


def root_log_likelihood(model, gapped, tree) -> float:
    root_len = sum(1 for c in gapped[tree.root()].seq if c not in "-.")
    ext = model.ins_ext_prob
    if ext > 0:
        return math.log(1 - ext) + math.log(ext) * root_len
    return math.log(1 - ext) if root_len == 0 else -math.inf


def pair_path_states(parent_row: np.ndarray, child_row: np.ndarray):
    """(src, dst) transition states of a branch's 2-row path in canonical
    order: within each run between matches, inserts, then deferred
    deletions, then the closing match."""
    keep = parent_row | child_row
    c1, c2 = parent_row[keep], child_row[keep]
    is_match = c1 & c2
    is_del = c1 & ~c2
    seg = np.cumsum(is_match) - is_match
    kind = np.where(is_match, 2, np.where(is_del, 1, 0))
    order = np.lexsort((np.arange(len(c1)), kind, seg))
    c1, c2 = c1[order], c2[order]
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
        src, dst = pair_path_states(
            np.asarray(path[parent], dtype=bool), np.asarray(path[node], dtype=bool)
        )
        terms = _log_trans_table(ProbModel(model, tree.branch_length(node)))[src, dst]
        if len(terms):
            lp += float(np.cumsum(terms)[-1])
    return lp


def log_likelihood(model, tree, gapped) -> float:
    engine = get_engine(model, tree)
    tokens = tokenize_alignment(model.alphabet, [s.seq for s in gapped])
    subst = float(column_log_likelihoods(tokens, engine.arrays, *engine.tensors()).cpu().numpy().sum())
    return (
        root_log_likelihood(model, gapped, tree)
        + indel_log_likelihood(model, gapped, tree)
        + subst
    )
