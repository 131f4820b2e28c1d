"""Iterative alignment refinement by per-branch Viterbi realignment.

Port of historian_tpu/sampler/refiner.py (the reference's Refiner,
refiner.cpp): cycle over the non-root nodes, realign each parent-child
branch by Viterbi over conditional position-weight matrices
(engine/branchmatrix.py), keep the new alignment if the history's
log-likelihood rises, and stop after a full cycle with no gain.

`LAST` holds the last `refine` call's steps, improvements, LP before
and after, and its seconds by phase: the conditional PWMs, the branch
matrix (emission, fill and band readback), the traceback and merge, and
the log-likelihood.
"""

from __future__ import annotations

import time

from historian_tpu_torch.core.alignpath import Alignment, GuideAlignmentEnvelope, align_path_merge
from historian_tpu_torch.core.seqs import FastSeq
from historian_tpu_torch.core.tree import Tree
from historian_tpu_torch.engine.branchmatrix import BranchMatrix
from historian_tpu_torch.engine.treealign import (
    branch_path,
    clade_path,
    get_conditional_pwms,
    get_guide_seq_pos,
    log_likelihood,
)
from historian_tpu_torch.models.ratemodel import RateModel
from historian_tpu_torch.recon import DEFAULT_MAX_DISTANCE_FROM_GUIDE
from historian_tpu_torch.utils.logging import log_this_at

REFINER_EPSILON = 1e-3
#: the last refine call: steps, improvements, lp_before, lp_after, seconds
#: by phase (pwms, matrix, traceback, loglik) and in all (total)
LAST: dict = {}


class Refiner:
    def __init__(self, model: RateModel, max_distance_from_guide: int = DEFAULT_MAX_DISTANCE_FROM_GUIDE):
        self.model = model
        self.max_distance_from_guide = max_distance_from_guide
        self.seconds = dict(pwms=0.0, matrix=0.0, traceback=0.0, loglik=0.0)

    def _lap(self, phase: str, t0: float) -> float:
        t = time.perf_counter()
        self.seconds[phase] += t - t0
        return t

    def refine_node(self, tree: Tree, gapped: list[FastSeq], node: int) -> list[FastSeq]:
        """One branch-realignment attempt (refiner.cpp:10-103 + 120-165)."""
        t = time.perf_counter()
        parent = tree.parent(node)
        dist = tree.branch_length_between(parent, node)
        old_align = Alignment.from_gapped(gapped)
        old_branch_path = branch_path(old_align.path, tree, node)
        env = GuideAlignmentEnvelope(old_branch_path, parent, node, self.max_distance_from_guide)
        p_clade = clade_path(old_align.path, tree, parent, node)
        n_clade = clade_path(old_align.path, tree, node, parent)
        parent_env_pos = get_guide_seq_pos(old_align.path, parent, parent)
        node_env_pos = get_guide_seq_pos(old_align.path, node, node)

        pwms = get_conditional_pwms(
            self.model, tree, gapped, {node: parent, parent: node}
        )
        t = self._lap("pwms", t)
        matrix = BranchMatrix(
            self.model, pwms[parent], pwms[node], dist, env,
            parent_env_pos, node_env_pos, parent, node, viterbi=True,
        )
        t = self._lap("matrix", t)
        new_branch_path = matrix.best()
        new_path = align_path_merge([p_clade, new_branch_path, n_clade])
        new_align = Alignment(old_align.ungapped, new_path)
        out = new_align.gapped()
        self._lap("traceback", t)
        return out

    def refine(self, tree: Tree, gapped: list[FastSeq]) -> tuple[Tree, list[FastSeq]]:
        if not tree.is_postorder_sorted():
            raise ValueError("tree must be postorder sorted")
        t_start = time.perf_counter()
        best_gapped = gapped
        best_lp = lp_before = log_likelihood(self.model, tree, best_gapped)
        node = 0
        steps = improvements = 0
        steps_since_improvement = 0
        while steps_since_improvement < tree.n_nodes() - 1:
            new_gapped = self.refine_node(tree, best_gapped, node)
            t = time.perf_counter()
            new_lp = log_likelihood(self.model, tree, new_gapped)
            self._lap("loglik", t)
            steps += 1
            if new_lp > best_lp:
                log_this_at(3, f"refinement improved logLik {best_lp:.4f} -> {new_lp:.4f}")
                best_gapped = new_gapped
                best_lp = new_lp
                improvements += 1
                steps_since_improvement = 0
            else:
                if new_lp < best_lp and abs(new_lp - best_lp) > REFINER_EPSILON * max(abs(new_lp), abs(best_lp)):
                    log_this_at(1, f"warning: refinement dropped logLik {best_lp} -> {new_lp}")
                steps_since_improvement += 1
            node = (node + 1) % (tree.n_nodes() - 1)
        LAST.clear()
        LAST.update(steps=steps, improvements=improvements, lp_before=lp_before,
                    lp_after=best_lp, seconds=dict(self.seconds,
                                                   total=time.perf_counter() - t_start))
        return tree, best_gapped
