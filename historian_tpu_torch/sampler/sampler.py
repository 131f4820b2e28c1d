"""MCMC co-sampling of trees and alignments.

Port of historian_tpu/sampler/sampler.py (the reference's Sampler):
Metropolis-Hastings over histories (tree + gapped alignment) with five
move types:

- BranchAlign: resample one parent-child alignment (BranchMatrix forward
  fill + stochastic traceback)
- NodeAlign: resample a node's alignment to both children (SiblingMatrix)
  and optionally its parent; optionally resamples ancestral residues
- PruneAndRegraft: SPR among contemporaneous nodes with distance-ranked
  weights and forward/reverse proposal symmetry
- NodeHeight: uniform resample between parent and children (root uses a
  log-multiplier with Jacobian)
- Rescale: whole-tree scaling with Jacobian

Each move's likelihood is the tree prior plus the root, indel and
substitution terms (engine/treealign.py), the last the sum-product
engine's memoized per-column sum.  The fills run where their matrices
route them: the sibling fill (kernel (d)) and the branch fill in Forward
mode (kernel (e)) on the card above their cell thresholds, the host's
fill.cpp below.  One process runs every dataset's chain (the JAX
package's multi-process sharding of datasets is not ported).
"""

from __future__ import annotations

import math
import time

import numpy as np

from historian_tpu_torch.core.alignpath import (
    Alignment,
    GuideAlignmentEnvelope,
    align_path_columns,
    align_path_merge,
    residues_in_row,
)
from historian_tpu_torch.core.seqs import FastSeq
from historian_tpu_torch.core.tree import Tree
from historian_tpu_torch.engine.branchmatrix import BranchMatrix
from historian_tpu_torch.engine.treealign import (
    History,
    SimpleTreePrior,
    branch_path,
    clade_path,
    get_conditional_pwms,
    get_guide_seq_pos,
    indel_log_likelihood,
    pair_path,
    root_log_likelihood,
    subst_log_likelihood,
)
from historian_tpu_torch.models.ratemodel import RateModel
from historian_tpu_torch.sampler.sibling import SiblingMatrix
from historian_tpu_torch.utils.logging import ProgressLogger, log_this_at
from historian_tpu_torch.utils.rng import MT19937

BRANCH_ALIGN, NODE_ALIGN, PRUNE_REGRAFT, NODE_HEIGHT, RESCALE = range(5)
MOVE_NAMES = ["BranchAlign", "NodeAlign", "PruneAndRegraft", "NodeHeight", "Rescale"]


def triple_path(path, l_child: int, r_child: int, parent: int):
    """Canonical-order 3-row subpath (sampler.cpp:193-242): left-insert
    columns deferred until the next parent-emitting column."""
    cols = align_path_columns(path)
    lr = np.asarray(path[l_child], dtype=bool)
    rr = np.asarray(path[r_child], dtype=bool)
    pr = np.asarray(path[parent], dtype=bool)
    from historian_tpu_torch.sampler import sibling as sib

    out_l: list[bool] = []
    out_r: list[bool] = []
    out_p: list[bool] = []
    n_left_ins = 0
    state = sib.IMM  # SSS aliases IMM
    for col in range(cols):
        lc, rc, pc = bool(lr[col]), bool(rr[col]), bool(pr[col])
        if not (lc or rc or pc):
            continue
        state = SiblingMatrix.get_state(state, lc, rc, pc)
        if state in (sib.IMM, sib.IMD, sib.IDM, sib.IDD):
            while n_left_ins > 0:
                out_l.append(True)
                out_r.append(False)
                out_p.append(False)
                n_left_ins -= 1
            out_l.append(lc)
            out_r.append(rc)
            out_p.append(pc)
        elif state in (sib.IMI, sib.IDI):
            out_l.append(lc)
            out_r.append(rc)
            out_p.append(pc)
        elif state in (sib.IIW, sib.IIX):
            n_left_ins += 1
        else:
            raise ValueError(f"bad state {state} (l,r,p)=({lc},{rc},{pc})")
    while n_left_ins > 0:
        out_l.append(True)
        out_r.append(False)
        out_p.append(False)
        n_left_ins -= 1
    return {
        l_child: np.array(out_l, dtype=bool),
        r_child: np.array(out_r, dtype=bool),
        parent: np.array(out_p, dtype=bool),
    }


def subpath_ungapped(path, rows: list[int]) -> bool:
    cols = align_path_columns(path)
    stacked = np.stack([np.asarray(path[r], dtype=bool) for r in rows])
    counts = stacked.sum(axis=0)
    return bool(np.all((counts == 0) | (counts == len(rows))))


def contemporaneous_nodes(tree: Tree, dist: np.ndarray, node: int) -> list[int]:
    """Nodes whose branch spans the height of node's parent
    (sampler.cpp:72-86), sorted by distance from node."""
    parent = tree.parent(node)
    if parent < 0 or tree.parent(parent) < 0:
        raise ValueError("need parent and grandparent")
    dist_parent = dist[parent]
    contemps = [
        n
        for n in range(tree.root())
        if tree.parent(n) != parent and dist[tree.parent(n)] < dist_parent and dist[n] > dist_parent
    ]
    ndist = tree.distance_from(node)
    contemps.sort(key=lambda n: (ndist[n], n))
    return contemps


def node_list_weights(n: int) -> list[float]:
    w = []
    wi = 1.0
    for _ in range(n):
        w.append(wi)
        wi /= 1.5
    norm = sum(w)
    return [x / norm for x in w]


def random_index(weights, rng: MT19937) -> int:
    total = float(sum(weights))
    r = rng.uniform(0, total)
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if r < acc:
            return i
    return len(weights) - 1


class Move:
    def __init__(self, move_type: int, history: History, old_lp: float):
        self.type = move_type
        self.old_history = history
        self.new_history = history
        self.old_log_likelihood = old_lp
        self.new_log_likelihood = 0.0
        self.log_forward_proposal = 0.0
        self.log_reverse_proposal = 0.0
        self.log_jacobian = 0.0
        self.log_accept_prob = -np.inf
        self.nullified = False
        self.comment = ""

    def nullify(self, reason: str) -> None:
        self.new_history = self.old_history
        self.new_log_likelihood = self.old_log_likelihood
        self.log_accept_prob = self.log_jacobian = 0.0
        self.log_forward_proposal = self.log_reverse_proposal = 0.0
        self.nullified = True
        self.comment = f"({reason})"

    def init_ratio(self, sampler: "Sampler") -> None:
        self.new_log_likelihood = sampler.log_likelihood(self.new_history)
        log_odds = self.new_log_likelihood - self.old_log_likelihood
        log_hastings = self.log_reverse_proposal - self.log_forward_proposal + self.log_jacobian
        self.log_accept_prob = log_odds + log_hastings

    def accept(self, rng: MT19937) -> bool:
        if self.nullified:
            return True
        if self.log_accept_prob >= 0:
            return True
        return rng.uniform() < math.exp(self.log_accept_prob)


class Sampler:
    def __init__(self, model: RateModel, tree_prior: SimpleTreePrior, gapped_guide: list[FastSeq], name: str = ""):
        self.model = model
        self.tree_prior = tree_prior
        self.name = name
        self.move_rate = [1.0] * 5
        self.moves_proposed = [0] * 5
        self.moves_accepted = [0] * 5
        self.move_seconds = [0.0] * 5
        self.use_fixed_guide = False
        self.sample_ancestral_seqs = False
        self.max_distance_from_guide = 20
        self.current_history: History | None = None
        self.best_history: History | None = None
        self.current_lp = -np.inf
        self.best_lp = -np.inf
        self.history_loggers: list = []

    # ------------------------------------------------------------- likelihood
    def log_likelihood(self, history: History) -> float:
        return (
            self.tree_prior.tree_log_likelihood(history.tree)
            + root_log_likelihood(self.model, history)
            + indel_log_likelihood(self.model, history)
            + subst_log_likelihood(self.model, history)
        )

    def initialize(self, history: History, name: str = "") -> None:
        if name:
            self.name = name
        self.current_history = history
        if not history.tree.is_ultrametric():
            log_this_at(1, "WARNING: initial tree is not ultrametric")
        self.best_history = history
        self.current_lp = self.best_lp = self.log_likelihood(history)
        self.move_rate[BRANCH_ALIGN] = 1.0 if history.tree.has_children() else 0.0
        self.move_rate[NODE_ALIGN] = 1.0
        self.move_rate[PRUNE_REGRAFT] = 1.0 if history.tree.has_grandchildren() else 0.0
        self.move_rate[NODE_HEIGHT] = 2.0
        self.move_rate[RESCALE] = 2.0

    def snapshot_state(self) -> dict:
        """JSON-able optimizer state (histories exact: repr floats in
        branch lengths, full gapped rows; counters for the final
        acceptance report)."""
        from historian_tpu_torch.utils.checkpoint import exact_newick

        def hist(h: History) -> dict:
            return {
                "tree": exact_newick(h.tree),
                "gapped": [[r.name, r.seq] for r in h.gapped],
            }

        return {
            "name": self.name,
            "current": hist(self.current_history),
            "best": hist(self.best_history),
            "current_lp": self.current_lp,
            "best_lp": self.best_lp,
            "moves_proposed": list(self.moves_proposed),
            "moves_accepted": list(self.moves_accepted),
            "move_seconds": list(self.move_seconds),
        }

    def restore_state(self, st: dict) -> None:
        """Inverse of snapshot_state; assumes initialize() already ran
        (move rates and guide state are derived from the command line,
        not checkpointed)."""

        def hist(d: dict) -> History:
            return History(
                gapped=[FastSeq(name=n, seq=s) for n, s in d["gapped"]],
                tree=Tree(d["tree"]),
            )

        self.current_history = hist(st["current"])
        self.best_history = hist(st["best"])
        self.current_lp = float(st["current_lp"])
        self.best_lp = float(st["best_lp"])
        self.moves_proposed = [int(v) for v in st["moves_proposed"]]
        self.moves_accepted = [int(v) for v in st["moves_accepted"]]
        self.move_seconds = [float(v) for v in st["move_seconds"]]

    def fix_tree(self) -> None:
        self.move_rate[PRUNE_REGRAFT] = 0.0
        self.move_rate[NODE_HEIGHT] = 0.0
        self.move_rate[RESCALE] = 0.0

    def fix_alignment(self) -> None:
        self.move_rate[BRANCH_ALIGN] = 0.0
        self.move_rate[NODE_ALIGN] = 0.0

    def make_guide(self, path, row1: int, row2: int) -> GuideAlignmentEnvelope:
        return GuideAlignmentEnvelope(path, row1, row2, self.max_distance_from_guide)

    # ------------------------------------------------------------------ moves
    def propose_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move_type = random_index(self.move_rate, rng)
        builder = [
            self._branch_align_move,
            self._node_align_move,
            self._prune_regraft_move,
            self._node_height_move,
            self._rescale_move,
        ][move_type]
        return builder(history, old_lp, rng)

    @staticmethod
    def _random_internal_node(tree: Tree, rng: MT19937) -> int:
        internal = [n for n in range(tree.n_nodes()) if not tree.is_leaf(n)]
        return internal[rng.next_u32() % len(internal)]

    @staticmethod
    def _random_child_node(tree: Tree, rng: MT19937) -> int:
        return rng.next_u32() % (tree.n_nodes() - 1)

    @staticmethod
    def _random_grandchild_node(tree: Tree, rng: MT19937) -> int:
        grandkids = [n for n in range(tree.root()) if tree.parent(n) != tree.root()]
        return grandkids[rng.next_u32() % len(grandkids)]

    def _branch_align_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move = Move(BRANCH_ALIGN, history, old_lp)
        tree = history.tree
        node = self._random_child_node(tree, rng)
        parent = tree.parent(node)
        dist = tree.branch_length_between(parent, node)
        old_align = Alignment.from_gapped(history.gapped)
        old_branch = branch_path(old_align.path, tree, node)
        env = self.make_guide(old_branch, parent, node)
        p_clade = clade_path(old_align.path, tree, parent, node)
        n_clade = clade_path(old_align.path, tree, node, parent)
        p_env_pos = get_guide_seq_pos(old_align.path, parent, parent)
        n_env_pos = get_guide_seq_pos(old_align.path, node, node)
        pwms = get_conditional_pwms(self.model, tree, history.gapped, {node: parent, parent: node})
        new_matrix = BranchMatrix(
            self.model, pwms[parent], pwms[node], dist, env, p_env_pos, n_env_pos, parent, node
        )
        new_branch = new_matrix.sample(rng)
        lp_new = new_matrix.log_post_prob(new_branch)
        old_env = self.make_guide(new_branch, parent, node)
        old_matrix = (
            new_matrix
            if self.use_fixed_guide
            else BranchMatrix(self.model, pwms[parent], pwms[node], dist, old_env, p_env_pos, n_env_pos, parent, node)
        )
        lp_old = old_matrix.log_post_prob(old_branch)
        if _paths_equal(old_branch, new_branch):
            move.nullify("no change")
            return move
        new_path = align_path_merge([p_clade, new_branch, n_clade])
        move.log_forward_proposal = lp_new
        move.log_reverse_proposal = lp_old
        move.new_history = History(
            gapped=Alignment(old_align.ungapped, new_path).gapped(), tree=tree
        )
        move.init_ratio(self)
        return move

    def _node_align_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move = Move(NODE_ALIGN, history, old_lp)
        tree = history.tree
        node = self._random_internal_node(tree, rng)
        l_child, r_child = tree.children(node)
        parent = tree.parent(node)
        l_dist = tree.branch_length_between(node, l_child)
        r_dist = tree.branch_length_between(node, r_child)
        old_align = Alignment.from_gapped(history.gapped)
        old_sibling = triple_path(old_align.path, l_child, r_child, node)
        l_clade = clade_path(old_align.path, tree, l_child, node)
        r_clade = clade_path(old_align.path, tree, r_child, node)
        l_env_pos = get_guide_seq_pos(old_align.path, l_child, l_child)
        r_env_pos = get_guide_seq_pos(old_align.path, r_child, r_child)
        sib_env = self.make_guide(
            pair_path(old_align.path, l_child, r_child), l_child, r_child
        )
        exclude = {l_child: node, r_child: node}
        if parent >= 0:
            exclude[node] = parent
            exclude[parent] = node
        pwms = get_conditional_pwms(self.model, tree, history.gapped, exclude)
        new_sib = SiblingMatrix(
            self.model, pwms[l_child], pwms[r_child], l_dist, r_dist,
            sib_env, l_env_pos, r_env_pos, l_child, r_child, node,
        )
        new_sib_path = new_sib.sample(rng)
        lp_new_sib = new_sib.log_post_prob(new_sib_path)
        lp_old_sib = new_sib.log_post_prob(old_sibling)
        move.log_forward_proposal = lp_new_sib
        move.log_reverse_proposal = lp_old_sib

        merge_components = [l_clade, r_clade, new_sib_path]
        new_path = align_path_merge(merge_components)

        new_node_pwm = new_sib.parent_seq(new_sib_path)
        old_node_pwm = new_sib.parent_seq(old_sibling)

        old_ungapped = old_align.ungapped
        new_ungapped = [FastSeq(name=s.name, comment=s.comment, seq=s.seq) for s in old_ungapped]
        new_ungapped[node].seq = "*" * residues_in_row(np.asarray(new_sib_path[node]))

        if parent >= 0:
            p_dist = tree.branch_length_between(parent, node)
            p_clade = clade_path(old_align.path, tree, parent, node)
            branch_env = self.make_guide(pair_path(old_align.path, parent, node), parent, node)
            p_env_pos = get_guide_seq_pos(old_align.path, parent, parent)
            new_node_env_pos = np.arange(len(new_node_pwm) + 1)
            old_node_env_pos = np.arange(len(old_node_pwm) + 1)
            new_branch_matrix = BranchMatrix(
                self.model, pwms[parent], new_node_pwm, p_dist,
                GuideAlignmentEnvelope(), p_env_pos, new_node_env_pos, parent, node,
            )
            new_branch = new_branch_matrix.sample(rng)
            lp_new_branch = new_branch_matrix.log_post_prob(new_branch)
            merge_components.append(p_clade)
            merge_components.append(new_branch)
            new_path = align_path_merge(merge_components)
            old_branch_matrix = BranchMatrix(
                self.model, pwms[parent], old_node_pwm, p_dist,
                GuideAlignmentEnvelope(), p_env_pos, old_node_env_pos, parent, node,
            )
            old_branch = branch_path(old_align.path, tree, node)
            lp_old_branch = old_branch_matrix.log_post_prob(old_branch)
            move.log_forward_proposal += lp_new_branch
            move.log_reverse_proposal += lp_old_branch

        if _paths_equal_all(new_path, old_align.path):
            move.nullify("no change")
            return move
        move.new_history = History(gapped=Alignment(new_ungapped, new_path).gapped(), tree=tree)
        move.init_ratio(self)
        return move

    def _prune_regraft_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move = Move(PRUNE_REGRAFT, history, old_lp)
        tree = history.tree
        dist_root = tree.distance_from_root()
        node = self._random_grandchild_node(tree, rng)
        contemps = contemporaneous_nodes(tree, dist_root, node)
        if not contemps:
            move.nullify("nowhere to regraft")
            return move
        weights = node_list_weights(len(contemps))
        idx = random_index(weights, rng)
        new_sibling = contemps[idx]
        parent = tree.parent(node)
        old_grandparent = tree.parent(parent)
        new_grandparent = tree.parent(new_sibling)
        old_sibling = tree.sibling(node)

        old_gp_dist = tree.branch_length_between(old_grandparent, parent)
        parent_node_dist = tree.branch_length_between(parent, node)
        parent_old_sib_dist = tree.branch_length_between(parent, old_sibling)
        parent_new_sib_dist = dist_root[new_sibling] - dist_root[parent]
        new_gp_dist = dist_root[parent] - dist_root[new_grandparent]

        new_tree = tree.copy()
        new_tree.set_parent(old_sibling, old_grandparent, old_gp_dist + parent_old_sib_dist)
        new_tree.set_parent(new_sibling, parent, parent_new_sib_dist)
        new_tree.set_parent(parent, new_grandparent, new_gp_dist)

        rev_contemps = contemporaneous_nodes(new_tree, new_tree.distance_from_root(), node)
        if old_sibling not in rev_contemps:
            move.nullify("couldn't invert move")
            return move
        rev_weights = node_list_weights(len(rev_contemps))
        rev_idx = rev_contemps.index(old_sibling)
        lp_fwd_select = math.log(weights[idx])
        lp_rev_select = math.log(rev_weights[rev_idx])

        old_align = Alignment.from_gapped(history.gapped)
        subpath_nodes = [old_sibling, parent, old_grandparent, new_grandparent, new_sibling]
        if subpath_ungapped(old_align.path, subpath_nodes):
            move.new_history = History(gapped=history.gapped, tree=new_tree)
            move.log_forward_proposal = lp_fwd_select
            move.log_reverse_proposal = lp_rev_select
            move.comment = "(alignment unchanged)"
        else:
            # general case: realign node:newSibling and newGrandparent:parent
            node_clade = clade_path(old_align.path, tree, node, parent)
            new_sib_clade = clade_path(old_align.path, tree, new_sibling, new_grandparent)
            old_sib_clade = clade_path(old_align.path, tree, old_sibling, parent)
            old_gran_clade = clade_path(old_align.path, tree, old_grandparent, parent, new_sibling)
            old_sibling_path = triple_path(old_align.path, node, old_sibling, parent)
            old_branch = branch_path(old_align.path, tree, parent)
            old_gran_sib = pair_path(old_align.path, old_grandparent, old_sibling)

            detached = tree.copy()
            detached.detach(node)
            exclude = {
                node: -1,
                old_sibling: parent,
                old_grandparent: parent,
                new_sibling: new_grandparent,
                new_grandparent: new_sibling,
            }
            pwms = get_conditional_pwms(self.model, detached, history.gapped, exclude)

            n_env = get_guide_seq_pos(old_align.path, node, node)
            ns_env = get_guide_seq_pos(old_align.path, new_sibling, new_sibling)
            new_sib_matrix = SiblingMatrix(
                self.model, pwms[node], pwms[new_sibling], parent_node_dist, parent_new_sib_dist,
                GuideAlignmentEnvelope(), n_env, ns_env, node, new_sibling, parent,
            )
            new_sibling_path = new_sib_matrix.sample(rng)
            lp_new_sib = new_sib_matrix.log_post_prob(new_sibling_path)
            merge_components = [node_clade, new_sib_clade, new_sibling_path]
            new_parent_subtree = align_path_merge(merge_components)

            new_parent_pwm = new_sib_matrix.parent_seq(new_sibling_path)
            ng_env = get_guide_seq_pos(old_align.path, new_grandparent, new_grandparent)
            new_branch_matrix = BranchMatrix(
                self.model, pwms[new_grandparent], new_parent_pwm, new_gp_dist,
                GuideAlignmentEnvelope(), ng_env, np.arange(len(new_parent_pwm) + 1),
                new_grandparent, parent,
            )
            new_branch = new_branch_matrix.sample(rng)
            lp_new_branch = new_branch_matrix.log_post_prob(new_branch)

            merge_components += [old_sib_clade, old_gran_sib, old_gran_clade, new_branch]
            new_path = align_path_merge(merge_components)

            os_env = get_guide_seq_pos(old_align.path, old_sibling, old_sibling)
            old_sib_matrix = SiblingMatrix(
                self.model, pwms[node], pwms[old_sibling], parent_node_dist, parent_old_sib_dist,
                GuideAlignmentEnvelope(), n_env, os_env, node, old_sibling, parent,
            )
            lp_old_sib = old_sib_matrix.log_post_prob(old_sibling_path)
            old_parent_pwm = old_sib_matrix.parent_seq(old_sibling_path)
            og_env = get_guide_seq_pos(old_align.path, old_grandparent, old_grandparent)
            old_branch_matrix = BranchMatrix(
                self.model, pwms[old_grandparent], old_parent_pwm, old_gp_dist,
                GuideAlignmentEnvelope(), og_env, np.arange(len(old_parent_pwm) + 1),
                old_grandparent, parent,
            )
            lp_old_branch = old_branch_matrix.log_post_prob(old_branch)

            move.log_forward_proposal = lp_fwd_select + lp_new_sib + lp_new_branch
            move.log_reverse_proposal = lp_rev_select + lp_old_sib + lp_old_branch

            new_ungapped = [FastSeq(name=s.name, comment=s.comment, seq=s.seq) for s in old_align.ungapped]
            new_ungapped[parent].seq = "*" * residues_in_row(np.asarray(new_sibling_path[parent]))
            move.new_history = History(
                gapped=Alignment(new_ungapped, new_path).gapped(), tree=new_tree
            )

        if parent < new_sibling or parent > new_grandparent:
            order = move.new_history.tree.postorder()
            move.new_history = _reorder_history(move.new_history, order)
        move.init_ratio(self)
        return move

    def _node_height_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move = Move(NODE_HEIGHT, history, old_lp)
        new_tree = history.tree.copy()
        node = self._random_internal_node(new_tree, rng)
        l_child, r_child = new_tree.children(node)
        parent = new_tree.parent(node)
        l_dist = new_tree.branch_length(l_child)
        r_dist = new_tree.branch_length(r_child)
        min_child = min(l_dist, r_dist)
        if parent < 0:
            log_mult = rng.uniform(-math.log(2), math.log(2))
            mult = math.exp(log_mult)
            new_min = min_child * mult
            new_tree.nodes[l_child].length = l_dist - min_child + new_min
            new_tree.nodes[r_child].length = r_dist - min_child + new_min
            move.log_jacobian += log_mult
        else:
            p_dist = max(0.0, new_tree.branch_length(node))
            p_range = p_dist + min_child
            p_new = rng.uniform(0, p_range)
            c_new = p_range - p_new
            new_tree.nodes[node].length = p_new
            new_tree.nodes[l_child].length = (l_dist - min_child) + c_new
            new_tree.nodes[r_child].length = (r_dist - min_child) + c_new
        move.new_history = History(gapped=history.gapped, tree=new_tree)
        move.init_ratio(self)
        return move

    def _rescale_move(self, history: History, old_lp: float, rng: MT19937) -> Move:
        move = Move(RESCALE, history, old_lp)
        log_mult = rng.uniform(-math.log(2), math.log(2))
        mult = math.exp(log_mult)
        new_tree = history.tree.copy()
        for n in new_tree.nodes:
            if n.length >= 0:
                n.length *= mult
        move.log_jacobian = log_mult
        move.new_history = History(gapped=history.gapped, tree=new_tree)
        move.init_ratio(self)
        return move

    # -------------------------------------------------------------- main loop
    def sample(self, rng: MT19937) -> Move:
        t0 = time.monotonic()
        move = self.propose_move(self.current_history, self.current_lp, rng)
        self.moves_proposed[move.type] += 1
        accepted = move.accept(rng)
        if accepted and not move.nullified:
            self.moves_accepted[move.type] += 1
            self.current_history = move.new_history
            self.current_lp = move.new_log_likelihood
            if self.current_lp > self.best_lp:
                self.best_history = self.current_history
                self.best_lp = self.current_lp
        self.move_seconds[move.type] += time.monotonic() - t0
        for logger in self.history_loggers:
            logger(self.current_history)
        log_this_at(
            3,
            f"{self.name} {MOVE_NAMES[move.type]} move "
            + ("bypassed" if move.nullified else ("ACCEPTED" if accepted else "rejected"))
            + f" with log(P_accept) = {move.log_accept_prob:.4f} {move.comment}",
        )
        return move

    @staticmethod
    def run(samplers: list["Sampler"], rng: MT19937, n_samples: int,
            checkpoint_path: str = "", checkpoint_every: int = 100) -> None:
        """Round-robin over datasets weighted by node count
        (sampler.cpp:1711-1734).  With checkpoint_path, a snapshot of
        every sampler + the generator is written every checkpoint_every
        steps and the run resumes from it when it exists."""
        nodes = [s.current_history.tree.n_nodes() for s in samplers]
        n0 = 0
        fp = ""
        if checkpoint_path:
            from historian_tpu_torch.utils import checkpoint as ckpt

            # identity of the initial histories, computed at run() entry on
            # both save and resume, so a stale snapshot for other inputs on
            # the same -checkpoint path never silently resumes
            fp = ckpt.input_fingerprint(
                [
                    f"{s.name}\n{ckpt.exact_newick(s.current_history.tree)}\n"
                    + "\n".join(f"{r.name} {r.seq}" for r in s.current_history.gapped)
                    for s in samplers
                ]
            )
            state = ckpt.load(checkpoint_path, "mcmc", fingerprint=fp)
            if state is not None and len(state.get("samplers", ())) == len(samplers):
                n0 = int(state["step"])
                ckpt.restore_rng(rng, state["rng"])
                for s, st in zip(samplers, state["samplers"]):
                    s.restore_state(st)
                log_this_at(
                    1, f"Resuming MCMC from checkpoint {checkpoint_path} (step {n0})"
                )
        progress = ProgressLogger("MCMC sampling run", level=2)
        for n in range(n0, n_samples):
            progress.update(n / max(1, n_samples - 1), f"step {n + 1}/{n_samples}")
            idx = random_index(nodes, rng)
            samplers[idx].sample(rng)
            if checkpoint_path and (n + 1) % checkpoint_every == 0:
                from historian_tpu_torch.utils import checkpoint as ckpt

                ckpt.save_atomic(
                    checkpoint_path,
                    {
                        "command": "mcmc",
                        "fingerprint": fp,
                        "step": n + 1,
                        "rng": ckpt.rng_state(rng),
                        "samplers": [s.snapshot_state() for s in samplers],
                    },
                )
        # per-move acceptance + timing summary (sampler.cpp:1736-1746)
        for s in samplers:
            for m in range(5):
                if s.moves_proposed[m]:
                    log_this_at(
                        2,
                        f"{s.name} {MOVE_NAMES[m]}: {s.moves_accepted[m]}/"
                        f"{s.moves_proposed[m]} accepted "
                        f"({100.0 * s.moves_accepted[m] / s.moves_proposed[m]:.1f}%), "
                        f"{s.move_seconds[m]:.3f}s total",
                    )


def _paths_equal(a, b) -> bool:
    if set(a) != set(b):
        return False
    return all(
        len(a[k]) == len(b[k]) and bool(np.all(np.asarray(a[k]) == np.asarray(b[k])))
        for k in a
    )


def _paths_equal_all(a, b) -> bool:
    return _paths_equal(a, b)


def _reorder_history(history: History, order: list[int]) -> History:
    new_tree = history.tree.reorder_nodes(order)
    new_gapped = [history.gapped[n] for n in order]
    return History(gapped=new_gapped, tree=new_tree)


def run_mcmc_on_datasets(recon) -> None:
    """CLI entry: MCMC over the Reconstructor's datasets
    (recon.cpp:1312-1366).

    In a process group (parallel/dist.py) the datasets go round-robin over
    the processes, each running the chains of its share only (a dataset's
    chain does not depend on the others'), `-trace` files numbered by the
    global dataset index and the checkpoint suffixed `.p<rank>` on every
    rank but 0; then the winning histories are all-gathered, so that every
    process writes every dataset."""
    from historian_tpu_torch.models.ratemodel import CachingRateModel
    from historian_tpu_torch.parallel import dist

    nproc, pid = dist.process_count(), dist.process_index()
    samplers: list[Sampler] = []
    prior = SimpleTreePrior()
    caching_model = CachingRateModel(recon.model)  # recon.cpp:1320
    all_datasets = list(recon.datasets)
    local_idx = [k for k in range(len(all_datasets)) if k % nproc == pid]
    datasets = [all_datasets[k] for k in local_idx]
    for ds in datasets:
        if not ds.has_reconstruction():
            recon.reconstruct(ds)
        tree = ds.tree.copy()
        tree.assign_internal_node_names()
        gapped = [
            FastSeq(name=tree.seq_name(n), seq=ds.gapped_recon[n].seq)
            for n in range(tree.n_nodes())
        ]
        sampler = Sampler(caching_model, prior, ds.gapped_guide, name=ds.name)
        sampler.max_distance_from_guide = recon.max_distance_from_guide
        sampler.initialize(History(gapped=gapped, tree=tree), ds.name)
        if recon.fix_tree_mcmc:
            sampler.fix_tree()
        if recon.fix_align_mcmc:
            sampler.fix_alignment()
        sampler.use_fixed_guide = recon.fix_guide_mcmc
        if recon.mcmc_trace_filename:
            # -trace: write every sampled history to a file numbered by the
            # dataset's global index
            trace_file = open(f"{recon.mcmc_trace_filename}.{local_idx[len(samplers)] + 1}", "w")

            def log_history(history, _f=trace_file, _name=ds.name):
                recon.write_tree_alignment(history.tree, history.gapped, _name, _f, True)
                _f.flush()

            sampler.history_loggers.append(log_history)
        samplers.append(sampler)
    n_samples = recon.mcmc_samples_per_seq * sum(
        s.current_history.tree.n_nodes() for s in samplers
    )
    ckpt_path = recon.checkpoint_filename
    if ckpt_path and pid > 0:
        ckpt_path += f".p{pid}"  # as the EM fit's snapshots
    if samplers:
        Sampler.run(
            samplers, recon.generator, n_samples,
            checkpoint_path=ckpt_path,
            checkpoint_every=recon.checkpoint_every,
        )
    for ds, sampler in zip(datasets, samplers):
        best = sampler.best_history
        ds.tree = best.tree
        ds.gapped_recon = best.gapped
    if nproc > 1:
        # every process holds every dataset's winner, so every one writes
        import json

        from historian_tpu_torch.parallel.pcounts import allgather_bytes
        from historian_tpu_torch.utils import checkpoint as ckpt

        mine = {
            str(k): {"tree": ckpt.exact_newick(ds.tree),
                     "rows": [[r.name, r.seq] for r in ds.gapped_recon]}
            for k, ds in zip(local_idx, datasets)
        }
        for blob in allgather_bytes(json.dumps(mine).encode()):
            for k_str, st in json.loads(blob.decode()).items():
                ds = all_datasets[int(k_str)]
                ds.tree = Tree(st["tree"])
                ds.gapped_recon = [FastSeq(name=n, seq=s) for n, s in st["rows"]]
