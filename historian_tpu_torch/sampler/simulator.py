"""Forward simulation of evolutionary histories (`generate`).

Port of historian_tpu/sampler/simulator.py, the reference's Simulator
(simulator.cpp): indels by Gillespie simulation on
each branch (total rate (L+1)*insRate + L*delRate, geometric lengths),
substitutions by sampling from matrix exponentials down the tree with
per-column mixture-component inheritance, emitted as Stockholm with a
#=GR CPT per-residue component annotation for mixtures.

Host code only: the Gillespie walk is sequential, and every draw comes
from the run's mt19937 (utils/rng.py) in the reference's order.
"""

from __future__ import annotations

import math

import numpy as np

from historian_tpu_torch.core.alignpath import AlignPath, align_path_columns, align_path_merge, residues_in_row
from historian_tpu_torch.core.seqs import FastSeq
from historian_tpu_torch.core.stockholm import Stockholm
from historian_tpu_torch.core.tree import Tree
from historian_tpu_torch.models.ratemodel import RateModel
from historian_tpu_torch.utils.rng import MT19937

COMPONENT_TAG = "CPT"


def _geometric(rng: MT19937, p_stop: float) -> int:
    """std::geometric_distribution(p): number of failures before success."""
    u = rng.uniform()
    if p_stop >= 1.0:
        return 0
    return int(math.floor(math.log1p(-u) / math.log1p(-(p_stop))))


def _discrete(rng: MT19937, weights) -> int:
    total = float(np.sum(weights))
    r = rng.uniform(0, total)
    acc = 0.0
    for i, w in enumerate(weights):
        acc += float(w)
        if r < acc:
            return i
    return len(weights) - 1


def simulate_gaps_by_gillespie(rng: MT19937, model: RateModel, parent_length: int, time: float, parent_row: int, child_row: int) -> AlignPath:
    """One branch of indel evolution (simulator.cpp:5-68)."""
    child2parent = list(range(parent_length))
    t = 0.0
    while True:
        total_ins = model.ins_rate * (len(child2parent) + 1)
        total_del = model.del_rate * len(child2parent)
        total = total_ins + total_del
        if total <= 0:
            break
        wait = -math.log(rng.uniform()) / total
        t += wait
        if t > time:
            break
        r = rng.uniform() * total
        if r < total_ins:
            ins_pos = int(r / model.ins_rate)
            ins_len = 1 + _geometric(rng, 1.0 - model.ins_ext_prob)
            child2parent[ins_pos:ins_pos] = [-1] * ins_len
        else:
            r_del = r - total_ins
            del_pos = int(r_del / model.del_rate)
            del_len = 1 + _geometric(rng, 1.0 - model.del_ext_prob)
            del child2parent[del_pos : min(del_pos + del_len, len(child2parent))]
    parent_path: list[bool] = []
    child_path: list[bool] = []
    parent_pos = 0
    for cp in child2parent:
        if cp < 0:
            parent_path.append(False)
            child_path.append(True)
        else:
            while parent_pos < cp:
                parent_path.append(True)
                child_path.append(False)
                parent_pos += 1
            parent_path.append(True)
            child_path.append(True)
            parent_pos += 1
    while parent_pos < parent_length:
        parent_path.append(True)
        child_path.append(False)
        parent_pos += 1
    return {
        parent_row: np.array(parent_path, dtype=bool),
        child_row: np.array(child_path, dtype=bool),
    }


def simulate_subs_by_matexp(rng: MT19937, model: RateModel, tree: Tree, path: AlignPath) -> list[FastSeq]:
    """Sample characters down the tree (simulator.cpp:70-116)."""
    cols = align_path_columns(path)
    n = tree.n_nodes()
    a = model.alphabet_size
    tok = np.zeros((n, cols), dtype=np.int32)
    component = np.zeros((n, cols), dtype=np.int32)
    seqs = [["-"] * cols for _ in range(n)]
    cpts = [["-"] * cols for _ in range(n)]
    sub_mats = {
        node: model.sub_prob_matrix(tree.branch_length(node)) for node in tree.preorder()
    }
    for node in tree.preorder():
        parent = tree.parent(node)
        row = np.asarray(path[node], dtype=bool)
        prow = np.asarray(path[parent], dtype=bool) if parent >= 0 else None
        for col in range(cols):
            if not row[col]:
                continue
            is_insertion = prow is None or not prow[col]
            if is_insertion:
                cpt = _discrete(rng, model.cpt_weight)
                tok[node, col] = _discrete(rng, model.ins_prob[cpt])
            else:
                cpt = component[parent, col]
                tok[node, col] = _discrete(rng, sub_mats[node][cpt, tok[parent, col]])
            component[node, col] = cpt
            seqs[node][col] = model.alphabet.symbol(tok[node, col])
            cpts[node][col] = chr(ord("0") + cpt) if cpt < 10 else chr(ord("A") + cpt - 10)
    out = []
    for node in range(n):
        out.append(
            FastSeq(name=tree.seq_name(node), seq="".join(seqs[node]), qual="".join(cpts[node]))
        )
    return out


def simulate_tree(rng: MT19937, model: RateModel, tree: Tree, root_length: int) -> Stockholm:
    """Whole-tree simulation -> Stockholm (simulator.cpp:118-146)."""
    branch_paths: list[AlignPath] = []
    node_len = [0] * tree.n_nodes()
    node_len[tree.root()] = root_length
    for node in range(tree.root() - 1, -1, -1):
        parent = tree.parent(node)
        bp = simulate_gaps_by_gillespie(
            rng, model, node_len[parent], tree.branch_length(node), parent, node
        )
        node_len[node] = residues_in_row(bp[node])
        branch_paths.append(bp)
    path = align_path_merge(branch_paths) if branch_paths else {tree.root(): np.ones(root_length, bool)}
    gapped = simulate_subs_by_matexp(rng, model, tree, path)
    stock = Stockholm.from_seqs(
        [FastSeq(name=s.name, seq=s.seq) for s in gapped], tree
    )
    if model.components > 1:
        for node in range(tree.n_nodes()):
            stock.gr.setdefault(COMPONENT_TAG, {})[gapped[node].name] = gapped[node].qual
    return stock
