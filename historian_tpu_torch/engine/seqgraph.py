"""Ancestral-sequence partial-order graph export (GraphViz dot).

The port's copy of historian_tpu/engine/seqgraph.py, the reference's SeqGraph:
one node per (profile state x above-threshold residue), simplification
passes eliminateNull -> eliminateDuplicates -> mergeCharClasses ->
collapseChains, dot output (the -savedot option).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.special import logsumexp

from historian_tpu_torch.engine.profile import Profile


@dataclass
class _Node:
    seq: str = ""
    in_edges: list = field(default_factory=list)
    out_edges: list = field(default_factory=list)

    @property
    def is_null(self) -> bool:
        return not self.seq


class SeqGraph:
    def __init__(self):
        self.nodes: list[_Node] = []
        self.edges: set[tuple[int, int]] = set()

    @classmethod
    def from_profile(cls, prof: Profile, alphabet: str, log_cpt_weight: np.ndarray, log_ins_prob: np.ndarray, min_post_prob: float) -> "SeqGraph":
        g = cls()
        min_lp = np.log(min_post_prob) if min_post_prob > 0 else -np.inf
        state_nodes: list[list[int]] = []
        for s in range(prof.size):
            st = prof.states[s]
            nodes_here: list[int] = []
            if st.is_null:
                nodes_here.append(len(g.nodes))
                g.nodes.append(_Node())
            else:
                scores = log_cpt_weight[:, None] + log_ins_prob + st.lp_absorb  # [C, A]
                lp_norm = logsumexp(scores)
                lp = logsumexp(scores - lp_norm, axis=0)  # [A]
                i_max = int(np.argmax(lp))
                for i in range(len(alphabet)):
                    if i == i_max or lp[i] > min_lp:
                        nodes_here.append(len(g.nodes))
                        g.nodes.append(_Node(seq=alphabet[i]))
            state_nodes.append(nodes_here)
        for t in prof.trans:
            for s in state_nodes[t.src]:
                for d in state_nodes[t.dest]:
                    g.edges.add((s, d))
        g._build_indices()
        return g

    def _build_indices(self) -> None:
        for n in self.nodes:
            n.in_edges = []
            n.out_edges = []
        for e in sorted(self.edges):
            self.nodes[e[0]].out_edges.append(e)
            self.nodes[e[1]].in_edges.append(e)
        for s, d in self.edges:
            assert d > s, "SeqGraph is not topologically sorted"

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    # ------------------------------------------------------------ simplify
    def eliminate_null(self) -> "SeqGraph":
        elim: dict[int, set[tuple[int, int]]] = {}
        keep: set[tuple[int, int]] = set()
        for src in range(self.n_nodes - 1, -1, -1):
            src_out: set[tuple[int, int]] = set()
            for e in self.nodes[src].out_edges:
                if e[1] in elim:
                    for e2 in elim[e[1]]:
                        src_out.add((src, e2[1]))
                else:
                    src_out.add(e)
            if self.nodes[src].is_null:
                elim[src] = src_out
            else:
                keep |= src_out
        if not elim:
            return self
        g = SeqGraph()
        old2new: dict[int, int] = {}
        for n in range(self.n_nodes):
            if not self.nodes[n].is_null:
                old2new[n] = len(g.nodes)
                g.nodes.append(_Node(seq=self.nodes[n].seq))
        for s, d in keep:
            g.edges.add((old2new[s], old2new[d]))
        g._build_indices()
        return g

    def eliminate_duplicates(self) -> "SeqGraph":
        equiv: dict[int, int] = {}
        unique: dict[tuple, int] = {}
        for n in range(self.n_nodes - 1, -1, -1):
            dests = frozenset(equiv.get(e[1], e[1]) for e in self.nodes[n].out_edges)
            summ = (self.nodes[n].seq, dests)
            if summ in unique:
                equiv[n] = unique[summ]
            else:
                unique[summ] = n
        if not equiv:
            return self
        g = SeqGraph()
        old2new: dict[int, int] = {}
        for n in range(self.n_nodes):
            if n not in equiv:
                old2new[n] = len(g.nodes)
                g.nodes.append(_Node(seq=self.nodes[n].seq))
        for s, d in self.edges:
            if s in old2new:
                g.edges.add((old2new[s], old2new[equiv.get(d, d)]))
        g._build_indices()
        return g

    def merge_char_classes(self) -> "SeqGraph":
        equiv: dict[int, int] = {}
        class_rep: dict[tuple, int] = {}
        class_chars: dict[int, str] = {}
        for n in range(self.n_nodes - 1, -1, -1):
            if len(self.nodes[n].seq) == 1:
                srcs = frozenset(equiv.get(e[0], e[0]) for e in self.nodes[n].in_edges)
                dests = frozenset(equiv.get(e[1], e[1]) for e in self.nodes[n].out_edges)
                summ = (srcs, dests)
                if summ in class_rep:
                    equiv[n] = class_rep[summ]
                    class_chars[class_rep[summ]] = self.nodes[n].seq + class_chars[class_rep[summ]]
                else:
                    class_rep[summ] = n
                    class_chars[n] = self.nodes[n].seq
        if not equiv:
            return self
        g = SeqGraph()
        old2new: dict[int, int] = {}
        for n in range(self.n_nodes):
            if n not in equiv:
                old2new[n] = len(g.nodes)
                if n in class_chars and len(class_chars[n]) > 1:
                    g.nodes.append(_Node(seq="[" + class_chars[n] + "]"))
                else:
                    g.nodes.append(_Node(seq=self.nodes[n].seq))
        for s, d in self.edges:
            if s in old2new and d in old2new:
                g.edges.add((old2new[s], old2new[d]))
        g._build_indices()
        return g

    def collapse_chains(self) -> "SeqGraph":
        chain_end: dict[int, int] = {}
        chain_seq: dict[int, str] = {}
        elim: set[int] = set()
        for n in range(self.n_nodes - 1, -1, -1):
            out = self.nodes[n].out_edges
            if len(out) == 1 and out[0][1] in chain_end and len(self.nodes[out[0][1]].in_edges) == 1:
                dest = out[0][1]
                chain_end[n] = chain_end[dest]
                chain_seq[chain_end[n]] = self.nodes[n].seq + chain_seq[chain_end[n]]
                elim.add(n)
            elif len(self.nodes[n].in_edges) == 1:
                chain_end[n] = n
                chain_seq[n] = self.nodes[n].seq
        if not elim:
            return self
        g = SeqGraph()
        old2new: dict[int, int] = {}
        for n in range(self.n_nodes):
            if n not in elim:
                old2new[n] = len(g.nodes)
                g.nodes.append(_Node(seq=chain_seq.get(n, self.nodes[n].seq)))
        for s, d in self.edges:
            if s in old2new:
                g.edges.add((old2new[s], old2new[chain_end.get(d, d)]))
        g._build_indices()
        return g

    def simplify(self) -> "SeqGraph":
        return (
            self.eliminate_null().eliminate_duplicates().merge_char_classes().collapse_chains()
        )

    # ----------------------------------------------------------------- output
    def to_dot(self) -> str:
        out = ["digraph profile {"]
        for n in range(self.n_nodes):
            out.append(f'  n{n + 1} [ shape = rect, label = "{self.nodes[n].seq}" ];')
        for s, d in sorted(self.edges):
            out.append(f"  n{s + 1} -> n{d + 1};")
        out.append("}")
        return "\n".join(out) + "\n"
