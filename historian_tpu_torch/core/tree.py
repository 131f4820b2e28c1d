"""Phylogenetic trees: Newick IO, traversals, NJ and UPGMA builders.

Counterpart of the reference's tree layer
(reference src/tree.h:25-121).  Same invariants: nodes are stored in
postorder (every child index < parent index, root = last node); branch
lengths are clamped to TREE_MIN_BRANCH_LEN at parse; NJ follows Durbin et
al. pp170-171 with the Kuhner-Felsenstein negative-branch correction
(tree.cpp:240-352); UPGMA is node-height based and yields an ultrametric
tree (tree.cpp:362-454).  The O(N^2)/O(N^3) builders stay on host (N is
small); the distance *matrix* that feeds them is computed on the
device (historian_tpu_torch/ops/distance.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

TREE_MIN_BRANCH_LEN = 1e-9
DEFAULT_NODE_NAME_PREFIX = "node"
DEFAULT_NEW_ROOT_NAME = "root"


def _fmt_g(d: float) -> str:
    """C++ default ostream float formatting (printf %g, 6 sig figs)."""
    return f"{d:g}"


def branch_length_string(d: float) -> str:
    return f":{_fmt_g(d)}" if d >= 0 else ""


@dataclass
class TreeNode:
    parent: int = -1
    children: list[int] = field(default_factory=list)
    name: str = ""
    length: float = -1.0  # branch length to parent; -1 = undefined


class Tree:
    """Postorder-indexed node array; root is the last node."""

    min_branch_length = TREE_MIN_BRANCH_LEN

    def __init__(self, newick: str | None = None):
        self.nodes: list[TreeNode] = []
        if newick is not None:
            self.parse(newick)

    # ------------------------------------------------------------------ parse
    def parse(self, newick: str) -> None:
        self.nodes = []
        text = newick.strip()
        pos = 0

        def skip_ws(p: int) -> int:
            while p < len(text) and (text[p].isspace() or text[p] == "["):
                if text[p] == "[":  # skip bracket comments (incl. NHX annotations)
                    depth = 1
                    p += 1
                    while p < len(text) and depth:
                        if text[p] == "[":
                            depth += 1
                        elif text[p] == "]":
                            depth -= 1
                        p += 1
                else:
                    p += 1
            return p

        def parse_name_length(p: int) -> tuple[str, float, int]:
            p = skip_ws(p)
            name_chars = []
            if p < len(text) and text[p] in "'\"":
                quote = text[p]
                p += 1
                while p < len(text) and text[p] != quote:
                    name_chars.append(text[p])
                    p += 1
                p += 1
            else:
                while p < len(text) and text[p] not in "():,;[":
                    name_chars.append(text[p])
                    p += 1
            length = -1.0
            p = skip_ws(p)
            if p < len(text) and text[p] == ":":
                p = skip_ws(p + 1)
                start = p
                while p < len(text) and (text[p] in "+-.eE" or text[p].isdigit()):
                    p += 1
                length = float(text[start:p])
            return "".join(name_chars).strip(), length, p

        def parse_subtree(p: int) -> tuple[int, int]:
            """Returns (node index, next position); assigns indices postorder."""
            p = skip_ws(p)
            children: list[int] = []
            if p < len(text) and text[p] == "(":
                p += 1
                while True:
                    child, p = parse_subtree(p)
                    children.append(child)
                    p = skip_ws(p)
                    if p < len(text) and text[p] == ",":
                        p += 1
                        continue
                    if p < len(text) and text[p] == ")":
                        p += 1
                        break
                    raise ValueError(f"Newick parse error at position {p}: {text[p:p+20]!r}")
            name, length, p = parse_name_length(p)
            idx = len(self.nodes)
            node = TreeNode(name=name, length=length, children=children)
            self.nodes.append(node)
            for c in children:
                self.nodes[c].parent = idx
            return idx, p

        root, pos = parse_subtree(0)
        pos = skip_ws(pos)
        if pos < len(text) and text[pos] == ";":
            pos += 1
        if skip_ws(pos) < len(text):
            raise ValueError(f"trailing characters after Newick tree: {text[pos:pos+20]!r}")

        # clamp branch lengths; check unique names (reference tree.cpp:27-34)
        names: set[str] = set()
        for n in self.nodes:
            if n.length >= 0:
                n.length = max(n.length, self.min_branch_length)
            if n.name:
                if n.name in names:
                    raise ValueError(f"duplicate node name {n.name!r} in tree")
                names.add(n.name)

    # -------------------------------------------------------------- accessors
    def n_nodes(self) -> int:
        return len(self.nodes)

    def root(self) -> int:
        return len(self.nodes) - 1

    def parent(self, n: int) -> int:
        return self.nodes[n].parent

    def children(self, n: int) -> list[int]:
        return self.nodes[n].children

    def n_children(self, n: int) -> int:
        return len(self.nodes[n].children)

    def is_leaf(self, n: int) -> bool:
        return not self.nodes[n].children

    def node_name(self, n: int) -> str:
        return self.nodes[n].name

    def branch_length(self, n: int) -> float:
        return self.nodes[n].length

    def branch_length_between(self, n1: int, n2: int) -> float:
        if n1 == self.parent(n2):
            return self.branch_length(n2)
        if n2 == self.parent(n1):
            return self.branch_length(n1)
        raise ValueError(f"nodes {n1} and {n2} are not connected by a branch")

    def sibling(self, n: int) -> int:
        p = self.parent(n)
        if p < 0:
            raise ValueError("root has no sibling")
        kids = self.children(p)
        if len(kids) != 2:
            raise ValueError("sibling lookup on non-binary node")
        return kids[1] if kids[0] == n else kids[0]

    def siblings(self, n: int) -> list[int]:
        p = self.parent(n)
        if p < 0:
            return []
        return [c for c in self.children(p) if c != n]

    def find_node(self, name: str) -> int:
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i
        raise KeyError(f"couldn't find tree node {name!r}")

    def has_node(self, name: str) -> bool:
        return any(n.name == name for n in self.nodes)

    def is_binary(self) -> bool:
        return all(self.is_leaf(n) or self.n_children(n) == 2 for n in range(self.n_nodes()))

    def assert_binary(self) -> None:
        if not self.is_binary():
            raise ValueError("tree is not binary")

    def is_postorder_sorted(self) -> bool:
        for n in range(self.root()):
            if self.parent(n) <= n:
                return False
        return self.parent(self.root()) < 0

    def validate_branch_lengths(self) -> None:
        for n in range(self.n_nodes() - 1):
            if self.branch_length(n) < self.min_branch_length:
                raise ValueError(f"node {self.seq_name(n)} has missing or below-minimum branch length")

    # ------------------------------------------------------------- traversals
    def rerooted_children(self, n: int, parent: int) -> list[int]:
        kids = [c for c in self.children(n) if c != parent]
        p = self.parent(n)
        if p >= 0 and p != parent:
            kids.append(p)
        return kids

    def rerooted_preorder(self, new_root: int, parent_of_root: int = -1) -> list[int]:
        out: list[int] = []
        stack = [(new_root, parent_of_root)]
        while stack:
            n, p = stack.pop()
            out.append(n)
            for kid in reversed(self.rerooted_children(n, p)):
                stack.append((kid, n))
        return out

    def rerooted_parent(self, new_root: int) -> list[int]:
        newp = [-1] * self.n_nodes()
        stack = [(new_root, -1)]
        while stack:
            n, p = stack.pop()
            newp[n] = p
            for kid in self.rerooted_children(n, p):
                stack.append((kid, n))
        return newp

    def preorder(self) -> list[int]:
        out: list[int] = []
        for r in range(self.n_nodes()):
            if self.parent(r) < 0:
                out.extend(self.rerooted_preorder(r))
        if not out:
            raise ValueError("couldn't find root")
        return out

    def postorder(self) -> list[int]:
        return list(reversed(self.preorder()))

    def node_and_ancestors(self, n: int) -> set[int]:
        out = set()
        while n >= 0:
            out.add(n)
            n = self.parent(n)
        return out

    def node_and_descendants(self, n: int) -> set[int]:
        return set(self.rerooted_preorder(n, self.parent(n)))

    def mrca(self, n1: int, n2: int) -> int:
        anc1 = self.node_and_ancestors(n1)
        while n2 >= 0 and n2 not in anc1:
            n2 = self.parent(n2)
        return n2

    def distance_from(self, node: int) -> np.ndarray:
        dist = np.zeros(self.n_nodes())
        newp = self.rerooted_parent(node)
        for n in self.rerooted_preorder(node):
            p = newp[n]
            if p >= 0:
                dist[n] = dist[p] + self.branch_length_between(p, n)
        return dist

    def distance_from_root(self) -> np.ndarray:
        return self.distance_from(self.root())

    def is_ultrametric(self, epsilon: float = 1e-4) -> bool:
        dist = self.distance_from_root()
        leaf_d = [dist[n] for n in range(self.n_nodes()) if self.is_leaf(n)]
        dmin = min(leaf_d)
        return all(abs(d - dmin) <= epsilon * max(abs(d), abs(dmin)) for d in leaf_d)

    def assert_ultrametric(self, epsilon: float = 1e-4) -> None:
        if not self.is_ultrametric(epsilon):
            raise ValueError("tree is not ultrametric")

    def closest_leaf(self, node: int, parent: int = -1) -> int:
        newp = self.rerooted_parent(node if parent < 0 else parent)
        post = list(reversed(self.rerooted_preorder(node, parent)))
        closest = [-1] * self.n_nodes()
        dist = [0.0] * self.n_nodes()
        for n in post:
            if self.is_leaf(n):
                closest[n] = n
                dist[n] = 0.0
            else:
                for c in self.rerooted_children(n, newp[n]):
                    d = dist[c] + self.branch_length_between(n, c)
                    if closest[n] < 0 or d < dist[n]:
                        closest[n] = closest[c]
                        dist[n] = d
        return closest[node]

    # ------------------------------------------------------------- serialization
    def node_descriptor(self, n: int, parent: int) -> tuple[str, float]:
        children = self.rerooted_children(n, parent)
        if not children:
            return self.node_name(n), self.branch_length_between(parent, n) if parent >= 0 else self.branch_length(n)
        if len(children) == 1:
            name, d = self.node_descriptor(children[0], n)
            up = self.branch_length_between(parent, n) if parent >= 0 else self.branch_length(n)
            return name, d + up
        parts = []
        for c in children:
            name, d = self.node_descriptor(c, n)
            parts.append(name + branch_length_string(d))
        s = "(" + ",".join(parts) + ")" + self.node_name(n)
        up = self.branch_length_between(parent, n) if parent >= 0 else self.branch_length(n)
        return s, up

    def node_to_string(self, n: int, parent: int | None = None) -> str:
        if parent is None:
            parent = self.parent(n)
        return self.node_descriptor(n, parent)[0]

    def to_string(self, n: int | None = None, parent: int | None = None) -> str:
        if n is None:
            n = self.root()
        return self.node_to_string(n, parent) + ";"

    def __str__(self) -> str:
        return self.to_string()

    def to_string_rerooted_above(self, n: int, new_root_name: str = DEFAULT_NEW_ROOT_NAME) -> str:
        if n == self.root() or self.parent(n) == self.root():
            return self.to_string()
        parent = self.parent(n)
        nd, nlen = self.node_descriptor(n, parent)
        pd, plen = self.node_descriptor(parent, n)
        return (
            "(" + nd + branch_length_string(nlen / 2) + ","
            + pd + branch_length_string(plen / 2) + ")" + new_root_name + ";"
        )

    def reroot_above(self, n, new_root_name: str = DEFAULT_NEW_ROOT_NAME) -> "Tree":
        if isinstance(n, str):
            n = self.find_node(n)
        return Tree(self.to_string_rerooted_above(n, new_root_name))

    def has_children(self) -> bool:
        return any(not self.is_leaf(n) for n in range(self.n_nodes()))

    def has_grandchildren(self) -> bool:
        return any(
            not self.is_leaf(n) and any(not self.is_leaf(c) for c in self.children(n))
            for n in range(self.n_nodes())
        )

    def detach(self, n: int) -> None:
        """Remove node n from its parent's child list (leaves parent dangling)."""
        p = self.parent(n)
        if p >= 0:
            self.nodes[p].children = [c for c in self.nodes[p].children if c != n]
        self.nodes[n].parent = -1

    def set_parent(self, n: int, parent: int, branch_length: float) -> None:
        """Re-attach node n below parent.  WARNING: does not check for
        cycles and may leave the tree non-postorder-sorted (reference
        tree.h:74)."""
        old = self.parent(n)
        if old >= 0:
            self.nodes[old].children = [c for c in self.nodes[old].children if c != n]
        self.nodes[n].parent = parent
        self.nodes[n].length = branch_length
        if parent >= 0 and n not in self.nodes[parent].children:
            self.nodes[parent].children.append(n)

    def copy(self) -> "Tree":
        t = Tree()
        for n in self.nodes:
            t.nodes.append(TreeNode(parent=n.parent, children=list(n.children), name=n.name, length=n.length))
        return t

    def reorder_nodes(self, new_order: list[int]) -> "Tree":
        t = Tree()
        old2new = [-1] * self.n_nodes()
        for new_idx, old_idx in enumerate(new_order):
            old2new[old_idx] = new_idx
        for old_idx in new_order:
            src = self.nodes[old_idx]
            t.nodes.append(
                TreeNode(
                    parent=old2new[src.parent] if src.parent >= 0 else -1,
                    children=[old2new[c] for c in src.children],
                    name=src.name,
                    length=src.length,
                )
            )
        return t

    # ------------------------------------------------------------ name mapping
    def seq_name(self, n: int) -> str:
        s = self.node_name(n)
        if not s:
            parts = [
                f"{self.seq_name(c)}:{_fmt_g(self.branch_length(c))}" for c in self.children(n)
            ]
            s = "(" + ",".join(parts) + ")"
        return s

    @staticmethod
    def pair_parent_name(l_name: str, l_time: float, r_name: str, r_time: float) -> str:
        return f"({l_name}:{_fmt_g(l_time)},{r_name}:{_fmt_g(r_time)})"

    def all_nodes_named(self) -> bool:
        return all(n.name for n in self.nodes)

    def reorder_seqs(self, seqs: list) -> list:
        """Return seqs reordered so seqs[n].name == seq_name(n)."""
        if len(seqs) != self.n_nodes():
            raise ValueError("number of sequences doesn't match number of tree nodes")
        by_name = {}
        for s in seqs:
            if s.name in by_name:
                raise ValueError(f"duplicate sequence name {s.name!r}")
            by_name[s.name] = s
        out = []
        for n in range(self.n_nodes()):
            name = self.seq_name(n)
            if name not in by_name:
                raise KeyError(f"tree node {name!r} is absent from sequence dataset")
            out.append(by_name[name])
        return out

    def assign_internal_node_names(self, prefix: str = DEFAULT_NODE_NAME_PREFIX) -> None:
        names = {n.name for n in self.nodes if n.name}
        for i, n in enumerate(self.nodes):
            if not n.name:
                nn = f"{prefix}{i + 1}"
                while nn in names:
                    nn = "_" + nn
                n.name = nn
                names.add(nn)

    # ------------------------------------------------------------- tree builders
    @classmethod
    def neighbor_joining(cls, names: list[str], dist: np.ndarray) -> "Tree":
        """Durbin et al. NJ with Kuhner-Felsenstein negative-branch fix.

        The active-pair minimization is vectorized with numpy; the N-step
        agglomeration loop stays host-side (N is tree-size small).
        """
        n_leaves = len(names)
        if n_leaves < 2:
            raise ValueError("fewer than 2 nodes; can't make a binary tree")
        t = cls()
        maxn = 2 * n_leaves
        d = np.zeros((maxn, maxn))
        d[:n_leaves, :n_leaves] = np.asarray(dist, dtype=float)
        for name in names:
            t.nodes.append(TreeNode(name=name))
        active = list(range(n_leaves))
        while len(active) > 2:
            a = np.array(active)
            sub = d[np.ix_(a, a)]
            avg = sub.sum(axis=1) / (len(a) - 2)
            comp = sub - avg[:, None] - avg[None, :]
            iu = np.triu_indices(len(a), 1)
            best = int(np.argmin(comp[iu]))
            ai, aj = iu[0][best], iu[1][best]
            min_i, min_j = int(a[ai]), int(a[aj])
            k = len(t.nodes)
            d_ij = d[min_i, min_j]
            d[k, a] = d[a, k] = 0.5 * (d[min_i, a] + d[min_j, a] - d_ij)
            d_ik = 0.5 * (d_ij + avg[ai] - avg[aj])
            d_jk = d_ij - d_ik
            if d_ik < cls.min_branch_length:
                d_jk -= d_ik - cls.min_branch_length
                d_ik = cls.min_branch_length
            if d_jk < 0:
                d_ik -= d_jk - cls.min_branch_length
                d_jk = cls.min_branch_length
            d[min_i, k] = d[k, min_i] = d_ik
            d[min_j, k] = d[k, min_j] = d_jk
            t.nodes.append(TreeNode(children=[min_i, min_j]))
            t.nodes[min_i].parent = k
            t.nodes[min_i].length = max(0.0, d_ik)
            t.nodes[min_j].parent = k
            t.nodes[min_j].length = max(0.0, d_jk)
            active.remove(min_i)
            active.remove(min_j)
            active.append(k)
        i, j = sorted(active)
        dd = max(d[i, j], 0.0)
        k = len(t.nodes)
        t.nodes.append(TreeNode(children=[i, j]))
        t.nodes[i].parent = k
        t.nodes[i].length = max(0.0, dd / 2)
        t.nodes[j].parent = k
        t.nodes[j].length = max(0.0, dd / 2)
        return cls(t.to_string())  # reparse for canonical postorder indexing

    @classmethod
    def upgma(cls, names: list[str], dist: np.ndarray) -> "Tree":
        """Node-height UPGMA; yields an ultrametric tree."""
        n_leaves = len(names)
        if n_leaves < 2:
            raise ValueError("fewer than 2 nodes; can't make a binary tree")
        t = cls()
        maxn = 2 * n_leaves
        d = np.zeros((maxn, maxn))
        d[:n_leaves, :n_leaves] = np.asarray(dist, dtype=float)
        height = np.zeros(maxn)
        for name in names:
            t.nodes.append(TreeNode(name=name))
        active = list(range(n_leaves))

        def join(min_i: int, min_j: int) -> int:
            k = len(t.nodes)
            d_ij = d[min_i, min_j]
            height[k] = max(
                height[min_i] + cls.min_branch_length,
                height[min_j] + cls.min_branch_length,
                (height[min_i] + height[min_j] + d_ij) / 2,
            )
            d_ik = height[k] - height[min_i]
            d_jk = height[k] - height[min_j]
            a = np.array([m for m in active if m not in (min_i, min_j)], dtype=int)
            if len(a):
                d[k, a] = d[a, k] = (d[min_i, a] + d[min_j, a]) / 2
            d[min_i, k] = d[k, min_i] = d_ik
            d[min_j, k] = d[k, min_j] = d_jk
            t.nodes.append(TreeNode(children=[min_i, min_j]))
            t.nodes[min_i].parent = k
            t.nodes[min_i].length = max(0.0, d_ik)
            t.nodes[min_j].parent = k
            t.nodes[min_j].length = max(0.0, d_jk)
            return k

        while len(active) > 2:
            a = np.array(active)
            sub = d[np.ix_(a, a)]
            iu = np.triu_indices(len(a), 1)
            best = int(np.argmin(sub[iu]))
            min_i, min_j = int(a[iu[0][best]]), int(a[iu[1][best]])
            k = join(min_i, min_j)
            active.remove(min_i)
            active.remove(min_j)
            active.append(k)
        i, j = sorted(active)
        join(i, j)
        out = cls(t.to_string())
        out.assert_ultrametric()
        return out
