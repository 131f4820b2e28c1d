"""Column-batched Felsenstein up-pass (sum-product on a tree), in PyTorch.

Port of the likelihood half of historian_tpu/ops/felsenstein.py:
`TreeArrays`, `tokenize_alignment` and `_fill_up_batch_tokens`.  The
JAX version scans the postorder nodes inside a vmap over columns; here
the loop over nodes is Python and each node is one batched
[L, C, A] x [A, A] product over all columns.  Same gap semantics (a
gapped node passes E = 1, an ungapped node under a gapped parent roots
a sub-forest of the column) and the same per-node max rescaling.
"""

from __future__ import annotations

import numpy as np
import torch

GAP_TOK = -1
WILD_TOK = -2


class TreeArrays:
    """Binary-tree structure as flat arrays, nodes in postorder (root last);
    -1 marks a missing parent or child."""

    def __init__(self, tree):
        n = tree.n_nodes()
        for node in range(n):
            if 0 <= tree.parent(node) <= node:
                raise ValueError("tree nodes must be toposorted (children before parents)")
        self.n_nodes = n
        self.parent = np.array([tree.parent(node) for node in range(n)], dtype=np.int64)
        self.left = np.full(n, -1, dtype=np.int64)
        self.right = np.full(n, -1, dtype=np.int64)
        for node in range(n):
            kids = tree.children(node)
            if len(kids) > 2:
                raise ValueError("sum-product requires at most 2 children per node")
            if kids:
                self.left[node] = kids[0]
            if len(kids) == 2:
                self.right[node] = kids[1]


def tokenize_alignment(alphabet, gapped_rows: list[str]) -> np.ndarray:
    """[N, L] int32: token >= 0, GAP_TOK for gaps, WILD_TOK for wildcards
    and symbols outside the alphabet."""
    n = len(gapped_rows)
    length = len(gapped_rows[0]) if n else 0
    if any(len(r) != length for r in gapped_rows):
        raise ValueError("alignment rows have unequal lengths")
    if n == 0 or length == 0:
        return np.full((n, length), WILD_TOK, dtype=np.int32)
    codes = np.frombuffer("".join(gapped_rows).encode("latin-1"), dtype=np.uint8)
    codes = codes.reshape(n, length)
    toks = alphabet.tokenize_bytes(codes)
    is_gap = (codes == ord("-")) | (codes == ord("."))
    return np.where(is_gap, GAP_TOK, np.where(toks >= 0, toks, WILD_TOK)).astype(np.int32)


def column_log_likelihoods(tokens: np.ndarray, arrays: TreeArrays, sub: torch.Tensor,
                           ins_prob: torch.Tensor, log_cpt_weight: torch.Tensor) -> torch.Tensor:
    """Per-column log-likelihood [L] of a tokenized alignment.

    sub [N, C, A, A] branch substitution probabilities (root row unused),
    ins_prob [C, A], log_cpt_weight [C], all on one device and dtype."""
    dev, dtype = sub.device, sub.dtype
    N, L = tokens.shape
    C, A = ins_prob.shape
    tok = torch.as_tensor(tokens, device=dev, dtype=torch.long)  # [N, L]
    obs = torch.nn.functional.one_hot(tok.clamp_min(0), A).to(dtype)
    obs = torch.where((tok < 0)[..., None], torch.ones_like(obs), obs)  # [N, L, A]
    gap = tok == GAP_TOK  # [N, L]
    tiny = torch.finfo(dtype).tiny
    ones = torch.ones((L, C, A), dtype=dtype, device=dev)
    zeros = torch.zeros((L, C), dtype=dtype, device=dev)
    E: list = [None] * N
    logE: list = [None] * N
    cpt_ll = torch.zeros((L, C), dtype=dtype, device=dev)
    for n in range(N):
        l, r = int(arrays.left[n]), int(arrays.right[n])
        child = (E[l] if l >= 0 else ones) * (E[r] if r >= 0 else ones)
        log_children = (logE[l] if l >= 0 else zeros) + (logE[r] if r >= 0 else zeros)
        f_raw = child * obs[n][:, None, :]  # [L, C, A]
        safe = torch.clamp_min(f_raw.amax(dim=-1, keepdim=True), tiny)
        f = f_raw / safe
        log_f = log_children + torch.log(safe[..., 0])
        p = int(arrays.parent[n])
        gap_p = gap[p] if p >= 0 else torch.ones_like(gap[n])
        is_root = ~gap[n] & gap_p  # [L]
        root_ll = log_f + torch.log(torch.clamp_min(torch.einsum("lca,ca->lc", f, ins_prob), tiny))
        cpt_ll = cpt_ll + torch.where(is_root[:, None], root_ll, 0.0)
        e = torch.einsum("cij,lcj->lci", sub[n], f)
        cut = (gap[n] | is_root)[:, None]
        E[n] = torch.where(cut[..., None], 1.0, e)
        logE[n] = torch.where(cut, 0.0, log_f)
    col_ll = torch.logsumexp(log_cpt_weight[None, :] + cpt_ll, dim=1)
    return torch.where(gap.all(dim=0), 0.0, col_ll)
