"""Column-batched Felsenstein sum-product on a tree, in PyTorch.

Port of historian_tpu/ops/felsenstein.py: `TreeArrays`,
`tokenize_alignment`, the up pass (`_fill_up_batch_tokens`), the down
pass (`_fill_down_batch`), the node posteriors (`_node_post_prob_batch`),
the eigencount contractions (`_eigen_counts_batch`, and the complex
`_eigen_counts_core_cplx` / `_eigen_counts_batch_cplx`) and the root
counts (`_root_counts_batch`).  The JAX versions scan the nodes inside a
vmap over columns; here the loop over nodes is Python and each node is
one batched [L, C, A] x [A, A] product over all columns, on the device
and in the dtype of the tensors given.  Same gap semantics (a gapped
node passes E = 1, an ungapped node under a gapped parent roots a
sub-forest of the column) and the same per-node max rescaling in the up
pass.  The complex contraction runs in complex128 where the JAX package
splits it into real and imaginary parts.

Shapes: L columns, N nodes (postorder, root last), C mixture components,
A alphabet symbols.  F, E, G are [L, N, C, A]; logF, logE, logG [L, N, C].
"""

from __future__ import annotations

import numpy as np
import torch

GAP_TOK = -1
WILD_TOK = -2


class TreeArrays:
    """Binary-tree structure as flat arrays, nodes in postorder (root last);
    -1 marks a missing parent, child or sibling."""

    def __init__(self, tree):
        n = tree.n_nodes()
        for node in range(n):
            if 0 <= tree.parent(node) <= node:
                raise ValueError("tree nodes must be toposorted (children before parents)")
        self.n_nodes = n
        self.parent = np.array([tree.parent(node) for node in range(n)], dtype=np.int64)
        self.left = np.full(n, -1, dtype=np.int64)
        self.right = np.full(n, -1, dtype=np.int64)
        self.sibling = np.full(n, -1, dtype=np.int64)
        for node in range(n):
            kids = tree.children(node)
            if len(kids) > 2:
                raise ValueError("sum-product requires at most 2 children per node")
            if kids:
                self.left[node] = kids[0]
            if len(kids) == 2:
                self.right[node] = kids[1]
                self.sibling[kids[0]] = kids[1]
                self.sibling[kids[1]] = kids[0]


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


def fill_up(tokens: np.ndarray, arrays: TreeArrays, sub: torch.Tensor,
            ins_prob: torch.Tensor, log_cpt_weight: torch.Tensor) -> tuple:
    """Tip-to-root messages of a tokenized alignment [N, L]:
    (F, logF, E, logE, cpt_ll [L, C], col_ll [L]).

    sub [N, C, A, A] branch substitution probabilities (root row unused),
    ins_prob [C, A], log_cpt_weight [C], all on one device and dtype.  A
    gapped node has F = 0 and E = 1; a column root has E = 1 and adds
    logF + log(F . insProb) to its column's cpt_ll."""
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
    F: list = [None] * N
    logF: list = [None] * N
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
        F[n] = torch.where(gap[n][:, None, None], 0.0, f)
        logF[n] = torch.where(gap[n][:, None], 0.0, log_f)
    col_ll = torch.logsumexp(log_cpt_weight[None, :] + cpt_ll, dim=1)
    col_ll = torch.where(gap.all(dim=0), 0.0, col_ll)
    return (torch.stack(F, dim=1), torch.stack(logF, dim=1), torch.stack(E, dim=1),
            torch.stack(logE, dim=1), cpt_ll, col_ll)


def column_log_likelihoods(tokens: np.ndarray, arrays: TreeArrays, sub: torch.Tensor,
                           ins_prob: torch.Tensor, log_cpt_weight: torch.Tensor) -> torch.Tensor:
    """Per-column log-likelihood [L] of a tokenized alignment (fill_up's
    col_ll)."""
    return fill_up(tokens, arrays, sub, ins_prob, log_cpt_weight)[5]


def fill_down(E: torch.Tensor, logE: torch.Tensor, is_gap: torch.Tensor, arrays: TreeArrays,
              sub: torch.Tensor, ins_prob: torch.Tensor) -> tuple:
    """Root-to-tip messages (G, logG) in preorder (reverse postorder).
    is_gap [L, N] bool.  A node whose parent is gapped or absent roots
    its column's sub-forest: G = insProb, logG = 0.  Otherwise
    G[n] = (G[parent] * E[sibling]) . sub[n], with the sibling's E taken
    as 1 where the sibling is gapped."""
    L, N, C, A = E.shape
    G: list = [None] * N
    logG: list = [None] * N
    ones = torch.ones((L, C, A), dtype=E.dtype, device=E.device)
    zeros = torch.zeros((L, C), dtype=E.dtype, device=E.device)
    root_g = ins_prob.expand(L, C, A)
    for n in reversed(range(N)):
        p, s = int(arrays.parent[n]), int(arrays.sibling[n])
        if p < 0:
            G[n], logG[n] = root_g, zeros
            continue
        es = torch.where(is_gap[:, s, None, None], ones, E[:, s]) if s >= 0 else ones
        les = logE[:, s] if s >= 0 else zeros
        g = torch.einsum("lci,cij->lcj", G[p] * es, sub[n])
        root = is_gap[:, p]
        G[n] = torch.where(root[:, None, None], root_g, g)
        logG[n] = torch.where(root[:, None], 0.0, logG[p] + les)
    return torch.stack(G, dim=1), torch.stack(logG, dim=1)


def node_post_prob(F: torch.Tensor, logF: torch.Tensor, G: torch.Tensor, logG: torch.Tensor,
                   col_ll: torch.Tensor, log_cpt_weight: torch.Tensor) -> torch.Tensor:
    """[L, N, A] log posterior over the states of every node, summed over
    the mixture components and capped at 0."""
    tiny = torch.finfo(F.dtype).tiny
    lpp = (log_cpt_weight[None, None, :, None]
           + logF[..., None] + torch.log(torch.clamp_min(F, tiny))
           + logG[..., None] + torch.log(torch.clamp_min(G, tiny))
           - col_ll[:, None, None, None])
    return torch.clamp_max(torch.logsumexp(lpp, dim=2), 0.0)


def _eigen_contract(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
                    log_cpt_weight, evec, evec_inv, j):
    """sum over columns and nodes of w * (D0 . evec)_k (U0 . evecInv^T)_m J_km,
    D0 = G[parent] * E[sibling], U0 = F,
    w = exp(logw_c + logF + logG[parent] + logE[sibling] - col_ll) * w_col
    on the unmasked (ungapped, non-root) nodes; in evec's dtype."""
    D0 = G[:, parent_safe] * E[:, sib_safe]
    log_scale = (log_cpt_weight[None, None, :] + logF + logG[:, parent_safe]
                 + logE[:, sib_safe] - col_ll[:, None, None])
    w = torch.where(mask[:, :, None], torch.exp(log_scale), 0.0) * w_col[:, None, None]
    db = torch.einsum("lnca,cak->lnck", (w[..., None] * D0).to(evec.dtype), evec)
    ub = torch.einsum("lncb,cmb->lncm", F.to(evec.dtype), evec_inv)
    s = torch.einsum("lnck,lncm->nckm", db, ub)  # one batched product per (node, component)
    return (s * j).sum(dim=0)


def eigen_counts(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
                 log_cpt_weight, evec, evec_inv, j, chunk: int = 8192) -> torch.Tensor:
    """[C, A, A] eigencounts of a column batch for an exactly-real
    eigensystem (evec, evec_inv [C, A, A] and j [N, C, A, A] real):
    parent_safe and sib_safe [N] index tensors (-1 clamped to 0), mask
    [L, N] the ungapped nodes under an ungapped parent, w_col [L] the
    column weights.  Columns are contracted `chunk` at a time."""
    if evec.is_complex():
        raise TypeError("eigen_counts takes a real eigensystem (see eigen_counts_cplx)")
    return _chunked(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
                    log_cpt_weight, evec, evec_inv, j, chunk)


def eigen_counts_cplx(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
                      log_cpt_weight, evec, evec_inv, j, chunk: int = 8192) -> torch.Tensor:
    """`eigen_counts` for a complex eigensystem (the ECM codon models):
    evec, evec_inv and j complex128, the messages real; [C, A, A]
    complex128."""
    if not evec.is_complex():
        raise TypeError("eigen_counts_cplx takes a complex eigensystem")
    return _chunked(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
                    log_cpt_weight, evec, evec_inv, j, chunk)


def _chunked(F, logF, E, logE, G, logG, col_ll, parent_safe, sib_safe, mask, w_col,
             log_cpt_weight, evec, evec_inv, j, chunk):
    out = None
    for lo in range(0, F.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        part = _eigen_contract(F[sl], logF[sl], E[sl], logE[sl], G[sl], logG[sl], col_ll[sl],
                               parent_safe, sib_safe, mask[sl], w_col[sl], log_cpt_weight,
                               evec, evec_inv, j)
        out = part if out is None else out + part
    return out


def root_counts(F_sel: torch.Tensor, logF_sel: torch.Tensor, col_ll_sel: torch.Tensor,
                w_sel: torch.Tensor, log_cpt_weight: torch.Tensor,
                ins_prob: torch.Tensor) -> torch.Tensor:
    """[C, A] root counts over the root-bearing columns: F_sel [l, C, A] and
    logF_sel [l, C] at each column's root, col_ll_sel and w_sel [l]."""
    norm = torch.exp(log_cpt_weight[None, :] + logF_sel - col_ll_sel[:, None])
    return torch.einsum("l,ci,lci,lc->ci", w_sel, ins_prob, F_sel, norm)
