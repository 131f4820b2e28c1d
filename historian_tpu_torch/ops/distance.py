"""All-pairs evolutionary distances for tree building.

Port of historian_tpu/ops/distance.py (`pair_count_matrices`,
`_grid_and_golden`, `batched_ml_distances`), which `recon` reaches
through `RateModel.distance_matrix`:

- the Jukes-Cantor shortcut (max_iterations <= 0, what `-jc` and so
  `-fast` take) on the host;
- the ML distances for every pair at once: the NLL on a shared t-grid
  as one einsum, then a lockstep golden-section search, in torch on the
  selected device in float64, as the JAX package runs them;
- the host per-pair solver for complex spectra, and for n <= 2
  sequences as `RateModel.distance_matrix` does.
"""

from __future__ import annotations

import numpy as np
import torch

T_MIN = 1e-9
T_MAX = 10.0
GOLDEN = 0.6180339887498949


def pair_count_matrices(alphabet, gapped_rows: list[str], dtype=np.float64) -> np.ndarray:
    """[P, A, A] aligned-pair counts for all P = N(N-1)/2 pairs (i < j)."""
    n = len(gapped_rows)
    a = alphabet.size
    length = len(gapped_rows[0]) if n else 0
    toks = np.stack([alphabet.tokenize(r) for r in gapped_rows])  # [N, L]
    onehot = np.zeros((n, length, a), dtype=dtype)
    valid = toks >= 0
    idx = np.nonzero(valid)
    onehot[idx[0], idx[1], toks[valid]] = 1.0
    pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
    out = np.empty((len(pairs), a, a), dtype=dtype)
    for p, (i, j) in enumerate(pairs):
        out[p] = np.einsum("la,lb->ab", onehot[i], onehot[j])
    return out


def grid_and_golden(counts, log_p_grid, t_grid, evec, evals, evinv, weights, n_golden: int):
    """counts [P, A, A]; log_p_grid [T, A, A]; t_grid [T]; the real
    eigen-decomposition evec [C, A, A], evals [C, A], evinv [C, A, A] and
    the component weights [C].  Returns t_opt [P]."""
    nll_grid = -torch.einsum("pab,tab->pt", counts, log_p_grid)
    best = torch.argmin(nll_grid, dim=1)
    a_ = t_grid[torch.clamp_min(best - 1, 0)]
    b_ = t_grid[torch.clamp_max(best + 1, len(t_grid) - 1)]

    def nll_at(t):  # t [P]
        e = torch.exp(evals[None, :, :] * t[:, None, None])  # [P, C, A]
        p = torch.einsum("c,cik,pck,ckj->pij", weights, evec, e, evinv)
        p = torch.clamp(p, 1e-300, 1.0)
        return -torch.einsum("pab,pab->p", counts, torch.log(p))

    for _ in range(n_golden):
        x1 = b_ - GOLDEN * (b_ - a_)
        x2 = a_ + GOLDEN * (b_ - a_)
        lower = nll_at(x1) < nll_at(x2)
        a_, b_ = torch.where(lower, a_, x1), torch.where(lower, x2, b_)
    return (a_ + b_) / 2


def _symmetric(n: int, values) -> np.ndarray:
    dist = np.zeros((n, n))
    p = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = values(p)
            p += 1
    return dist


def batched_ml_distances(model, gapped_seqs, max_iterations: int, device: torch.device,
                         n_grid: int = 96, n_golden: int = 40) -> np.ndarray:
    """All-pairs distance matrix (historian_tpu/ops/distance.py
    batched_ml_distances); the grid and golden search run on `device`."""
    from historian_tpu_torch.models.eigen import EigenModel

    n = len(gapped_seqs)
    counts = pair_count_matrices(model.alphabet, [s.seq for s in gapped_seqs])
    if max_iterations <= 0:  # the Jukes-Cantor shortcut
        return _symmetric(n, lambda p: min(T_MAX, max(T_MIN, model.jukes_cantor_distance(counts[p]))))
    eigen = EigenModel(model)
    if not np.all(eigen.is_real):  # complex spectrum: host per-pair solves
        return _symmetric(n, lambda p: model.ml_distance_from_counts(counts[p], max_iterations))
    t_grid = np.concatenate([[T_MIN], np.geomspace(1e-4, T_MAX, n_grid - 1)])
    p_grid = np.stack([model.sub_prob_matrix(t) for t in t_grid])  # [T, C, A, A]
    p_mix = np.einsum("c,tcab->tab", model.cpt_weight, p_grid)
    log_p_grid = np.log(np.clip(p_mix, 1e-300, 1.0))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    t_opt = grid_and_golden(
        t(counts), t(log_p_grid), t(t_grid), t(eigen.evec.real), t(eigen.eval.real),
        t(eigen.evec_inv.real), t(model.cpt_weight), n_golden,
    )
    t_opt = t_opt.cpu().numpy()
    return _symmetric(n, lambda p: float(t_opt[p]))


def distance_matrix(model, gapped_seqs, max_iterations: int, device: torch.device) -> np.ndarray:
    """`RateModel.distance_matrix` of the JAX package on the port: the
    batched solver for n > 2 sequences, the host per-pair path below."""
    n = len(gapped_seqs)
    if n > 2:
        return batched_ml_distances(model, gapped_seqs, max_iterations, device)
    return _symmetric(n, lambda p: model.ml_distance(
        gapped_seqs[0].seq, gapped_seqs[1].seq, max_iterations))
