"""Tree sum-product engine, likelihood subset.

Port of historian_tpu/engine/sumprod.py::SumProductEngine as far as the
`#=GF LP` rescore needs it: per-branch substitution matrices and the
column log-likelihoods of a gapped alignment, computed in float64 on
the selected device.  Posteriors, eigencounts and the down pass are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from historian_tpu_torch.ops.felsenstein import (
    TreeArrays,
    column_log_likelihoods,
    tokenize_alignment,
)


class SumProductEngine:
    def __init__(self, model, tree, device: torch.device, dtype=torch.float64):
        self.model = model
        self.arrays = TreeArrays(tree)
        n = self.arrays.n_nodes
        c, a = model.components, model.alphabet_size
        sub = np.zeros((n, c, a, a))
        for node in range(n - 1):
            sub[node] = model.sub_prob_matrix(tree.branch_length(node))
        sub[n - 1] = np.eye(a)[None, :, :]  # the root has no branch
        with np.errstate(divide="ignore"):
            lw = np.log(model.cpt_weight)
        self.sub = torch.as_tensor(sub, dtype=dtype, device=device)
        self.ins_prob = torch.as_tensor(model.ins_prob, dtype=dtype, device=device)
        self.log_cpt_weight = torch.as_tensor(lw, dtype=dtype, device=device)

    def column_log_likelihoods(self, gapped_rows: list[str]) -> np.ndarray:
        tokens = tokenize_alignment(self.model.alphabet, gapped_rows)
        return column_log_likelihoods(
            tokens, self.arrays, self.sub, self.ins_prob, self.log_cpt_weight
        ).cpu().numpy()

    def log_likelihood(self, gapped_rows: list[str]) -> float:
        return float(self.column_log_likelihoods(gapped_rows).sum())
