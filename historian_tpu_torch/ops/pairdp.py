"""Banded pairwise Viterbi fill (the guide stage's 3-state M/I/D DP).

Port of historian_tpu/ops/pairdp.py::banded_viterbi_fill: one vector
step per y column, every x row at once.  Match and Insert read only the
previous column; Delete's within-column chain
del[i] = max(base[i], del[i-1] + d2d) is the JAX package's telescoped
form, z = base - i*d2d, a running max that resets at out-of-envelope
cells, then + i*d2d.  The multiply and the add are separate tensor ops,
so nothing is contracted into a fused multiply-add, and the running max
is exact, so the values are those of the JAX fill bit for bit in f64.

This is the plain version the guide kernel (csrc/guidealign.cu) is held
against; `ops/guidedp.py` runs it for CPU tensors.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _shift(v: torch.Tensor, d: int, fill) -> torch.Tensor:
    """v at row i-d along the last axis; the first d rows read `fill`."""
    return torch.cat([v.new_full((*v.shape[:-1], d), fill), v[..., :-d]], dim=-1)


def _shift_down(v: torch.Tensor) -> torch.Tensor:
    """v at row i-1; row 0 reads NEG_INF."""
    return _shift(v, 1, NEG_INF)


def segmented_running_max(z: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """out[i] = max(z[k] for k in s..i) along the last axis, s the last
    reset at or before i (a Hillis-Steele scan of the JAX package's
    `seg_combine`)."""
    v, f = z, reset
    n = z.shape[-1]
    d = 1
    while d < n:
        v_s = _shift(v, d, NEG_INF)
        f_s = _shift(f, d, False)
        v = torch.where(f, v, torch.maximum(v, v_s))
        f = f | f_s
        d *= 2
    return v


def banded_viterbi_fill(emit, mask, start_gap, trans):
    """emit, start_gap [..., X+1, Y+1] float; mask [..., X+1, Y+1] bool;
    trans [10] (m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m, -, -).  Returns
    (mat, ins, del), each [..., Y+1, X+1] (column-major stack), column 0
    all NEG_INF.  Leading axes are a batch of pairs padded to one shape:
    a cell reads only cells of lower i and j, so cells past a pair's own
    size (masked out) never reach its values."""
    m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m = trans[:8].tolist()
    X1, Y1 = emit.shape[-2:]
    idx = torch.arange(X1, dtype=emit.dtype, device=emit.device)
    idx_d2d = idx * d2d
    neg = emit.new_full((*emit.shape[:-2], X1), NEG_INF)
    mats, inss, dels = [neg], [neg], [neg]
    m_prev = i_prev = d_prev = neg
    for j in range(1, Y1):
        mask_col = mask[..., j]
        m_cand = torch.maximum(
            torch.maximum(_shift_down(m_prev) + m2m, _shift_down(d_prev) + d2m),
            _shift_down(i_prev) + i2m,
        )
        m_cand = torch.maximum(m_cand, start_gap[..., j])
        m = torch.where(mask_col, m_cand + emit[..., j], neg)
        ins = torch.where(mask_col, torch.maximum(i_prev + i2i, m_prev + m2i), neg)
        base = torch.maximum(_shift_down(ins) + i2d, _shift_down(m) + m2d)
        z = torch.where(mask_col, base - idx_d2d, neg)
        seg = segmented_running_max(z, ~mask_col)
        d = torch.where(mask_col, seg + idx_d2d, neg)
        mats.append(m)
        inss.append(ins)
        dels.append(d)
        m_prev, i_prev, d_prev = m, ins, d
    return torch.stack(mats, -2), torch.stack(inss, -2), torch.stack(dels, -2)
