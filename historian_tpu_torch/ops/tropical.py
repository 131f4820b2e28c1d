"""Tropical (max-plus, Viterbi) pair DP of one chain x chain pair, kernel (f).

Port of historian_tpu/ops/tropical.py (`max_affine_scan`,
`tropical_pair_forward`): the pair Forward of ops/pairforward.py
`pair_forward` with every log-sum-exp a maximum, over the same inputs
(absorb [X+1, Y+1], rootsub_x / ins_x [X+1], rootsub_y / ins_y [Y+1], the
envelope mask [X+1, Y+1] and trans [23], `pack_transitions`), giving each
cell's best-path score and the best end-to-end score.  It is sound only
where the reference itself runs Viterbi (guide alignments, refinement
sweeps, feasibility probes: a tropical end value is finite exactly when
the Forward one is); never for fills whose sums over paths feed sampling,
counts, posteriors or reported likelihoods.

- `tropical_pair_forward_plain` is the JAX row scan in PyTorch, row by
  row as `pair_forward` is, the two scans along y by `max_affine_scan`;
  given `strips`, the scans run strip by strip with the left strip's u
  carried in, as the kernel hands it on.
- `tropical_pair_forward` is the entry: the plain version for CPU
  tensors; for CUDA tensors the hand-written kernel csrc/tropical.cu
  (K3's row step in max-plus, every cell written, the columns in strips
  over many SMs: ops/pairstrips.py); any other device raises.

NEG = -1e30 is the semiring's zero, as in the JAX package: a masked cell
holds exactly NEG, and any cell no path reaches at most about NEG.  Every
max is exact, so the kernel's cells differ from the plain version's and
the JAX package's only in how the scans associate their sums.
`LAUNCHES` counts kernel launches (never the plain version's calls);
`LAST_LAUNCH` holds the last one's shape.
"""

from __future__ import annotations

import torch

from historian_tpu_torch.ops.pairforward import _shift

NEG = -1e30
#: kernel launches made by `tropical_pair_forward` (never by the plain version)
LAUNCHES = 0
#: the last launch: dtype, rows, columns and the strip layout
#: (`StripPlan.describe`)
LAST_LAUNCH: dict = {}


def _tmax(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


def max_affine_scan(a, b):
    """u[j] = max(a[j], u[j-1] + b[j]) along the last axis, u[-1] = -inf:
    the tropical form of ops/pairforward.py `affine_scan`, a Hillis-Steele
    scan of (v, w) pairs with (vl, wl) o (vr, wr) = (max(vr, vl + wr),
    wl + wr), shifted-in lanes the identity (-inf, 0)."""
    n = a.shape[-1]
    v, w = a, b
    d = 1
    while d < n:
        v = torch.maximum(v, _shift(v, d, -torch.inf) + w)
        w = w + _shift(w, d, 0.0)
        d *= 2
    return v


def strip_scan(a, b, width: int):
    """`max_affine_scan` along the last axis by strips of `width` lanes, as
    kernel (f) runs it: each strip scanned from the identity, then the
    left strip's last u carried in, u = max(v, carry + w), w the strip's
    running sum of b."""
    n = a.shape[-1]
    out, carry = [], None
    for s in range(0, n, width):
        v = max_affine_scan(a[..., s:s + width], b[..., s:s + width])
        if carry is not None:
            v = torch.maximum(v, carry[..., None] + torch.cumsum(b[..., s:s + width], dim=-1))
        out.append(v)
        carry = v[..., -1]
    return torch.cat(out, dim=-1)


def tropical_pair_forward_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
                                strips: int = 1):
    """The JAX `tropical_pair_forward` in PyTorch, on the inputs' device
    and dtype: (cells [X+1, Y+1, 5] in IMM, IMD, IDM, IMI, IIW order,
    lp_best, a 0-d tensor).  `strips` cuts the columns into that many
    strips of equal width (the last shorter) for the two scans
    (`strip_scan`)."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    X1, Y1 = absorb.shape
    if strips < 1:
        raise ValueError(f"strips must be positive, got {strips}")
    width = -(-Y1 // strips)
    neg_row = absorb.new_full((Y1,), NEG)
    cols = torch.arange(Y1, device=absorb.device)
    y_ready = (cols < Y1 - 1) | (Y1 == 1)
    p = (neg_row,) * 5
    cells = absorb.new_empty((X1, Y1, 5))
    for i in range(X1):
        imm_p, imd_p, idm_p, imi_p, iiw_p = p
        mask_row = mask[i]
        x_ready = i < X1 - 1 or X1 == 1
        imd = _tmax(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) \
            + rootsub_x[i]
        iiw = _tmax(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = torch.where(y_ready, imd, NEG)
        iiw = torch.where(y_ready, iiw, NEG)
        imm_src = _tmax(imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm, imi_p + imi_imm,
                        iiw_p + iiw_imm)
        imm = _shift(imm_src, 1, NEG) + absorb[i]
        if i == 0:
            imm = torch.where(cols == 0, 0.0, imm)
            imd = iiw = neg_row
        imm = torch.where(mask_row, imm, NEG)
        imd = torch.where(mask_row, imd, NEG)
        iiw = torch.where(mask_row, iiw, NEG)
        gate = mask_row & x_ready
        a_idm = torch.where(gate, _shift(_tmax(imm + imm_idm, imd + imd_idm, iiw + iiw_idm), 1,
                                         NEG) + rootsub_y, NEG)
        idm = strip_scan(a_idm, torch.where(gate, idm_idm + rootsub_y, NEG), width)
        idm = torch.where(gate, idm, NEG)
        a_imi = torch.where(gate, _shift(imm + imm_imi, 1, NEG) + ins_y, NEG)
        imi = strip_scan(a_imi, torch.where(gate, imi_imi + ins_y, NEG), width)
        imi = torch.where(gate, imi, NEG)
        p = (imm, imd, idm, imi, iiw)
        cells[i] = torch.stack(p, dim=-1)
    f = cells[X1 - 1, Y1 - 1]
    lp_best = _tmax(f[0] + imm_eee, f[1] + imd_eee, f[2] + idm_eee, f[3] + imi_eee,
                    f[4] + iiw_eee)
    return cells, lp_best


def _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans) -> None:
    dt = absorb.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the tropical pair DP takes float32 or float64, got {dt}")
    if absorb.dim() != 2:
        raise ValueError(f"absorb must be [X+1, Y+1], got shape {tuple(absorb.shape)}")
    X1, Y1 = absorb.shape
    if X1 < 1 or Y1 < 1:
        raise ValueError(f"empty grid {tuple(absorb.shape)}")
    want = {"rootsub_x": (rootsub_x, (X1,), dt), "rootsub_y": (rootsub_y, (Y1,), dt),
            "ins_x": (ins_x, (X1,), dt), "ins_y": (ins_y, (Y1,), dt),
            "mask": (mask, (X1, Y1), torch.bool), "trans": (trans, (23,), dt)}
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape or t.dtype != tdt or t.device != absorb.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"{shape} {tdt} on {absorb.device}")


def tropical_pair_forward(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, *,
                          lanes: int | None = None, warps: int | None = None,
                          cluster: int | None = None):
    """Kernel (f): (cells [X+1, Y+1, 5], lp_best) of one pair, as the JAX
    package's `tropical_pair_forward` returns them; lp_best is no greater
    than `pair_forward`'s lp_end.  The plain version for CPU tensors; for
    CUDA tensors (float32 or float64, any width) the kernel, its strips
    laid out by ops/pairstrips.py `strip_plan` (`lanes`, `warps` and
    `cluster` force a layout); any other device raises."""
    global LAUNCHES
    _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans)
    dev = absorb.device
    if dev.type == "cpu":
        return tropical_pair_forward_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask,
                                           trans)
    if dev.type != "cuda":
        raise RuntimeError(f"the tropical pair DP has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels, pairstrips

    X1, Y1 = absorb.shape
    plan = pairstrips.card_plan("tropical", absorb.dtype, dev, [(0, Y1)], lanes=lanes,
                                warps=warps, cluster=cluster)
    table, _records = pairstrips.strip_table(plan, X1, absorb.dtype, dev)
    table = torch.from_numpy(table).to(dev)
    args = [t.contiguous() for t in (absorb, rootsub_x, rootsub_y, ins_x, ins_y)]
    mask_b = mask.contiguous().view(torch.uint8)
    cells = torch.empty((X1, Y1, 5), dtype=absorb.dtype, device=dev)
    lp_best = torch.empty(1, dtype=absorb.dtype, device=dev)
    suffix = "f32" if absorb.dtype == torch.float32 else "f64"
    with torch.cuda.device(dev):
        code = getattr(_kernels.lib(), f"tropical_{suffix}")(
            table.data_ptr(), plan.blocks, plan.lanes, plan.warps, plan.cluster,
            *(t.data_ptr() for t in args), mask_b.data_ptr(), trans.contiguous().data_ptr(),
            cells.data_ptr(), lp_best.data_ptr(), X1, Y1,
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "tropical")
    LAUNCHES += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(dtype=str(absorb.dtype)[6:], rows=X1, cols=Y1, **plan.describe())
    return cells, lp_best[0]
