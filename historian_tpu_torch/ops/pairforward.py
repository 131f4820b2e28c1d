"""Batched chain x chain pair-Forward (kernels K3 and K4).

Port of historian_tpu/ops/pairforward.py (`emission_tensors`,
`pair_forward`, `pack_transitions`, `chain_pair_forward_arrays`) and of
the Pallas kernels of historian_tpu/ops/pallas_pairforward.py:

- K3 `pallas_pair_forward_lp` -> `pair_forward_lp` (csrc/pairforward.cu
  `pairforward_lp_{f32,f64}`): B pairs of one shape, the 5-state Forward
  over the full [X+1, Y+1] grid of each, returning lp_end [B] only;
- K4 `pallas_pair_forward_lp_tiled` -> `pair_forward_lp_tiled` (the same
  source, `pairforward_lp_tiled_{f32,f64}`): the same lp_end with the
  absorb rows streamed in tiles of `x_tile` rows.

Their inputs: absorb [B, X+1, Y+1] (the match emission of every cell;
row 0 and column 0 are the boundary), rsx/ix [B, X+1] and rsy/iy
[B, Y+1] (the delete and insert emissions of x and y positions) and
trans [23] (`pack_transitions`).  NEG = -1e30 is the finite semiring
zero.  `pair_forward_lp_plain` is their plain PyTorch version: the
TPU kernels' recurrence step for step -- the start row seeded as
`_kernel` seeds it, the y-ready gate, every max(., NEG) clamp, the
Hillis-Steele affine scans, and lp_end read at the corner from IMM, IMD
and IIW only.  The wrappers take it for a CPU tensor and launch the CUDA
kernel for a CUDA tensor.

`pair_forward` is the plain version of the JAX package's `lax.scan`
kernel, with its cells and its envelope mask.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

NEG = -1e30
#: K3 launches made by `pair_forward_lp` (never by the plain path)
LAUNCHES = 0
#: K4 launches made by `pair_forward_lp_tiled` (never by the plain path)
TILED_LAUNCHES = 0
#: the most lanes (Y + 1) a block takes, by dtype: 32 warps (16 in
#: float64) x 32 threads x 8 lanes a thread kept in registers; the
#: launcher picks the block's shape (csrc/pairforward.cu
#: `lanes_per_thread`, read back through `kernel_attrs`)
MAX_LANES = {torch.float32: 8192, torch.float64: 4096}
#: shared memory a K4 block leaves to its transitions and handoff ring
#: (a static_assert in csrc/pairforward.cu)
K4_STATIC_SMEM = 8192


def emission_tensors(x_onehot, y_onehot, sub_l, sub_r, log_root, log_cpt_weight, log_ins_l,
                     log_ins_r):
    """All emission scores as batched einsums (historian_tpu/ops/
    pairforward.py `emission_tensors`): x_onehot [X, A], y_onehot [Y, A]
    (linear space), sub_l/sub_r [C, A, A], log_root [C, A] (log root
    prob + log component weight), log_cpt_weight [C], log_ins_l/r [C, A].
    Returns (absorb [X, Y], rootsub_x [X], rootsub_y [Y], ins_x [X],
    ins_y [Y])."""
    subx = torch.einsum("cad,xd->xca", sub_l, x_onehot)
    suby = torch.einsum("cad,yd->yca", sub_r, y_onehot)
    root = torch.exp(log_root)
    absorb = torch.log(torch.einsum("xca,ca,yca->xy", subx, root, suby) + 1e-300)
    rootsub_x = torch.log(torch.einsum("xca,ca->x", subx, root) + 1e-300)
    rootsub_y = torch.log(torch.einsum("yca,ca->y", suby, root) + 1e-300)
    w_ins_l = torch.exp(log_cpt_weight[:, None] + log_ins_l)
    w_ins_r = torch.exp(log_cpt_weight[:, None] + log_ins_r)
    ins_x = torch.log(torch.einsum("xa,ca->x", x_onehot, w_ins_l) + 1e-300)
    ins_y = torch.log(torch.einsum("ya,ca->y", y_onehot, w_ins_r) + 1e-300)
    return absorb, rootsub_x, rootsub_y, ins_x, ins_y


def pack_transitions(hmm) -> np.ndarray:
    """Flatten an engine.pairhmm.PairHMM into the kernels' [23] layout."""
    return np.array(
        [
            hmm.imm_imm, hmm.imm_imd, hmm.imm_idm, hmm.imm_imi, hmm.imm_iiw, hmm.imm_eee,
            hmm.imd_imm, hmm.imd_imd, hmm.imd_idm, hmm.imd_eee,
            hmm.idm_imm, hmm.idm_imd, hmm.idm_idm, hmm.idm_eee,
            hmm.imi_imm, hmm.imi_imd, hmm.imi_imi, hmm.imi_iiw, hmm.imi_eee,
            hmm.iiw_imm, hmm.iiw_idm, hmm.iiw_iiw, hmm.iiw_eee,
        ]
    )


def chain_pair_forward_arrays(model, x_seq: str, y_seq: str, t_x: float, t_y: float,
                              dtype=torch.float32):
    """Kernel inputs for a leaf sequence pair, on the CPU:
    ((absorb, rsx, rsy, ix, iy, mask, trans), hmm), as
    historian_tpu/ops/pairforward.py `chain_pair_forward_arrays` builds
    them (position 0 of each sequence is the DP boundary)."""
    from historian_tpu_torch.engine.pairhmm import PairHMM
    from historian_tpu_torch.models.ratemodel import ProbModel

    npdt = np.float32 if dtype == torch.float32 else np.float64
    xp = ProbModel(model, t_x)
    yp = ProbModel(model, t_y)
    hmm = PairHMM(xp, yp, model.ins_prob)
    pad = np.zeros((1, model.alphabet_size), dtype=npdt)
    x_onehot = np.concatenate([pad, model.alphabet.one_hot(x_seq, dtype=npdt)])
    y_onehot = np.concatenate([pad, model.alphabet.one_hot(y_seq, dtype=npdt)])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    absorb, rsx, rsy, ix, iy = emission_tensors(
        t(x_onehot), t(y_onehot), t(xp.sub_mat), t(yp.sub_mat), t(hmm.log_root),
        t(np.log(model.cpt_weight)), t(hmm.logl.log_ins_prob), t(hmm.logr.log_ins_prob),
    )
    mask = torch.ones((len(x_seq) + 1, len(y_seq) + 1), dtype=torch.bool)
    return (absorb, rsx, rsy, ix, iy, mask, t(pack_transitions(hmm))), hmm


def _lse(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.logaddexp(out, x)
    return out


def _shift(v, d, fill):
    """v moved d lanes right along the last axis; the first d lanes take `fill`."""
    n = v.shape[-1]
    head = v.new_full(v.shape[:-1] + (min(d, n),), fill)
    return torch.cat([head, v[..., : n - d]], dim=-1) if d < n else head


def affine_scan(a, b, floor=None):
    """u[j] = lse(a[j], u[j-1] + b[j]) along the last axis: a
    Hillis-Steele scan over affine pairs (v, w) with the composition
    (vl, wl) o (vr, wr) = (lse(vr, vl + wr), wl + wr).

    With no `floor` this is ops/semiring.py's `affine_scan` (u[-1] = -inf,
    shifted-in lanes the identity (-inf, 0)).  With a floor it is the TPU
    kernels' `_affine_scan_row`: max(1, ceil(log2 n)) steps, shifted-in
    lanes (floor, 0) and w clamped below at the floor."""
    n = a.shape[-1]
    v, w = a, b
    steps = max(1, math.ceil(math.log2(n))) if floor is not None else math.ceil(math.log2(n))
    fill = -math.inf if floor is None else floor
    for k in range(steps):
        d = 1 << k
        v_s, w_s = _shift(v, d, fill), _shift(w, d, 0.0)
        v = torch.logaddexp(v, v_s + w)
        w = w + w_s if floor is None else torch.clamp_min(w + w_s, floor)
    return v


def pair_forward(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans):
    """Plain version of historian_tpu/ops/pairforward.py `pair_forward`
    (one pair): returns (cells [X+1, Y+1, 5] in IMM, IMD, IDM, IMI, IIW
    order, lp_end)."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    X1, Y1 = absorb.shape
    neg_row = absorb.new_full((Y1,), NEG)
    cols = torch.arange(Y1, device=absorb.device)
    y_ready = (cols < Y1 - 1) | (Y1 == 1)
    x_empty = X1 == 1
    imm_p = imd_p = idm_p = imi_p = iiw_p = neg_row
    rows = []
    for i in range(X1):
        mask_row = mask[i]
        x_ready = (i < X1 - 1) or x_empty
        imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) + rootsub_x[i]
        iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = torch.where(y_ready, imd, NEG)
        iiw = torch.where(y_ready, iiw, NEG)
        imm_src = _lse(imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm, imi_p + imi_imm,
                       iiw_p + iiw_imm)
        imm = _shift(imm_src, 1, NEG) + absorb[i]
        if i == 0:
            imm = torch.where(cols == 0, 0.0, imm)
            imd = iiw = neg_row
        imm = torch.where(mask_row, imm, NEG)
        imd = torch.where(mask_row, imd, NEG)
        iiw = torch.where(mask_row, iiw, NEG)
        gate = mask_row & x_ready
        a_idm = torch.where(gate, _shift(_lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm), 1, NEG)
                            + rootsub_y, NEG)
        idm = torch.where(gate, affine_scan(a_idm, torch.where(gate, idm_idm + rootsub_y, NEG)), NEG)
        a_imi = torch.where(gate, _shift(imm + imm_imi, 1, NEG) + ins_y, NEG)
        imi = torch.where(gate, affine_scan(a_imi, torch.where(gate, imi_imi + ins_y, NEG)), NEG)
        imm_p, imd_p, idm_p, imi_p, iiw_p = imm, imd, idm, imi, iiw
        rows.append(torch.stack([imm, imd, idm, imi, iiw], dim=-1))
    cells = torch.stack(rows)
    f = cells[X1 - 1, Y1 - 1]
    lp_end = _lse(f[0] + imm_eee, f[1] + imd_eee, f[2] + idm_eee, f[3] + imi_eee, f[4] + iiw_eee)
    return cells, lp_end


def pair_forward_lp_plain(absorb, rsx, rsy, ix, iy, trans):
    """Plain PyTorch version of K3 and K4: lp_end [B] of B pairs of one
    shape, on the inputs' device and dtype."""
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    B, X1, Y1 = absorb.shape
    cols = torch.arange(Y1, device=absorb.device)
    y_ready = cols < Y1 - 1
    neg_row = absorb.new_full((B, Y1), NEG)
    rsx_c, ix_c = torch.clamp_min(rsx, NEG), torch.clamp_min(ix, NEG)

    def y_scans(imm, imd, iiw):
        idm_other = _lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)
        idm = affine_scan(_shift(idm_other, 1, NEG) + rsy, idm_idm + rsy, NEG)
        imi = affine_scan(_shift(imm + imm_imi, 1, NEG) + iy, imi_imi + iy, NEG)
        return idm, imi

    # the start row: IMM 1 at the start cell, its IDM/IMI scans seeded
    # from it (pallas_pairforward.py:80-83)
    imm = torch.where(cols == 0, 0.0, neg_row)
    imd = iiw = neg_row
    idm = affine_scan(_shift(imm + imm_idm, 1, NEG) + rsy, idm_idm + rsy, NEG)
    imi = affine_scan(_shift(imm + imm_imi, 1, NEG) + iy, imi_imi + iy, NEG)
    for i in range(1, X1):
        imm_p, imd_p, idm_p, imi_p, iiw_p = imm, imd, idm, imi, iiw
        imd = _lse(_lse(imm_p + imm_imd, imd_p + imd_imd),
                   _lse(idm_p + idm_imd, imi_p + imi_imd)) + rsx_c[:, i, None]
        iiw = _lse(_lse(imm_p + imm_iiw, imi_p + imi_iiw), iiw_p + iiw_iiw) + ix_c[:, i, None]
        imd = torch.where(y_ready, imd, NEG)
        iiw = torch.where(y_ready, iiw, NEG)
        imm_src = _lse(_lse(_lse(imm_p + imm_imm, imd_p + imd_imm),
                            _lse(idm_p + idm_imm, imi_p + imi_imm)), iiw_p + iiw_imm)
        imm = _shift(imm_src, 1, NEG) + absorb[:, i]
        idm, imi = y_scans(imm, imd, iiw)
    # the last row's y-absorbing states are blocked (x waits): the corner
    # is read from IMM, IMD and IIW only
    return _lse(_lse(imm[:, -1] + imm_eee, imd[:, -1] + imd_eee), iiw[:, -1] + iiw_eee)


def _check_inputs(what, absorb, rsx, rsy, ix, iy, trans):
    dt = absorb.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {dt}")
    if absorb.dim() != 3:
        raise ValueError(f"absorb must be [B, X+1, Y+1], got shape {tuple(absorb.shape)}")
    B, X1, Y1 = absorb.shape
    if B < 1 or X1 < 1 or Y1 < 1:
        raise ValueError(f"empty batch or grid {tuple(absorb.shape)}")
    want = {"absorb": (absorb, (B, X1, Y1)), "rsx": (rsx, (B, X1)), "rsy": (rsy, (B, Y1)),
            "ix": (ix, (B, X1)), "iy": (iy, (B, Y1)), "trans": (trans, (23,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != absorb.device:
            raise ValueError(f"{name} is on {t.device}, absorb on {absorb.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, absorb is {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if Y1 > MAX_LANES[dt]:
        raise ValueError(f"{what} takes at most {MAX_LANES[dt]} lanes (Y + 1) in {dt}, got {Y1}")


def kernel_attrs(y1: int, dtype, tiled: bool) -> dict:
    """The compiled K3 (K4 with `tiled`) instance that takes y1 lanes:
    lanes a thread, warps a block, registers and local (spill) bytes a
    thread, static shared bytes.  Builds the kernels; needs CUDA."""
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    fn = lib.pairforward_attrs_f32 if dtype == torch.float32 else lib.pairforward_attrs_f64
    out = (ctypes.c_int * 5)()
    _kernels.check(fn(int(tiled), y1, out), "pairforward_attrs")
    return dict(zip(("lanes_per_thread", "warps", "registers", "local_bytes", "static_smem"),
                    out))


def _launch(fn, absorb, rsx, rsy, ix, iy, trans, *extra):
    B, X1, Y1 = absorb.shape
    out = torch.empty(B, dtype=absorb.dtype, device=absorb.device)
    with torch.cuda.device(absorb.device):
        stream = torch.cuda.current_stream(absorb.device).cuda_stream
        code = fn(absorb.data_ptr(), rsx.data_ptr(), rsy.data_ptr(), ix.data_ptr(),
                  iy.data_ptr(), trans.data_ptr(), out.data_ptr(), B, X1, Y1, *extra, stream)
    return out, code


def pair_forward_lp(absorb, rsx, rsy, ix, iy, trans):
    """K3: lp_end [B].  The plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (float32 or float64).  Any other device raises."""
    global LAUNCHES
    _check_inputs("K3", absorb, rsx, rsy, ix, iy, trans)
    dev = absorb.device
    if dev.type == "cpu":
        return pair_forward_lp_plain(absorb, rsx, rsy, ix, iy, trans)
    if dev.type != "cuda":
        raise RuntimeError(f"K3 has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    fn = lib.pairforward_lp_f32 if absorb.dtype == torch.float32 else lib.pairforward_lp_f64
    out, code = _launch(fn, absorb, rsx, rsy, ix, iy, trans)
    _kernels.check(code, "pairforward_lp")
    LAUNCHES += 1
    return out


def k4_rows(y1: int, itemsize: int, x_tile: int, smem_bytes: int) -> int:
    """The rows of a K4 tile: `x_tile`, clamped to the rows whose two
    absorb slabs (double buffering) fit a block's shared memory."""
    fit = (smem_bytes - K4_STATIC_SMEM) // (2 * y1 * itemsize)
    if fit < 1:
        raise ValueError(f"K4: one row of {y1} lanes does not fit twice in "
                         f"{smem_bytes - K4_STATIC_SMEM} bytes of shared memory")
    return min(x_tile, fit)


def pair_forward_lp_tiled(absorb, rsx, rsy, ix, iy, trans, x_tile: int = 512):
    """K4: lp_end [B] with X streamed in tiles of `x_tile` rows (clamped to
    what fits shared memory twice).  The plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.  Any other device raises."""
    global TILED_LAUNCHES
    _check_inputs("K4", absorb, rsx, rsy, ix, iy, trans)
    if x_tile < 1:
        raise ValueError(f"x_tile must be positive, got {x_tile}")
    dev = absorb.device
    if dev.type == "cpu":
        return pair_forward_lp_plain(absorb, rsx, rsy, ix, iy, trans)
    if dev.type != "cuda":
        raise RuntimeError(f"K4 has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    rows = k4_rows(absorb.shape[2], absorb.element_size(), x_tile, smem)
    lib = _kernels.lib()
    fn = lib.pairforward_lp_tiled_f32 if absorb.dtype == torch.float32 \
        else lib.pairforward_lp_tiled_f64
    out, code = _launch(fn, absorb, rsx, rsy, ix, iy, trans, rows)
    _kernels.check(code, "pairforward_lp_tiled")
    TILED_LAUNCHES += 1
    return out
