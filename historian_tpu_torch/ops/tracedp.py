"""End gather and trace walk over resident fill planes.

Port of historian_tpu/ops/tracedp.py: `end_lp` is `_end_lp` (plain
PyTorch gathers) and `pair_trace` is `pair_trace_device`, the XLA
while-loop walker, as a hand-written CUDA kernel (csrc/tracedp.cu) with
`pair_trace_plain` beside it.  Candidate semantics are the JAX walker's
exactly:

- y-move rows first (in-edges sorted by source by the bridge, s' inner),
  then the x-move row, i.e. the host's sorted candidate order;
- best traces take the first maximum (strict >);
- the first step leaves the EEE cell through the end in-edges.

Sampled traces follow the host's walk instead (DPMatrix.sample_cell,
ForwardMatrix.sample_trace), so that they take the run's mt19937 draws
one for one: weights exp(lp - lpmax), ptot summed in candidate order, p
= u * ptot, then p -= w_k in order, the first candidate of positive
weight with p <= 0 wins.  A walk draws once a step, the EEE step
included, so it takes n_steps draws; the sampled walks run one after
another over one 1-D draw buffer, each from where the one before
stopped.

Returns pi, pj, ps [T, L] int32 (post-step cells, end->start, -1 after
the start cell; the best walk first), vals [T, L] (cell value per step,
NEG after), n_steps [T] int32 and lp_end (a 0-d tensor).
"""

from __future__ import annotations

import torch

NEG = -1e30
IMM, IMD, IDM, IMI, IIW, EEE = 0, 1, 2, 3, 4, 5
#: kernel launches made by `pair_trace` (never by the plain path)
LAUNCHES = 0


def source_gate(dtype, device) -> torch.Tensor:
    """[dest, src] additive gate (0 / NEG) of PairHMM.sources."""
    g = torch.full((5, 5), NEG, dtype=dtype, device=device)
    g[IMM, [IMM, IMD, IDM, IMI, IIW]] = 0.0
    g[IMD, [IMM, IMD, IDM, IMI]] = 0.0
    g[IDM, [IMM, IMD, IDM, IIW]] = 0.0
    g[IMI, [IMM, IMI]] = 0.0
    g[IIW, [IMM, IIW, IMI]] = 0.0
    return g


def _cells(planes, jj, ii):
    """planes[:, jj, ii] as [..., 5]."""
    SX = planes.shape[2]
    flat = (jj * SX + ii).long()
    return planes.reshape(5, -1)[:, flat].movedim(0, -1)


def end_lp(planes, t6, xe_src, xe_lp, ye_src, ye_lp):
    """lp_end as the host gathers it: per end-edge pair a left-to-right
    5-way logaddexp of cell + trans, plus the edge lps, chained in ye
    order from -inf."""
    e_cell = _cells(planes, ye_src, torch.full_like(ye_src, int(xe_src)))  # [KE, 5]
    row = e_cell[:, 0] + t6[0, EEE]
    for q in (1, 2, 3, 4):
        row = torch.logaddexp(row, e_cell[:, q] + t6[q, EEE])
    row = row + xe_lp + ye_lp
    out = torch.full((), float("-inf"), dtype=planes.dtype, device=planes.device)
    for v in row:
        out = torch.logaddexp(out, v)
    return out


def sampled_index(w, u) -> int:
    """The host's sampled pick (DPMatrix.sample_cell) over the weights w
    of one step, in candidate order, in w's own precision: ptot summed
    left to right, p = u * ptot, then p -= w_k in that order; the first
    k with w_k > 0 and p <= 0 wins.  A zero weight never wins (where p
    stays above 0 by rounding, the last positive weight does)."""
    zero = w.dtype.type(0)
    ptot = zero
    for x in w:
        ptot = ptot + x
    p = w.dtype.type(u) * ptot
    last = 0
    for k, x in enumerate(w):
        p = p - x
        if x > zero:
            if p <= zero:
                return k
            last = k
    return last


def _pick(cand_lp, u):
    """Index into cand_lp [M]: the first maximum for a best walk (u None),
    else the host's sampled pick with the weights exp(lp - lpmax)."""
    if u is None:
        return int(torch.argmax(cand_lp))
    w = torch.exp(cand_lp - cand_lp.max())
    return sampled_index(w.cpu().numpy(), u)


def _walk_plain(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src, ye_lp,
                u, L: int):
    """One walk from the end cell to (0, 0): best when u is None, else
    sampled with draw n of the step after n steps from u (host floats).
    Returns (pi, pj, ps) lists of the post-step cells, end->start."""
    dev, dtype = planes.device, planes.dtype
    gate = source_gate(dtype, dev)
    KY = y_src.shape[1]

    # ---- EEE step: the end-transition candidates ----
    e_cell = _cells(planes, ye_src, torch.full_like(ye_src, int(xe_src)))
    e_lp = torch.clamp_min(
        ye_lp[:, None] + t6[:5, EEE][None, :] + xe_lp + e_cell, NEG
    ).reshape(-1)
    k = _pick(e_lp, None if u is None else u[0])
    i, j, s = int(xe_src), int(ye_src[k // 5]), k % 5
    path = [(i, j, s)]
    while len(path) < L and not (i == 0 and j == 0):
        ys = y_src[j].long()
        ynul = bool(y_null[j])
        txi = tx[i]
        t6_s = t6[:5, s]  # trans6[s', s]
        if s in (IMM, IDM, IMI):  # y-moves live
            if ynul:
                sp = IMM if s == IMM else s
                y_cand_lp = torch.full((KY, 5), NEG, dtype=dtype, device=dev)
                y_cand_lp[:, sp] = y_lp[j]
            elif s == IMM:
                y_cand_lp = y_lp[j][:, None] + (gate[IMM] + t6[:5, IMM] + txi)[None, :]
            else:
                y_cand_lp = y_lp[j][:, None] + (gate[s] + t6_s)[None, :]
            y_i = i - 1 if (s == IMM and not ynul) else i
            y_cell = planes[:, ys, max(y_i, 0)].T  # [KY, 5]
            y_cand = torch.clamp_min(y_cand_lp + y_cell, NEG).reshape(-1)
            x_cand = torch.full((5,), NEG, dtype=dtype, device=dev)
        else:  # x-moves live
            y_i = i
            y_cand = torch.full((KY * 5,), NEG, dtype=dtype, device=dev)
            x_cand = torch.clamp_min(gate[s] + t6_s + txi + planes[:, j, max(i - 1, 0)], NEG)
        k = _pick(torch.cat([y_cand, x_cand]), None if u is None else u[len(path)])
        if k < KY * 5:
            i, j = y_i, int(ys[k // 5])
        else:
            i = i - 1
        s = k % 5
        path.append((i, j, s))
    return path


def pair_trace_plain(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp,
                     ye_src, ye_lp, uniforms, include_best: bool, n_samples: int,
                     n_steps_max: int):
    """Plain PyTorch walker: the best walk, then the sampled walks in order,
    walk t reading its draws from where walk t - 1 stopped."""
    dev, dtype = planes.device, planes.dtype
    L = n_steps_max
    u_host = uniforms.cpu().numpy()
    paths, off = [], 0
    if include_best:
        paths.append(_walk_plain(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp,
                                 ye_src, ye_lp, None, L))
    for _ in range(n_samples):
        path = _walk_plain(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp,
                           ye_src, ye_lp, u_host[off:], L)
        off += len(path)
        paths.append(path)
    T = len(paths)
    cells = torch.full((T, L, 3), -1, dtype=torch.int32)
    for t, path in enumerate(paths):
        cells[t, : len(path)] = torch.tensor(path, dtype=torch.int32)
    cells = cells.to(dev)
    pi, pj, ps = (cells[..., q].contiguous() for q in range(3))
    n_steps = (pi >= 0).sum(dim=1).to(torch.int32)
    all5 = _cells(planes, torch.clamp_min(pj, 0), torch.clamp_min(pi, 0))  # [T, L, 5]
    vals = all5.gather(-1, torch.clamp_min(ps, 0).long()[..., None])[..., 0]
    vals = torch.where(pi >= 0, vals, NEG)
    lp = end_lp(planes, t6, xe_src, xe_lp, ye_src, ye_lp)
    return pi, pj, ps, vals, n_steps, lp


def _check_inputs(planes, y_src, y_lp, y_null, tx, t6, ye_src, ye_lp,
                  uniforms, include_best, n_samples, n_steps_max):
    _, SY, SX = planes.shape
    dt, dev = planes.dtype, planes.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"planes must be float32 or float64, got {dt}")
    KY, KE = y_src.shape[1], ye_src.shape[0]
    want = {
        "planes": (planes, (5, SY, SX), dt), "y_src": (y_src, (SY, KY), torch.int32),
        "y_lp": (y_lp, (SY, KY), dt), "y_null": (y_null, (SY,), torch.bool),
        "tx": (tx, (SX,), dt), "t6": (t6, (6, 6), dt),
        "ye_src": (ye_src, (KE,), torch.int32), "ye_lp": (ye_lp, (KE,), dt),
        "uniforms": (uniforms, tuple(uniforms.shape[:1]), dt),
    }
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape or t.dtype != tdt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected {shape} {tdt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if n_samples < 0 or int(include_best) + n_samples < 1 or KE < 1 or n_steps_max < 1:
        raise ValueError(f"empty walk: best={include_best} samples={n_samples} KE={KE} "
                         f"L={n_steps_max}")
    if uniforms.shape[0] < n_samples * n_steps_max:
        raise ValueError(f"uniforms: {uniforms.shape[0]} draws, the sampled walks may "
                         f"take {n_samples} x {n_steps_max}")


def pair_trace(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src,
               ye_lp, uniforms, include_best: bool, n_samples: int, n_steps_max: int):
    """The walker: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (the best walk in one block, the sampled walks one after
    another in a second, each from where the one before stopped in the
    1-D draw buffer `uniforms`).  Any other device raises."""
    global LAUNCHES
    _check_inputs(planes, y_src, y_lp, y_null, tx, t6, ye_src, ye_lp,
                  uniforms, include_best, n_samples, n_steps_max)
    dev = planes.device
    args = (planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src,
            ye_lp, uniforms, include_best, n_samples, n_steps_max)
    if dev.type == "cpu":
        return pair_trace_plain(*args)
    if dev.type != "cuda":
        raise RuntimeError(f"trace walker has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    _, SY, SX = planes.shape
    n_best = int(bool(include_best))
    T, L = n_best + n_samples, n_steps_max
    xe = torch.as_tensor(xe_lp, dtype=planes.dtype, device=dev).reshape(1)
    pi = torch.empty((T, L), dtype=torch.int32, device=dev)
    pj = torch.empty_like(pi)
    ps = torch.empty_like(pi)
    vals = torch.empty((T, L), dtype=planes.dtype, device=dev)
    n_steps = torch.empty((T,), dtype=torch.int32, device=dev)
    fn = _kernels.lib().pairtrace_f32 if planes.dtype == torch.float32 \
        else _kernels.lib().pairtrace_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(planes.data_ptr(), SY, SX, y_src.data_ptr(), y_lp.data_ptr(),
                  y_src.shape[1], y_null.data_ptr(), tx.data_ptr(), t6.data_ptr(),
                  int(xe_src), xe.data_ptr(), ye_src.data_ptr(), ye_lp.data_ptr(),
                  ye_src.shape[0], uniforms.data_ptr(), n_best, T, L,
                  pi.data_ptr(), pj.data_ptr(), ps.data_ptr(), vals.data_ptr(),
                  n_steps.data_ptr(), stream)
    _kernels.check(code, "pairtrace")
    LAUNCHES += 1
    lp = end_lp(planes, t6, xe_src, xe_lp, ye_src, ye_lp)
    return pi, pj, ps, vals, n_steps, lp
