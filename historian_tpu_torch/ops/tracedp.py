"""End gather and trace walk over resident fill planes.

Port of historian_tpu/ops/tracedp.py: `end_lp` is `_end_lp` (plain
PyTorch gathers) and `pair_trace` is `pair_trace_device`, the XLA
while-loop walker, as a hand-written CUDA kernel (csrc/tracedp.cu) with
`pair_trace_plain` beside it.  Candidate semantics are the JAX walker's
exactly:

- y-move rows first (in-edges sorted by source by the bridge, s' inner),
  then the x-move row, i.e. the host's sorted candidate order;
- best traces take the first maximum (strict >);
- sampled traces take the first candidate whose running weight sum
  reaches u * ptot, with weights exp(lp - lpmax);
- the first step leaves the EEE cell through the end in-edges.

Returns pi, pj, ps [T, L] int32 (post-step cells, end->start, -1 after
the start cell), vals [T, L] (cell value per step, NEG after), n_steps
[T] int32 and lp_end (a 0-d tensor).
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


def _pick(cand_lp, u, best):
    """Index per row of cand_lp [T, M]: first max for best rows, else the
    first index whose weight cumsum reaches u * ptot."""
    lpmax = cand_lp.max(dim=1, keepdim=True).values
    w = torch.exp(cand_lp - lpmax)
    p = u * w.sum(dim=1)
    k_samp = torch.argmax((torch.cumsum(w, dim=1) >= p[:, None]).to(torch.int8), dim=1)
    k_best = torch.argmax(cand_lp, dim=1)
    return torch.where(best, k_best, k_samp)


def pair_trace_plain(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp,
                     ye_src, ye_lp, uniforms, is_best, n_steps_max: int):
    """Plain PyTorch walker, vectorized over the T traces."""
    dev, dtype = planes.device, planes.dtype
    T = is_best.shape[0]
    L = n_steps_max
    KY = y_src.shape[1]
    gate = source_gate(dtype, dev)
    sp = torch.arange(5, device=dev)
    rows = torch.arange(T, device=dev)

    # ---- EEE step: the end-transition candidates ----
    KE = ye_src.shape[0]
    e_cell = _cells(planes, ye_src, torch.full_like(ye_src, int(xe_src)))
    e_lp = torch.clamp_min(
        ye_lp[:, None] + t6[:5, EEE][None, :] + xe_lp + e_cell, NEG
    ).reshape(-1)
    e_j = ye_src.long().repeat_interleave(5)
    e_s = sp.repeat(KE)
    k0 = _pick(e_lp[None, :].expand(T, -1), uniforms[:, 0], is_best)
    i = torch.full((T,), int(xe_src), dtype=torch.long, device=dev)
    j = e_j[k0]
    s = e_s[k0]

    pi = torch.full((T, L), -1, dtype=torch.int32, device=dev)
    pj = torch.full_like(pi, -1)
    ps = torch.full_like(pi, -1)
    pi[:, 0], pj[:, 0], ps[:, 0] = i, j, s
    done = (i == 0) & (j == 0)
    n = 0
    while n + 1 < L and not bool(done.all()):
        ys = y_src[j].long()  # [T, KY]
        yl = y_lp[j]
        ynul = y_null[j]
        is_imm = s == IMM
        null_ok = sp[None, :] == torch.where(is_imm, IMM, s)[:, None]  # [T, 5]
        t6_s = t6[:5][:, s].T  # [T, 5]: trans6[s', s]
        txi = tx[i][:, None]
        emit_lp = torch.where(
            is_imm[:, None],
            gate[IMM][None, :] + t6[:5, IMM][None, :] + txi,
            gate[s] + t6_s,
        )
        y_cand_lp = torch.where(
            ynul[:, None, None],
            torch.where(null_ok[:, None, :], yl[:, :, None], NEG),
            yl[:, :, None] + emit_lp[:, None, :],
        )  # [T, KY, 5]
        y_i = torch.where(is_imm & ~ynul, i - 1, i)
        y_cell = _cells(planes, ys, torch.clamp_min(y_i, 0)[:, None].expand(-1, KY))
        y_cand = torch.clamp_min(y_cand_lp + y_cell, NEG)
        y_live = (s == IMM) | (s == IDM) | (s == IMI)
        y_cand = torch.where(y_live[:, None, None], y_cand, NEG)

        x_cand_lp = gate[s] + t6_s + txi
        x_cell = _cells(planes, j, torch.clamp_min(i - 1, 0))  # [T, 5]
        x_cand = torch.clamp_min(x_cand_lp + x_cell, NEG)
        x_live = (s == IMD) | (s == IIW)
        x_cand = torch.where(x_live[:, None], x_cand, NEG)

        cand_lp = torch.cat([y_cand.reshape(T, -1), x_cand], dim=1)
        k = _pick(cand_lp, uniforms[:, n + 1], is_best)
        from_y = k < KY * 5
        ky = torch.clamp_max(k // 5, KY - 1)
        ni = torch.where(from_y, y_i, i - 1)
        nj = torch.where(from_y, ys[rows, ky], j)
        ns = k % 5
        ni = torch.where(done, i, ni)
        nj = torch.where(done, j, nj)
        ns = torch.where(done, s, ns)
        pi[:, n + 1] = torch.where(done, -1, ni).to(torch.int32)
        pj[:, n + 1] = torch.where(done, -1, nj).to(torch.int32)
        ps[:, n + 1] = torch.where(done, -1, ns).to(torch.int32)
        done = done | ((ni == 0) & (nj == 0))
        i, j, s = ni, nj, ns
        n += 1
    n_steps = (pi >= 0).sum(dim=1).to(torch.int32)
    all5 = _cells(planes, torch.clamp_min(pj, 0), torch.clamp_min(pi, 0))  # [T, L, 5]
    vals = all5.gather(-1, torch.clamp_min(ps, 0).long()[..., None])[..., 0]
    vals = torch.where(pi >= 0, vals, NEG)
    lp = end_lp(planes, t6, xe_src, xe_lp, ye_src, ye_lp)
    return pi, pj, ps, vals, n_steps, lp


def _check_inputs(planes, y_src, y_lp, y_null, tx, t6, ye_src, ye_lp,
                  uniforms, is_best, n_steps_max):
    _, SY, SX = planes.shape
    dt, dev = planes.dtype, planes.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"planes must be float32 or float64, got {dt}")
    T = is_best.shape[0]
    KY, KE = y_src.shape[1], ye_src.shape[0]
    want = {
        "planes": (planes, (5, SY, SX), dt), "y_src": (y_src, (SY, KY), torch.int32),
        "y_lp": (y_lp, (SY, KY), dt), "y_null": (y_null, (SY,), torch.bool),
        "tx": (tx, (SX,), dt), "t6": (t6, (6, 6), dt),
        "ye_src": (ye_src, (KE,), torch.int32), "ye_lp": (ye_lp, (KE,), dt),
        "uniforms": (uniforms, (T, n_steps_max), dt), "is_best": (is_best, (T,), torch.bool),
    }
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape or t.dtype != tdt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected {shape} {tdt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if T < 1 or KE < 1 or n_steps_max < 1:
        raise ValueError(f"empty walk: T={T} KE={KE} L={n_steps_max}")


def pair_trace(planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src,
               ye_lp, uniforms, is_best, n_steps_max: int):
    """The walker: the plain version for CPU tensors, the CUDA kernel (one
    warp per trace) for CUDA tensors.  Any other device raises."""
    global LAUNCHES
    _check_inputs(planes, y_src, y_lp, y_null, tx, t6, ye_src, ye_lp,
                  uniforms, is_best, n_steps_max)
    dev = planes.device
    args = (planes, y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src,
            ye_lp, uniforms, is_best, n_steps_max)
    if dev.type == "cpu":
        return pair_trace_plain(*args)
    if dev.type != "cuda":
        raise RuntimeError(f"trace walker has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    _, SY, SX = planes.shape
    T, L = uniforms.shape
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
                  ye_src.shape[0], uniforms.data_ptr(), is_best.data_ptr(), T, L,
                  pi.data_ptr(), pj.data_ptr(), ps.data_ptr(), vals.data_ptr(),
                  n_steps.data_ptr(), stream)
    _kernels.check(code, "pairtrace")
    LAUNCHES += 1
    lp = end_lp(planes, t6, xe_src, xe_lp, ye_src, ye_lp)
    return pi, pj, ps, vals, n_steps, lp
