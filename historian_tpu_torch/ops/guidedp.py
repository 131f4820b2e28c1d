"""Guide alignment of a batch of pairs: banded Viterbi fill, best end cell
and traceback (the guide kernel).

Port of historian_tpu/ops/guidedp.py::guide_align_device, which the TPU
ran as XLA (a vmapped column scan plus a while_loop), with the outputs of
that function.  Inputs, padded to the longest pair of the batch:

- x_tok [B, PX], y_tok [B, PY] int32 tokens (-1 for wildcards and pads)
- lut [B, PX + PY + 1] bool: diagonal d = i - j is in the envelope at
  lut[b, d + PY]
- x_len, y_len [B] int32 (every pair non-empty)
- submat [A, A] substitution log-odds, trans [10] (m2m, m2i, m2d, i2i,
  i2m, i2d, d2d, d2m, -, -)
- sg [P + 1], P = max(PX, PY): startGapScore(pos) for pos = 0..P
- end_x [B, PX + 1], end_y [B, PY + 1]: the end-gap scores per position

all built on the host as the JAX package's host route builds them
(historian_tpu/engine/quickalign.py), so the device only adds them.
Returns (steps [B, PX + PY] int8 -- 0 M, 1 I, 2 D, 3 pad, end to start --,
n_steps, x_end, y_end, lead_i, lead_j [B] int32, score [B]).

`guide_align_plain` is the plain version: the torch fill of
ops/pairdp.py over the whole padded batch at once, then the host's
end-cell argmax and traceback on each pair's planes copied back (historian_tpu/engine/quickalign.py `_finish` and
`align_path`: candidates M, I, D, Start, strict > keeps the first
maximum).  `guide_align` is the wrapper: the plain version for CPU
tensors, the CUDA kernel (csrc/guidealign.cu) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from historian_tpu_torch.ops.pairdp import banded_viterbi_fill

STEP_M, STEP_I, STEP_D, STEP_S = 0, 1, 2, 3
#: kernel launches made by `guide_align` (never by the plain path)
LAUNCHES = 0


def _walk(mat, ins, dele, emit, sg, trans, x_end: int, y_end: int):
    """The host traceback from (x_end, y_end) in state M over [X+1, Y+1]
    planes: step codes end to start, and the (i, j) where Start won."""
    m2m, m2i, m2d, i2i, i2m, i2d, d2d, d2m = trans[:8]
    i, j, state = x_end, y_end, STEP_M
    steps: list[int] = []
    limit = mat.shape[0] + mat.shape[1] - 2
    while state != STEP_S and len(steps) < limit and i >= 1 and j >= 1:
        steps.append(state)
        if state == STEP_M:
            e = emit[i, j]
            i -= 1
            j -= 1
            cands = (mat[i, j] + m2m + e, ins[i, j] + i2m + e,
                     dele[i, j] + d2m + e, sg[i + 1] + sg[j + 1] + e)
        elif state == STEP_I:
            j -= 1
            cands = (mat[i, j] + m2i, ins[i, j] + i2i)
        else:
            i -= 1
            cands = (mat[i, j] + m2d, ins[i, j] + i2d, dele[i, j] + d2d)
        best, state = cands[0], 0
        for k in range(1, len(cands)):
            if cands[k] > best:
                best, state = cands[k], k
    return steps, i, j


def guide_align_plain(x_tok, y_tok, lut, x_len, y_len, submat, trans, sg, end_x, end_y):
    """Plain PyTorch version of the guide kernel on the inputs' device and
    dtype (the walk runs on the host)."""
    B, PX = x_tok.shape
    PY = y_tok.shape[1]
    dev, dtype = submat.device, submat.dtype
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    trans_h = [np_dt(v) for v in trans.cpu().numpy()]
    sg_h = sg.cpu().numpy()
    steps = torch.full((B, PX + PY), STEP_S, dtype=torch.int8)
    ints = torch.zeros((5, B), dtype=torch.int32)  # n_steps, x_end, y_end, lead_i, lead_j
    score = torch.zeros(B, dtype=dtype)
    # the batch padded to [B, PX + 1, PY + 1]; cells past a pair's size
    # are out of its mask
    xt, yt = x_tok.long(), y_tok.long()
    emit = torch.zeros((B, PX + 1, PY + 1), dtype=dtype, device=dev)
    valid = (xt >= 0)[:, :, None] & (yt >= 0)[:, None, :]
    sub = submat[xt.clamp_min(0)[:, :, None], yt.clamp_min(0)[:, None, :]]
    emit[:, 1:, 1:] = torch.where(valid, sub, torch.zeros((), dtype=dtype, device=dev))
    ii = torch.arange(PX + 1, device=dev)[:, None]
    jj = torch.arange(PY + 1, device=dev)[None, :]
    mask = lut[:, ii - jj + PY] & (ii >= 1) & (jj >= 1)
    mask &= (ii <= x_len[:, None, None]) & (jj <= y_len[:, None, None])
    start_gap = sg[: PX + 1, None] + sg[None, : PY + 1]
    planes = banded_viterbi_fill(emit, mask, start_gap.expand(B, -1, -1), trans)
    for b in range(B):
        X, Y = int(x_len[b]), int(y_len[b])
        mat, ins, dele = (p[b, : Y + 1, : X + 1].T.cpu().numpy() for p in planes)
        end_gap = end_x[b, : X + 1, None].cpu().numpy() + end_y[b, None, : Y + 1].cpu().numpy()
        grid = (mat + end_gap)[1:, 1:].T  # [Y, X]: flat order is (j, i)
        best_j, best_i = divmod(int(np.argmax(grid)), X)
        score[b] = float(grid[best_j, best_i])
        path, li, lj = _walk(mat, ins, dele, emit[b, : X + 1, : Y + 1].cpu().numpy(), sg_h,
                             trans_h, best_i + 1, best_j + 1)
        steps[b, : len(path)] = torch.tensor(path, dtype=torch.int8)
        ints[:, b] = torch.tensor([len(path), best_i + 1, best_j + 1, li, lj], dtype=torch.int32)
    out = (steps, *ints, score)
    return tuple(t.to(dev) for t in out)


def _check_inputs(x_tok, y_tok, lut, x_len, y_len, submat, trans, sg, end_x, end_y):
    dt = submat.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the guide kernel takes float32 or float64, got {dt}")
    B, PX = x_tok.shape
    PY = y_tok.shape[1]
    A = submat.shape[0]
    want = {
        "x_tok": (x_tok, (B, PX), torch.int32), "y_tok": (y_tok, (B, PY), torch.int32),
        "lut": (lut, (B, PX + PY + 1), torch.bool), "x_len": (x_len, (B,), torch.int32),
        "y_len": (y_len, (B,), torch.int32), "submat": (submat, (A, A), dt),
        "trans": (trans, (10,), dt), "sg": (sg, (max(PX, PY) + 1,), dt),
        "end_x": (end_x, (B, PX + 1), dt), "end_y": (end_y, (B, PY + 1), dt),
    }
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != tdt:
            raise TypeError(f"{name} is {t.dtype}, expected {tdt}")
        if t.device != submat.device:
            raise ValueError(f"{name} is on {t.device}, submat on {submat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if B < 1 or bool((x_len < 1).any()) or bool((y_len < 1).any()):
        raise ValueError("the guide kernel takes a non-empty batch of non-empty pairs")
    if bool((x_len > PX).any()) or bool((y_len > PY).any()):
        raise ValueError("a pair is longer than its padded row")


def _chunks(cells: list[int], budget: int) -> list[tuple[int, int]]:
    """Consecutive [lo, hi) ranges of pairs whose back-pointer bytes fit
    the budget; a pair that cannot fit alone raises."""
    out, lo, acc = [], 0, 0
    for b, c in enumerate(cells):
        if c > budget:
            raise MemoryError(f"guide pair {b} needs {c / 1e9:.2f} GB of back-pointers, "
                              f"{budget / 1e9:.2f} GB available")
        if acc + c > budget:
            out.append((lo, b))
            lo, acc = b, 0
        acc += c
    out.append((lo, len(cells)))
    return out


def guide_align(x_tok, y_tok, lut, x_len, y_len, submat, trans, sg, end_x, end_y):
    """The guide kernel: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (float32 or float64).  Any other device
    raises."""
    global LAUNCHES
    _check_inputs(x_tok, y_tok, lut, x_len, y_len, submat, trans, sg, end_x, end_y)
    dev = submat.device
    if dev.type == "cpu":
        return guide_align_plain(x_tok, y_tok, lut, x_len, y_len, submat, trans, sg, end_x, end_y)
    if dev.type != "cuda":
        raise RuntimeError(f"the guide kernel has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    B, PX = x_tok.shape
    PY = y_tok.shape[1]
    dtype = submat.dtype
    cells = ((x_len.long() + 1) * (y_len.long() + 1)).tolist()
    free, _ = torch.cuda.mem_get_info(dev)
    steps = torch.full((B, PX + PY), STEP_S, dtype=torch.int8, device=dev)
    ints = torch.zeros((5, B), dtype=torch.int32, device=dev)
    score = torch.zeros(B, dtype=dtype, device=dev)
    fn = _kernels.lib().guidealign_f32 if dtype == torch.float32 else _kernels.lib().guidealign_f64
    for lo, hi in _chunks(cells, free // 2):
        off = torch.tensor(np.concatenate([[0], np.cumsum(cells[lo:hi])[:-1]]),
                           dtype=torch.int64, device=dev)
        bp = torch.empty(sum(cells[lo:hi]), dtype=torch.uint8, device=dev)
        col = torch.empty((hi - lo, 6, PX + 1), dtype=dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(x_tok[lo].data_ptr(), y_tok[lo].data_ptr(), lut[lo].data_ptr(),
                      x_len[lo].data_ptr(), y_len[lo].data_ptr(), submat.data_ptr(),
                      submat.shape[0], trans.data_ptr(), sg.data_ptr(),
                      end_x[lo].data_ptr(), end_y[lo].data_ptr(), PX, PY,
                      bp.data_ptr(), off.data_ptr(), col.data_ptr(),
                      steps[lo].data_ptr(), ints[0, lo:].data_ptr(), ints[1, lo:].data_ptr(),
                      ints[2, lo:].data_ptr(), ints[3, lo:].data_ptr(), ints[4, lo:].data_ptr(),
                      score[lo].data_ptr(), hi - lo, stream)
        _kernels.check(code, "guidealign")
        LAUNCHES += 1
    return (steps, *ints, score)
