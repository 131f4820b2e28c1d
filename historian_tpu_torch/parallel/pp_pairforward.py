"""Pipeline-parallel (PP) pair Forward over a mesh, kernel (g3).

Port of historian_tpu/parallel/pp_pairforward.py (`pp_pair_forward_lp`):
the rows of a batch of chain x chain pairs of one shape cut into stages,
one a device of a mesh axis (the port's parallel/mesh.py `Mesh`).  Stage
k owns rows [k xb, (k + 1) xb), xb = ceil((X + 1) / n); rows past X + 1
pass the carry through.  It fills them for each pair from the boundary
row [5, Y + 1] that stage k - 1 handed it, and the last stage gives
lp_end [PAIRS].  No mask.

- `pp_pair_forward_lp_plain` is the plain PyTorch version: the stages and
  the pairs in the JAX schedule's order (pipeline step s runs pair s - k
  on stage k), each stage's rows as ops/pairforward.py `pair_forward`
  computes them, the boundary row passed between stages.
- `pp_pair_forward_lp` is the entry: on a mesh of CPU devices the plain
  version; on a mesh of CUDA devices the hand-written kernel
  csrc/pppairforward.cu, the stages as groups of blocks (K3's block and
  row step under the JAX rules) of one cooperative launch a card, a ready flag for each (stage, pair) so that
  stage k starts pair p only once stage k - 1 has finished it.  Between
  cards a boundary's rows and flags lie in the reading card's memory or in
  pinned host memory, as kernel (g1)'s records do.  A mesh that mixes
  device types, holds another process's device or another device type
  raises.

`LAUNCHES` counts kernel launches (one a device a call), never the plain
version's calls; `LAST_LAUNCH` describes the last call.
"""

from __future__ import annotations

import torch

from historian_tpu_torch.ops.pairforward import ROW_MAX_COLS, _lse, _shift, affine_scan
from historian_tpu_torch.ops.sp_colforward import _record_place
from historian_tpu_torch.ops.sp_pairforward import _axis_devices, _on_cpu, _torch_devices

NEG = -1e30
#: kernel launches (one a device a call; never the plain version's)
LAUNCHES = 0
#: the last kernel call: stages, rows a stage, blocks a stage, devices,
#: launches, the boundaries' places and bytes
LAST_LAUNCH: dict = {}


def _stage_rows(X1: int, n: int, k: int) -> tuple:
    """Stage k's real rows [r0, r1) of X1 over n stages (r1 <= r0: none)."""
    xb = -(-X1 // n)
    return k * xb, min((k + 1) * xb, X1)


def pp_pair_forward_lp_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, n_stages: int):
    """The JAX `_pp_kernel`'s schedule over `n_stages` stages, on the
    inputs' device and dtype: lp_end [PAIRS]."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be positive, got {n_stages}")
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    PAIRS, X1, Y1 = absorb.shape
    n = n_stages
    col = torch.arange(Y1, device=absorb.device)
    y_ready = (col < Y1 - 1) | (Y1 == 1)
    neg_row = absorb.new_full((Y1,), NEG)
    init = (neg_row,) * 5
    lp = absorb.new_full((PAIRS,), NEG)
    incoming = [init] * n  # the boundary row each stage receives this step
    for s in range(PAIRS + n - 1):
        outgoing = [init] * n
        for k in range(n):
            p = s - k
            if not 0 <= p < PAIRS:
                continue
            imm, imd, idm, imi, iiw = init if k == 0 else incoming[k]
            rsy, iy = rootsub_y[p], ins_y[p]
            r0, r1 = _stage_rows(X1, n, k)
            for i in range(r0, r1):
                x_ready = i < X1 - 1 or X1 == 1
                imm_p, imd_p, idm_p, imi_p, iiw_p = imm, imd, idm, imi, iiw
                imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) \
                    + rootsub_x[p, i]
                iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[p, i]
                imd = torch.where(y_ready, imd, NEG)
                iiw = torch.where(y_ready, iiw, NEG)
                imm = _shift(_lse(imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm,
                                  imi_p + imi_imm, iiw_p + iiw_imm), 1, NEG) + absorb[p, i]
                if i == 0:
                    imm = torch.where(col == 0, 0.0, imm)
                    imd = iiw = neg_row
                if x_ready:
                    a = _shift(_lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm), 1, NEG) + rsy
                    idm = affine_scan(a, idm_idm + rsy)
                    imi = affine_scan(_shift(imm + imm_imi, 1, NEG) + iy, imi_imi + iy)
                else:
                    idm = imi = neg_row
            if k == n - 1:
                lp[p] = _lse(imm[-1] + imm_eee, imd[-1] + imd_eee, idm[-1] + idm_eee,
                             imi[-1] + imi_eee, iiw[-1] + iiw_eee)
            else:
                outgoing[k + 1] = (imm, imd, idm, imi, iiw)
        incoming = outgoing
    return lp


def _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans) -> None:
    dt = absorb.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"(g3) takes float32 or float64, got {dt}")
    if absorb.dim() != 3 or min(absorb.shape) < 1:
        raise ValueError(f"absorb must be [PAIRS, X+1, Y+1], got {tuple(absorb.shape)}")
    P, X1, Y1 = absorb.shape
    want = {"rootsub_x": (rootsub_x, (P, X1)), "rootsub_y": (rootsub_y, (P, Y1)),
            "ins_x": (ins_x, (P, X1)), "ins_y": (ins_y, (P, Y1)), "trans": (trans, (23,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != absorb.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"{shape} {dt} on {absorb.device}")
    if Y1 > ROW_MAX_COLS:
        raise ValueError(f"(g3) takes at most {ROW_MAX_COLS} columns (Y + 1), got {Y1}")


def _boundary(place: str, reader: torch.device, PAIRS: int, Y1: int, dtype) -> tuple:
    """A stage boundary's rows [PAIRS, 5, Y1] and ready flags [PAIRS] at
    `place` (sp_colforward._record_place's): (rows, flags, system scope)."""
    if place == "host":
        return (torch.empty((PAIRS, 5, Y1), dtype=dtype).pin_memory(),
                torch.zeros(PAIRS, dtype=torch.int32).pin_memory(), True)
    return (torch.empty((PAIRS, 5, Y1), dtype=dtype, device=reader),
            torch.zeros(PAIRS, dtype=torch.int32, device=reader), place == "peer")


def _kernel(absorb, rsx, rsy, ix, iy, trans, devices: list):
    global LAUNCHES
    from historian_tpu_torch.ops import _kernels

    PAIRS, X1, Y1 = absorb.shape
    n = len(devices)
    dtype = absorb.dtype
    suffix = "f32" if dtype == torch.float32 else "f64"
    places = [_record_place(devices[k - 1], devices[k]) for k in range(1, n)]
    bounds = [_boundary(p, devices[k], PAIRS, Y1, dtype) for k, p in enumerate(places, 1)]
    inputs, rows, order = {}, {}, []
    for k, dev in enumerate(devices):
        if dev not in inputs:
            inputs[dev] = [t.to(dev).contiguous() for t in (absorb, rsx, rsy, ix, iy, trans)]
            rows[dev] = []
            order.append(dev)
        left = bounds[k - 1] if k > 0 else None
        right = bounds[k] if k + 1 < n else None
        rows[dev].append([*_stage_rows(X1, n, k),
                          left[0].data_ptr() if left else 0, left[1].data_ptr() if left else 0,
                          right[0].data_ptr() if right else 0, right[1].data_ptr() if right else 0,
                          int(bool((left and left[2]) or (right and right[2]))), 0])
    last = devices[-1]
    lp = torch.full((PAIRS,), NEG, dtype=dtype, device=last)
    lib = _kernels.lib()
    groups = {}
    for dev in order:
        table = torch.tensor(rows[dev], dtype=torch.int64).to(dev)
        out = lp if dev == last else torch.empty(PAIRS, dtype=dtype, device=dev)
        g = torch.zeros(1, dtype=torch.int32)
        with torch.cuda.device(dev):
            code = getattr(lib, f"pppairforward_{suffix}")(
                table.data_ptr(), len(rows[dev]), *(t.data_ptr() for t in inputs[dev]),
                out.data_ptr(), PAIRS, X1, Y1, g.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(code, "pppairforward")
        groups[str(dev)] = int(g[0])
        LAUNCHES += 1
    if len(order) > 1 or any(p != "device" for p in places):
        for dev in order:
            torch.cuda.synchronize(dev)
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(stages=n, rows=[_stage_rows(X1, n, k) for k in range(n)],
                       groups=groups, devices=[str(d) for d in order], launches=len(order),
                       places=places,
                       boundary_bytes=sum(b[0].numel() * b[0].element_size() for b in bounds))
    return lp.to(absorb.device)


def pp_pair_forward_lp(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, mesh,
                       axis: str = "pp"):
    """lp_end [PAIRS] of a batch of pairs of one shape (absorb [PAIRS, X+1,
    Y+1], rootsub_x / ins_x [PAIRS, X+1], rootsub_y / ins_y [PAIRS, Y+1],
    trans [23]) with the rows in stages over the devices of `mesh`'s
    `axis`.  A mesh of CPU devices: the plain version; of CUDA devices:
    kernel (g3)."""
    _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans)
    devices = _torch_devices(_axis_devices(mesh, axis)[:, 0])
    if _on_cpu(devices + [absorb.device], "(g3)"):
        return pp_pair_forward_lp_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans,
                                        len(devices))
    return _kernel(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, devices)
