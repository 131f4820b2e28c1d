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
  computes them, the boundary row passed between stages; given `strips`,
  the row's columns are cut into strips whose scans' carries compose as
  the kernel hands them on (sp_pairforward's `_global_affine`).
- `pp_pair_forward_lp` is the entry: on a mesh of CPU devices the plain
  version; on a mesh of CUDA devices the hand-written kernel
  csrc/pppairforward.cu.  A card's work items, a (stage, pair) each, go
  round-robin in stage order to slots, each slot a chain of strips of the
  row's columns over many SMs (K3's row step under the JAX rules, the
  row's values handed strip to strip through distributed shared memory;
  ops/pairstrips.py `slot_plan`), all resident at once, one launch a
  card.  Strip s of stage k publishes its slice of a pair's last row and
  a flag for (k, p, s), on which strip s of stage k + 1 alone waits.
  Between cards a boundary's rows and flags lie in the reading card's
  memory or in pinned host memory, as kernel (g1)'s records do.  Any
  width runs.  A mesh that mixes device types, holds another process's
  device or another device type raises.

`LAUNCHES` counts kernel launches (one a device a call), never the plain
version's calls; `LAST_LAUNCH` describes the last call.
"""

from __future__ import annotations

import numpy as np
import torch

from historian_tpu_torch.ops.pairforward import _lse, _shift, affine_scan
from historian_tpu_torch.ops.sp_colforward import _record_place
from historian_tpu_torch.ops.sp_pairforward import (
    _axis_devices,
    _global_affine,
    _on_cpu,
    _torch_devices,
)

NEG = -1e30
#: kernel launches (one a device a call; never the plain version's)
LAUNCHES = 0
#: the last kernel call: stages, rows a stage, devices, launches, each
#: card's items and slots and strip layout (`StripPlan.describe`), the
#: boundaries' places and bytes
LAST_LAUNCH: dict = {}


def _stage_rows(X1: int, n: int, k: int) -> tuple:
    """Stage k's real rows [r0, r1) of X1 over n stages (r1 <= r0: none)."""
    xb = -(-X1 // n)
    return k * xb, min((k + 1) * xb, X1)


def pp_pair_forward_lp_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, n_stages: int,
                             strips: int = 1):
    """The JAX `_pp_kernel`'s schedule over `n_stages` stages, on the
    inputs' device and dtype: lp_end [PAIRS].  `strips` cuts the row into
    that many strips of equal width (the last shorter) for the two scans."""
    if n_stages < 1 or strips < 1:
        raise ValueError(f"n_stages and strips must be positive, got {n_stages}, {strips}")
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    PAIRS, X1, Y1 = absorb.shape
    n = n_stages
    width = -(-Y1 // strips)

    def scan(a, b):
        if strips == 1:
            return affine_scan(a, b)
        return _global_affine(a[None], b.expand_as(a)[None], width)[0]

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
                    idm = scan(a, idm_idm + rsy)
                    imi = scan(_shift(imm + imm_imi, 1, NEG) + iy, imi_imi + iy)
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


def _boundary(place: str, reader: torch.device, PAIRS: int, Y1: int, strips: int, dtype) -> tuple:
    """A stage boundary's rows [PAIRS, 5, Y1] and ready counts [PAIRS,
    strips] (a strip's row warps that have written their lanes) at `place`
    (sp_colforward._record_place's): (rows, counts, system scope)."""
    if place == "host":
        return (torch.empty((PAIRS, 5, Y1), dtype=dtype).pin_memory(),
                torch.zeros((PAIRS, strips), dtype=torch.int32).pin_memory(), True)
    return (torch.empty((PAIRS, 5, Y1), dtype=dtype, device=reader),
            torch.zeros((PAIRS, strips), dtype=torch.int32, device=reader), place == "peer")


def _items(stages: list, PAIRS: int) -> np.ndarray:
    """A card's work items [stages * PAIRS, 2] (its stage's index among the
    card's stages, pair), stage by stage: an item's own dependency, the
    same pair on the stage before, comes earlier."""
    return np.array([(k, p) for k in range(len(stages)) for p in range(PAIRS)],
                    dtype=np.int32).reshape(-1, 2)


def _kernel(absorb, rsx, rsy, ix, iy, trans, devices: list, force: dict):
    """Kernel (g3) with the stages on `devices`; `force` (lanes, warps,
    cluster, slots: the card tests and the benches) sets its layout in
    place of `slot_plan`'s rule."""
    global LAUNCHES
    from historian_tpu_torch.ops import _kernels, pairstrips

    PAIRS, X1, Y1 = absorb.shape
    n = len(devices)
    dtype = absorb.dtype
    suffix = "f32" if dtype == torch.float32 else "f64"
    order, stages = [], {}
    for k, dev in enumerate(devices):
        if dev not in stages:
            stages[dev] = []
            order.append(dev)
        stages[dev].append(k)
    # one block shape on every card, so that a boundary's strips are the
    # same on both sides; each card as many slots as it holds
    first = order[0]
    sms = torch.cuda.get_device_properties(first).multi_processor_count

    def capacity(dev):
        index = torch.device(dev).index
        return lambda m, w, c: pairstrips.card_capacity("pppairforward", suffix, index, m, w, c)

    shape = pairstrips.slot_plan(len(stages[first]) * PAIRS, PAIRS, Y1, sms, capacity(first),
                                 **force)
    nstrips = -(-Y1 // shape.width)
    places = [_record_place(devices[k - 1], devices[k]) for k in range(1, n)]
    bounds = [_boundary(p, devices[k], PAIRS, Y1, nstrips, dtype)
              for k, p in enumerate(places, 1)]
    last = devices[-1]
    lp = torch.full((PAIRS,), NEG, dtype=dtype, device=last)
    lib = _kernels.lib()
    layouts, keep = {}, []
    for dev in order:
        rows = []
        for k in stages[dev]:
            left = bounds[k - 1] if k > 0 else None
            right = bounds[k] if k + 1 < n else None
            rows.append([*_stage_rows(X1, n, k),
                         left[0].data_ptr() if left else 0, left[1].data_ptr() if left else 0,
                         right[0].data_ptr() if right else 0,
                         right[1].data_ptr() if right else 0,
                         int(bool((left and left[2]) or (right and right[2]))), 0])
        items = _items(stages[dev], PAIRS)
        plan = pairstrips.slot_plan(
            len(items), PAIRS, Y1, torch.cuda.get_device_properties(dev).multi_processor_count,
            capacity(dev), lanes=shape.lanes, warps=shape.warps, cluster=shape.cluster,
            slots=force.get("slots"))
        slots = plan.strips // nstrips
        item_rows = [max(0, rows[k][1] - rows[k][0]) for k, _ in items]
        # the records between a slot's clusters hold every row of its items
        table, records = pairstrips.strip_table(
            plan, max(sum(item_rows[s::slots]) for s in range(slots)), dtype, dev)
        args = [torch.from_numpy(table).to(dev), torch.tensor(rows, dtype=torch.int64).to(dev),
                torch.from_numpy(items).to(dev)]
        inputs = [t.to(dev).contiguous() for t in (absorb, rsx, rsy, ix, iy, trans)]
        out = lp if dev == last else torch.empty(PAIRS, dtype=dtype, device=dev)
        keep.append((args, records, inputs, out))
        with torch.cuda.device(dev):
            code = getattr(lib, f"pppairforward_{suffix}")(
                args[0].data_ptr(), plan.blocks, plan.lanes, plan.warps, plan.cluster,
                args[1].data_ptr(), args[2].data_ptr(), len(items), slots,
                *(t.data_ptr() for t in inputs), out.data_ptr(), X1, Y1,
                torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(code, "pppairforward")
        LAUNCHES += 1
        layouts[str(dev)] = dict(plan.describe(), items=len(items), slots=slots)
    if len(order) > 1 or any(p != "device" for p in places):
        for dev in order:
            torch.cuda.synchronize(dev)
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(stages=n, rows=[_stage_rows(X1, n, k) for k in range(n)],
                       devices=[str(d) for d in order], launches=len(order), layouts=layouts,
                       places=places,
                       boundary_bytes=sum(b[0].numel() * b[0].element_size() for b in bounds))
    return lp.to(absorb.device)


def pp_pair_forward_lp(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, mesh,
                       axis: str = "pp"):
    """lp_end [PAIRS] of a batch of pairs of one shape (absorb [PAIRS, X+1,
    Y+1], rootsub_x / ins_x [PAIRS, X+1], rootsub_y / ins_y [PAIRS, Y+1],
    trans [23]) with the rows in stages over the devices of `mesh`'s
    `axis`.  A mesh of CPU devices: the plain version; of CUDA devices:
    kernel (g3), laid out by ops/pairstrips.py `slot_plan`."""
    _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans)
    devices = _torch_devices(_axis_devices(mesh, axis)[:, 0])
    if _on_cpu(devices + [absorb.device], "(g3)"):
        return pp_pair_forward_lp_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans,
                                        len(devices))
    return _kernel(absorb, rootsub_x, rootsub_y, ins_x, ins_y, trans, devices, {})
