"""Sequence-parallel (SP) pair Forward over a mesh, kernel (g2).

Port of historian_tpu/ops/sp_pairforward.py (`sp_pair_forward`,
`sp_pair_forward_batch`): ops/pairforward.py `pair_forward`'s recurrence
over a chain x chain pair with the Y columns cut into one shard a device
of a mesh axis (the port's parallel/mesh.py `Mesh`); Y + 1 is padded to a
multiple of the shards with masked columns, and lp_end comes from the
shard that holds column Y.

- `sp_pair_forward_plain` is the plain PyTorch version: the shards held
  as a batch dimension, the three shifted values passed from each shard
  to the next (`sp_colforward._shift1`) and each scan's carry composed
  across the shards from the shards' summaries (`_global_affine`), as the
  JAX ring scan composes them; given `strips`, each shard's columns are
  cut into strips whose carries compose in the same way, as the kernel
  hands them on.
- `sp_pair_forward` / `sp_pair_forward_batch` are the entries: on a mesh
  of CPU devices the plain version (a pair at a time for the batch, whose
  pairs the `dp` axis only distributes); on a mesh of CUDA devices the
  hand-written kernel csrc/sppairforward.cu: each shard of a pair cut
  into strips over many SMs (ops/pairstrips.py), each a block of K3's row
  step under the JAX rules, each row's five boundary values passed from
  strip to strip in order in place of the ring scan (the same function
  up to round-off).  The mesh may repeat a device: the blocks of one card
  are one launch, checked to be resident at once (a batch too large for
  that in waves of pairs, a launch each); between cards each
  shard boundary's records lie where kernel (g1)'s do
  (`sp_colforward._record_place`, `_record_buffer`).  A mesh that mixes
  device types, holds another process's device or another device type
  raises.

`LAUNCHES` counts kernel launches (one a device a wave), never the plain
version's calls; `LAST_LAUNCH` describes the last call.
"""

from __future__ import annotations

import numpy as np
import torch

from historian_tpu_torch.ops.pairforward import _lse, affine_scan
from historian_tpu_torch.ops.sp_colforward import _record_buffer, _record_place, _shift1

NEG = -1e30
#: kernel launches (one a device a wave; never the plain version's)
LAUNCHES = 0
#: the last kernel call: pairs, shards a pair and their columns, devices,
#: launches, the pairs of each wave, blocks, the shard boundaries' places,
#: record bytes and each launch's strip layout (`StripPlan.describe`)
LAST_LAUNCH: dict = {}


def _global_affine(a, b, width: int):
    """u[j] = lse(a[j], u[j-1] + b[j]) over the whole sharded row [n, y],
    each shard's columns in strips of `width`: each strip scans its block
    from -inf, then the carry into a strip is the strips before it (shard
    by shard, in order) composed left to right from NEG (the JAX ring
    scan's exclusive prefix), and it is folded into every lane."""
    starts = range(0, a.shape[1], width)
    u_local = [affine_scan(a[:, s:s + width], b[:, s:s + width]) for s in starts]
    cumb = [torch.cumsum(b[:, s:s + width], dim=1) for s in starts]
    carry, into = u_local[0].new_full((), NEG), [[] for _ in starts]
    for d in range(a.shape[0]):
        for p in range(len(u_local)):
            into[p].append(carry)
            carry = torch.logaddexp(u_local[p][d, -1], carry + cumb[p][d, -1])
    return torch.cat([torch.logaddexp(u, torch.stack(c)[:, None] + w)
                      for u, c, w in zip(u_local, into, cumb)], dim=1)


def sp_pair_forward_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
                          n_shards: int, strips: int = 1):
    """The JAX `_sp_kernel` over `n_shards` shards of Y + 1 (padded with
    masked NEG columns), on the inputs' device and dtype: lp_end, a 0-d
    tensor.  `strips` cuts each shard into that many strips of equal width
    (the last shorter) for the two scans (`_global_affine`)."""
    if n_shards < 1 or strips < 1:
        raise ValueError(f"n_shards and strips must be positive, got {n_shards}, {strips}")
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, imm_eee,
     imd_imm, imd_imd, imd_idm, imd_eee,
     idm_imm, idm_imd, idm_idm, idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, iiw_eee) = trans.tolist()
    X1, Y1 = absorb.shape
    n = n_shards
    pad = (-Y1) % n
    if pad:
        absorb = torch.cat([absorb, absorb.new_full((X1, pad), NEG)], dim=1)
        rootsub_y = torch.cat([rootsub_y, rootsub_y.new_full((pad,), NEG)])
        ins_y = torch.cat([ins_y, ins_y.new_full((pad,), NEG)])
        mask = torch.cat([mask, mask.new_zeros((X1, pad))], dim=1)
    y_loc = (Y1 + pad) // n
    width = -(-y_loc // strips)
    col = torch.arange(n * y_loc, device=absorb.device).reshape(n, y_loc)
    y_ready = (col < Y1 - 1) | (Y1 == 1)
    rsy, iy = rootsub_y.reshape(n, y_loc), ins_y.reshape(n, y_loc)
    neg_row = absorb.new_full((n, y_loc), NEG)
    imm = imd = idm = imi = iiw = neg_row
    for i in range(X1):
        mask_row = mask[i].reshape(n, y_loc)
        x_ready = i < X1 - 1 or X1 == 1
        imm_p, imd_p, idm_p, imi_p, iiw_p = imm, imd, idm, imi, iiw
        imd = _lse(imm_p + imm_imd, imd_p + imd_imd, idm_p + idm_imd, imi_p + imi_imd) \
            + rootsub_x[i]
        iiw = _lse(imm_p + imm_iiw, imi_p + imi_iiw, iiw_p + iiw_iiw) + ins_x[i]
        imd = torch.where(y_ready, imd, NEG)
        iiw = torch.where(y_ready, iiw, NEG)
        imm_src = _lse(imm_p + imm_imm, imd_p + imd_imm, idm_p + idm_imm, imi_p + imi_imm,
                       iiw_p + iiw_imm)
        imm = _shift1(imm_src) + absorb[i].reshape(n, y_loc)
        if i == 0:
            imm = torch.where(col == 0, 0.0, imm)
            imd = iiw = neg_row
        imm = torch.where(mask_row, imm, NEG)
        imd = torch.where(mask_row, imd, NEG)
        iiw = torch.where(mask_row, iiw, NEG)
        gate = mask_row & x_ready
        a_idm = _shift1(_lse(imm + imm_idm, imd + imd_idm, iiw + iiw_idm)) + rsy
        idm = _global_affine(torch.where(gate, a_idm, NEG),
                             torch.where(gate, idm_idm + rsy, NEG), width)
        idm = torch.where(gate, idm, NEG)
        a_imi = _shift1(imm + imm_imi) + iy
        imi = _global_affine(torch.where(gate, a_imi, NEG),
                             torch.where(gate, imi_imi + iy, NEG), width)
        imi = torch.where(gate, imi, NEG)
    lp = _lse(imm + imm_eee, imd + imd_eee, idm + idm_eee, imi + imi_eee, iiw + iiw_eee)
    return lp.reshape(-1)[Y1 - 1]


def _axis_devices(mesh, axis: str) -> np.ndarray:
    """The mesh's devices with `axis` first, as an array [n, rest]."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {mesh.axis_names})")
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return devs.reshape(devs.shape[0], -1)


def _torch_devices(mesh_devices) -> list:
    """The torch devices of MeshDevices; each must be this process's."""
    out = []
    for d in mesh_devices:
        if not d.is_local:
            raise ValueError(f"(g2) runs on this process's devices; the mesh holds device "
                             f"{d.index} of process {d.process}")
        out.append(d.device)
    return out


def _on_cpu(devices: list, what: str) -> bool:
    """True for a mesh of CPU devices, False for one of CUDA devices; a
    mixed mesh or another device type raises."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise RuntimeError(f"{what} has no kernel for a mesh of {sorted(kinds)} devices")


def _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, batched: bool) -> None:
    dt = absorb.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"(g2) takes float32 or float64, got {dt}")
    if absorb.dim() != (3 if batched else 2):
        raise ValueError(f"absorb has shape {tuple(absorb.shape)}")
    lead = tuple(absorb.shape[:1]) if batched else ()
    X1, Y1 = absorb.shape[-2:]
    if X1 < 1 or Y1 < 1:
        raise ValueError(f"empty grid {tuple(absorb.shape)}")
    want = {"rootsub_x": (rootsub_x, lead + (X1,), dt),
            "rootsub_y": (rootsub_y, lead + (Y1,), dt),
            "ins_x": (ins_x, lead + (X1,), dt), "ins_y": (ins_y, lead + (Y1,), dt),
            "mask": (mask, (X1, Y1), torch.bool), "trans": (trans, (23,), dt)}
    for name, (t, shape, tdt) in want.items():
        if tuple(t.shape) != shape or t.dtype != tdt or t.device != absorb.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"{shape} {tdt} on {absorb.device}")


def _kernel(absorb, rsx, rsy, ix, iy, mask, trans, placement: list, force: dict):
    """Kernel (g2) on B pairs [B, X1, Y1] (mask [X1, Y1] shared), pair b's
    shards on the CUDA devices placement[b] (n each), each device's shards
    cut into strips (ops/pairstrips.py `strip_plan`; `force` its lanes,
    warps, cluster): lp_end [B] on absorb's device.  The pairs go in waves
    (`pairstrips.strip_waves`), one launch a device each, every wave's
    blocks resident at once on every card; the waves are the same on every
    card, so that a wave waits only on itself and the waves before it."""
    global LAUNCHES
    from historian_tpu_torch.ops import _kernels, pairstrips

    B, X1, Y1 = absorb.shape
    n = len(placement[0])
    y_loc = -(-Y1 // n)
    shards = -(-Y1 // y_loc)  # those holding a real column; the rest hold padding only
    dtype = absorb.dtype
    suffix = "f32" if dtype == torch.float32 else "f64"
    inputs, outs, chains, order = {}, {}, {}, []
    places, edges = [], []
    for b, devs in enumerate(placement):
        for d in range(shards):
            dev = devs[d]
            if dev not in inputs:
                inputs[dev] = [t.to(dev).contiguous() for t in (absorb, rsx, rsy, ix, iy)] + [
                    mask.to(dev).contiguous().view(torch.uint8), trans.to(dev).contiguous()]
                outs[dev] = torch.full((B,), NEG, dtype=dtype, device=dev)
                chains[dev] = [[] for _ in range(B)]
                order.append(dev)
        bounds = []
        for d in range(1, shards):
            place = _record_place(devs[d - 1], devs[d])
            bounds.append(_record_buffer(place, devs[d], X1, dtype))
            places.append(place)
        edges += bounds
        for d in range(shards):
            chains[devs[d]][b].append((d * y_loc, min(y_loc, Y1 - d * y_loc),
                                       bounds[d - 1] if d > 0 else None,
                                       bounds[d] if d + 1 < shards else None))
    # the waves: every card's cuts, so each wave is resident on every card
    cuts = {B}
    for dev in order:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        index = torch.device(dev).index
        cap = (lambda m, w, c, index=index: pairstrips.card_capacity(
            "sppairforward", suffix, index, m, w, c))
        held = [b for b in range(B) if chains[dev][b]]
        groups = [[(c0, nc) for c0, nc, _, _ in chains[dev][b]] for b in held]
        cuts.update(held[e - 1] + 1 for _, e in pairstrips.strip_waves(
            "sppairforward", groups, sms, cap, **force))
    cuts = sorted(cuts)
    lib = _kernels.lib()
    layouts, keep, waves = [], [], []  # keep: every table and record outlives its launch
    for w0, w1 in zip([0] + cuts[:-1], cuts):
        waves.append(w1 - w0)
        for dev in order:
            runs, ends = [], {}
            for b in range(w0, w1):
                for c0, nc, left, right in chains[dev][b]:
                    if left is not None:
                        ends[(len(runs), "left")] = left
                    if right is not None:
                        ends[(len(runs), "right")] = right
                    runs.append((b, c0, nc))
            if not runs:
                continue
            plan = pairstrips.card_plan("sppairforward", dtype, dev,
                                        [(c0, nc) for _, c0, nc in runs], **force)
            table, records = pairstrips.strip_table(plan, X1, dtype, dev, ends)
            # a strip's chain in the table is its pair
            live = plan.chain >= 0
            table[live, 0] = np.asarray([b for b, _, _ in runs])[plan.chain[live]]
            table = torch.from_numpy(table).to(dev)
            keep.append((table, records))
            layouts.append(plan.describe())
            with torch.cuda.device(dev):
                code = getattr(lib, f"sppairforward_{suffix}")(
                    table.data_ptr(), plan.blocks, plan.lanes, plan.warps, plan.cluster,
                    *(t.data_ptr() for t in inputs[dev]), outs[dev].data_ptr(), X1, Y1,
                    torch.cuda.current_stream(dev).cuda_stream)
            _kernels.check(code, "sppairforward")
            LAUNCHES += 1
    if len(order) > 1 or any(p != "device" for p in places):
        # the boundaries' buffers lie outside any one stream's order: finish
        # every card before they can be freed
        for dev in order:
            torch.cuda.synchronize(dev)
    lp = torch.stack([outs[devs[shards - 1]][b].to(absorb.device)
                      for b, devs in enumerate(placement)])
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(pairs=B, shards=n, cols=[min(y_loc, Y1 - d * y_loc) for d in range(shards)],
                       devices=[str(d) for d in order], launches=len(layouts), waves=waves,
                       blocks=[lay["blocks"] for lay in layouts], places=places,
                       record_bytes=sum(e[0].numel() * e[0].element_size() for e in edges),
                       layouts=layouts)
    return lp


def sp_pair_forward(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, mesh,
                    axis: str = "sp", *, lanes: int | None = None, warps: int | None = None,
                    cluster: int | None = None):
    """lp_end (a 0-d tensor) of one pair with its Y + 1 columns over the
    devices of `mesh`'s `axis`, args as ops/pairforward.py
    `pair_forward`'s.  A mesh of CPU devices: the plain version with one
    shard a device; of CUDA devices: kernel (g2), the inputs on any of
    them (`lanes`, `warps` and `cluster` force its strip layout)."""
    _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, False)
    devices = _torch_devices(_axis_devices(mesh, axis)[:, 0])
    if _on_cpu(devices + [absorb.device], "(g2)"):
        return sp_pair_forward_plain(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans,
                                     len(devices))
    return _kernel(absorb[None], rootsub_x[None], rootsub_y[None], ins_x[None], ins_y[None],
                   mask, trans, [devices], dict(lanes=lanes, warps=warps, cluster=cluster))[0]


def sp_pair_forward_batch(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, mesh,
                          dp_axis: str = "dp", sp_axis: str = "sp"):
    """lp_end [B] of B pairs (absorb [B, X+1, Y+1], rootsub_x / ins_x [B,
    X+1], rootsub_y / ins_y [B, Y+1]; mask and trans shared): the batch in
    B / dp contiguous parts over `dp_axis`, each pair's columns over the
    `sp_axis` devices of its part, as the JAX `shard_map` lays them out.
    CPU devices: the plain version a pair at a time; CUDA devices: kernel
    (g2), the pairs in waves that can each be resident at once, one launch
    a device a wave."""
    _check(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, True)
    if dp_axis not in mesh.axis_names or sp_axis not in mesh.axis_names:
        raise ValueError(f"the mesh's axes are {mesh.axis_names}, not {dp_axis!r} and "
                         f"{sp_axis!r}")
    grid = np.moveaxis(mesh.devices, (mesh.axis_names.index(dp_axis),
                                      mesh.axis_names.index(sp_axis)), (0, 1))
    grid = grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]
    n_dp = grid.shape[0]
    B = absorb.shape[0]
    if B % n_dp:
        raise ValueError(f"a batch of {B} pairs does not divide over {n_dp} dp devices")
    placement = [_torch_devices(grid[b // (B // n_dp)]) for b in range(B)]
    if _on_cpu([d for p in placement for d in p] + [absorb.device], "(g2)"):
        return torch.stack([sp_pair_forward_plain(absorb[b], rootsub_x[b], rootsub_y[b],
                                                  ins_x[b], ins_y[b], mask, trans,
                                                  grid.shape[1]) for b in range(B)])
    return _kernel(absorb, rootsub_x, rootsub_y, ins_x, ins_y, mask, trans, placement, {})
