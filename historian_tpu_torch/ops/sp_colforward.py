"""Sequence-parallel (SP) column fill of a chain-x x DAG-y merge, kernel (g1).

Port of historian_tpu/ops/sp_colforward.py::sp_col_forward_cells, the
XLA shard_map kernel that runs K1's recurrence with the x chain sharded
over a device mesh, in the argument layout of K1 (ops/colforward.py):
y_src [SY, KY] int32, y_lp [SY, KY], y_flags [SY, 4], absorb and maskg
[SY, SX], xvec [4, SX], trans [23]; the planes [5, SY, SX] come back.

- `sp_col_forward_planes_plain` is the plain PyTorch version: the JAX
  `_sp_col_kernel` with x padded to a multiple of n and cut into n equal
  shards, held as a batch dimension, each column's five messages passed
  between neighbouring shards (`_shift1` three times, `_global_affine`
  twice: a local scan, then the segment summaries composed across the
  shards as the JAX ring scan composes them).  It equals K1's plain
  version up to reassociation (bit for bit at n = 1).
- `sp_col_forward_planes` is the wrapper: the plain version for CPU
  tensors; for CUDA tensors the kernel csrc/spcolforward.cu, whose
  shards are runs of whole K1 strips (`shard_bounds`) and whose cells
  are bit-equal to K1's for any cut.  A strip block hands its last
  lane's record a column to the next strip through distributed shared
  memory within a thread block cluster of up to 8 strips of a shard,
  through a record in device memory between clusters
  (ops/pairstrips.py's layout at K1's 128 lanes).  `devices` lists a
  device a shard and may repeat one: the strips of one card run in one
  launch on it, checked to be resident at once; between cards, each
  boundary's record buffer lies in the reading card's memory (peer
  access) or in pinned host memory.  `sp_col_forward_shards` takes
  inputs already cut and placed.

`LAUNCHES` counts kernel launches (one a device a fill), never the plain
path; `LAST_LAUNCH` describes the last one.
"""

from __future__ import annotations

import torch

from historian_tpu_torch.ops.colforward import (
    NEG,
    STRIP_WIDTH,
    _check_inputs,
    _affine_scan,
    _check_lanes,
    _lse,
)

#: kernel launches made by the wrapper (never by the plain path)
LAUNCHES = 0
#: the last kernel fill: shards, their devices, lanes and strips, the
#: launches it took, the bytes of its shard boundaries' exchange buffers,
#: their places, and each launch's strip layout (`StripPlan.describe`,
#: with `deep`: every edge also in device memory)
LAST_LAUNCH: dict = {}
#: values a column's exchange record holds (csrc/colforward_step.cuh kRecord)
RECORD = 8
#: shards one device's launch takes (csrc/spcolforward.cu kMaxShards)
MAX_SHARDS_A_DEVICE = 16
#: in-edges at most this many columns back travel on chip between strips
#: (csrc/colforward_step.cuh kHalo)
HALO = 16


def _shift1(v):
    """v [n, x] at the global lane i-1: each shard's first lane takes its
    left neighbour's last lane (the message), shard 0 the boundary NEG."""
    incoming = torch.cat([v.new_full((1,), NEG), v[:-1, -1]])
    return torch.cat([incoming[:, None], v[:, :-1]], dim=1)


def _global_affine(a, b):
    """The affine scan over the whole sharded row [n, x]: each shard scans
    its block from NEG, then the blocks' summaries (last u, sum of b) are
    composed left to right into each shard's carry-in (the JAX ring scan's
    exclusive prefix), and the carry is folded into every lane."""
    u_local = _affine_scan(a, b)
    cumb = torch.clamp_min(torch.cumsum(b, dim=1), NEG)
    incl = _affine_scan(u_local[:, -1][None], cumb[:, -1][None])[0]
    u_in = torch.cat([incl.new_full((1,), NEG), incl[:-1]])
    return _lse(u_local, u_in[:, None] + cumb)


def sp_col_forward_planes_plain(y_src, y_lp, y_flags, absorb, maskg, xvec, trans,
                                n_shards: int):
    """Plain PyTorch version of (g1) over `n_shards` equal shards of x (x
    padded with masked NEG lanes at the end, as the JAX kernel pads it), on
    the inputs' device and dtype.  Returns [5, SY, SX]."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    SY, SX = absorb.shape
    KY = y_src.shape[1]
    n = n_shards
    pad = (-SX) % n
    if pad:
        absorb = torch.cat([absorb, absorb.new_full((SY, pad), NEG)], dim=1)
        maskg = torch.cat([maskg, maskg.new_full((SY, pad), NEG)], dim=1)
        xvec = torch.cat([xvec, xvec.new_full((4, pad), NEG)], dim=1)
    x_loc = (SX + pad) // n
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = trans.tolist()
    rsx, isx, x_gate, x_eos = (v.reshape(n, x_loc) for v in xvec)
    planes = absorb.new_full((5, SY, n, x_loc), NEG)
    src_h, lp_h, flags_h = y_src.tolist(), y_lp.tolist(), y_flags.tolist()
    neg_row = absorb.new_full((n, x_loc), NEG)
    for j in range(SY):
        t5_acc = immn_acc = idm_acc = idmn_acc = imi_acc = imin_acc = neg_row
        for k in range(KY):
            w = lp_h[j][k]
            s_imm, s_imd, s_idm, s_imi, s_iiw = planes[:, src_h[j][k]]
            t5 = _lse(_lse(_lse(s_imm + imm_imm, s_imd + imd_imm),
                           _lse(s_idm + idm_imm, s_imi + imi_imm)),
                      s_iiw + iiw_imm)
            t5_acc = _lse(t5_acc, torch.clamp_min(t5 + w, NEG))
            immn_acc = _lse(immn_acc, torch.clamp_min(s_imm + w, NEG))
            kn_idm = _lse(_lse(s_imm + imm_idm, s_imd + imd_idm),
                          _lse(s_idm + idm_idm, s_iiw + iiw_idm))
            idm_acc = _lse(idm_acc, torch.clamp_min(kn_idm + w, NEG))
            idmn_acc = _lse(idmn_acc, torch.clamp_min(s_idm + w, NEG))
            kn_imi = _lse(s_imm + imm_imi, s_imi + imi_imi)
            imi_acc = _lse(imi_acc, torch.clamp_min(kn_imi + w, NEG))
            imin_acc = _lse(imin_acc, torch.clamp_min(s_imi + w, NEG))
        nul_j, rdy_j, rsy_j, isy_j = flags_h[j]
        mgate = maskg[j].reshape(n, x_loc)
        if nul_j > 0.5:
            imm = torch.clamp_min(immn_acc + x_eos, NEG)
            idm = idmn_acc
            imi = imin_acc
        else:
            imm = _shift1(t5_acc) + absorb[j].reshape(n, x_loc)  # message 1
            idm = torch.clamp_min(idm_acc + rsy_j + x_gate, NEG)
            imi = torch.clamp_min(imi_acc + isy_j + x_gate, NEG)
        if j == 0:
            imm = imm.clone()
            imm[0, 0] = torch.clamp_min(imm[0, 0], 0.0)  # the start cell
        imm = torch.clamp_min(imm + mgate, NEG)
        idm = torch.clamp_min(idm + mgate, NEG)
        imi = torch.clamp_min(imi + mgate, NEG)

        ygate = 0.0 if rdy_j > 0.5 else NEG
        a_imd = _shift1(_lse(_lse(imm + imm_imd, idm + idm_imd), imi + imi_imd))  # message 2
        a_imd = torch.clamp_min(a_imd + rsx + ygate + mgate, NEG)
        b_imd = torch.clamp_min(imd_imd + rsx + mgate, NEG)
        a_iiw = _shift1(_lse(imm + imm_iiw, imi + imi_iiw))  # message 3
        a_iiw = torch.clamp_min(a_iiw + isx + ygate + mgate, NEG)
        b_iiw = torch.clamp_min(iiw_iiw + isx + mgate, NEG)

        planes[0, j] = imm
        planes[1, j] = torch.clamp_min(_global_affine(a_imd, b_imd), NEG)  # message 4
        planes[2, j] = idm
        planes[3, j] = imi
        planes[4, j] = torch.clamp_min(_global_affine(a_iiw, b_iiw), NEG)  # message 5
    return planes.reshape(5, SY, n * x_loc)[:, :, :SX].contiguous()


def shard_bounds(SX: int, n_shards: int) -> list:
    """The kernel's cut of SX lanes into n_shards runs of whole K1 strips,
    as (first lane, end lane) pairs in lane order; a shard that gets no
    strip (more shards than strips) is left out."""
    strips = -(-SX // STRIP_WIDTH)
    cuts = [min(SX, (d * strips // n_shards) * STRIP_WIDTH) for d in range(n_shards + 1)]
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def _record_place(writer: torch.device, reader: torch.device) -> str:
    """Where a boundary's records lie: "device" (one card: the reader's
    memory, device scope), "peer" (the reader's memory, which the writer
    stores into through peer access) or "host" (pinned host memory, where
    the two cards have no peer access)."""
    if writer == reader:
        return "device"
    from historian_tpu_torch.ops import _kernels

    peer = _kernels.lib().spcolforward_peer(writer.index, reader.index)
    if peer < 0:
        raise RuntimeError(f"spcolforward: peer access {writer} -> {reader} failed "
                           f"with CUDA error {-peer}")
    return "peer" if peer else "host"


def _record_buffer(place: str, reader: torch.device, SY: int, dtype) -> tuple:
    """A boundary's record buffer and column counter at `place`
    (`_record_place`); returns (records, counter, system scope), system
    scope wherever the boundary crosses cards."""
    if place == "host":
        return (torch.full((SY, RECORD), NEG, dtype=dtype).pin_memory(),
                torch.zeros(1, dtype=torch.int32).pin_memory(), True)
    return (torch.full((SY, RECORD), NEG, dtype=dtype, device=reader),
            torch.zeros(1, dtype=torch.int32, device=reader), place == "peer")


def deep_edges(y_src) -> bool:
    """Whether some in-edge of y comes from more than the kernel's ring
    (csrc/colforward_step.cuh kHalo columns) back, so that every strip
    edge keeps its records in device memory too."""
    j = torch.arange(y_src.shape[0], device=y_src.device)[:, None]
    back = torch.where(y_src < j, j - y_src, torch.zeros_like(y_src))
    return bool(back.numel()) and int(back.max()) > HALO


def strip_layout(cuts: list, sms: int, capacity, cluster: int | None = None):
    """The kernel's blocks for shards of (first lane, lanes) `cuts` in
    order (one device's): ops/pairstrips.py `strip_plan` at K1's strip,
    1 lane a thread x STRIP_WIDTH / 32 warps, each shard a chain of whole
    strips, in clusters of `cluster` (default: up to 8 strips of a shard);
    `capacity(lanes, warps, cluster)` the blocks resident at once.  Raises
    ValueError where they cannot all be resident."""
    from historian_tpu_torch.ops import pairstrips

    return pairstrips.strip_plan("spcolforward", cuts, sms, capacity, lanes=1,
                                 warps=STRIP_WIDTH // 32, cluster=cluster)


def sp_col_forward_shards(y_src, y_lp, y_flags, trans, lanes, shards: list) -> list:
    """The kernel over shards already cut and placed: `shards` lists, in
    lane order, (absorb [SY, W], maskg [SY, W], xvec [4, W]) on the shard's
    CUDA device, every W a multiple of STRIP_WIDTH but the last.  y_src,
    y_lp, y_flags, trans and lanes (int32 [SY, 3] in the grid's lanes, or
    None: every lane) go to each device.  Each device's strips run in one
    launch, in clusters of ops/pairstrips.py's rule (up to 8 strips of a
    shard), every block resident at once.  Returns each shard's planes
    [5, SY, W] on its device."""
    return _shards(y_src, y_lp, y_flags, trans, lanes, shards, None)


def _shards(y_src, y_lp, y_flags, trans, lanes, shards: list, cluster) -> list:
    """sp_col_forward_shards in clusters of `cluster` strips (None: the
    rule's), the seam by which the card tests and the benches force it."""
    global LAUNCHES
    from historian_tpu_torch.ops import _kernels, pairstrips

    SY = y_flags.shape[0]
    dtype = shards[0][0].dtype
    suffix = "f32" if dtype == torch.float32 else "f64"
    lib = _kernels.lib()
    lane0, cuts = 0, []
    for d, (absorb, maskg, xvec) in enumerate(shards):
        W = absorb.shape[1]
        if absorb.device.type != "cuda":
            raise RuntimeError(f"(g1) has no kernel for device {absorb.device}")
        if W % STRIP_WIDTH and d + 1 < len(shards):
            raise ValueError(f"shard {d} has {W} lanes, not whole strips of {STRIP_WIDTH}")
        cuts.append((lane0, W))
        lane0 += W
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"(g1) takes float32 or float64, got {dtype}")
    if y_src.dtype != torch.int32:
        raise TypeError(f"y_src must be int32, got {y_src.dtype}")
    KY = y_src.shape[1]
    for name, t, shape in (("y_src", y_src, (SY, KY)), ("y_lp", y_lp, (SY, KY)),
                           ("y_flags", y_flags, (SY, 4)), ("trans", trans, (23,))):
        if tuple(t.shape) != shape or (name != "y_src" and t.dtype != dtype):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected {shape}")
    devs = [s[0].device for s in shards]
    outs = []
    for (absorb, maskg, xvec), dev, (_, W) in zip(shards, devs, cuts):
        for name, t, shape in (("absorb", absorb, (SY, W)), ("maskg", maskg, (SY, W)),
                               ("xvec", xvec, (4, W))):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"{name} of a shard on {dev}: {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}, expected {shape} {dtype} contiguous")
        outs.append(torch.full((5, SY, W), NEG, dtype=dtype, device=dev) if lanes is not None
                    else torch.empty((5, SY, W), dtype=dtype, device=dev))
    deep = deep_edges(y_src)
    places = [_record_place(devs[d - 1], devs[d]) for d in range(1, len(shards))]
    edges = [_record_buffer(p, devs[d], SY, dtype) for d, p in enumerate(places, 1)]
    rows, order = {}, []
    for d, ((absorb, maskg, xvec), dev, (l0, W)) in enumerate(zip(shards, devs, cuts)):
        if dev not in rows:
            rows[dev] = []
            order.append(dev)
        rows[dev].append((d, [absorb.data_ptr(), maskg.data_ptr(), xvec.data_ptr(),
                              outs[d].data_ptr(), l0, W]))
    layouts, keep = [], []  # keep: every table and record outlives its launch
    for dev in order:
        if len(rows[dev]) > MAX_SHARDS_A_DEVICE:
            raise ValueError(f"(g1) takes at most {MAX_SHARDS_A_DEVICE} shards a device, "
                             f"not {len(rows[dev])} on {dev}")
        ends = {}
        for j, (d, _) in enumerate(rows[dev]):
            if d > 0:
                ends[(j, "left")] = edges[d - 1]
            if d + 1 < len(shards):
                ends[(j, "right")] = edges[d]
        index = torch.device(dev).index
        index = torch.cuda.current_device() if index is None else index
        plan = strip_layout([cuts[d] for d, _ in rows[dev]],
                            torch.cuda.get_device_properties(index).multi_processor_count,
                            lambda m, w, c: pairstrips.card_capacity("spcolforward", suffix,
                                                                     index, m, w, c), cluster)
        table, records = pairstrips.strip_table(plan, SY, dtype, dev, ends,
                                                cluster_records=deep)
        shard_rows = torch.tensor([r for _, r in rows[dev]], dtype=torch.int64)  # a parameter
        table = torch.from_numpy(table).to(dev)
        keep.append((table, records))
        layouts.append(dict(plan.describe(), deep=deep))
        with torch.cuda.device(dev):
            lanes_d = None if lanes is None else lanes.to(dev)
            if lanes_d is not None:
                _check_lanes(lanes_d, SY, dev)
            args = [t.to(dev).contiguous() for t in (y_src, y_lp, y_flags, trans)]
            keep.append((args, lanes_d))
            code = getattr(lib, f"spcolforward_{suffix}")(
                shard_rows.data_ptr(), len(rows[dev]), table.data_ptr(), plan.blocks,
                plan.cluster, *(t.data_ptr() for t in args),
                0 if lanes_d is None else lanes_d.data_ptr(), SY, KY, STRIP_WIDTH,
                torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(code, "spcolforward")
        LAUNCHES += 1
    if len(order) > 1:
        # the boundaries' buffers are shared between cards, outside any one
        # stream's order: finish every card before they can be freed
        for dev in order:
            torch.cuda.synchronize(dev)
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(
        shards=len(shards), devices=[str(d) for d in devs], cuts=cuts,
        strips=[-(-W // STRIP_WIDTH) for _, W in cuts], launches=len(order), lanes=lanes,
        exchange_bytes=sum(e[0].numel() * e[0].element_size() + 4 for e in edges),
        places=places, system_scope=[bool(e[2]) for e in edges], layouts=layouts)
    return outs


def sp_col_forward_planes(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes=None,
                          devices=None):
    """(g1) over one shard a device of `devices` (a list that may repeat a
    device; default: one shard on absorb's device).  CPU tensors: the plain
    version with len(devices) shards.  CUDA tensors: the kernel, on x cut
    by `shard_bounds`, each shard's inputs copied to its device; the
    planes [5, SY, SX] come back on absorb's device.  lanes: as K1's
    (int32 [SY, 3], or None), ignored by the plain version."""
    return _planes(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes, devices, None)


def _planes(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes, devices, cluster):
    """sp_col_forward_planes with the kernel's strips in clusters of
    `cluster` (None: the rule's; the card tests and the benches force it)."""
    _check_inputs(y_src, y_lp, y_flags, absorb, maskg, xvec, trans)
    dev = absorb.device
    devices = [dev] if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("(g1) needs at least one device")
    if dev.type == "cpu":
        if any(d.type != "cpu" for d in devices):
            raise ValueError(f"CPU inputs with devices {devices}")
        return sp_col_forward_planes_plain(y_src, y_lp, y_flags, absorb, maskg, xvec, trans,
                                           len(devices))
    if dev.type != "cuda" or any(d.type != "cuda" for d in devices):
        raise RuntimeError(f"(g1) has no kernel for device {dev} with shards on {devices}")
    _check_lanes(lanes, absorb.shape[0], dev)
    bounds = shard_bounds(absorb.shape[1], len(devices))
    shards = [tuple(t[..., a:b].contiguous().to(d) for t in (absorb, maskg, xvec))
              for (a, b), d in zip(bounds, devices)]
    outs = _shards(y_src, y_lp, y_flags, trans, lanes, shards, cluster)
    return torch.cat([o.to(dev) for o in outs], dim=2)
