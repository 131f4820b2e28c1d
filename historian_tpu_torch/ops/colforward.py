"""Column-major Forward fill of a chain-x x DAG-y merge (kernel K1).

Port of historian_tpu/ops/pallas_colforward.py::pallas_col_forward_cells
(the Pallas kernel on the `recon` main path) with the argument layout of
that kernel:

- y_src [SY, KY] int32, y_lp [SY, KY]: y in-edges (pads: lp = NEG)
- y_flags [SY, 4]: null, ready, rootsub_y, ins_y per y column
- absorb [SY, SX]: match emission, NEG outside the band
- maskg [SY, SX]: 0 inside the band, NEG outside
- xvec [4, SX]: rootsub_x, ins_x, x_gate, x_eos (gates 0/NEG)
- trans [23]: packed pair-HMM transitions

and returns the planes [5, SY, SX] in IMM, IMD, IDM, IMI, IIW order.
NEG = -1e30 is the finite semiring zero.

`col_forward_planes_plain` is the plain PyTorch recurrence (one vector
step per y column, IMD/IIW as Hillis-Steele affine log-sum-exp scans
over x).  `col_forward_planes` is the wrapper: the plain version for a
CPU tensor, the CUDA kernel (csrc/colforward.cu) for a CUDA tensor.

Kernel K2, `col_forward_planes_fused`, ports
historian_tpu/ops/pallas_colforward.py::pallas_col_forward_cells_fused:
the same fill, with the emission log(ey @ ex_t) + shifts and the band
mask built inside the kernel (csrc/colforward_fused.cu) from O(L)
vectors, in that kernel's layout (see `col_forward_planes_fused_plain`).
Its plain version builds `absorb` and `maskg` with `emission_planes`,
as the K1 route of ops/devicedp.py does, then runs K1's plain version.

Both kernels cut the x lanes into strips of NS lanes, one block a strip,
launched cooperatively (csrc/colforward_step.cuh).  A strip with no band
lane in a column skips it: `band_lanes` gives each column's band lanes
from the envelope's vectors, `lanes_from_mask` from a mask, and
`strip_activity` which strips hold any.  The wrapper fills the output
with NEG first, which is what a full sweep writes there, bit for bit.
"""

from __future__ import annotations

import functools

import torch

NEG = -1e30
#: kernel launches made by `col_forward_planes` (never by the plain path)
LAUNCHES = 0
#: K2 launches made by `col_forward_planes_fused` (never by the plain path)
FUSED_LAUNCHES = 0
#: the largest emission width CA that K2 takes
FUSED_MAX_CA = 256
#: the strip width NS of K1 and K2 (csrc/colforward.cu kNS), in both
#: dtypes: the fastest of 64-512 lanes at long12's shape (PERF.md)
STRIP_WIDTH = 128
#: K2's strip width where a [CA, STRIP_WIDTH] slice of ex_t does not fit
#: shared memory
NARROW_STRIP_WIDTH = 64
#: the last launch of K1 or K2: kernel, strips, their width ns, SX and the
#: lanes it was given (None: every lane); `active_share` reads it
LAST_LAUNCH: dict = {}
#: per device, the `band_lanes` calls whose m1 was not non-decreasing (full
#: columns given), kept on the device so that the check costs no
#: synchronize; `nonmonotone_m1` reads them
_NONMONOTONE: dict = {}


def _lse(a, b):
    return torch.logaddexp(a, b)


def _shift1(v):
    """v at lane i-1; lane 0 reads the boundary NEG."""
    return torch.cat([v.new_full((1,), NEG), v[:-1]])


def _affine_scan(a, b):
    """u[..., i] = lse(a[..., i], u[..., i-1] + b[..., i]), u[..., -1] =
    NEG, along the last dimension: Hillis-Steele over affine pairs, the
    Pallas kernel's `_affine_scan_lanes`."""
    n = a.shape[-1]
    v, w = a, b
    d = 1
    while d < n:
        v_s = torch.cat([v.new_full(v.shape[:-1] + (d,), NEG), v[..., :-d]], dim=-1)
        w_s = torch.cat([w.new_zeros(w.shape[:-1] + (d,)), w[..., :-d]], dim=-1)
        v = _lse(v, v_s + w)
        w = torch.clamp_min(w + w_s, NEG)
        d *= 2
    return v


def col_forward_planes_plain(y_src, y_lp, y_flags, absorb, maskg, xvec, trans):
    """Plain PyTorch version of K1 on the inputs' device and dtype."""
    SY, SX = absorb.shape
    KY = y_src.shape[1]
    (imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw, _imm_eee,
     imd_imm, imd_imd, imd_idm, _imd_eee,
     idm_imm, idm_imd, idm_idm, _idm_eee,
     imi_imm, imi_imd, imi_imi, imi_iiw, _imi_eee,
     iiw_imm, iiw_idm, iiw_iiw, _iiw_eee) = trans.tolist()
    rsx, isx, x_gate, x_eos = xvec
    planes = absorb.new_full((5, SY, SX), NEG)
    src_h = y_src.tolist()
    lp_h = y_lp.tolist()
    flags_h = y_flags.tolist()
    neg_row = absorb.new_full((SX,), NEG)
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
        is_null = nul_j > 0.5
        mgate = maskg[j]

        if is_null:
            imm = torch.clamp_min(immn_acc + x_eos, NEG)
            idm = idmn_acc
            imi = imin_acc
        else:
            imm = _shift1(t5_acc) + absorb[j]
            idm = torch.clamp_min(idm_acc + rsy_j + x_gate, NEG)
            imi = torch.clamp_min(imi_acc + isy_j + x_gate, NEG)
        if j == 0:
            imm = imm.clone()
            imm[0] = torch.clamp_min(imm[0], 0.0)  # the start cell
        imm = torch.clamp_min(imm + mgate, NEG)
        idm = torch.clamp_min(idm + mgate, NEG)
        imi = torch.clamp_min(imi + mgate, NEG)

        ygate = 0.0 if rdy_j > 0.5 else NEG
        a_imd = _shift1(_lse(_lse(imm + imm_imd, idm + idm_imd), imi + imi_imd))
        a_imd = torch.clamp_min(a_imd + rsx + ygate + mgate, NEG)
        b_imd = torch.clamp_min(imd_imd + rsx + mgate, NEG)
        a_iiw = _shift1(_lse(imm + imm_iiw, imi + imi_iiw))
        a_iiw = torch.clamp_min(a_iiw + isx + ygate + mgate, NEG)
        b_iiw = torch.clamp_min(iiw_iiw + isx + mgate, NEG)

        planes[0, j] = imm
        planes[1, j] = _affine_scan(a_imd, b_imd)
        planes[2, j] = idm
        planes[3, j] = imi
        planes[4, j] = _affine_scan(a_iiw, b_iiw)
    return planes


def _first_lane(m1, m2, bound, strict: bool):
    """Per column j, the first lane i with m1[i] - m2[j] >= bound (> bound
    when strict), the difference taken in m1's dtype as the kernels take
    it.  m1 is non-decreasing, so the test is monotone in i: a bisection
    of all columns at once."""
    SX = m1.shape[0]
    lo = torch.zeros(m2.shape[0], dtype=torch.long, device=m1.device)
    hi = torch.full_like(lo, SX)
    for _ in range(SX.bit_length()):
        mid = (lo + hi) // 2
        d = m1[mid.clamp(max=SX - 1)] - m2
        right = ((d <= bound) if strict else (d < bound)) & (mid < hi)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def band_lanes(m1, m2, dist, x_near_start, y_near_end, ny=None, x_in_range=None):
    """The lanes of each column that can hold a band cell, as int32 [SY, 3]:
    (head, lo, hi), every in-band lane of column j in [0, head) or
    [lo, hi).  The band is |m2[j] - m1[i]| <= dist or x_near_start[i] or
    y_near_end[j], and x_in_range[i] and j < ny where given (K2's test).

    head is one past the last x_near_start lane; [lo, hi) holds the lanes
    with -dist <= m1[i] - m2[j] <= dist, found by bisection since m1 is
    non-decreasing along a chain x; a y_near_end column is full.  Where
    m1 is not non-decreasing every column is full (counted in
    `nonmonotone_m1`).  Columns j >= ny are empty; every interval is cut
    to the hull of x_in_range."""
    SX, SY = m1.shape[0], m2.shape[0]
    dev = m1.device
    lane = torch.arange(SX, device=dev)
    bound = torch.as_tensor(dist, dtype=m1.dtype, device=dev)
    nonmonotone = (m1[1:] < m1[:-1]).any()
    _NONMONOTONE[dev] = _NONMONOTONE.get(dev, 0) + nonmonotone.long()
    full = nonmonotone | y_near_end
    lo = torch.where(full, 0, _first_lane(m1, m2, -bound, strict=False))
    hi = torch.where(full, SX, _first_lane(m1, m2, bound, strict=True))
    head = torch.where(x_near_start, lane + 1, 0).max().expand(SY)
    if x_in_range is not None:
        first = torch.where(x_in_range, lane, SX).min()
        last = torch.where(x_in_range, lane + 1, 0).max()
        lo = torch.maximum(lo, first)
        hi = torch.minimum(hi, last)
        head = torch.minimum(head, last)
    if ny is not None:
        row = torch.arange(SY, device=dev) < ny
        head = torch.where(row, head, 0)
        lo = torch.where(row, lo, 0)
        hi = torch.where(row, hi, 0)
    return torch.stack([head, lo, hi], 1).to(torch.int32)


def nonmonotone_m1() -> int:
    """The `band_lanes` calls so far whose m1 was not non-decreasing."""
    return sum(int(n) for n in _NONMONOTONE.values())


def lanes_from_mask(mask):
    """`band_lanes`' layout for a band mask [SY, SX]: each column's hull of
    mask lanes as [lo, hi), no head; an empty column gives (0, 0, 0)."""
    SX = mask.shape[1]
    lane = torch.arange(SX, device=mask.device)
    hi = torch.where(mask, lane + 1, 0).max(1).values
    lo = torch.where(mask, lane, SX).min(1).values
    lo = torch.where(hi > 0, lo, 0)
    return torch.stack([torch.zeros_like(lo), lo, hi], 1).to(torch.int32)


def strip_activity(lanes, SX: int, ns: int):
    """bool [SY, strips]: which strips of ns lanes hold a lane of `lanes`
    in each column, the kernels' own test (colforward_step.cuh)."""
    a = torch.arange(0, SX, ns, device=lanes.device)
    b = torch.clamp(a + ns, max=SX)
    head, lo, hi = (lanes[:, k, None].long() for k in range(3))
    return (a < head) | ((lo < hi) & (a < hi) & (lo < b))


def _check_lanes(lanes, SY: int, device) -> None:
    if lanes is None:
        return
    if lanes.dtype != torch.int32:
        raise TypeError(f"lanes must be int32, got {lanes.dtype}")
    if tuple(lanes.shape) != (SY, 3):
        raise ValueError(f"lanes has shape {tuple(lanes.shape)}, expected {(SY, 3)}")
    if lanes.device != device:
        raise ValueError(f"lanes is on {lanes.device}, the planes on {device}")
    if not lanes.is_contiguous():
        raise ValueError("lanes is not contiguous")


def active_share(launch: dict) -> float:
    """The share of (strip, column) pairs of a LAST_LAUNCH record whose strip
    held a band lane and so did work (1.0 without lanes)."""
    if launch["lanes"] is None:
        return 1.0
    return float(strip_activity(launch["lanes"], launch["SX"], launch["ns"]).double().mean())


@functools.lru_cache(maxsize=None)
def _capacity(name: str, dtype: torch.dtype, ns: int, ca: int, device: int) -> int:
    """Strips of ns lanes the card holds at once (negative: a CUDA error,
    such as K2's [ca, ns] slice of ex_t not fitting shared memory)."""
    from historian_tpu_torch.ops import _kernels

    fn = getattr(_kernels.lib(), f"{name}_capacity_{'f32' if dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(device):
        return fn() if name == "colforward" else fn(ns, ca)


def strip_width(name: str, SX: int, dtype, device, ca: int = 0) -> int:
    """The strip width of a launch: STRIP_WIDTH, or for K2
    NARROW_STRIP_WIDTH where a [ca, STRIP_WIDTH] slice of ex_t does not fit
    shared memory; 0 where its strips cannot all be resident at once.  A
    negative capacity (a CUDA error) raises."""
    ns = STRIP_WIDTH
    cap = _capacity(name, dtype, ns, ca, device.index)
    if cap <= 0 and name == "colforward_fused":
        ns = NARROW_STRIP_WIDTH
        cap = _capacity(name, dtype, ns, ca, device.index)
    if cap < 0:
        raise RuntimeError(f"{name}: the strip capacity query failed with CUDA error {-cap}")
    return ns if -(-SX // ns) <= cap else 0


def _launch_strips(name: str, fn, inputs: list, lanes, SY: int, SX: int, tail: list,
                   dtype, device, ca: int = 0):
    """Allocate the output and the strips' sync buffers, launch `fn`
    cooperatively and record LAST_LAUNCH.  With `lanes` the output starts
    as NEG, which the skipped strips keep."""
    from historian_tpu_torch.ops import _kernels

    width = strip_width(name, SX, dtype, device, ca)
    if not width:
        raise RuntimeError(f"{name}: {SX} lanes need more strips than {device} holds at once")
    strips = -(-SX // width)
    if lanes is None:
        out = torch.empty((5, SY, SX), dtype=dtype, device=device)
    else:
        out = torch.full((5, SY, SX), NEG, dtype=dtype, device=device)
    progress = torch.zeros(strips, dtype=torch.int32, device=device)
    rec = torch.empty((strips, SY, 4), dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(t.data_ptr() for t in inputs), 0 if lanes is None else lanes.data_ptr(),
                  progress.data_ptr(), rec.data_ptr(), out.data_ptr(), *tail, width, stream)
    _kernels.check(code, name)
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(kernel=name, strips=strips, ns=width, SX=SX, lanes=lanes)
    return out


def _check_inputs(y_src, y_lp, y_flags, absorb, maskg, xvec, trans):
    SY, SX = absorb.shape
    dt = absorb.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, got {dt}")
    if y_src.dtype != torch.int32:
        raise TypeError(f"y_src must be int32, got {y_src.dtype}")
    KY = y_src.shape[1]
    want = {
        "y_src": (y_src, (SY, KY)), "y_lp": (y_lp, (SY, KY)),
        "y_flags": (y_flags, (SY, 4)), "maskg": (maskg, (SY, SX)),
        "xvec": (xvec, (4, SX)), "trans": (trans, (23,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != absorb.device:
            raise ValueError(f"{name} is on {t.device}, absorb on {absorb.device}")
        if name != "y_src" and t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, absorb is {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not absorb.is_contiguous():
        raise ValueError("absorb is not contiguous")
    if SY < 1 or SX < 1:
        raise ValueError(f"empty grid {SY}x{SX}")


def col_forward_planes(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes=None):
    """K1: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (float32 or float64).  Any other device raises.

    lanes: None (every lane) or int32 [SY, 3] as `band_lanes` gives it,
    covering every lane where maskg is 0; the kernel's strips with none
    skip the column.  The plain version computes every lane and ignores
    it."""
    global LAUNCHES
    _check_inputs(y_src, y_lp, y_flags, absorb, maskg, xvec, trans)
    dev = absorb.device
    _check_lanes(lanes, absorb.shape[0], dev)
    if dev.type == "cpu":
        return col_forward_planes_plain(y_src, y_lp, y_flags, absorb, maskg, xvec, trans)
    if dev.type != "cuda":
        raise RuntimeError(f"K1 has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    SY, SX = absorb.shape
    fn = _kernels.lib().colforward_f32 if absorb.dtype == torch.float32 \
        else _kernels.lib().colforward_f64
    out = _launch_strips("colforward", fn, [y_src, y_lp, y_flags, absorb, maskg, xvec, trans],
                         lanes, SY, SX, [SY, SX, y_src.shape[1]], absorb.dtype, dev)
    LAUNCHES += 1
    return out


def emission_planes(ey, ex_t, shift_y, shift_x, in_band):
    """(absorb, maskg) [SY, SX]: the match emission
    max(log(ey @ ex_t) + shift_y + shift_x, NEG) inside the band and NEG
    outside, and the gate (0 inside, NEG outside)."""
    dense = torch.matmul(ey, ex_t)
    torch.log_(dense)
    dense += shift_y[:, None]
    dense += shift_x[None, :]
    absorb = torch.where(in_band, torch.clamp_min(dense, NEG), NEG)
    del dense
    maskg = torch.zeros_like(absorb).masked_fill_(~in_band, NEG)
    return absorb, maskg


def fused_band_mask(y_flags, xvec, params):
    """K2's band [SY, SX] from its packed inputs (see
    `col_forward_planes_fused_plain`)."""
    SY = y_flags.shape[0]
    dist, ny = params[23], params[24]
    in_band = torch.abs(y_flags[:, 4, None] - xvec[5][None, :]) <= dist
    in_band |= (xvec[6] > 0.5)[None, :]
    in_band |= (y_flags[:, 5] > 0.5)[:, None]
    in_band &= (xvec[7] > 0.5)[None, :]
    in_band &= (torch.arange(SY, device=y_flags.device) < ny)[:, None]
    return in_band


def col_forward_planes_fused_plain(y_src, y_lp, y_flags, ey, ex_t, xvec, params):
    """Plain PyTorch version of K2.  y_flags [SY, 8]: null, ready,
    rootsub_y, ins_y, m2, y_near_end, shift_y, -; ey [SY, CA]; ex_t
    [CA, SX]; xvec [8, SX]: rootsub_x, ins_x, x_gate, x_eos, shift_x, m1,
    x_near_start, x_in_range; params [32]: 23 transitions, the band
    distance, ny.  A cell is in the band when |m2 - m1| <= distance or it
    is near the start of x or the end of y, and it lies in the real
    region (x_in_range, row < ny)."""
    absorb, maskg = emission_planes(ey, ex_t, y_flags[:, 6], xvec[4],
                                    fused_band_mask(y_flags, xvec, params))
    return col_forward_planes_plain(
        y_src, y_lp, y_flags[:, :4].contiguous(), absorb, maskg,
        xvec[:4].contiguous(), params[:23].contiguous(),
    )


def _check_fused_inputs(y_src, y_lp, y_flags, ey, ex_t, xvec, params):
    dt = ey.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K2 takes float32 or float64, got {dt}")
    if y_src.dtype != torch.int32:
        raise TypeError(f"y_src must be int32, got {y_src.dtype}")
    SY, CA = ey.shape
    SX = ex_t.shape[1]
    KY = y_src.shape[1]
    if not 1 <= CA <= FUSED_MAX_CA:
        raise ValueError(f"K2 takes 1 to {FUSED_MAX_CA} emission factors, got {CA}")
    want = {
        "y_src": (y_src, (SY, KY)), "y_lp": (y_lp, (SY, KY)), "y_flags": (y_flags, (SY, 8)),
        "ey": (ey, (SY, CA)), "ex_t": (ex_t, (CA, SX)), "xvec": (xvec, (8, SX)),
        "params": (params, (32,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != ey.device:
            raise ValueError(f"{name} is on {t.device}, ey on {ey.device}")
        if name != "y_src" and t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, ey is {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if SY < 1 or SX < 1:
        raise ValueError(f"empty grid {SY}x{SX}")


def fused_lanes(y_flags, xvec, params):
    """`band_lanes` of K2's packed inputs: m2 and y_near_end from y_flags,
    m1, x_near_start and x_in_range from xvec, the distance and ny from
    params."""
    return band_lanes(xvec[5], y_flags[:, 4], params[23], xvec[6] > 0.5, y_flags[:, 5] > 0.5,
                      ny=params[24], x_in_range=xvec[7] > 0.5)


def col_forward_planes_fused(y_src, y_lp, y_flags, ey, ex_t, xvec, params):
    """K2: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (float32 or float64).  Any other device raises.  The kernel's
    strips skip the columns where `fused_lanes` gives them no lane."""
    global FUSED_LAUNCHES
    _check_fused_inputs(y_src, y_lp, y_flags, ey, ex_t, xvec, params)
    dev = ey.device
    if dev.type == "cpu":
        return col_forward_planes_fused_plain(y_src, y_lp, y_flags, ey, ex_t, xvec, params)
    if dev.type != "cuda":
        raise RuntimeError(f"K2 has no kernel for device {dev}")
    from historian_tpu_torch.ops import _kernels

    SY, CA = ey.shape
    SX = ex_t.shape[1]
    fn = _kernels.lib().colforward_fused_f32 if ey.dtype == torch.float32 \
        else _kernels.lib().colforward_fused_f64
    out = _launch_strips("colforward_fused", fn, [y_src, y_lp, y_flags, ey, ex_t, xvec, params],
                         fused_lanes(y_flags, xvec, params), SY, SX, [SY, SX, y_src.shape[1], CA],
                         ey.dtype, dev, CA)
    FUSED_LAUNCHES += 1
    return out
