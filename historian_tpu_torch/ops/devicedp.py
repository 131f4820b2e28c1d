"""The merge bridge: profiles -> fill planes -> traces or host cells.

Port of the resident, factored, vector-mask route of
historian_tpu/ops/devicedp.py (`col_forward_device` ->
`col_forward_cells(keep=True)` -> `_oneshot_vecmask_pallas`, and
`DeviceTraceFill`), and of its full-readback route (`col_forward_cells`
on `_oneshot_idx_pallas`, and `chain_forward_cells`):

1. the host builds the y in-edge tables, the x vectors with the chain
   lp folded in, the emission factors and the envelope's O(L) vectors
   (`fill_arrays`, exact sizes: no shape buckets);
2. on the device, the emission is log(ey @ ex.T) + shifts, the band mask
   is rebuilt from the vectors, and kernel K1 fills the five planes
   (`fill_planes`); under HISTORIAN_PALLAS_FUSED=1, the JAX package's
   switch, kernel K2 builds the emission and the mask itself from the
   packed O(L) vectors and fills the planes (`fill_planes_fused`), so
   no [SY, SX] emission or mask plane exists;
3. either `TorchTraceFill` keeps the planes resident and answers lp_end
   and the trace walks there, so that only the visited cells come back
   to the host; or, for a merge whose whole band the host reads (the
   BackwardMatrix, counts), `col_forward_cells` gathers the in-envelope
   cells on the device and copies them to the host once (`read_band`).
   A chain y is a DAG y whose states have one in-edge each, so chain x
   chain merges take this route too: the JAX package's separate
   chain x chain scan needs no kernel of its own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from historian_tpu_torch import convert
from historian_tpu_torch.ops.colforward import (
    band_lanes,
    col_forward_planes,
    col_forward_planes_fused,
    emission_planes,
    strip_width,
)
from historian_tpu_torch.ops.readback import gather_to_host
from historian_tpu_torch.ops.tracedp import end_lp, pair_trace

NEG = -1e30
#: values below this are the semiring zero; the host reads them as -inf
NEG_CUTOFF = -1e25


def _clamp(a, dtype=np.float64) -> np.ndarray:
    """Finite NEG in place of -inf (the kernels' semiring zero)."""
    return np.where(np.isfinite(a), a, NEG).astype(dtype, copy=False)


def pack_transitions(hmm) -> np.ndarray:
    """A PairHMM in the kernels' [23] layout (historian_tpu/ops/
    pairforward.py::pack_transitions)."""
    return np.array([
        hmm.imm_imm, hmm.imm_imd, hmm.imm_idm, hmm.imm_imi, hmm.imm_iiw, hmm.imm_eee,
        hmm.imd_imm, hmm.imd_imd, hmm.imd_idm, hmm.imd_eee,
        hmm.idm_imm, hmm.idm_imd, hmm.idm_idm, hmm.idm_eee,
        hmm.imi_imm, hmm.imi_imd, hmm.imi_imi, hmm.imi_iiw, hmm.imi_eee,
        hmm.iiw_imm, hmm.iiw_idm, hmm.iiw_iiw, hmm.iiw_eee,
    ])


def profile_in_edges(profile, n: int):
    """y in-edge tables [n, K] (src int32, lp with NEG pads), K = the
    largest in-degree among the first n states; memoized on the profile."""
    cached = profile.__dict__.get("_torch_in_edges")
    if cached is not None:
        return cached
    K = max(1, max((len(profile.states[s].in_trans) for s in range(n)), default=1))
    src = np.zeros((n, K), dtype=np.int32)
    lp = np.full((n, K), NEG)
    for s in range(n):
        for k, t in enumerate(profile.states[s].in_trans):
            src[s, k] = profile.trans[t].src
            lp[s, k] = _clamp(profile.trans[t].lp)
    profile.__dict__["_torch_in_edges"] = (src, lp)
    return src, lp


def sorted_walk_edges(src: np.ndarray, lp: np.ndarray):
    """Per-row copies of the in-edge tables sorted by source with the
    padding last: the walker's candidate order is the host's sorted
    cell order (historian_tpu/ops/devicedp.py::_sorted_walk_edges)."""
    pad = lp <= NEG / 2
    order = np.argsort(np.where(pad, np.iinfo(np.int32).max, src), axis=1, kind="stable")
    rows = np.arange(src.shape[0])[:, None]
    return src[rows, order], lp[rows, order]


def fill_arrays(dp) -> dict:
    """Host inputs of the one-program fill for a chain-x DPMatrix, the
    arrays the JAX bridge passes to `_oneshot_vecmask_pallas`, at exact
    sizes SX = nx, SY = ny."""
    ex = dp.x.as_chain()
    nx, ny = dp.x_size - 1, dp.y_size - 1
    tx = ex[:nx]  # transition lp into x state i (tx[0] = 0 for START)
    rsx = _clamp(dp.rootsubx[:nx] + tx)
    isx = _clamp(dp.insx[:nx] + tx)
    y_src, y_lp = profile_in_edges(dp.y, ny)
    y_flags = np.stack([
        dp.y_null[:ny], (dp.y_ready | dp.y_empty)[:ny],
        _clamp(dp.rootsuby[:ny]), _clamp(dp.insy[:ny]),
    ], axis=1).astype(np.float64)
    xvec = np.stack([
        rsx, isx,
        np.where((dp.x_ready | dp.x_empty)[:nx], 0.0, NEG),
        np.where(dp.x_emit_or_start[:nx], 0.0, NEG),
    ])
    fx, sxs, fy, sys_ = dp.absorb_factors
    ev = dp.env_vectors
    if ev is None:  # no envelope: every cell is in the band
        m1, m2, dist = np.zeros(nx, np.int64), np.zeros(ny, np.int64), 0
    else:
        m1, m2, dist = ev[0][:nx], ev[1][:ny], ev[2]
    return dict(
        y_src=y_src, y_lp=y_lp, y_flags=y_flags,
        ey_e=fy[:ny], ex_e=fx[:nx], shift_y=sys_[:ny], shift_x=sxs[:nx] + tx,
        m2=np.asarray(m2, np.int64), m1=np.asarray(m1, np.int64), dist=dist,
        yne=dp.y_near_end[:ny], xns=dp.x_near_start[:nx], ny=ny, nx=nx,
        xvec=xvec, trans=_clamp(pack_transitions(dp.hmm)),
    )


def fill_planes(t: dict) -> torch.Tensor:
    """The one-program fill on the tensors' device: emission matmul, band
    mask from the envelope vectors, and K1, whose strips skip the columns
    where the envelope's `band_lanes` give them no lane.  Returns
    [5, SY, SX]."""
    mask = torch.abs(t["m2"][:, None] - t["m1"][None, :]) <= t["dist"]
    mask |= t["yne"][:, None]
    mask |= t["xns"][None, :]
    absorb, maskg = emission_planes(t["ey_e"], t["ex_e"].T, t["shift_y"], t["shift_x"], mask)
    del mask
    lanes = band_lanes(t["m1"], t["m2"], t["dist"], t["xns"], t["yne"])
    return col_forward_planes(
        t["y_src"], t["y_lp"], t["y_flags"], absorb, maskg, t["xvec"], t["trans"], lanes
    )


def fused_enabled() -> bool:
    """HISTORIAN_PALLAS_FUSED=1 routes every merge through K2."""
    return os.environ.get("HISTORIAN_PALLAS_FUSED", "0") == "1"


def fill_planes_fused(t: dict) -> torch.Tensor:
    """The fused fill: K2 on the packed tensors of convert.fused_tensors.
    Returns [5, SY, SX]."""
    return col_forward_planes_fused(
        t["y_src"], t["y_lp"], t["y_flags"], t["ey"], t["ex_t"], t["xvec"], t["params"]
    )


def walk_arrays(dp) -> dict:
    """Host inputs of the walker for a chain-x DPMatrix (the JAX
    `DeviceTraceFill._walk_args`, at exact sizes)."""
    nx, ny = dp.x_size - 1, dp.y_size - 1
    src, lp = profile_in_edges(dp.y, ny)
    y_src, y_lp = sorted_walk_edges(src, lp)
    x_end = dp.x.end
    if len(x_end.in_trans) != 1:
        raise ValueError("a chain x has exactly one END in-edge")
    xt = dp.x.trans[x_end.in_trans[0]]
    ye = sorted((dp.y.trans[t].src, dp.y.trans[t].lp) for t in dp.y.end.in_trans)
    return dict(
        y_src=y_src, y_lp=y_lp, y_null=dp.y_null[:ny],
        tx=_clamp(dp.x.as_chain()[:nx]), t6=_clamp(dp.hmm.trans_table),
        xe_src=xt.src, xe_lp=_clamp(xt.lp),
        ye_src=np.array([s for s, _ in ye], np.int32),
        ye_lp=_clamp(np.array([v for _, v in ye])),
    )


def _fits_budget(device: torch.device, SY: int, SX: int, dtype: torch.dtype,
                 fused: bool) -> bool:
    """Whether the merge can stay resident: the planes plus, on the K1
    route, the fill's transients (emission, mask, gate) must fit the free
    memory, the blocks PyTorch's allocator holds unused included."""
    if device.type != "cuda":
        return True
    item = torch.finfo(dtype).bits // 8
    need = SY * SX * (5 * item if fused else 8 * item + 1)
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return need <= free + cached


def _strips_fit(dp, device: torch.device, dtype: torch.dtype, fused: bool) -> bool:
    """Whether all of the merge's lane strips can be resident at once
    (`colforward.strip_width`); the plain versions have no strips."""
    if device.type != "cuda":
        return True
    if fused:
        return strip_width("colforward_fused", dp.x_size - 1, dtype, device,
                           dp.absorb_factors[2].shape[1]) > 0
    return strip_width("colforward", dp.x_size - 1, dtype, device) > 0


def merge_fits(dp, device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a chain-x merge fills on `device`: its memory budget and its
    strips.  Where it does not, the JAX package's `col_forward_device`
    returns None and the merge fills on the host (historian_tpu/ops/
    devicedp.py col_forward_device); so does the port's (engine/forward.py
    `_fill_device`)."""
    fused = fused_enabled()
    return (_fits_budget(device, dp.y_size - 1, dp.x_size - 1, dtype, fused)
            and _strips_fit(dp, device, dtype, fused))


def fill_merge(dp, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Fill a chain-x merge on `device`: the planes [5, SY, SX], by K1, or
    by K2 under HISTORIAN_PALLAS_FUSED=1.  The caller has checked
    `merge_fits`."""
    arrays = fill_arrays(dp)
    if fused_enabled():
        return fill_planes_fused(convert.fused_tensors(arrays, device, dtype))
    return fill_planes(convert.fill_tensors(arrays, device, dtype))


def col_forward_device(dp, device: torch.device, dtype: torch.dtype) -> "TorchTraceFill":
    """Fill a chain-x merge on `device` and keep the planes there."""
    return TorchTraceFill(dp, fill_merge(dp, device, dtype), walk_arrays(dp))


def col_forward_cells(dp, device: torch.device, dtype: torch.dtype, out: np.ndarray) -> None:
    """Fill a chain-x merge on `device` and read its band into the host
    grid `out` [x_size, y_size, 5] (float64, filled with -inf by the
    caller)."""
    read_band(fill_merge(dp, device, dtype), dp, out)


def band_index(dp) -> np.ndarray | None:
    """Flat indices into the [SY, SX] planes of the merge's in-envelope
    cells, in the row-major order of the host grid's envelope mask (the
    JAX package's `_mask_idx` over the transposed grid); None when the
    merge has no envelope and every cell is in the band."""
    if dp.env_vectors is None:
        return None
    nx, ny = dp.x_size - 1, dp.y_size - 1
    ii, jj = np.nonzero(dp.env_mask[:nx, :ny])
    return jj.astype(np.int64) * nx + ii


def read_band(planes: torch.Tensor, dp, out: np.ndarray) -> None:
    """Gather the merge's in-envelope cells on the device, copy them to the
    host once (`readback.gather_to_host`, logged in its READBACKS as a
    "merge") and scatter them into the host grid `out`; cells below
    NEG_CUTOFF read as -inf, as the JAX package's `_expand_cells` reads
    them."""
    nx, ny = dp.x_size - 1, dp.y_size - 1
    idx = band_index(dp)
    idx_d = None if idx is None else torch.as_tensor(idx, device=planes.device)
    # the JAX package's `planes.reshape(5, -1).T[idx]`, state-major: [5, n]
    (host,) = gather_to_host("merge", planes.reshape(5, -1), 1, idx_d)
    v = host.numpy().astype(np.float64)
    v[v < NEG_CUTOFF] = -np.inf
    if idx is None:
        out[:nx, :ny] = v.reshape(5, ny, nx).transpose(2, 1, 0)
    else:
        out[:nx, :ny][dp.env_mask[:nx, :ny]] = v.T


class TorchTraceFill:
    """Device-resident fill handle with the interface engine/forward.py
    calls on the JAX package's DeviceTraceFill: dispatch_lp_end, lp_end,
    dispatch_traces, collect_traces, lp_end_and_traces; a host consumer
    of the whole band reads it from `planes` (`read_band`)."""

    def __init__(self, dp, planes: torch.Tensor, walk: dict):
        self.dp = dp
        self.planes = planes  # [5, SY, SX] on the device
        self.ny, self.nx = planes.shape[1], planes.shape[2]
        self.walk = convert.walk_tensors(walk, planes.device, planes.dtype)
        self.n_steps_max = self.nx + self.ny
        self._lp_end = None
        self._lp_end_dev = None

    def dispatch_lp_end(self) -> None:
        """Enqueue the end gather without waiting for it."""
        if self._lp_end is None and self._lp_end_dev is None:
            w = self.walk
            self._lp_end_dev = end_lp(
                self.planes, w["t6"], w["xe_src"], w["xe_lp"], w["ye_src"], w["ye_lp"]
            )

    @property
    def lp_end(self) -> float:
        if self._lp_end is None:
            self.dispatch_lp_end()
            v = float(self._lp_end_dev)
            self._lp_end_dev = None
            self._lp_end = -np.inf if v < NEG_CUTOFF else v
        return self._lp_end

    def dispatch_traces(self, n_samples: int, include_best: bool, uniforms=None):
        """Enqueue the best walk and n_samples sampled walks in one launch.
        The sampled walks take their draws in order from `uniforms`, the
        run's next mt19937 uniforms (float64, at least n_samples x
        n_steps_max of them), copied to the device in the fill dtype."""
        dev, dtype = self.planes.device, self.planes.dtype
        if n_samples:
            u = torch.as_tensor(np.asarray(uniforms)[: n_samples * self.n_steps_max],
                                dtype=dtype).to(dev)
        else:
            u = torch.zeros(1, dtype=dtype, device=dev)
        w = self.walk
        return pair_trace(
            self.planes, w["y_src"], w["y_lp"], w["y_null"], w["tx"], w["t6"],
            w["xe_src"], w["xe_lp"], w["ye_src"], w["ye_lp"], u, include_best,
            n_samples, self.n_steps_max,
        )

    def collect_traces(self, raw, n_samples: int, include_best: bool):
        """Read a dispatch_traces result back: a list of (cells, vals)
        start->end (END excluded), best first when include_best.  A walk's
        draws are its step count, len(cells)."""
        T = n_samples + (1 if include_best else 0)
        pi, pj, ps, vals, n_steps, lp = (x.cpu().numpy() for x in raw)
        vals = vals.astype(np.float64)
        vals[vals < NEG_CUTOFF] = -np.inf
        lp = float(lp)
        if self._lp_end is None:
            self._lp_end = -np.inf if lp < NEG_CUTOFF else lp
        traces = []
        for t in range(T):
            n = int(n_steps[t])
            cells = [(int(pi[t, k]), int(pj[t, k]), int(ps[t, k])) for k in range(n)]
            cells.reverse()  # the walker emits end->start
            traces.append((cells, vals[t, :n][::-1]))
        return traces

    def lp_end_and_traces(self, n_samples: int, include_best: bool, uniforms=None):
        raw = self.dispatch_traces(n_samples, include_best, uniforms)
        traces = self.collect_traces(raw, n_samples, include_best)
        return self.lp_end, traces
