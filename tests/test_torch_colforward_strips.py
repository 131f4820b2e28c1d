"""The strip skipping of kernels K1 and K2, on the CPU
(historian_tpu_torch/ops/colforward.py `band_lanes`, `lanes_from_mask`,
`strip_activity` and the wrappers' `lanes` argument).

The kernels cut the x lanes into strips and skip, in each column, the
strips that `band_lanes` gives no lane; the wrapper fills the output with
NEG first.  That is exact only if a full sweep writes exactly -1e30 at
every cell of a skipped strip, which is checked here against the JAX
package:

- `band_lanes` covers every in-band cell of the mask that K2's plain
  version builds (hypothesis, float32 and float64 coordinates), and its
  interval [lo, hi) holds no lane outside the distance band;
- on a banded `-fast` merge of small6's first two sequences (the port's
  `fill_arrays`) and on chip_smoke.py's synthetic K2 band at 96-256
  lanes, the JAX package's planes (`col_pair_forward_cells` in float64,
  the Pallas kernels in interpret mode in float32) are exactly -1e30 at
  every cell of every inactive strip, for strips of 32 and 64 lanes, and
  the port's plain planes with those strips overwritten by NEG are
  unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from historian_tpu.ops.colforward import col_pair_forward_cells
from historian_tpu.ops.pallas_colforward import (
    pallas_col_forward_cells,
    pallas_col_forward_cells_fused,
)
from historian_tpu_torch import convert
from historian_tpu_torch import device as devmod
from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
from historian_tpu_torch.core.seqs import read_fasta
from historian_tpu_torch.engine.forward import DPMatrix
from historian_tpu_torch.engine.profile import Profile
from historian_tpu_torch.engine.quickalign import QuickAligner
from historian_tpu_torch.models.presets import named_model
from historian_tpu_torch.ops import colforward, devicedp
from historian_tpu_torch.recon import DEFAULT_MAX_DISTANCE_FROM_GUIDE
from tests.torch_twins import DATA, PORT, pair_hmm

NEG = -1e30
STRIPS = (32, 64)


def _packed(m1, m2, dist, xns, yne, ny, xir, dtype):
    """K2's y_flags, xvec and params holding only the band's vectors."""
    SX, SY = len(m1), len(m2)
    y_flags = np.zeros((SY, 8))
    y_flags[:, 4], y_flags[:, 5] = m2, yne
    xvec = np.zeros((8, SX))
    xvec[5], xvec[6], xvec[7] = m1, xns, xir
    params = np.zeros(32)
    params[23], params[24] = dist, ny
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (y_flags, xvec, params))


@st.composite
def bands(draw):
    SX = draw(st.integers(1, 70))
    SY = draw(st.integers(1, 40))
    big = draw(st.booleans())  # coordinates where float32 rounds a difference
    scale = (1 << 29) if big else 1
    m1 = np.sort(np.array(draw(st.lists(st.integers(-60, 60), min_size=SX, max_size=SX))))
    m2 = np.array(draw(st.lists(st.integers(-70, 70), min_size=SY, max_size=SY)))
    bools = st.lists(st.booleans(), min_size=SX, max_size=SX)
    return dict(
        m1=m1 * scale + 3, m2=m2 * scale + 1, dist=draw(st.integers(0, 12)) * scale,
        xns=np.array(draw(st.lists(st.booleans(), min_size=SX, max_size=SX))) & (
            np.arange(SX) < draw(st.integers(0, 5))),
        yne=np.array(draw(st.lists(st.booleans(), min_size=SY, max_size=SY))),
        ny=draw(st.integers(0, SY)),
        xir=np.array(draw(bools)) | draw(st.booleans()),
        dtype=draw(st.sampled_from([torch.float32, torch.float64])),
    )


@settings(max_examples=200, deadline=None)
@given(bands())
def test_band_lanes_cover_the_fused_band(b):
    y_flags, xvec, params = _packed(b["m1"], b["m2"], b["dist"], b["xns"], b["yne"], b["ny"],
                                    b["xir"], b["dtype"])
    mask = colforward.fused_band_mask(y_flags, xvec, params).numpy()
    lanes = colforward.fused_lanes(y_flags, xvec, params).numpy()
    assert lanes.shape == (len(b["m2"]), 3) and lanes.dtype == np.int32
    head, lo, hi = (lanes[:, k, None] for k in range(3))
    lane = np.arange(len(b["m1"]))[None, :]
    covered = (lane < head) | ((lane >= lo) & (lane < hi))
    assert not (mask & ~covered).any()
    # [lo, hi) holds only lanes within the distance, in the dtype's arithmetic
    near = (torch.abs(y_flags[:, 4, None] - xvec[5][None, :]) <= params[23]).numpy()
    plain_rows = ~(b["yne"].astype(bool))[:, None]
    assert not ((lane >= lo) & (lane < hi) & plain_rows & ~near).any()


def test_band_lanes_full_columns_for_a_nonmonotone_m1():
    m1 = np.array([0, 1, 2, 5, 4, 6, 7, 8])
    xir = np.ones(8, bool)
    xir[-2:] = False
    y_flags, xvec, params = _packed(m1, np.array([0, 3, 8, 20]), 1, np.zeros(8, bool),
                                    np.zeros(4, bool), 3, xir, torch.float64)
    before = colforward.nonmonotone_m1()
    lanes = colforward.fused_lanes(y_flags, xvec, params).tolist()
    assert colforward.nonmonotone_m1() == before + 1
    # rows below ny: the hull of x_in_range; the row past ny: empty
    assert lanes == [[0, 0, 6], [0, 0, 6], [0, 0, 6], [0, 0, 0]]
    monotone = colforward.band_lanes(torch.arange(8), torch.tensor([0, 3]), 1,
                                     torch.zeros(8, dtype=torch.bool),
                                     torch.zeros(2, dtype=torch.bool))
    assert colforward.nonmonotone_m1() == before + 1
    assert monotone.tolist() == [[0, 0, 2], [0, 2, 5]]


def test_lanes_from_mask_and_strip_activity():
    mask = torch.zeros(4, 10, dtype=torch.bool)
    mask[0, 2:5] = True
    mask[1, [0, 9]] = True
    mask[3, 7] = True
    lanes = colforward.lanes_from_mask(mask)
    assert lanes.tolist() == [[0, 2, 5], [0, 0, 10], [0, 0, 0], [0, 7, 8]]
    act = colforward.strip_activity(lanes, 10, 4)  # strips [0,4) [4,8) [8,10)
    assert act.tolist() == [[True, True, False], [True, True, True],
                            [False, False, False], [False, True, False]]
    head = torch.tensor([[5, 9, 9]], dtype=torch.int32)  # a head, an empty interval
    assert colforward.strip_activity(head, 10, 4).tolist() == [[True, True, False]]


def test_active_share_of_a_launch_record():
    """A launch record's share of working (strip, column) pairs: that of
    its lanes at its strip width, 1.0 where it had none."""
    lanes = torch.tensor([[0, 2, 5], [0, 0, 0]], dtype=torch.int32)
    launch = dict(kernel="colforward", strips=3, ns=4, SX=10, lanes=lanes)
    assert colforward.active_share(launch) == 2 / 6
    assert colforward.active_share(dict(launch, lanes=None)) == 1.0


def _inactive(lanes, SX: int, ns: int) -> np.ndarray:
    """bool [SY, SX]: the cells of the strips that skip their column."""
    act = colforward.strip_activity(lanes, SX, ns).numpy()
    return np.repeat(~act, ns, axis=1)[:, :SX]


def _check_skip_exact(port_planes, lanes, jax_planes: dict) -> None:
    """The port's plain planes and each JAX plane set ([5, SY, SX]) are
    exactly NEG (in their dtype) at every inactive cell, for strips of
    32 and 64 lanes."""
    SX = port_planes.shape[2]
    for ns in STRIPS:
        off = _inactive(lanes, SX, ns)
        assert off.any(), ns  # the band leaves strips idle
        cut = port_planes.copy()
        cut[:, off] = NEG
        assert np.array_equal(cut, port_planes), ns
        for name, p in jax_planes.items():
            assert np.array_equal(p[:, off], np.full_like(p[:, off], NEG)), (name, ns)


def _pallas_k1(args):
    """The Pallas K1 kernel in float32, interpret mode, with SY padded to a
    multiple of 8 by rows that only follow the real ones."""
    y_src, y_lp, y_flags, absorb, maskg, xvec, trans = args
    SY = y_src.shape[0]
    pad = -SY % 8

    def rows(a, v):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], v, a.dtype)])

    f32 = [rows(y_lp, NEG), rows(y_flags, 0.0), rows(absorb, NEG), rows(maskg, NEG), xvec,
           trans]
    f32 = [rows(y_src, 0).astype(np.int32)] + [a.astype(np.float32) for a in f32]
    planes = np.asarray(pallas_col_forward_cells(*(jnp.asarray(a) for a in f32), interpret=True))
    return planes[:, :SY]


def _xla(args):
    """The XLA column kernel of the JAX package on K1's arguments, float64,
    as [5, SY, SX]."""
    y_src, y_lp, y_flags, absorb, maskg, xvec, trans = args
    cells = col_pair_forward_cells(
        jnp.asarray(absorb), jnp.asarray(xvec[0]), jnp.asarray(xvec[1]),
        jnp.asarray(y_flags[:, 2]), jnp.asarray(y_flags[:, 3]), jnp.asarray(maskg == 0),
        jnp.asarray(trans), jnp.asarray(xvec[2] == 0), jnp.asarray(xvec[3] == 0),
        jnp.asarray(y_src), jnp.asarray(y_lp), jnp.asarray(y_flags[:, 0] > 0.5),
        jnp.asarray(y_flags[:, 1] > 0.5))
    return np.moveaxis(np.asarray(cells), -1, 0)


def test_skipping_is_exact_on_a_banded_merge():
    """small6's first two sequences (240 and 260 aa) merged as `recon -fast`
    merges leaves: banded by the guide at the default distance."""
    devmod.select("cpu")
    model = named_model("lg")
    x, y = read_fasta(f"{DATA}/long6.fa")[:2]
    x.seq, y.seq = x.seq[:240], y.seq[:260]
    guide = QuickAligner(model, 1.0).align_batch([(x, y, None)])[0].align_path(0, 1)
    a, b = (Profile.from_sequence(model.components, model.alphabet, s, k)
            for k, s in enumerate((x, y)))
    env = GuideAlignmentEnvelope(guide, 0, 1, DEFAULT_MAX_DISTANCE_FROM_GUIDE)
    arrays = devicedp.fill_arrays(DPMatrix(a, b, pair_hmm(PORT, model, 0.3, 0.2), env))
    t = convert.fill_tensors(arrays, "cpu", torch.float64)
    lanes = colforward.band_lanes(t["m1"], t["m2"], t["dist"], t["xns"], t["yne"])
    port = devicedp.fill_planes(t).numpy()

    # K1's arguments as fill_planes builds them, for the JAX kernels
    mask = torch.abs(t["m2"][:, None] - t["m1"][None, :]) <= t["dist"]
    mask |= t["yne"][:, None]
    mask |= t["xns"][None, :]
    absorb, maskg = colforward.emission_planes(t["ey_e"], t["ex_e"].T, t["shift_y"],
                                               t["shift_x"], mask)
    args = tuple(np.asarray(v) for v in (t["y_src"], t["y_lp"], t["y_flags"], absorb.numpy(),
                                         maskg.numpy(), t["xvec"], t["trans"]))
    jax_planes = {"xla f64": _xla(args), "pallas f32": _pallas_k1(args)}
    for p in jax_planes.values():
        assert ((p > -1e25) == (port > -1e25)).all()
    _check_skip_exact(port, lanes, jax_planes)


@pytest.mark.parametrize("SX,SY,KY", [(96, 64, 4), (256, 128, 1)])
def test_skipping_is_exact_on_the_smoke_band(SX, SY, KY):
    """chip_smoke.py's K2 band (|i - j| <= 10, 3 lanes near the start, 3
    rows near the end): the fused Pallas kernel in interpret mode in
    float32, the XLA kernel on the same band in float64."""
    args = chip_smoke.k2_inputs(SX, SY, KY, 23, torch.float64, dev=torch.device("cpu"))
    y_src, y_lp, y_flags, ey, ex_t, xvec, params = args
    lanes = colforward.fused_lanes(y_flags, xvec, params)
    port = colforward.col_forward_planes_fused(*args).numpy()

    f32 = [np.asarray(v) if v.dtype == torch.int32 else np.asarray(v, np.float32) for v in args]
    fused = np.asarray(pallas_col_forward_cells_fused(*(jnp.asarray(a) for a in f32),
                                                      interpret=True))
    absorb, maskg = colforward.emission_planes(ey, ex_t, y_flags[:, 6], xvec[4],
                                               colforward.fused_band_mask(y_flags, xvec, params))
    k1 = tuple(np.asarray(v) for v in (y_src, y_lp, y_flags[:, :4], absorb, maskg, xvec[:4],
                                       params[:23]))
    jax_planes = {"pallas fused f32": fused, "xla f64": _xla(k1)}
    for p in jax_planes.values():
        assert ((p > -1e25) == (port > -1e25)).all()
    _check_skip_exact(port, lanes, jax_planes)


def test_wrapper_lanes_checks():
    """`lanes` of the wrong dtype, shape or device raises; the CPU takes the
    plain version, ignores `lanes` and counts no launch."""
    args = chip_smoke.k1_inputs(40, 30, 2, True, 3, torch.float64, dev=torch.device("cpu"))
    mask = args[4] == 0
    lanes = colforward.lanes_from_mask(mask)
    before = (colforward.LAUNCHES, dict(colforward.LAST_LAUNCH))
    full = colforward.col_forward_planes(*args)
    skipped = colforward.col_forward_planes(*args, lanes=lanes)
    assert torch.equal(full, skipped)
    assert (colforward.LAUNCHES, colforward.LAST_LAUNCH) == before
    with pytest.raises(TypeError, match="int32"):
        colforward.col_forward_planes(*args, lanes=lanes.long())
    with pytest.raises(ValueError, match="shape"):
        colforward.col_forward_planes(*args, lanes=lanes[:-1].contiguous())
    with pytest.raises(ValueError, match="is on"):
        colforward.col_forward_planes(*args, lanes=lanes.to("meta"))
