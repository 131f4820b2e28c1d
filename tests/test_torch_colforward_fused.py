"""Kernel K2's plain version (historian_tpu_torch/ops/colforward.py
`col_forward_planes_fused_plain`) against the JAX package.

- Against the Pallas kernel `pallas_col_forward_cells_fused` in
  interpret mode, float32, on the inputs tests/test_pallas.py builds for
  it (padded grid, CA padded to 24, a real region inside): identical
  liveness, rtol 2e-5, atol 1e-3, K1's tolerances.
- Against the port's K1 route (`fill_planes`: emission matmul, band mask,
  K1) on the same merge in float64, within 1e-9: a leaf-by-leaf merge of
  two long8 sequences banded by a guide envelope (distance 3)."""

import jax.numpy as jnp
import numpy as np
import torch

from historian_tpu.core.alignpath import GuideAlignmentEnvelope
from historian_tpu.core.seqs import read_fasta
from historian_tpu.engine.forward import DPMatrix
from historian_tpu.engine.pairhmm import PairHMM
from historian_tpu.engine.profile import Profile
from historian_tpu.models.presets import named_model
from historian_tpu.models.ratemodel import ProbModel
from historian_tpu.ops.pallas_colforward import pallas_col_forward_cells_fused
from historian_tpu_torch import convert
from historian_tpu_torch import device as devmod
from historian_tpu_torch.engine.quickalign import QuickAligner
from historian_tpu_torch.ops import colforward, devicedp
from tests.test_torch_span import DATA

NEG = -1e30


def _pallas_case():
    """tests/test_pallas.py::test_pallas_col_fused_matches_xla's inputs."""
    SX, SY, KY, CA = 128, 256, 4, 20
    nx, ny = 101, 233
    rng = np.random.default_rng(31)
    dt = np.float32
    ex_f = rng.uniform(0.05, 1.0, (SX, CA)).astype(dt)
    ex_f[nx:] = 0
    ey_f = rng.uniform(0.05, 1.0, (SY, CA)).astype(dt)
    ey_f[ny:] = 0
    shift_x = rng.normal(-1, 0.5, SX).astype(dt)
    shift_x[nx:] = np.float32(NEG)
    shift_y = rng.normal(-1, 0.5, SY).astype(dt)
    shift_y[ny:] = 0
    m1 = np.full(SX, 1 << 29, np.int32)
    m1[:nx] = np.sort(rng.integers(0, 60, nx))
    m2 = np.full(SY, -(1 << 29), np.int32)
    m2[:ny] = np.sort(rng.integers(0, 60, ny))
    xns = np.zeros(SX, bool)
    xns[:3] = True
    yne = np.zeros(SY, bool)
    yne[ny - 2: ny] = True
    rsx, isx = rng.normal(-2, 1, SX).astype(dt), rng.normal(-2, 1, SX).astype(dt)
    rsy, isy = rng.normal(-2, 1, SY).astype(dt), rng.normal(-2, 1, SY).astype(dt)
    trans = rng.normal(-1, 0.5, 23).astype(dt)
    x_ready = np.ones(SX, bool)
    x_ready[-1] = False
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, 6, (SY, KY)), 0, None)
    y_src = y_src.astype(np.int32)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (SY, KY)).astype(dt)
    y_lp[:, 2:] = np.float32(NEG)
    y_null = np.zeros(SY, bool)
    y_null[rng.choice(np.arange(1, ny), 12, replace=False)] = True
    y_ready = np.ones(SY, bool)
    y_ready[0] = False
    y_flags = np.zeros((SY, 8), dt)
    y_flags[:, 0], y_flags[:, 1], y_flags[:, 2], y_flags[:, 3] = y_null, y_ready, rsy, isy
    y_flags[:, 4], y_flags[:, 5], y_flags[:, 6] = m2, yne, shift_y
    xvec = np.zeros((8, SX), dt)
    xvec[0], xvec[1] = rsx, isx
    xvec[2] = np.where(x_ready, 0.0, NEG)
    xvec[3] = 0.0
    xvec[4], xvec[5], xvec[6] = shift_x, m1, xns
    xvec[7, :nx] = 1.0
    ex_t = np.zeros((24, SX), dt)
    ex_t[:CA] = ex_f.T
    ey_p = np.zeros((SY, 24), dt)
    ey_p[:, :CA] = ey_f
    params = np.zeros(32, dt)
    params[:23], params[23], params[24] = trans, 7, ny
    return y_src, y_lp, y_flags, ey_p, ex_t, xvec, params


def test_k2_plain_matches_pallas_fused_interpret():
    args = _pallas_case()
    ref = np.asarray(pallas_col_forward_cells_fused(
        *(jnp.asarray(a) for a in args), interpret=True)).astype(np.float64)
    got = colforward.col_forward_planes_fused(*(torch.as_tensor(a) for a in args))
    got = got.double().numpy()
    live = ref > -1e25
    assert np.array_equal(got > -1e25, live) and live.any() and not live.all()
    np.testing.assert_allclose(got[live], ref[live], rtol=2e-5, atol=1e-3)


def test_k2_plain_matches_k1_route_on_banded_merge():
    devmod.select("cpu")
    model = named_model("lg")
    x, y = read_fasta(f"{DATA}/long8.fa")[:2]
    x.seq, y.seq = x.seq[:150], y.seq[10:170]
    guide = QuickAligner(model, 1.0).align_batch([(x, y, None)])[0].align_path(0, 1)
    a, b = (Profile.from_sequence(model.components, model.alphabet, s, k)
            for k, s in enumerate((x, y)))
    env = GuideAlignmentEnvelope(guide, 0, 1, 3)
    hmm = PairHMM(ProbModel(model, 0.3), ProbModel(model, 0.2), model.ins_prob)
    dp = DPMatrix(a, b, hmm, env)
    arrays = devicedp.fill_arrays(dp)
    ref = devicedp.fill_planes(convert.fill_tensors(arrays, "cpu", torch.float64)).numpy()
    before = colforward.FUSED_LAUNCHES
    got = devicedp.fill_planes_fused(convert.fused_tensors(arrays, "cpu", torch.float64))
    assert colforward.FUSED_LAUNCHES == before  # the CPU takes the plain version
    got = got.numpy()
    live = ref > -1e25
    # the band binds: a good share of the grid is out of it
    assert np.array_equal(got > -1e25, live) and 0.01 < live[0].mean() < 0.5
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-9, atol=1e-9)
