"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips without CUDA.  This file imports no jax, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch

from historian_tpu_torch.ops import colforward, tracedp
from historian_tpu_torch.ops.devicedp import sorted_walk_edges

NEG = -1e30
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1_args(S, KY, dtype, dev, seed=3):
    rng = np.random.default_rng(seed)
    y_src = np.clip(np.arange(S)[:, None] - 1 - rng.integers(0, 6, (S, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(S) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (S, KY))
    y_lp[:, 2:] = NEG
    y_null = np.zeros(S, bool)
    y_null[rng.choice(np.arange(1, S), S // 16, replace=False)] = True
    flags = np.stack([y_null, np.arange(S) > 0, rng.normal(-2, 1, S), rng.normal(-2, 1, S)], 1)
    band = np.abs(np.arange(S)[None, :] - np.arange(S)[:, None]) < 20
    xvec = np.stack([rng.normal(-2, 1, S), rng.normal(-2, 1, S), np.zeros(S), np.zeros(S)])

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(flags.astype(float)),
            t(np.where(band, rng.normal(-5, 1, (S, S)), NEG)), t(np.where(band, 0.0, NEG)),
            t(xvec), t(rng.normal(-1, 0.5, 23))), y_null


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-3),
                                             (torch.float64, 1e-9, 1e-9)])
@pytest.mark.parametrize("S,KY", [(200, 4), (1500, 1)])
def test_k1_kernel_matches_plain(cuda, S, KY, dtype, rtol, atol):
    args, _ = _k1_args(S, KY, dtype, cuda)
    before = colforward.LAUNCHES
    got = colforward.col_forward_planes(*args)
    assert colforward.LAUNCHES == before + 1
    ref = colforward.col_forward_planes_plain(*args)
    g, r = got.cpu().double().numpy(), ref.cpu().double().numpy()
    live = r > -1e25
    assert np.array_equal(g > -1e25, live)
    np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)


def test_walker_kernel_matches_plain(cuda):
    S = 300
    args, y_null = _k1_args(S, 4, torch.float64, cuda)
    planes = colforward.col_forward_planes(*args)
    ws, wl = sorted_walk_edges(args[0].cpu().numpy(), args[1].cpu().numpy())
    rng = np.random.default_rng(9)
    tx = rng.normal(-0.1, 0.05, S)
    tx[0] = 0.0
    f64 = dict(dtype=torch.float64, device=cuda)
    walk = (planes, torch.as_tensor(ws, device=cuda), torch.as_tensor(wl, **f64),
            torch.as_tensor(y_null, device=cuda), torch.as_tensor(tx, **f64),
            torch.as_tensor(rng.normal(-1, 0.5, (6, 6)), **f64), S - 1, -0.3,
            torch.tensor([S - 2, S - 1], dtype=torch.int32, device=cuda),
            torch.tensor([-1.0, -0.5], **f64),
            torch.as_tensor(rng.random((5, 2 * S)), **f64),
            torch.tensor([True, False, False, False, False], device=cuda), 2 * S)
    before = tracedp.LAUNCHES
    got = tracedp.pair_trace(*walk)
    assert tracedp.LAUNCHES == before + 1
    ref = tracedp.pair_trace_plain(*walk)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert abs(float(got[5]) - float(ref[5])) < 1e-9
