"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips without CUDA.  This file imports no jax, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch

from historian_tpu_torch.ops import colforward, guidedp, tracedp
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


def _k2_args(S, KY, CA, dtype, dev, seed=4):
    """K2's packed inputs: K1's recurrence inputs, random emission factors,
    and a band |m2 - m1| <= 6 around a drifting diagonal, with a few
    x-near-start and y-near-end lanes."""
    args, _ = _k1_args(S, KY, torch.float64, "cpu", seed)
    y_src, y_lp, flags, _, _, xvec4, trans = (a.numpy() for a in args)
    rng = np.random.default_rng(seed)
    y_flags = np.zeros((S, 8))
    y_flags[:, :4] = flags
    y_flags[:, 4] = np.sort(rng.integers(0, S, S))  # m2
    y_flags[S - 3:, 5] = 1.0  # y near end
    y_flags[:, 6] = rng.normal(-1, 0.5, S)  # shift_y
    xvec = np.zeros((8, S))
    xvec[:4] = xvec4
    xvec[4] = rng.normal(-1, 0.5, S)  # shift_x
    xvec[5] = np.arange(S)  # m1
    xvec[6, :2] = 1.0  # x near start
    xvec[7] = 1.0
    params = np.zeros(32)
    params[:23] = trans
    params[23], params[24] = 6, S

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(y_flags), t(rng.uniform(0.05, 1, (S, CA))),
            t(rng.uniform(0.05, 1, (CA, S))), t(xvec), t(params))


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-3),
                                             (torch.float64, 1e-9, 1e-9)])
def test_k2_kernel_matches_plain(cuda, dtype, rtol, atol):
    args = _k2_args(300, 4, 20, dtype, cuda)
    before = colforward.FUSED_LAUNCHES
    got = colforward.col_forward_planes_fused(*args)
    assert colforward.FUSED_LAUNCHES == before + 1
    ref = colforward.col_forward_planes_fused_plain(*args)
    g, r = got.cpu().double().numpy(), ref.cpu().double().numpy()
    live = r > -1e25
    assert np.array_equal(g > -1e25, live) and live.any() and not live.all()
    np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)


def guide_args(lengths, A=20, seed=6, full=False):
    """numpy inputs of the guide kernel for pairs of the given (x, y)
    lengths: random tokens (a few wildcards), a random band of diagonals
    around 0 (or every diagonal), random scores."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    PX = max(x for x, _ in lengths)
    PY = max(y for _, y in lengths)
    x_tok = np.full((B, PX), -1, np.int32)
    y_tok = np.full((B, PY), -1, np.int32)
    lut = np.zeros((B, PX + PY + 1), bool)
    end_x, end_y = np.zeros((B, PX + 1)), np.zeros((B, PY + 1))
    for b, (X, Y) in enumerate(lengths):
        x_tok[b, :X] = np.where(rng.random(X) < 0.02, -1, rng.integers(0, A, X))
        y_tok[b, :Y] = np.where(rng.random(Y) < 0.02, -1, rng.integers(0, A, Y))
        d = np.arange(1 - Y, X)
        keep = full | (np.abs(d - rng.integers(-5, 6)) <= 12) | (rng.random(len(d)) < 0.05)
        lut[b, d[keep] + PY] = True
        end_x[b, : X + 1] = -0.7 - 0.1 * (X - np.arange(X + 1))
        end_y[b, : Y + 1] = -0.7 - 0.1 * (Y - np.arange(Y + 1))
    trans = np.array([-0.2, -2.5, -2.9, -0.4, -1.3, -3.1, -0.4, -1.3, 0.0, 0.0])
    sg = -1.1 - 0.1 * np.arange(max(PX, PY) + 1)
    return dict(x_tok=x_tok, y_tok=y_tok, lut=lut,
                x_len=np.array([x for x, _ in lengths], np.int32),
                y_len=np.array([y for _, y in lengths], np.int32),
                submat=rng.normal(-0.5, 1.5, (A, A)), trans=trans, sg=sg,
                end_x=end_x, end_y=end_y)


GUIDE_ORDER = ("x_tok", "y_tok", "lut", "x_len", "y_len", "submat", "trans", "sg", "end_x", "end_y")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_guide_kernel_matches_plain(cuda, dtype):
    from historian_tpu_torch import convert

    t = convert.guide_tensors(guide_args([(240, 300), (310, 260), (1, 5), (7, 1), (200, 200)]),
                              cuda, dtype)
    args = [t[k] for k in GUIDE_ORDER]
    before = guidedp.LAUNCHES
    got = guidedp.guide_align(*args)
    assert guidedp.LAUNCHES == before + 1
    ref = guidedp.guide_align_plain(*args)
    for name, a, b in zip(("steps", "n_steps", "x_end", "y_end", "lead_i", "lead_j", "score"),
                          got, ref):
        assert torch.equal(a, b), name
