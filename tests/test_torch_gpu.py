"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips without CUDA.  This file imports no jax, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py imports jax.)
"""

import os

import numpy as np
import pytest
import torch

from historian_tpu_torch.ops import (
    _kernels,
    colforward,
    guidedp,
    pairforward,
    sp_colforward,
    tracedp,
)
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
            torch.as_tensor(rng.random(4 * 2 * S), **f64), True, 4, 2 * S)
    before = tracedp.LAUNCHES
    got = tracedp.pair_trace(*walk)
    assert tracedp.LAUNCHES == before + 1
    ref = tracedp.pair_trace_plain(*walk)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert abs(float(got[5]) - float(ref[5])) < 1e-9


def _walk_args(SX, SY, KY, T, dtype, dev, seed=13, exact=False, filled=False):
    """Walker arguments on random planes [5, SY, SX] (a few NEG cells):
    y in-edges up to 6 rows back (KY of them, sorted as the bridge sorts
    them), nulls when KY > 1, two end in-edges, a best walk and T - 1
    sampled walks over one buffer of (T - 1) L draws.  exact: planes,
    transitions and edge weights 0, so that every candidate weight is 0 or
    1, and uniforms in {0, 1/4, 1/2, 3/4, 1}, so that p = u * ptot falls
    exactly on 0 after a subtraction (and at u = 0 the first candidate of
    positive weight must win).  filled: the planes and y side of a K1 fill
    over the full grid instead, whose NEG cells keep a walk inside the
    grid on the smallest shapes."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(-8, 3, (5, SY, SX))
    planes[rng.random(planes.shape) < 0.05] = NEG
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, 6, (SY, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (SY, KY))
    y_null = np.zeros(SY, bool)
    if KY > 1 and SY > 2:
        y_null[rng.choice(np.arange(1, SY), max(SY // 16, 1), replace=False)] = True
    if filled:
        k1, _ = _k1_rect(SX, SY, KY, np.ones((SY, SX), bool), torch.float64, dev, seed)
        planes = colforward.col_forward_planes(*k1).cpu().numpy()
        y_src, y_lp = k1[0].cpu().numpy(), k1[1].cpu().numpy()
        y_null = k1[2][:, 0].cpu().numpy() > 0.5
    tx, t6 = rng.normal(-0.1, 0.05, SX), rng.normal(-1, 0.5, (6, 6))
    tx[0] = 0.0
    xe_lp, ye_lp = -0.3, rng.normal(-1, 0.3, 2)
    L = SX + SY
    u = rng.random(max(T - 1, 1) * L)
    if exact:
        planes[:] = 0.0
        y_lp[:], tx[:], t6[:], ye_lp[:], xe_lp = 0.0, 0.0, 0.0, 0.0, 0.0
        u = rng.integers(0, 5, u.shape) / 4
    ws, wl = sorted_walk_edges(y_src.astype(np.int32), y_lp)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    ye = np.array([max(SY - 2, 0), SY - 1], np.int32)
    return (t(planes), t(ws, torch.int32), t(wl), t(y_null, torch.bool), t(tx), t(t6), SX - 1,
            xe_lp, t(ye, torch.int32), t(ye_lp), t(u), True, T - 1, L)


WALK_CASES = {
    # name: (SX, SY, KY, T, exact, filled)
    "best only": (700, 650, 1, 1, False, False),
    "33 walks": (240, 260, 4, 33, False, False),
    "KY 7, two rounds": (300, 280, 7, 3, False, False),
    "exact boundaries": (150, 170, 4, 9, True, False),
    "two rows": (90, 2, 1, 4, False, True),
    "one column": (2, 80, 3, 4, False, True),
    # a y side too large for shared memory: the kernel reads it from
    # device memory, on the one-round path (KY 5) and in rounds (KY 7);
    # filled, since a random walk on so narrow an x leaves the grid
    "y side in device memory": (64, 6000, 5, 2, False, True),
    "y side in device memory, KY 7": (64, 4500, 7, 2, False, True),
}


def y_side_fits(SX, SY, KY, dtype, dev) -> bool:
    """Whether the walker stages the y side in shared memory: its bytes
    (y_lp, tx, t6, y_src, y_null) under the card's per-block limit, less
    the kernel's other shared memory (under 2 KB)."""
    item = torch.finfo(dtype).bits // 8
    y_side = (SY * KY + SX + 36) * item + SY * KY * 4 + SY
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    return y_side + 2048 <= limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_walker_cases_match_plain(cuda, name, dtype):
    """The warp-per-walk kernel against the plain walker, with the y side
    in shared or in device memory: paths, values and step counts
    identical."""
    SX, SY, KY, T, exact, filled = WALK_CASES[name]
    assert y_side_fits(SX, SY, KY, dtype, cuda) == ("device memory" not in name)
    walk = _walk_args(SX, SY, KY, T, dtype, cuda, exact=exact, filled=filled)
    before = tracedp.LAUNCHES
    got = tracedp.pair_trace(*walk)
    assert tracedp.LAUNCHES == before + 1
    ref = tracedp.pair_trace_plain(*walk)
    for what, a, b in zip(("pi", "pj", "ps", "vals", "n_steps"), got[:5], ref[:5]):
        assert torch.equal(a, b), (name, what)
    assert abs(float(got[5]) - float(ref[5])) <= 1e-9 * max(1.0, abs(float(ref[5])))


def _long12_first_merge() -> tuple:
    """(SX, SY) of long12's first merge, t01 x t02: START plus the residues."""
    from historian_tpu_torch.core.seqs import read_fasta

    seqs = {s.name: s.seq for s in read_fasta(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "long12.fa"))}
    return len(seqs["t01"]) + 1, len(seqs["t02"]) + 1


SAMPLED_CASES = {
    # name: (SX, SY, KY, T), on filled planes; every case's second sampled
    # walk starts inside the L draws the first could have taken
    "long12 first merge": (*_long12_first_merge(), 1, 4),
    "DAG y, KY 7": (420, 400, 7, 6),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SAMPLED_CASES))
def test_walker_sampled_walks_in_order(cuda, name, dtype):
    """The best walk and T - 1 sampled walks in one launch: the sampled
    walks one after another over one draw buffer, walk t from where walk
    t - 1 stopped.  Paths, values and step counts identical to the plain
    walker's, and each sampled walk the same as one walked alone from its
    offset."""
    SX, SY, KY, T = SAMPLED_CASES[name]
    walk = _walk_args(SX, SY, KY, T, dtype, cuda, seed=21, filled=True)
    before = tracedp.LAUNCHES
    got = tracedp.pair_trace(*walk)
    assert tracedp.LAUNCHES == before + 1
    ref = tracedp.pair_trace_plain(*walk)
    for what, a, b in zip(("pi", "pj", "ps", "vals", "n_steps"), got[:5], ref[:5]):
        assert torch.equal(a, b), (name, what)
    n_steps = got[4].tolist()
    L = walk[-1]
    assert all(0 < n < L for n in n_steps)  # every walk ends at the start cell
    off = n_steps[1]  # the second sampled walk reads from inside the first's L
    alone = tracedp.pair_trace(*walk[:10], walk[10][off:].contiguous(), False, 1, L)
    for a, b in zip(alone[:5], got[:5]):
        assert torch.equal(a[0], b[2])


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


def _guide_case(name):
    """guide_args for the card's edge cases of the rank-space kernel."""
    if name == "full":  # every diagonal: ND = X + Y - 1 > X
        return guide_args([(90, 130), (140, 70)], seed=7, full=True)
    if name == "single diagonal":
        a = guide_args([(80, 100), (100, 80), (3, 1)], seed=8)
        a["lut"][:] = False
        a["lut"][:, 2 + a["y_tok"].shape[1]] = True
        return a
    if name == "unequal lengths":
        return guide_args([(400, 120), (35, 500), (1, 1), (260, 260), (9, 300)], seed=9)
    if name == "run breaks at the edge":
        # runs of diagonals that cross each pair's last diagonals, X - 1 and
        # 1 - Y, and a pair whose band misses its grid altogether
        lengths = [(60, 200), (200, 60), (150, 150), (20, 30)]
        a = guide_args(lengths, seed=10)
        PY = a["y_tok"].shape[1]
        for b, (X, Y) in enumerate(lengths[:3]):
            a["lut"][b, max(X - 8, 0) + PY: X + 6 + PY] = True
            a["lut"][b, 1 - Y - 5 + PY: 1 - Y + 4 + PY] = True
        a["lut"][3] = False
        a["lut"][3, 40 + PY] = True
        return a
    if name == "several tiles":  # ND > 1024: a column takes several tiles
        return guide_args([(700, 700), (650, 720)], seed=12, full=True)
    raise KeyError(name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["full", "single diagonal", "unequal lengths",
                                  "run breaks at the edge", "several tiles"])
def test_guide_rank_space_cases(cuda, name, dtype):
    from historian_tpu_torch import convert

    t = convert.guide_tensors(_guide_case(name), cuda, dtype)
    args = [t[k] for k in GUIDE_ORDER]
    nd = guidedp.diagonal_ranks(t["lut"], t["x_len"], t["y_len"], t["y_tok"].shape[1])["nd"]
    if name == "full":
        assert bool((nd > t["x_len"]).all())
    if name == "several tiles":
        assert int(nd.min()) > 1024
    before = guidedp.LAUNCHES
    got = guidedp.guide_align(*args)
    assert guidedp.LAUNCHES == before + 1
    ref = guidedp.guide_align_plain(*args)
    for what, a, b in zip(("steps", "n_steps", "x_end", "y_end", "lead_i", "lead_j", "score"),
                          got, ref):
        assert torch.equal(a, b), (name, what)


def _pf_args(B, X1, Y1, dtype, dev, seed=8):
    """K3/K4 arguments: random emissions with the boundary row and column
    at -inf, as float32 arrays of chain_pair_forward_arrays have them."""
    rng = np.random.default_rng(seed)
    absorb = rng.normal(-5, 1, (B, X1, Y1))
    absorb[:, 0, :] = absorb[:, :, 0] = -np.inf
    vx = rng.normal(-3, 1, (2, B, X1))
    vy = rng.normal(-3, 1, (2, B, Y1))
    vx[:, :, 0] = vy[:, :, 0] = -np.inf

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return t(absorb), t(vx[0]), t(vy[0]), t(vx[1]), t(vy[1]), t(rng.normal(-1, 0.5, 23))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-9)])
@pytest.mark.parametrize("B,X1,Y1", [(5, 70, 100), (3, 60, 1500), (2, 1, 40)])
def test_pairforward_kernels_match_plain(cuda, B, X1, Y1, dtype, rtol):
    """K3 and K4 (x_tile 16: several tiles, the last one partial) against
    their plain version; 1500 lanes take several lane tiles a row."""
    args = _pf_args(B, X1, Y1, dtype, cuda)
    ref = pairforward.pair_forward_lp_plain(*args).cpu().double()
    k3, k4 = pairforward.LAUNCHES, pairforward.TILED_LAUNCHES
    got3 = pairforward.pair_forward_lp(*args)
    got4 = pairforward.pair_forward_lp_tiled(*args, x_tile=16)
    torch.cuda.synchronize()
    assert (pairforward.LAUNCHES, pairforward.TILED_LAUNCHES) == (k3 + 1, k4 + 1)
    assert torch.isfinite(ref).all()
    for got in (got3, got4):
        err = (got.cpu().double() - ref).abs()
        assert bool((err <= rtol * ref.abs()).all()), (err.max().item(), ref.tolist())


def _lp_close(got, ref, rtol):
    """Identical liveness (an lp below -1e25 is the semiring zero), then
    within rtol of |lp|."""
    got, ref = got.cpu().double(), ref.cpu().double()
    dead = ref < -1e25
    assert torch.equal(got < -1e25, dead), (got.tolist(), ref.tolist())
    err = (got - ref).abs()[~dead]
    assert bool((err <= rtol * ref.abs()[~dead]).all()), (err.max().item(), ref.tolist())


PF_EDGE_Y1 = [1, 2, 31, 32, 33, 385, 1024, 1025, 3001, "max"]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-9)])
@pytest.mark.parametrize("y1", PF_EDGE_Y1)
def test_pairforward_edge_cases(cuda, y1, dtype, rtol):
    """K3 and K4 (x_tile 1, 16 and X1) at the edges of the warp pipe: one
    lane, lanes around a warp and around 1024, the widest block; one,
    two and 70 rows; one pair.  Each kernel runs 4 times: every run equal
    to the first (a stale handoff shows now and then), the first within
    tolerance of the plain version."""
    Y1 = pairforward.MAX_LANES[dtype] if y1 == "max" else y1
    for X1 in (1, 2, 70):
        args = _pf_args(1, X1, Y1, dtype, cuda, seed=Y1 + X1)
        ref = pairforward.pair_forward_lp_plain(*args)
        runs = {"K3": lambda: pairforward.pair_forward_lp(*args)}
        for x_tile in (1, 16, X1):
            runs[f"K4 x_tile {x_tile}"] = \
                lambda x_tile=x_tile: pairforward.pair_forward_lp_tiled(*args, x_tile=x_tile)
        for what, fn in runs.items():
            outs = [fn() for _ in range(4)]
            torch.cuda.synchronize()
            for o in outs[1:]:
                assert torch.equal(o, outs[0]), (what, X1, Y1)
            _lp_close(outs[0], ref, rtol)


def test_pairforward_block_shapes(cuda):
    """The launcher's block shapes, as kernel_attrs reads them: the
    fewest lanes a thread of {1, 2, 4, 6, 8} within 32 warps (16 in
    float64), then the fewest warps; K3 and K4 alike; MAX_LANES fills the
    widest block."""
    f32, f64 = torch.float32, torch.float64
    shapes = {(1, f32): (1, 1), (33, f32): (1, 2), (385, f32): (1, 13), (1024, f32): (1, 32),
              (1025, f32): (2, 17), (1500, f32): (2, 24), (3001, f32): (4, 24),
              (5000, f32): (6, 27), (8192, f32): (8, 32), (385, f64): (1, 13),
              (513, f64): (2, 9), (1500, f64): (4, 12), (3001, f64): (6, 16),
              (4096, f64): (8, 16)}
    for (y1, dtype), shape in shapes.items():
        for tiled in (False, True):
            at = pairforward.kernel_attrs(y1, dtype, tiled)
            assert (at["lanes_per_thread"], at["warps"]) == shape, (y1, dtype, tiled)
            assert at["registers"] > 0
    assert [pairforward.MAX_LANES[dt] for dt in (f32, f64)] == [8192, 4096]


def _k1_rect(SX, SY, KY, mask, dtype, dev, seed=11):
    """K1 inputs on an SX x SY grid with the band `mask` [SY, SX] and its
    lanes: y in-edges up to 6 columns back, nulls when KY > 1."""
    rng = np.random.default_rng(seed)
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, 6, (SY, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (SY, KY))
    y_lp[:, 2:] = NEG
    y_null = np.zeros(SY, bool)
    if KY > 1:
        y_null[rng.choice(np.arange(1, SY), SY // 16, replace=False)] = True
    flags = np.stack([y_null, np.arange(SY) > 0, rng.normal(-2, 1, SY), rng.normal(-2, 1, SY)], 1)
    x_ready = np.arange(SX) < SX - 1
    xvec = np.stack([rng.normal(-2, 1, SX), rng.normal(-2, 1, SX),
                     np.where(x_ready, 0.0, NEG), np.zeros(SX)])

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    args = (t(y_src, torch.int32), t(y_lp), t(flags.astype(float)),
            t(np.where(mask, rng.normal(-5, 1, (SY, SX)), NEG)), t(np.where(mask, 0.0, NEG)),
            t(xvec), t(rng.normal(-1, 0.5, 23)))
    return args, colforward.lanes_from_mask(torch.as_tensor(mask, device=dev))


def _band(SX, SY, starts, width):
    """mask [SY, SX]: lanes [starts[j], starts[j] + width) of column j."""
    lane = np.arange(SX)[None, :]
    lo = np.asarray(starts)[:, None]
    return (lane >= lo) & (lane < lo + width)


def _check_repeated(fn, plain, rtol, atol, reps=4):
    """The kernel `reps` times against its plain version: every run
    identical to the first (a stale read across strips shows as a
    difference now and then), the first one within tolerance with
    identical liveness.  Returns the launch record of the last run."""
    runs = [fn() for _ in range(reps)]
    torch.cuda.synchronize()
    launch = dict(colforward.LAST_LAUNCH, active_share=colforward.active_share(
        colforward.LAST_LAUNCH))
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    g, r = runs[0].cpu().double().numpy(), plain().cpu().double().numpy()
    live = r > -1e25
    assert np.array_equal(g > -1e25, live)
    np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)
    return launch


TOLS = [(torch.float32, 2e-5, 1e-3), (torch.float64, 1e-9, 1e-9)]


def _strip_cases(ns):
    """(name, SX, SY, KY, band starts, band width) of the strip pipeline's
    edge cases at strip width ns; width None: no lanes (every lane)."""
    SY = 160
    j = np.arange(SY)
    return [
        ("partial last strip", 3 * ns + 37, SY, 4, None, None),
        ("one strip", ns // 2 + 5, SY, 4, None, None),
        # the band steps by half a strip every 4 columns, so every other
        # step starts it at a strip boundary: the halo lane's strip idles
        # in that column but was in the band in the column before
        ("band at a strip boundary", 6 * ns, SY, 1, np.minimum(j // 4, 9) * (ns // 2), ns // 2),
        # the band jumps three strips between two columns
        ("band jumps strips", 8 * ns, SY, 4, np.where(j < SY // 2, ns // 3, 4 * ns + ns // 3),
         ns // 2),
        ("diagonal band", 5 * ns + 11, SY, 4, j * (5 * ns) // SY, 24),
    ]


@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_k1_strip_edge_cases(cuda, dtype, rtol, atol):
    ns = colforward.STRIP_WIDTH
    for name, SX, SY, KY, starts, width in _strip_cases(ns):
        mask = np.ones((SY, SX), bool) if starts is None else _band(SX, SY, starts, width)
        args, lanes = _k1_rect(SX, SY, KY, mask, dtype, cuda)
        use = None if starts is None else lanes
        launch = _check_repeated(lambda: colforward.col_forward_planes(*args, lanes=use),
                                 lambda: colforward.col_forward_planes_plain(*args), rtol, atol)
        assert launch["ns"] == ns and launch["strips"] == -(-SX // ns), name
        if starts is not None:
            assert launch["active_share"] < 0.9, (name, launch)


def _k2_rect(SX, SY, KY, dtype, dev, m1, dist=6, seed=12):
    """K2's packed inputs on an SX x SY grid: m1 given, m2 = a sorted draw
    over m1's range, x near start on lanes 0-1, y near end on the last 3
    rows, nulls when KY > 1, x_in_range off on the last 5 lanes, ny = SY - 2."""
    args, _ = _k1_rect(SX, SY, KY, np.ones((SY, SX), bool), torch.float64, "cpu", seed)
    y_src, y_lp, flags, _, _, xvec4, trans = (a.numpy() for a in args)
    rng = np.random.default_rng(seed)
    y_flags = np.zeros((SY, 8))
    y_flags[:, :4] = flags
    y_flags[:, 4] = np.sort(rng.integers(int(m1.min()), int(m1.max()) + 1, SY))
    y_flags[SY - 3:, 5] = 1.0
    y_flags[:, 6] = rng.normal(-1, 0.5, SY)
    xvec = np.zeros((8, SX))
    xvec[:4] = xvec4
    xvec[4] = rng.normal(-1, 0.5, SX)
    xvec[5] = m1
    xvec[6, :2] = 1.0
    xvec[7, : SX - 5] = 1.0
    params = np.zeros(32)
    params[:23] = trans
    params[23], params[24] = dist, SY - 2

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(y_flags), t(rng.uniform(0.05, 1, (SY, 20))),
            t(rng.uniform(0.05, 1, (20, SX))), t(xvec), t(params))


@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_k2_strip_edge_cases(cuda, dtype, rtol, atol):
    """K2 with y-near-end rows, rows past ny, null columns (KY = 4), a
    partial last strip, and a non-monotone m1 (every column full)."""
    ns = colforward.STRIP_WIDTH
    for monotone in (True, False):
        SX, SY = 4 * ns + 21, 200
        m1 = np.arange(SX) // 2
        if not monotone:
            m1[SX // 2], m1[SX // 2 + 1] = m1[SX // 2 + 1] + 1, m1[SX // 2]
        args = _k2_rect(SX, SY, 4, dtype, cuda, m1)
        before = colforward.nonmonotone_m1()
        launch = _check_repeated(lambda: colforward.col_forward_planes_fused(*args),
                                 lambda: colforward.col_forward_planes_fused_plain(*args),
                                 rtol, atol)
        assert launch["strips"] == -(-SX // ns) and launch["ns"] == ns
        if monotone:
            assert colforward.nonmonotone_m1() == before and launch["active_share"] < 0.9
        else:
            # every column full but the two past ny
            assert colforward.nonmonotone_m1() > before
            assert launch["active_share"] == pytest.approx((SY - 2) / SY)


def test_strip_launch_raises_when_strips_cannot_be_resident(cuda):
    """More strips than the card holds at once: the wrapper raises before
    launching; the kernel library refuses a width it lacks."""
    ns = colforward.STRIP_WIDTH
    cap = colforward._capacity("colforward", torch.float32, ns, 0, torch.cuda.current_device())
    assert cap > 0
    SX = ns * cap + 1
    args, _ = _k1_rect(SX, 2, 1, np.ones((2, SX), bool), torch.float32, cuda)
    before = colforward.LAUNCHES
    with pytest.raises(RuntimeError, match="holds"):
        colforward.col_forward_planes(*args)
    assert colforward.LAUNCHES == before
    small, _ = _k1_rect(100, 2, 1, np.ones((2, 100), bool), torch.float32, cuda)
    out = torch.empty((5, 2, 100), device=cuda)
    buffers = (torch.zeros(1, dtype=torch.int32, device=cuda), torch.empty((1, 2, 4), device=cuda))
    code = _kernels.lib().colforward_f32(
        *(t.data_ptr() for t in small), 0, *(t.data_ptr() for t in buffers), out.data_ptr(),
        2, 100, 1, ns // 2, torch.cuda.current_stream().cuda_stream)
    assert code != 0


def test_k2_wide_emission_takes_a_narrower_strip(cuda):
    """CA = 256 in float64: a [CA, NS] slice of ex_t fits shared memory only
    at NS = 64, so the wrapper falls back to it, here over 5 strips, each
    run 4 times; CA = 257 raises."""
    args = _k2_args(300, 4, 256, torch.float64, cuda)
    launch = _check_repeated(lambda: colforward.col_forward_planes_fused(*args),
                             lambda: colforward.col_forward_planes_fused_plain(*args), 1e-9, 1e-9)
    assert launch["ns"] == colforward.NARROW_STRIP_WIDTH == 64 and launch["strips"] == 5
    assert launch["active_share"] < 0.9
    wide = _k2_args(300, 4, 257, torch.float64, cuda)
    with pytest.raises(ValueError, match="emission factors"):
        colforward.col_forward_planes_fused(*wide)


# ---------------------------------------------------------------- sum-product
SP_TREE = "(((a:0.3,b:0.05):0.2,c:0.7):0.1,(d:0.01,(e:0.4,f:0.2):0.15):0.25)r;"
#: float64 on the card against float64 on the CPU: the products and sums
#: run in another order (cuBLAS against the CPU's BLAS), ~L eps apart
SP_RTOL = 1e-11


def _sp_model(name):
    """`lg`, or `complex`: ECMunrest plus a cyclic non-reversible term, a
    complex spectrum (as tests/test_torch_felsenstein.py builds it)."""
    from historian_tpu_torch.models.presets import named_model

    model = named_model("lg" if name == "lg" else "ECMunrest")
    if name == "complex":
        rng = np.random.default_rng(11)
        rate = model.sub_rate.copy()
        idx = np.arange(rate.shape[1])
        rate[0, idx, (idx + 1) % rate.shape[1]] += 2.0 + rng.random(rate.shape[1])
        np.fill_diagonal(rate[0], 0.0)
        np.fill_diagonal(rate[0], -rate[0].sum(axis=1))
        model.sub_rate = rate
    return model


def _sp_rows(model, tree, L, seed):
    rng = np.random.default_rng(seed)
    syms = np.array([model.alphabet.symbol(i) for i in range(model.alphabet.size)])
    return ["".join(np.where(rng.random(L) < 0.15, "-", syms[rng.integers(0, len(syms), L)]))
            if tree.is_leaf(n) else "*" * L for n in range(tree.n_nodes())]


@pytest.mark.parametrize("name", ["lg", "complex"])
def test_sumprod_passes_on_card_match_cpu(cuda, name):
    """The torch route of the sum-product engine on the card against the
    same code on the CPU: up and down passes, posteriors, ancestral rows,
    and the eigencount contraction (real for lg, complex128 otherwise),
    with every route counted on CUDA."""
    from historian_tpu_torch.core.tree import Tree
    from historian_tpu_torch.engine import sumprod

    model = _sp_model(name)
    tree = Tree(SP_TREE)
    rows = _sp_rows(model, tree, 1500, seed=4)
    w = np.random.default_rng(5).random(1500)
    out = {}
    sumprod.ROUTES.clear()
    for dev in (torch.device("cpu"), cuda):
        eng = sumprod.SumProductEngine(model, tree, dev)
        eng.NATIVE_FILL_MAX_CELLS = 0
        fill = eng.fill(rows)
        c, a = model.components, model.alphabet_size
        root, eig = np.zeros((c, a)), np.zeros((c, a, a), complex)
        fill.accumulate_eigen_counts(root, eig, w)
        out[dev.type] = dict(fill=fill, root=root, eig=eig, anc=fill.ancestral_gapped_rows(rows),
                             lnpp=fill.log_node_post_prob_all())
    kind = "real" if name == "lg" else "complex"
    assert sumprod.ROUTES == {f"{what}:{d}": 1 for what in ("fill", "down", "post")
                              for d in ("cpu", "cuda")} | {f"counts:cpu:{kind}": 1,
                                                           f"counts:cuda:{kind}": 1}
    ref, got = out["cpu"], out["cuda"]
    assert got["fill"].tensor("F").is_cuda
    for k in ("F", "logF", "E", "logE", "G", "logG", "cpt_ll", "col_ll"):
        np.testing.assert_allclose(getattr(got["fill"], k), getattr(ref["fill"], k),
                                   rtol=SP_RTOL, atol=1e-300, err_msg=k)
    np.testing.assert_allclose(got["lnpp"], ref["lnpp"], rtol=SP_RTOL, atol=1e-12)
    assert got["anc"] == ref["anc"]
    for k in ("root", "eig"):
        np.testing.assert_allclose(got[k], ref[k], rtol=SP_RTOL, atol=1e-12 * np.abs(ref[k]).max())


# -------------------------------------------------------------- full band
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fullband_gather_matches_full_readback(cuda, dtype):
    """The full-band route's readback (ops/devicedp.py `read_band`: the
    in-envelope cells gathered on the card, one copy into pinned memory,
    scattered into the host grid) against the whole planes copied to the
    host: the band's cells bit for bit (the semiring zero read as -inf),
    every other cell -inf; with no envelope, every cell."""
    from historian_tpu_torch.ops import devicedp, readback

    S = 1500
    args, _ = _k1_args(S, 4, dtype, cuda)
    planes = colforward.col_forward_planes(*args)
    mask = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :]) < 20  # [nx, ny]

    class Merge:  # the attributes read_band reads of a DPMatrix
        x_size = y_size = S + 1
        env_mask, env_vectors = np.pad(mask, ((0, 1), (0, 1))), ()

    full = planes.permute(2, 1, 0).cpu().double().numpy()
    full[full < devicedp.NEG_CUTOFF] = -np.inf
    n_read = len(readback.READBACKS)
    out = np.full((S + 1, S + 1, 5), -np.inf)
    devicedp.read_band(planes, Merge, out)
    np.testing.assert_array_equal(out[:S, :S][mask], full[mask])
    assert np.isneginf(out[:S, :S][~mask]).all() and np.isfinite(full[mask]).any()
    read = readback.READBACKS[-1]
    assert len(readback.READBACKS) == n_read + 1 and read["cells"] == mask.sum()
    assert read["kind"] == "merge"
    assert read["bytes"] == mask.sum() * 5 * planes.element_size() and read["ms"] > 0
    Merge.env_vectors = None
    out[:] = -np.inf
    devicedp.read_band(planes, Merge, out)
    np.testing.assert_array_equal(out[:S, :S], full)


def _port_merge(kind):
    """A merge of the port's own classes (this file imports no jax): a leaf
    of tests/data/long8.fa cut to 300 aa against another leaf ("chain") or
    against a sampled profile of two more leaves ("dag", built on the
    CPU), with the sum-product engine of its tree."""
    from historian_tpu_torch.core.seqs import read_fasta
    from historian_tpu_torch.core.tree import Tree
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.engine.pairhmm import PairHMM
    from historian_tpu_torch.engine.profile import Profile
    from historian_tpu_torch.engine.sumprod import SumProductEngine
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.models.ratemodel import ProbModel
    from historian_tpu_torch.utils.rng import MT19937

    tree = Tree("(t2:0.15,(t0:0.3,t1:0.2)n:0.25)r;" if kind == "dag" else "(t0:0.12,t1:0.2)r;")
    model = named_model("lg")
    seqs = read_fasta(os.path.join(os.path.dirname(__file__), "data", "long8.fa"))[:3]
    by_name = {f"t{k}": s for k, s in enumerate(seqs)}
    for s in seqs:
        s.seq = s.seq[:300]
    strategy = (forward.COLLAPSE_CHAINS | forward.COUNT_SUBST_EVENTS
                | forward.COUNT_INDEL_EVENTS | forward.INCLUDE_BEST_TRACE)
    sumprod = SumProductEngine(model, tree)

    def hmm(node):
        l, r = tree.children(node)
        return PairHMM(ProbModel(model, tree.branch_length(l)),
                       ProbModel(model, tree.branch_length(r)), model.ins_prob)

    prof = {}
    for node in range(tree.n_nodes()):
        if tree.is_leaf(node):
            prof[node] = Profile.from_sequence(model.components, model.alphabet,
                                               by_name[tree.node_name(node)], node)
        elif node != tree.root():
            l, r = tree.children(node)
            child = forward.ForwardMatrix(prof[l], prof[r], hmm(node), node, None, sumprod)
            prof[node] = child.sample_profile(MT19937(5489), 10, 0, strategy)
    l, r = tree.children(tree.root())
    return prof[l], prof[r], hmm(tree.root()), tree.root(), sumprod, strategy


@pytest.mark.parametrize("kind", ["chain", "dag"])
def test_card_backward_matches_cpu(cuda, kind):
    """A full-band merge on the card (K1 in float64, the band read back)
    against the same merge on the CPU (K1's plain version): the Forward and
    Backward cells to 1e-9, the same posterior and best profiles, and the
    expected counts to 1e-9."""
    from historian_tpu_torch import device
    from historian_tpu_torch.engine import forward

    device.select("cpu")
    x, y, hmm, row, sumprod, strategy = _port_merge(kind)
    out = {}
    try:
        for platform in ("gpu", "cpu"):
            device.select(platform)
            before = colforward.LAUNCHES
            fwd = forward.ForwardMatrix(x, y, hmm, row, None, sumprod)
            assert fwd.route == "fullband"
            assert colforward.LAUNCHES == before + (platform == "gpu")
            bwd = forward.BackwardMatrix(fwd)
            out[platform] = dict(
                fwd=fwd.cells.copy(), bwd=bwd.cells.copy(), lp=fwd.lp_end, start=bwd.lp_start,
                post=bwd.post_prob_profile(0.01, 0, strategy).to_json(),
                best=bwd.best_profile(strategy).to_json(), counts=bwd.get_counts())
            del fwd, bwd
    finally:
        device.select("cpu")
    got, ref = out["gpu"], out["cpu"]
    for k in ("fwd", "bwd"):
        assert np.array_equal(np.isfinite(got[k]), np.isfinite(ref[k]))
        live = np.isfinite(ref[k])
        np.testing.assert_allclose(got[k][live], ref[k][live], rtol=1e-9, atol=1e-9)
    assert got["lp"] == pytest.approx(ref["lp"], rel=1e-12)
    assert got["start"] == pytest.approx(ref["start"], rel=1e-12)
    assert got["post"] == ref["post"] and got["best"] == ref["best"]
    for k in ("root_count", "eigen_count"):
        np.testing.assert_allclose(getattr(got["counts"], k), getattr(ref["counts"], k),
                                   rtol=1e-9, atol=1e-12)
    assert got["counts"].indel.ins == pytest.approx(ref["counts"].indel.ins, rel=1e-9)


def _branch_inputs(X1, Y1, band, seed):
    """Seeded (emit, ins, mask, trans) of a branch fill: NEG on row and
    column 0, a cumulative-match band (-1: full; -2: a random mask with
    holes), boundary lines in."""
    rng = np.random.default_rng(seed)
    emit = rng.normal(-4.0, 1.5, (X1, Y1))
    emit[0, :] = emit[:, 0] = NEG
    ins = np.concatenate([[NEG], rng.normal(-3.0, 0.5, Y1 - 1)])
    if band == -2:  # holes anywhere
        mask = rng.random((X1, Y1)) < 0.3
    elif band < 0:
        mask = np.ones((X1, Y1), dtype=bool)
    else:
        m1, m2 = np.cumsum(rng.random(X1) < 0.8), np.cumsum(rng.random(Y1) < 0.8)
        mask = np.abs(m1[:, None] - m2[None, :]) <= band
    mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
    p = rng.dirichlet([8, 1, 1], 3)
    trans = np.log(np.array([p[0, 0], p[0, 1], p[0, 2], p[1, 0], p[1, 1], p[1, 2],
                             p[2, 0] + p[2, 1], p[2, 2]]))
    return emit, ins, mask, trans


BRANCH_SHAPES = [(1, 1, -1), (1, 40, -1), (40, 1, -1), (2, 2, -1), (3, 3, 0), (37, 53, -1),
                 (130, 97, 6), (1100, 1300, 20), (2100, 90, 3), (1300, 1100, -1),
                 (200, 230, -2), (700, 650, 200)]


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", BRANCH_SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in BRANCH_SHAPES])
def test_branchfill_kernel_matches_host_and_plain(cuda, shape, viterbi):
    """Kernel (e) against csrc/fill.cpp `branch_fill` (Viterbi: bit for bit;
    Forward: 1e-12 relative, the card's exp and log1p against glibc's) and
    against its plain version (1e-12 relative); outside the mask every
    state is NEG.  Diagonals longer than a block (1300 x 1100), a mask with
    holes, grids of one row or column, a ring of seven warps (700 x 650)
    included."""
    from historian_tpu_torch.native import get_native
    from historian_tpu_torch.ops import branchdp

    emit, ins, mask, trans = _branch_inputs(*shape, seed=sum(shape))
    t = [torch.as_tensor(a, device=cuda) for a in (emit, ins, mask, trans)]
    before = branchdp.LAUNCHES
    got = branchdp.branch_fill(*t, viterbi)
    torch.cuda.synchronize()
    assert branchdp.LAUNCHES == before + 1
    g = got.cpu().numpy()
    host = np.empty((*emit.shape, 3))
    get_native().branch_fill(emit.shape[0], emit.shape[1], emit, ins, mask.astype(np.uint8),
                             trans, np.uint8(viterbi), host)
    if viterbi:
        assert np.array_equal(g.view(np.uint64), host.view(np.uint64))
    else:
        assert np.all(np.abs(g - host) <= 1e-12 * np.maximum(1.0, np.abs(host)))
    plain = branchdp.branch_fill_plain(*t, viterbi).cpu().numpy()
    assert np.all(np.abs(g - plain) <= 1e-12 * np.maximum(1.0, np.abs(plain)))
    assert np.all(g[~mask] == NEG)


def _host_fill(emit, ins, mask, trans, viterbi):
    from historian_tpu_torch.native import get_native

    host = np.empty((*emit.shape, 3))
    get_native().branch_fill(emit.shape[0], emit.shape[1], emit, ins, mask.astype(np.uint8),
                             trans, np.uint8(viterbi), host)
    return host


def test_branchfill_band_readback(cuda):
    """The refiner's route on the card: a band's inputs packed into pinned
    memory and uploaded in one copy (logged), kernel (e) on the band (the
    ring design), the band read back in one copy of n x 24 bytes, and
    BandCells reading every cell as csrc/fill.cpp's full grid, bit for
    bit (Viterbi), NEG outside the band."""
    from historian_tpu_torch.ops import branchdp, readback

    emit, ins, mask, trans = _branch_inputs(300, 280, 8, seed=5)
    hull = (t.numpy() for t in branchdp.interior_hull(torch.as_tensor(mask)))
    lay = branchdp.band_layout(*hull, 300, 280)
    n_up = len(branchdp.UPLOADS)
    inp = branchdp.upload_band(lay, emit, mask, ins, trans, cuda)
    assert len(branchdp.UPLOADS) == n_up + 1 and branchdp.UPLOADS[-1]["bytes"] >= lay.n * 9
    rings = branchdp.DESIGNS["ring"]
    cells = branchdp.read_band(branchdp.branch_fill_band(inp, True), lay)
    assert branchdp.DESIGNS["ring"] == rings + 1
    assert readback.READBACKS[-1]["bytes"] == lay.n * 24
    assert readback.READBACKS[-1]["kind"] == "branch"
    full = _host_fill(emit, ins, mask, trans, True)
    for x in range(300):
        for y in range(280):
            assert np.array_equal(cells[x, y].view(np.uint64), full[x, y].view(np.uint64))


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
def test_branchfill_full_mask_wider_than_the_ring(cuda, viterbi):
    """A full mask (an uninitialised envelope) whose diagonals hold more
    cells than the ring design's block: the wrapper picks the strip design
    before the launch and counts it, and the cells equal fill.cpp's
    (Viterbi bit for bit, Forward to 1e-12 relative)."""
    from historian_tpu_torch.ops import branchdp

    emit, ins, mask, trans = _branch_inputs(900, 700, -1, seed=6)
    hull = (t.numpy() for t in branchdp.interior_hull(torch.as_tensor(mask)))
    lay = branchdp.band_layout(*hull, 900, 700)
    assert lay.widest > branchdp.RING_MAX_CELLS and lay.design() == "strip"
    strips = branchdp.DESIGNS["strip"]
    t = [torch.as_tensor(a, device=cuda) for a in (emit, ins, mask, trans)]
    g = branchdp.branch_fill(*t, viterbi).cpu().numpy()
    assert branchdp.DESIGNS["strip"] == strips + 1
    assert branchdp.LAST_LAUNCH["design"] == "strip"
    host = _host_fill(emit, ins, mask, trans, viterbi)
    if viterbi:
        assert np.array_equal(g.view(np.uint64), host.view(np.uint64))
    else:
        assert np.all(np.abs(g - host) <= 1e-12 * np.maximum(1.0, np.abs(host)))


def _band_on_card(X1, Y1, band, seed, dev):
    from historian_tpu_torch.ops import branchdp

    emit, ins, mask, trans = _branch_inputs(X1, Y1, band, seed=seed)
    hull = (t.numpy() for t in branchdp.interior_hull(torch.as_tensor(mask)))
    lay = branchdp.band_layout(*hull, X1, Y1)
    return lay, branchdp.upload_band(lay, emit, mask, ins, trans, dev), (emit, ins, mask, trans)


#: the strip design's (rows, lead): one warp's rows with the shortest
#: lead, the rule's, the widest strips with the longest lead
STRIP_LAYOUTS = [(32, 1), (64, 8), (128, 16), (256, 254)]


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("layout", STRIP_LAYOUTS, ids=[f"{r}r{lead}" for r, lead in STRIP_LAYOUTS])
def test_branchfill_strip_matches_ring_bits(cuda, layout, viterbi):
    """On a band both designs take (a ring of eight warps: 236 cells on
    its widest diagonal), the strip design's cells equal the ring design's
    bit for bit in both modes, at each layout, three runs alike."""
    from historian_tpu_torch.ops import branchdp

    lay, inp, _ = _band_on_card(700, 650, 180, 7, cuda)
    assert lay.design() == "ring"
    ring = branchdp._fill_band(inp, viterbi, design="ring").cpu().numpy()
    rows, lead = layout
    for _ in range(3):
        got = branchdp._fill_band(inp, viterbi, design="strip", strip_rows=rows,
                                  lead=lead).cpu().numpy()
        assert branchdp.LAST_LAUNCH["rows"] == rows and branchdp.LAST_LAUNCH["lead"] == lead
        assert np.array_equal(got.view(np.uint64), ring.view(np.uint64))


#: (rows, lead, blocks) at a 1000 x 600 full mask: more strips than blocks
#: (32 strips on 3 blocks, and on one), a partial last strip (1000 = 10 x 96
#: + 40; 15 x 64 + 40)
STRIP_CASES = [(32, 4, 3), (32, 2, 1), (96, 2, None), (64, 8, None)]


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("case", STRIP_CASES,
                         ids=[f"{r}r{lead}l{b}b" for r, lead, b in STRIP_CASES])
def test_branchfill_strip_layouts_match_fill_cpp(cuda, case, viterbi):
    """The strip design at a full mask with a partial last strip and with
    more strips than resident blocks (block b takes strips b, b + G, ...):
    Viterbi bit for bit equal to fill.cpp, Forward within 1e-12 relative
    and equal, bit for bit, at every layout; three runs alike."""
    from historian_tpu_torch.ops import branchdp

    lay, inp, host_args = _band_on_card(1000, 600, -1, 8, cuda)
    rows, lead, blocks = case
    host = _host_fill(*host_args, viterbi).reshape(-1, 3)[lay.flat_index()]
    first = None
    for _ in range(3):
        got = branchdp._fill_band(inp, viterbi, strip_rows=rows, lead=lead,
                                  blocks=blocks).cpu().numpy()
        launch = branchdp.LAST_LAUNCH
        assert launch["design"] == "strip" and launch["strips"] == -(-1000 // rows)
        assert blocks is None or launch["blocks"] == blocks
        first = got if first is None else first
        assert np.array_equal(got.view(np.uint64), first.view(np.uint64))
    if viterbi:
        assert np.array_equal(first.view(np.uint64), host.view(np.uint64))
    else:
        assert np.all(np.abs(first - host) <= 1e-12 * np.maximum(1.0, np.abs(host)))
        rule = branchdp.branch_fill_band(inp, False).cpu().numpy()
        assert np.array_equal(first.view(np.uint64), rule.view(np.uint64))


def test_branchfill_rejects_float32(cuda):
    from historian_tpu_torch.ops import branchdp

    t = [torch.as_tensor(a, device=cuda) for a in _branch_inputs(5, 5, -1, 0)]
    t[0] = t[0].float()
    with pytest.raises(ValueError, match="float64"):
        branchdp.branch_fill(*t, True)


def _sibling_case(X, Y, band, seed):
    """Seeded sibling fill inputs (tests/test_torch_siblingdp.py's form)
    and the band layout of their mask."""
    from historian_tpu_torch.ops import branchdp, siblingdp

    rng = np.random.default_rng(seed)
    tmat = np.full((12, 12), -np.inf)
    for a, b in siblingdp._KEYS:
        tmat[siblingdp._INDEX[a], siblingdp._INDEX[b]] = np.log(rng.uniform(0.05, 0.9))
    l_emit, r_emit = rng.uniform(-4, -1, X), rng.uniform(-4, -1, Y)
    match = np.full((X + 1, Y + 1), -np.inf)
    match[1:, 1:] = rng.uniform(-8, -2, (X, Y))
    mask = np.ones((X + 1, Y + 1), bool)
    if band == -2:  # holes anywhere
        mask = rng.random((X + 1, Y + 1)) < 0.4
    elif band >= 0:
        m1, m2 = np.cumsum(rng.random(X + 1) < 0.8), np.cumsum(rng.random(Y + 1) < 0.8)
        mask = np.abs(m1[:, None] - m2[None, :]) <= band
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    hull = (t.numpy() for t in branchdp.interior_hull(torch.as_tensor(mask)))
    return (match, mask, l_emit, r_emit, tmat), branchdp.band_layout(*hull, X + 1, Y + 1)


SIBLING_SHAPES = [(1, 1, -1), (3, 2, -1), (1, 40, -1), (40, 1, -1), (120, 90, 6),
                  (300, 340, -1), (1300, 1100, -1), (1100, 1300, 20), (200, 230, -2)]


@pytest.mark.parametrize("shape", SIBLING_SHAPES,
                         ids=[f"{a}x{b}b{c}" for a, b, c in SIBLING_SHAPES])
def test_siblingfill_kernel_matches_host_and_plain(cuda, shape):
    """Kernel (d) on the band against csrc/fill.cpp `sibling_fill` and its
    plain version: the same -inf cells, the rest and lp_end within 1e-9
    (the card's exp and log against glibc's); the ring design (one block)
    where the widest diagonal holds at most RING_MAX_CELLS cells, else the
    strip design, a cooperative launch of a block a strip (300 x 340, 1300
    x 1100, a mask with holes)."""
    from historian_tpu_torch.ops import siblingdp
    from historian_tpu_torch.sampler.sibling import native_fill

    (match, mask, l_emit, r_emit, tmat), lay = _sibling_case(*shape, seed=sum(shape))
    host, lp = native_fill(l_emit, r_emit, match, mask, tmat)
    ref = host.reshape(-1, 11)[lay.flat_index()]
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, cuda)
    before = siblingdp.LAUNCHES
    cells, lp_end = siblingdp.sibling_fill_band(inp)
    torch.cuda.synchronize()
    assert siblingdp.LAUNCHES == before + 1
    launch = siblingdp.LAST_LAUNCH
    assert launch["design"] == ("ring" if lay.widest <= siblingdp.RING_MAX_CELLS else "strip")
    if launch["design"] == "ring":
        assert launch["blocks"] == 1 and launch["threads"] == 4 * launch["width"]
    else:
        assert launch["strips"] == -(-(shape[0] + 1) // siblingdp.STRIP_ROWS)
        assert 1 <= launch["blocks"] <= launch["strips"]
    g = cells.cpu().numpy()
    assert np.array_equal(g == -np.inf, ref == -np.inf)
    live = np.isfinite(ref)
    assert np.all(np.abs(g[live] - ref[live]) <= 1e-9)
    assert abs(lp_end.item() - lp) <= 1e-9 * max(1.0, abs(lp))
    plain, plain_lp = siblingdp.sibling_fill_band_plain(inp)
    p = plain.cpu().numpy()
    assert np.array_equal(g == -np.inf, p == -np.inf)
    assert np.all(np.abs(g[live] - p[live]) <= 1e-9)
    assert abs(lp_end.item() - plain_lp.item()) <= 1e-9 * max(1.0, abs(lp))


@pytest.mark.parametrize("design,strip_rows,blocks", [("ring", None, None),
                                                      ("strip", 16, None), ("strip", 32, None),
                                                      ("strip", 8, 3)],
                         ids=["ring", "strip16", "strip32", "strip8-3blocks"])
def test_siblingfill_both_designs(cuda, design, strip_rows, blocks):
    """A full mask whose widest diagonal (101 cells) fits the ring and spans
    four or more strips of 32 rows and fewer: each design against
    fill.cpp (1e-9), and the two designs' cells equal bit for bit (the
    same operations a cell); with 3 blocks for 13 strips, each block
    takes strips b, b + 3, ... in turn."""
    from historian_tpu_torch.ops import siblingdp
    from historian_tpu_torch.sampler.sibling import native_fill

    (match, mask, l_emit, r_emit, tmat), lay = _sibling_case(100, 110, -1, seed=11)
    assert lay.widest == 101
    host, lp = native_fill(l_emit, r_emit, match, mask, tmat)
    ref = host.reshape(-1, 11)[lay.flat_index()]
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, cuda)
    ring, ring_lp = siblingdp.sibling_fill_band(inp, design="ring")
    cells, lp_end = siblingdp.sibling_fill_band(inp, design=design, strip_rows=strip_rows,
                                                blocks=blocks)
    launch = siblingdp.LAST_LAUNCH
    assert launch["design"] == design
    if design == "strip":
        assert launch["strips"] == -(-101 // strip_rows) >= 4
        assert launch["blocks"] == (blocks or launch["strips"])
    g = cells.cpu().numpy()
    assert np.array_equal(g == -np.inf, ref == -np.inf)
    live = np.isfinite(ref)
    assert np.all(np.abs(g[live] - ref[live]) <= 1e-9)
    assert abs(lp_end.item() - lp) <= 1e-9 * max(1.0, abs(lp))
    assert torch.equal(cells, ring) and torch.equal(lp_end, ring_lp)


@pytest.mark.parametrize("shape", [(1, 1, -1), (3, 2, -1), (1, 40, -1), (40, 1, -1),
                                   (120, 90, 6), (100, 110, -1), (1100, 1300, 20),
                                   (200, 230, -2)],
                         ids=lambda s: f"{s[0]}x{s[1]}b{s[2]}")
def test_siblingplan_kernel_matches_plain(cuda, shape):
    """The ring design's plan kernel against the plain plan on the same
    inputs: every record equal byte for byte (positions, emissions, ring
    slots, flags, the zero padding)."""
    from historian_tpu_torch.ops import siblingdp

    (match, mask, l_emit, r_emit, tmat), lay = _sibling_case(*shape, seed=sum(shape))
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, cuda)
    before = siblingdp.PLAN_LAUNCHES
    got = siblingdp.plan_records(inp)
    assert siblingdp.PLAN_LAUNCHES == before + 1
    want = siblingdp.plan_records_plain(inp, *siblingdp.ring_shape(lay))
    assert got.shape == want.shape and torch.equal(got, want)


def test_siblingfill_band_readback(cuda):
    """The sampler's route on the card: the band up in one pinned copy
    (logged), kernel (d), the band and lp_end back in one copy of n x 88 +
    8 bytes, and BandCells reading every cell as fill.cpp's grid, -inf
    outside the band."""
    from historian_tpu_torch.ops import readback, siblingdp
    from historian_tpu_torch.sampler.sibling import native_fill

    (match, mask, l_emit, r_emit, tmat), lay = _sibling_case(300, 280, 8, seed=5)
    n_up = len(siblingdp.UPLOADS)
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, cuda)
    assert len(siblingdp.UPLOADS) == n_up + 1 and siblingdp.UPLOADS[-1]["bytes"] >= lay.n * 9
    cells, lp = siblingdp.read_band(*siblingdp.sibling_fill_band(inp), lay)
    assert readback.READBACKS[-1]["bytes"] == lay.n * 88 + 8
    assert readback.READBACKS[-1]["kind"] == "sibling"
    host, hlp = native_fill(l_emit, r_emit, match, mask, tmat)
    grid = np.array([[cells[x, y] for y in range(281)] for x in range(301)])
    assert np.array_equal(grid == -np.inf, host == -np.inf)
    live = np.isfinite(host)
    assert np.all(np.abs(grid[live] - host[live]) <= 1e-9)
    assert abs(lp - hlp) <= 1e-9 * abs(hlp)


def test_siblingfill_rejects_float32(cuda):
    from historian_tpu_torch.ops import siblingdp

    (match, mask, l_emit, r_emit, tmat), lay = _sibling_case(5, 5, -1, 0)
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, cuda)
    inp.emit = inp.emit.float()
    with pytest.raises(ValueError, match="float64"):
        siblingdp.sibling_fill_band(inp)


def test_branch_matrix_full_envelope_takes_the_wide_design(cuda):
    """An MCMC branch fill under an uninitialised envelope (the full mask
    of a node-align or prune-and-regraft move) on the card: kernel (e) in
    Forward mode in its design for diagonals wider than the ring (the
    strip design since it replaced the wide one), cells within 1e-9 of
    fill.cpp's."""
    from historian_tpu_torch import device
    from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.ops import branchdp

    rng = np.random.default_rng(4)
    model = named_model("lg")

    def pwm(n):
        z = rng.normal(0, 2, (n, model.components, model.alphabet_size))
        return z - np.log(np.exp(z).sum(axis=(1, 2), keepdims=True))

    x_pwm, y_pwm = pwm(900), pwm(800)
    env = GuideAlignmentEnvelope()
    args = (model, x_pwm, y_pwm, 0.3, env, np.arange(901), np.arange(801), 0, 1)
    device.select("gpu")
    os.environ["HISTORIAN_DEVICE_BRANCH"] = "1"
    try:
        strips = branchdp.DESIGNS["strip"]
        dev = branchmatrix.BranchMatrix(*args)
        assert branchdp.DESIGNS["strip"] == strips + 1
        os.environ["HISTORIAN_DEVICE_BRANCH"] = "0"
        host = branchmatrix.BranchMatrix(*args)
    finally:
        del os.environ["HISTORIAN_DEVICE_BRANCH"]
    g = np.array([[dev.cells[x, y] for y in range(801)] for x in range(901)])
    assert np.all(np.abs(g - host.cells) <= 1e-9 * np.maximum(1.0, np.abs(host.cells)))
    assert abs(dev.lp_end - host.lp_end) <= 1e-9 * abs(host.lp_end)


def _dag_merge(x_cut: int, y_cut: int, banded: bool, y_leaf: bool = False,
               x_post: bool = False):
    """A merge of a sampled x (tests/data/long6.fa's third and fourth
    sequences cut to `x_cut` aa; 10 traces and the best, mt19937 seed 7),
    or of their posterior profile (`x_post`, 0.01: states of many
    in-edges), against a sampled y (its first two cut to `y_cut`, seed 99)
    or the first alone (`y_leaf`), each child filled on the host; banded
    around a guide that aligns the sequences from their first residue.
    Returns (the merge's ForwardMatrix arguments, the host-filled merge)."""
    from historian_tpu_torch import device
    from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu_torch.core.seqs import FastSeq, read_fasta
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.engine.pairhmm import PairHMM
    from historian_tpu_torch.engine.profile import Profile
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.models.ratemodel import ProbModel
    from historian_tpu_torch.utils.rng import MT19937

    class HostFill(forward.ForwardMatrix):
        def _fill_device(self):
            return False

    device.select("cpu")
    model = named_model("lg")
    seqs = read_fasta(os.path.join(os.path.dirname(__file__), "data", "long6.fa"))
    cuts = {2: x_cut, 3: x_cut, 0: y_cut, 1: y_cut}
    leaf = {k: Profile.from_sequence(model.components, model.alphabet,
                                     FastSeq(name=seqs[k].name, seq=seqs[k].seq[:n]), k)
            for k, n in cuts.items()}

    def hmm(a, b):
        return PairHMM(ProbModel(model, a), ProbModel(model, b), model.ins_prob)

    x_fill = HostFill(leaf[2], leaf[3], hmm(0.3, 0.25), 6)
    x = (forward.BackwardMatrix(x_fill).post_prob_profile(0.01, 0, forward.COLLAPSE_CHAINS)
         if x_post else x_fill.sample_profile(MT19937(7), 10, 0))
    y = leaf[0] if y_leaf else HostFill(leaf[0], leaf[1], hmm(0.3, 0.25), 7).sample_profile(
        MT19937(99), 10, 0)
    env = None
    if banded:
        guide = {k: np.arange(max(cuts.values())) < n for k, n in cuts.items()}
        env = GuideAlignmentEnvelope(guide, 2, 0, 12)
    args = (x, y, hmm(0.2, 0.35), 8, env)
    return args, HostFill(*args)


#: name: _dag_merge's arguments.  "banded" and "chain y" take the ring
#: design (one block), "posterior" too with states of many in-edges; "wide"
#: (widest wavefront 420) and "two-block" (162, one block of PR 14's 256
#: threads a cell, six of the lane groups') the wide design's cooperative
#: launch
DAG_CASES = {"banded": (600, 560, True, False), "wide": (420, 380, False, False),
             "chain y": (240, 200, True, True), "posterior": (300, 280, True, False, True),
             "two-block": (200, 150, False, False)}


@pytest.mark.parametrize("case", list(DAG_CASES))
def test_dagfill_kernel_matches_host_and_plain(cuda, case):
    """Kernel (a) on the band against csrc/fill.cpp's grid and its plain
    version on the card: the same -inf cells, the rest within 1e-9 of
    fill.cpp (the card's exp and log1p against glibc's) and 1e-12 relative
    of the plain version; the ring design in one block where the widest
    wavefront has at most RING_MAX_CELLS cells, else the wide design's
    cooperative launch of several."""
    from historian_tpu_torch.ops import dagforward

    _, host = _dag_merge(*DAG_CASES[case])
    nx, ny = host.x_size - 1, host.y_size - 1
    p = dagforward.plan(host)
    inp = dagforward.upload_band(p, cuda)
    before, plans = dagforward.LAUNCHES, dagforward.PLAN_LAUNCHES
    cells = dagforward.dag_fill_band(inp)
    torch.cuda.synchronize()
    assert dagforward.LAUNCHES == before + 1 and dagforward.PLAN_LAUNCHES == plans + 1
    launch = dagforward.LAST_LAUNCH
    assert launch["design"] == ("ring" if p.widest <= dagforward.RING_MAX_CELLS else "wide")
    assert (launch["blocks"] > 1) == (case in ("wide", "two-block"))
    assert launch["waves"] == len(p.wave) - 1 and launch["lanes"] == dagforward.LANES
    ref = host.cells[:nx, :ny].reshape(-1, 5)[p.layout.flat_index()]
    g = cells.cpu().numpy()
    assert np.array_equal(g == -np.inf, ref == -np.inf)
    live = np.isfinite(ref)
    assert np.all(np.abs(g[live] - ref[live]) <= 1e-9)
    plain = dagforward.dag_fill_band_plain(inp).cpu().numpy()
    assert np.array_equal(g == -np.inf, plain == -np.inf)
    assert np.all(np.abs(g[live] - plain[live]) <= 1e-12 * np.maximum(1.0, np.abs(plain[live])))


@pytest.mark.parametrize("case", list(DAG_CASES))
def test_dagplan_kernel_matches_plain_plan(cuda, case):
    """The plan kernel's records, terms and spans equal the plain plan's on
    the same inputs on the card: every integer word, every lp; the absorb
    values (each the card's log of the same ordered sum) to 1e-15."""
    from historian_tpu_torch.ops import dagforward

    _, host = _dag_merge(*DAG_CASES[case])
    inp = dagforward.upload_band(dagforward.plan(host), cuda)
    got, band = dagforward.plan_records(inp)
    want = dagforward.plan_records_plain(inp)
    assert torch.equal(got.spans, want.spans) and got.terms.shape == want.terms.shape
    assert torch.equal(got.terms, want.terms)
    assert torch.equal(got.recs[:, 10:], want.recs[:, 10:])
    assert torch.equal(got.recs[:, 2:10], want.recs[:, 2:10])
    a, b = got.recs.view(torch.float64)[:, 0], want.recs.view(torch.float64)[:, 0]
    assert torch.equal(a == 0, b == 0) and torch.equal(torch.isfinite(a), torch.isfinite(b))
    live = torch.isfinite(b)
    assert torch.all((a[live] - b[live]).abs() <= 1e-15 * b[live].abs().clamp(min=1.0))
    assert bool((band == -torch.inf).all()) and band.shape == (inp.layout.n, 5)


def test_dagfill_band_readback(cuda):
    """The merge's route on the card: the plan up in one pinned copy
    (logged), the band back in one (a "dag" readback of 40 B a cell) into
    the host grid, which then equals fill.cpp's."""
    from historian_tpu_torch.ops import dagforward, readback

    _, host = _dag_merge(240, 220, True)
    n_up, n_read = len(dagforward.UPLOADS), len(readback.READBACKS)
    out = np.full_like(host.cells, -np.inf)
    p = dagforward.dag_forward_cells(host, cuda, out)
    assert len(dagforward.UPLOADS) == n_up + 1
    ex = p.factors[0]
    assert dagforward.UPLOADS[-1]["bytes"] >= len(p.cells) * 8 + ex.size * 8
    assert len(readback.READBACKS) == n_read + 1
    read = readback.READBACKS[-1]
    assert read["kind"] == "dag" and read["bytes"] == p.layout.n * 40
    assert np.array_equal(out == -np.inf, host.cells == -np.inf)
    live = np.isfinite(host.cells)
    assert np.all(np.abs(out[live] - host.cells[live]) <= 1e-9)


def test_dagfill_rejects_float32(cuda):
    from historian_tpu_torch.ops import dagforward

    _, host = _dag_merge(60, 50, False)
    inp = dagforward.upload_band(dagforward.plan(host), cuda)
    inp.ex = inp.ex.float()
    with pytest.raises(ValueError, match="float64"):
        dagforward.dag_fill_band(inp)


def test_forced_dag_route_on_the_card(cuda, monkeypatch):
    """A merge of a sampled x with the card's threshold at 0: route "dag",
    one launch, the host route's lp_end, cells and sampled profile."""
    from historian_tpu_torch import device
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.ops import dagforward
    from historian_tpu_torch.utils.rng import MT19937

    args, host = _dag_merge(300, 280, True)
    monkeypatch.setitem(forward.DAG_DEVICE_MIN_CELLS, "cuda", 0)
    device.select("gpu")
    try:
        before = dagforward.LAUNCHES
        dev = forward.ForwardMatrix(*args, defer_cells=True)
    finally:
        device.select("cpu")
    assert dev.route == "dag" and dagforward.LAUNCHES == before + 1
    assert dev.lp_end == pytest.approx(host.lp_end, rel=1e-12)
    live = np.isfinite(host.cells)
    assert np.array_equal(np.isfinite(dev.cells), live)
    assert np.all(np.abs(dev.cells[live] - host.cells[live]) <= 1e-9)
    profs = [f.sample_profile(MT19937(31), 10, 0).to_json() for f in (host, dev)]
    assert profs[1] == profs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,KY,n,banded", [(200, 4, 2, False), (700, 4, 3, True),
                                           (1500, 1, 5, True), (1500, 1, 12, False),
                                           (130, 1, 2, True)])
def test_sp_kernel_bit_equal_to_k1(cuda, S, KY, n, banded, dtype):
    """Kernel (g1) over n shards of the card (runs of whole 128-lane strips;
    12 shards of 1500 lanes leave none empty, 2 of 130 a one-lane last
    shard): cells bit-equal to K1's on the same inputs, with and without
    the band's lanes, run 3 times (a stale read across a boundary shows
    only now and then); one launch a fill."""
    args, _ = _k1_args(S, KY, dtype, cuda)
    lanes = colforward.lanes_from_mask(args[4] == 0) if banded else None
    ref = colforward.col_forward_planes(*args, lanes=lanes)
    for _ in range(3):
        before = sp_colforward.LAUNCHES
        got = sp_colforward.sp_col_forward_planes(*args, lanes, [cuda] * n)
        assert sp_colforward.LAUNCHES == before + 1
        assert torch.equal(got, ref)
    cuts = sp_colforward.LAST_LAUNCH["cuts"]
    assert len(cuts) == min(n, -(-S // colforward.STRIP_WIDTH))
    assert sp_colforward.LAST_LAUNCH["exchange_bytes"] == (len(cuts) - 1) * (
        S * sp_colforward.RECORD * ref.element_size() + 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("place", ["host", "peer"])
def test_sp_kernel_system_scope_exchange(cuda, monkeypatch, place, n, dtype):
    """The cross-card exchange of kernel (g1) on the one card: every
    boundary's records in pinned host memory ("host", the buffer of two
    cards without peer access) or in the card's memory at system scope
    ("peer", the buffer a peer card stores into), so that the system-scope
    release, acquire and loads run; cells bit-equal to K1's, run 3 times."""
    args, _ = _k1_args(1500, 1, dtype, cuda)
    lanes = colforward.lanes_from_mask(args[4] == 0)
    ref = colforward.col_forward_planes(*args, lanes=lanes)
    monkeypatch.setattr(sp_colforward, "_record_place", lambda writer, reader: place)
    for _ in range(3):
        got = sp_colforward.sp_col_forward_planes(*args, lanes, [cuda] * n)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    launch = sp_colforward.LAST_LAUNCH
    assert launch["places"] == [place] * (n - 1)
    assert launch["system_scope"] == [True] * (n - 1)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-3),
                                             (torch.float64, 1e-9, 1e-9)])
def test_sp_kernel_matches_plain(cuda, dtype, rtol, atol):
    """Kernel (g1) at 4 shards against its plain version at 4 shards."""
    args, _ = _k1_args(600, 4, dtype, cuda)
    got = sp_colforward.sp_col_forward_planes(*args, None, [cuda] * 4)
    ref = sp_colforward.sp_col_forward_planes_plain(*args, 4)
    g, r = got.cpu().double().numpy(), ref.cpu().double().numpy()
    live = r > -1e25
    assert np.array_equal(g > -1e25, live)
    np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("cluster", [1, 2, 8])
def test_sp_kernel_cluster_sizes_bit_equal_to_k1(cuda, cluster, n, dtype):
    """Kernel (g1) with its strips in clusters of 1 (every edge a record in
    device memory), 2 and 8 (edges through distributed shared memory) over
    1 and 3 shards of 1500 lanes (12 strips), banded: cells bit-equal to
    K1's, run 3 times."""
    args, _ = _k1_args(1500, 4, dtype, cuda)
    lanes = colforward.lanes_from_mask(args[4] == 0)
    ref = colforward.col_forward_planes(*args, lanes=lanes)
    for _ in range(3):
        got = sp_colforward._planes(*args, lanes, [cuda] * n, cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    lay = sp_colforward.LAST_LAUNCH["layouts"][0]
    assert lay["cluster"] == cluster and lay["warps"] == 4 and not lay["deep"]
    assert (lay["cluster_edges"] > 0) == (cluster > 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,banded", [(1, False), (2, True), (4, False)])
def test_sp_kernel_dag_past_the_ring_bit_equal_to_k1(cuda, n, banded, dtype):
    """A DAG y whose in-edges reach 20 to 60 columns back, past the strip
    edges' on-chip ring (sp_colforward.HALO): every edge keeps its records
    in device memory too and the old in-edges' halo reads them; cells
    bit-equal to K1's at 1, 2 and 4 shards, run 3 times."""
    args, _ = _k1_args(900, 4, dtype, cuda, seed=5)
    rng = np.random.default_rng(9)
    j = np.arange(900)
    y_src = args[0].cpu().numpy()
    y_src[:, 1] = np.clip(j - 20 - rng.integers(0, 41, 900), 0, None)
    y_src[:20, 1] = 900  # no second in-edge there
    args = (torch.as_tensor(y_src, device=cuda),) + args[1:]
    assert sp_colforward.deep_edges(args[0])
    lanes = colforward.lanes_from_mask(args[4] == 0) if banded else None
    ref = colforward.col_forward_planes(*args, lanes=lanes)
    for _ in range(3):
        got = sp_colforward.sp_col_forward_planes(*args, lanes, [cuda] * n)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert all(lay["deep"] for lay in sp_colforward.LAST_LAUNCH["layouts"])


def test_sp_kernel_rejects_ragged_shards(cuda):
    """A shard that is not whole strips, but the last, is refused."""
    args, _ = _k1_args(300, 1, torch.float64, cuda)
    y_src, y_lp, y_flags, absorb, maskg, xvec, trans = args
    shards = [(absorb[:, a:b].contiguous(), maskg[:, a:b].contiguous(),
               xvec[:, a:b].contiguous()) for a, b in ((0, 100), (100, 300))]
    with pytest.raises(ValueError, match="not whole strips"):
        sp_colforward.sp_col_forward_shards(y_src, y_lp, y_flags, trans, None, shards)


# --------------------------------------------- kernels (f), (d'), (g2), (g3)
def _long6_pair(x_len, y_len, dtype, dev, offset=0, pair=(0, 1), data="long6.fa"):
    """Pair-DP inputs of two long6 sequences (or `data`'s) cut to x_len and
    y_len residues from `offset` (preset lg) on `dev`."""
    from historian_tpu_torch.core.seqs import read_fasta
    from historian_tpu_torch.models.presets import named_model

    seqs = read_fasta(os.path.join(os.path.dirname(__file__), "data", data))
    x = seqs[pair[0]].seq[offset: offset + x_len]
    y = seqs[pair[1]].seq[offset: offset + y_len]
    args, _ = pairforward.chain_pair_forward_arrays(named_model("lg"), x, y, 0.7, 0.4,
                                                    dtype=dtype)
    return [a.to(dev) for a in args]


def _pair_band(X1, Y1, width, dev):
    diag = np.arange(X1)[:, None] * ((Y1 - 1) / max(X1 - 1, 1))
    band = np.abs(diag - np.arange(Y1)[None, :]) <= width
    band[0, :] = band[:, 0] = True
    band[-1, -1] = True
    return torch.as_tensor(band, device=dev)


def _card_mesh(dev, n, names=("sp",), shape=None):
    from historian_tpu_torch.parallel.mesh import Mesh, MeshDevice

    devs = np.array([MeshDevice(0, k, dev) for k in range(n)], dtype=object)
    return Mesh(devs.reshape(shape or (n,)), names)


TROPICAL_SHAPES = [(0, 40, -1), (1, 0, -1), (36, 28, -1), (60, 74, 5), (300, 600, -1),
                   (40, 1100, 30), (30, 2100, -1), (120, 3000, 200), (25, 5000, -1)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", TROPICAL_SHAPES,
                         ids=[f"{a}x{b}b{c}" for a, b, c in TROPICAL_SHAPES])
def test_tropical_kernel_matches_plain(cuda, shape, dtype, rtol):
    """Kernel (f) against its plain version (the rule's strips: one strip
    of one block up to 128 columns, 40 strips at 5001):
    the cells above -1e29 within rtol, every other cell at or below -1e29
    in both (-inf in the same cells), a masked cell exactly NEG, lp_best
    likewise; 3 runs equal."""
    from historian_tpu_torch.ops import tropical

    x_len, y_len, band = shape
    args = _long6_pair(x_len, y_len, dtype, cuda)
    if band >= 0:
        args[5] = _pair_band(x_len + 1, y_len + 1, band, cuda)
    ref, ref_lp = tropical.tropical_pair_forward_plain(*args)
    before = tropical.LAUNCHES
    runs = [tropical.tropical_pair_forward(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert tropical.LAUNCHES == before + 3
    for cells, lp in runs[1:]:
        assert torch.equal(cells, runs[0][0]) and torch.equal(lp, runs[0][1])
    cells, lp = runs[0]
    for got, want in ((cells, ref), (lp[None], ref_lp[None])):
        g, r = got.cpu().double().numpy(), want.cpu().double().numpy()
        live = r > -1e29
        assert np.array_equal(g > -1e29, live)
        assert np.array_equal(g == -np.inf, r == -np.inf)
        assert np.all(np.abs(g[live] - r[live]) <= rtol * np.abs(r[live]))
    neg = torch.tensor(NEG, dtype=dtype)
    assert bool((cells.cpu()[~args[5].cpu()] == neg).all())


def _tropical_close(got, want, rtol):
    """(f)'s cells or lp_best against the plain version's: the -1e29 rule,
    -inf in the same cells, rtol on the rest."""
    g, r = got.cpu().double().numpy(), want.cpu().double().numpy()
    live = r > -1e29
    assert np.array_equal(g > -1e29, live)
    assert np.array_equal(g == -np.inf, r == -np.inf)
    assert np.all(np.abs(g[live] - r[live]) <= rtol * np.abs(r[live]))


#: strip layouts (lanes a thread, warps, cluster): every edge a record
#: (cluster 1), portable and non-portable clusters, a cluster wider than
#: the strips, each lanes a thread
STRIP_LAYOUTS = [(1, 1, 1), (1, 2, 8), (1, 4, 16), (1, 3, 5), (2, 2, 1), (2, 4, 8),
                 (4, 1, 16), (4, 8, 2)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(120, 3000, 200), (40, 1100, -1)], ids=["3000b200", "1100"])
def test_tropical_strip_layouts_match_plain(cuda, shape, dtype, rtol):
    """Kernel (f) at every layout of STRIP_LAYOUTS against its plain
    version, and the layouts of one lanes a thread bit-equal to each other
    (a strip boundary at a warp boundary passes what the warp ring
    passes); each run twice, equal."""
    from historian_tpu_torch.ops import tropical

    x_len, y_len, band = shape
    args = _long6_pair(x_len, y_len, dtype, cuda)
    if band >= 0:
        args[5] = _pair_band(x_len + 1, y_len + 1, band, cuda)
    ref, ref_lp = tropical.tropical_pair_forward_plain(*args)
    first = {}
    for lanes, warps, cluster in STRIP_LAYOUTS:
        runs = [tropical.tropical_pair_forward(*args, lanes=lanes, warps=warps, cluster=cluster)
                for _ in range(2)]
        torch.cuda.synchronize()
        launch = tropical.LAST_LAUNCH
        assert (launch["lanes"], launch["warps"], launch["cluster"]) == (lanes, warps, cluster)
        cells, lp = runs[0]
        assert torch.equal(runs[1][0], cells) and torch.equal(runs[1][1], lp)
        _tropical_close(cells, ref, rtol)
        _tropical_close(lp[None], ref_lp[None], rtol)
        c0, lp0 = first.setdefault(lanes, (cells, lp))
        assert torch.equal(cells, c0) and torch.equal(lp, lp0), (lanes, warps, cluster)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_tropical_kernel_past_8192_columns(cuda, dtype, rtol):
    """Kernel (f) on long8x12k's first pair cut to 60 rows at all 11019
    columns (past the one-block design's 8192) against its plain version,
    on the rule's strips and on clusters of 16."""
    from historian_tpu_torch.ops import tropical

    args = _long6_pair(59, 11018, dtype, cuda, data="long8x12k.fa")
    assert args[0].shape == (60, 11019)
    ref, ref_lp = tropical.tropical_pair_forward_plain(*args)
    for force in ({}, dict(lanes=2, warps=4, cluster=16)):
        cells, lp = tropical.tropical_pair_forward(*args, **force)
        assert tropical.LAST_LAUNCH["strips"] > 1
        _tropical_close(cells, ref, rtol)
        _tropical_close(lp[None], ref_lp[None], rtol)


def test_strip_layout_not_resident_raises(cuda):
    """A layout with more blocks than can be resident at once raises for
    (f) and (g2); nothing falls back to fewer blocks."""
    from historian_tpu_torch.ops import pairstrips, sp_pairforward, tropical

    args = _long6_pair(1, 3000, torch.float32, cuda)
    wide = [torch.cat([t] * 80, dim=-1) if t.dim() and t.shape[-1] == 3001 else t for t in args]
    cap = pairstrips.card_capacity("tropical", "f32", torch.cuda.current_device(), 1, 1, 1)
    assert wide[0].shape[1] // 32 > cap
    before = tropical.LAUNCHES
    with pytest.raises(ValueError, match="cannot be resident"):
        tropical.tropical_pair_forward(*wide, lanes=1, warps=1, cluster=1)
    with pytest.raises(ValueError, match="cannot be resident"):
        sp_pairforward.sp_pair_forward(*wide, mesh=_card_mesh(cuda, 1), lanes=1, warps=1,
                                       cluster=1)
    assert tropical.LAUNCHES == before


def _sibling_batch(items):
    """Padded batch inputs (numpy) of `_sibling_case` items (X, Y, band),
    NEG for -inf, as SiblingMatrix.fill_batch builds them, with each item's
    own inputs and band layout."""
    from historian_tpu_torch.ops import siblingdp

    cases = [_sibling_case(X, Y, band, seed=X + Y + 5) for X, Y, band in items]
    K = len(items)
    X1 = max(X for X, _, _ in items) + 1
    Y1 = max(Y for _, Y, _ in items) + 1
    l_emit, r_emit = np.full((K, X1 - 1), -1e30), np.full((K, Y1 - 1), -1e30)
    match, mask = np.full((K, X1, Y1), -1e30), np.zeros((K, X1, Y1), bool)
    trans, ends = np.empty((K, 35)), np.empty((K, 2), np.int32)
    for k, ((X, Y, _), ((me, mk, le, re, tmat), _)) in enumerate(zip(items, cases)):
        l_emit[k, :X], r_emit[k, :Y] = le, re
        match[k, : X + 1, : Y + 1] = np.where(np.isfinite(me), me, -1e30)
        mask[k, : X + 1, : Y + 1] = mk
        trans[k], ends[k] = siblingdp.pack_table(tmat), (X, Y)
    return (l_emit, r_emit, match, mask, trans, ends), cases


SIBLING_BATCH = [(120, 90, 6), (300, 340, -1), (40, 1, -1), (1, 40, -1), (200, 230, -2),
                 (3, 2, -1)]


def test_sibling_batch_kernel_matches_host_and_single_fills(cuda):
    """Kernel (d') on 6 items of mixed sizes in one launch: each item's
    cells bit-equal to kernel (d)'s fill of that item alone (the same cell
    step), within 3.64e-12 of csrc/fill.cpp (kernel (d)'s bound against
    it), -inf where fill.cpp has -inf and past the item's corner; lp_end
    likewise; against the plain version within 1e-9 relative (its row
    scan's drift); 3 runs equal."""
    from historian_tpu_torch.ops import siblingdp
    from historian_tpu_torch.sampler.sibling import native_fill

    arrays, cases = _sibling_batch(SIBLING_BATCH)
    t = [torch.as_tensor(a, device=cuda) for a in arrays]
    before = siblingdp.BATCH_LAUNCHES
    runs = [siblingdp.sibling_forward_batch(*t) for _ in range(3)]
    torch.cuda.synchronize()
    assert siblingdp.BATCH_LAUNCHES == before + 3
    for c, lp in runs[1:]:
        assert torch.equal(c, runs[0][0]) and torch.equal(lp, runs[0][1])
    cells, lp_end = (v.cpu().numpy() for v in runs[0])
    plain, plain_lp = (v.numpy() for v in siblingdp.sibling_forward_batch_plain(
        *(torch.as_tensor(a) for a in arrays)))
    for k, ((X, Y, _), ((me, mk, le, re, tmat), lay)) in enumerate(zip(SIBLING_BATCH, cases)):
        got = cells[k, : X + 1, : Y + 1]
        host, hlp = native_fill(le, re, me, mk, tmat)
        assert np.array_equal(got == -np.inf, host == -np.inf)
        live = np.isfinite(host)
        assert np.all(np.abs(got[live] - host[live]) <= 3.64e-12), k
        assert abs(lp_end[k] - hlp) <= 3.64e-12
        assert np.all(cells[k, X + 1:] == -np.inf) and np.all(cells[k, :, Y + 1:] == -np.inf)
        band, blp = siblingdp.sibling_fill_band(
            siblingdp.upload_band(lay, me, mk, le, re, tmat, cuda))
        assert np.array_equal(got.reshape(-1, 11)[lay.flat_index()], band.cpu().numpy()), k
        assert lp_end[k] == blp.item()
        p = plain[k, : X + 1, : Y + 1]
        assert np.array_equal(p <= -1e29, ~live)
        assert np.all(np.abs(got[live] - p[live]) <= 1e-9 * np.abs(p[live]))
        assert abs(lp_end[k] - plain_lp[k]) <= 1e-9 * abs(plain_lp[k])


#: items whose diagonals pass 256 cells, with unequal corners
SIBLING_BATCH_WIDE = [(300, 262, -1), (265, 300, 40), (20, 7, -1)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_sibling_batch_clusters_match_kernel_d(cuda, cluster):
    """Kernel (d') at each cluster size (1: two rows a lane group, in
    turns; 2, 4, 8: strips handing their last row through distributed
    shared memory): each item's cells and lp_end bit-equal to kernel (d)'s
    fill of that item alone, -inf past the corner; three runs alike."""
    from historian_tpu_torch.ops import siblingdp

    arrays, cases = _sibling_batch(SIBLING_BATCH_WIDE)
    t = [torch.as_tensor(a, device=cuda) for a in arrays]
    runs = [siblingdp._forward_batch(*t, cluster=cluster) for _ in range(3)]
    assert siblingdp.LAST_BATCH["cluster"] == cluster and siblingdp.LAST_BATCH["ring"] == "shared"
    assert siblingdp.LAST_BATCH["turns"] == (2 if cluster == 1 else 1)
    for c, lp in runs[1:]:
        assert torch.equal(c, runs[0][0]) and torch.equal(lp, runs[0][1])
    cells, lp_end = (v.cpu().numpy() for v in runs[0])
    for k, ((X, Y, _), ((me, mk, le, re, tmat), lay)) in enumerate(zip(SIBLING_BATCH_WIDE,
                                                                       cases)):
        got = cells[k, : X + 1, : Y + 1]
        band, blp = siblingdp.sibling_fill_band(
            siblingdp.upload_band(lay, me, mk, le, re, tmat, cuda))
        assert np.array_equal(got.reshape(-1, 11)[lay.flat_index()], band.cpu().numpy()), k
        assert lp_end[k] == blp.item()
        assert np.all(cells[k, X + 1:] == -np.inf) and np.all(cells[k, :, Y + 1:] == -np.inf)


#: grids whose strips outgrow a block's shared memory (more than ~6450
#: rows at clusters of 8), with unequal corners
SIBLING_BATCH_TALL = {7000: [(7000, 24, -1), (6500, 31, -2)],
                      11000: [(11000, 20, -1), (10400, 26, 3)]}


@pytest.mark.parametrize("rows", list(SIBLING_BATCH_TALL))
def test_sibling_batch_past_shared_memory_matches_kernel_d(cuda, rows):
    """Kernel (d') on grids of 7000 and 11000 rows (clusters of 8, several
    rows a lane group in turns, the strips' planes in device memory): each
    item's cells and lp_end bit-equal to kernel (d)'s fill of that item
    alone, -inf past the corner; two runs alike."""
    from historian_tpu_torch.ops import siblingdp

    items = SIBLING_BATCH_TALL[rows]
    arrays, cases = _sibling_batch(items)
    t = [torch.as_tensor(a, device=cuda) for a in arrays]
    runs = [siblingdp.sibling_forward_batch(*t) for _ in range(2)]
    assert siblingdp.LAST_BATCH["ring"] == "device" and siblingdp.LAST_BATCH["turns"] > 1
    assert torch.equal(runs[1][0], runs[0][0]) and torch.equal(runs[1][1], runs[0][1])
    cells, lp_end = (v.cpu().numpy() for v in runs[0])
    for k, ((X, Y, _), ((me, mk, le, re, tmat), lay)) in enumerate(zip(items, cases)):
        got = cells[k, : X + 1, : Y + 1]
        band, blp = siblingdp.sibling_fill_band(
            siblingdp.upload_band(lay, me, mk, le, re, tmat, cuda))
        assert np.array_equal(got.reshape(-1, 11)[lay.flat_index()], band.cpu().numpy()), k
        assert lp_end[k] == blp.item()
        assert np.all(cells[k, X + 1:] == -np.inf) and np.all(cells[k, :, Y + 1:] == -np.inf)


def test_sibling_batch_kernel_rejects_float32(cuda):
    from historian_tpu_torch.ops import siblingdp

    t = [torch.as_tensor(a, device=cuda) for a in _sibling_batch([(5, 6, -1)])[0]]
    t[2] = t[2].float()
    with pytest.raises(ValueError, match="float64"):
        siblingdp.sibling_forward_batch(*t)


def _k3_lp(args):
    return pairforward.pair_forward_lp(*(a[None] for a in args[:5]), args[6])[0]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-9)])
def test_sp_pair_kernel_matches_k3(cuda, n, dtype, rtol):
    """Kernel (g2) at n shards of the card (one cooperative launch) against
    K3's lp_end on the same pair (300 x 280; and 60 x 3000, 8 lanes a
    thread at one shard), 3 runs equal."""
    from historian_tpu_torch.ops import sp_pairforward

    for shape in ((300, 280), (60, 3000)):
        args = _long6_pair(*shape, dtype, cuda)
        ref = _k3_lp(args)
        runs = [sp_pairforward.sp_pair_forward(*args, mesh=_card_mesh(cuda, n))
                for _ in range(3)]
        torch.cuda.synchronize()
        assert sp_pairforward.LAST_LAUNCH["launches"] == 1
        assert all(torch.equal(r, runs[0]) for r in runs)
        _lp_close(runs[0][None], ref[None], rtol)


@pytest.mark.parametrize("n", [4, 8])
def test_sp_pair_kernel_banded_padding_matches_plain(cuda, n):
    """Kernel (g2) with a banded mask and Y + 1 = 30 (padding columns at 4
    and 8 shards, a shard of padding only at 8) against its plain version
    and pair_forward, float64: 1e-9 relative."""
    from historian_tpu_torch.ops import sp_pairforward

    args = _long6_pair(33, 29, torch.float64, cuda, offset=100, pair=(2, 3))
    args[5] = _pair_band(34, 30, 6, cuda)
    got = sp_pairforward.sp_pair_forward(*args, mesh=_card_mesh(cuda, n))
    plain = sp_pairforward.sp_pair_forward_plain(*args, n)
    _, one = pairforward.pair_forward(*args)
    for ref in (plain, one):
        _lp_close(got[None], ref[None], 1e-9)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-9)])
def test_sp_pair_strip_layouts_match_k3(cuda, n, dtype, rtol):
    """Kernel (g2) at n shards of the card at every layout of
    STRIP_LAYOUTS against K3's lp_end (60 x 3000), the layouts of one
    lanes a thread bit-equal to each other, each run twice, equal."""
    from historian_tpu_torch.ops import sp_pairforward

    args = _long6_pair(60, 3000, dtype, cuda)
    ref = _k3_lp(args)
    first = {}
    for lanes, warps, cluster in STRIP_LAYOUTS:
        runs = [sp_pairforward.sp_pair_forward(*args, mesh=_card_mesh(cuda, n), lanes=lanes,
                                               warps=warps, cluster=cluster) for _ in range(2)]
        torch.cuda.synchronize()
        lay = sp_pairforward.LAST_LAUNCH["layouts"][0]
        assert (lay["lanes"], lay["warps"], lay["cluster"]) == (lanes, warps, cluster)
        assert torch.equal(runs[0], runs[1])
        _lp_close(runs[0][None], ref[None], rtol)
        assert torch.equal(runs[0], first.setdefault(lanes, runs[0])), (lanes, warps, cluster)


@pytest.mark.parametrize("n", [1, 2])
def test_sp_pair_kernel_past_8192_columns(cuda, n):
    """Kernel (g2) on long8x12k's first pair cut to 60 rows at all 11019
    columns (at 1 shard a shard past the one-block design's 8192) against
    its plain version: 1e-9."""
    from historian_tpu_torch.ops import sp_pairforward

    args = _long6_pair(59, 11018, torch.float64, cuda, data="long8x12k.fa")
    assert args[0].shape == (60, 11019)
    got = sp_pairforward.sp_pair_forward(*args, mesh=_card_mesh(cuda, n))
    assert sp_pairforward.LAST_LAUNCH["layouts"][0]["strips"] > 1
    plain = sp_pairforward.sp_pair_forward_plain(*args, n)
    _lp_close(got[None], plain[None], 1e-9)


@pytest.mark.parametrize("place", ["host", "peer"])
@pytest.mark.parametrize("n", [2, 8])
def test_sp_pair_kernel_system_scope_exchange(cuda, monkeypatch, place, n):
    """Kernel (g2)'s cross-card exchange on the one card: every boundary's
    records in pinned host memory ("host") or in the card's memory at
    system scope ("peer"), float64; lp_end within 1e-9 of K3's, 3 runs."""
    from historian_tpu_torch.ops import sp_pairforward

    args = _long6_pair(200, 260, torch.float64, cuda)
    ref = _k3_lp(args)
    monkeypatch.setattr(sp_pairforward, "_record_place", lambda writer, reader: place)
    for _ in range(3):
        got = sp_pairforward.sp_pair_forward(*args, mesh=_card_mesh(cuda, n))
        _lp_close(got[None], ref[None], 1e-9)
    assert sp_pairforward.LAST_LAUNCH["places"] == [place] * (n - 1)


def test_sp_pair_batch_kernel_matches_k3(cuda):
    """sp_pair_forward_batch on a 2 x 4 dp x sp mesh of the card over 8
    pairs (one launch, 32 blocks) against K3, float64."""
    from historian_tpu_torch.ops import sp_pairforward

    pairs = [_long6_pair(150, 170, torch.float64, cuda, offset=37 * k, pair=(k % 6, (k + 1) % 6))
             for k in range(8)]
    batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
    ref = pairforward.pair_forward_lp(*batch, pairs[0][6])
    got = sp_pairforward.sp_pair_forward_batch(
        *batch, pairs[0][5], pairs[0][6], mesh=_card_mesh(cuda, 8, ("dp", "sp"), (2, 4)))
    assert sp_pairforward.LAST_LAUNCH["blocks"] == [32]
    _lp_close(got, ref, 1e-9)


def test_sp_pair_batch_past_capacity_in_waves(cuda):
    """sp_pair_forward_batch with more pairs than one launch can hold (the
    card's capacity at the widest strip, plus 9; 30 x 300 each, one shard):
    the batch runs in waves, each resident at once, against K3 and the
    plain version: 1e-9."""
    from historian_tpu_torch.ops import pairstrips, sp_pairforward

    cap = pairstrips.card_capacity("sppairforward", "f64", torch.cuda.current_device(), 4, 8, 1)
    B = cap + 9
    base = [_long6_pair(29, 299, torch.float64, cuda, offset=7 * k, pair=(k % 6, (k + 1) % 6))
            for k in range(6)]
    pairs = [base[k % 6] for k in range(B)]
    batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
    ref = pairforward.pair_forward_lp(*batch, pairs[0][6])
    got = sp_pairforward.sp_pair_forward_batch(
        *batch, pairs[0][5], pairs[0][6], mesh=_card_mesh(cuda, 1, ("dp", "sp"), (1, 1)))
    waves = sp_pairforward.LAST_LAUNCH["waves"]
    assert len(waves) >= 2 and sum(waves) == B
    assert sp_pairforward.LAST_LAUNCH["launches"] == len(waves)
    _lp_close(got, ref, 1e-9)
    plain = torch.stack([sp_pairforward.sp_pair_forward_plain(*base[k][:5], base[0][5],
                                                              base[0][6], 1) for k in range(6)])
    _lp_close(got[:6], plain, 1e-9)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-9)])
def test_pp_pair_kernel_matches_k3(cuda, n, dtype, rtol):
    """Kernel (g3) at n stages of the card against K3's lp_end: 6 pairs of
    120 x 150 (121 rows, which 2, 4 and 8 do not divide) and 3 pairs of
    4 x 60 (5 rows: at 8 stages three stages pass the carry through), 3
    runs equal."""
    from historian_tpu_torch.parallel import pp_pairforward

    for count, x_len, y_len in ((6, 120, 150), (3, 4, 60)):
        pairs = [_long6_pair(x_len, y_len, dtype, cuda, offset=50 * k, pair=(k, (k + 1) % 6))
                 for k in range(count)]
        batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
        ref = pairforward.pair_forward_lp(*batch, pairs[0][6])
        runs = [pp_pairforward.pp_pair_forward_lp(*batch, pairs[0][6],
                                                  mesh=_card_mesh(cuda, n, ("pp",)))
                for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(r, runs[0]) for r in runs)
        assert pp_pairforward.LAST_LAUNCH["launches"] == 1
        _lp_close(runs[0], ref, rtol)


#: (g3) layouts (lanes, warps, cluster, slots) held against the plain
#: version: one slot for every item (the items in turn), records at every
#: edge, the rule's cluster, wide strips, blocks of 13 and 15 row warps
PP_LAYOUTS = [(1, 1, 1, 1), (1, 2, 8, None), (1, 2, 4, 2), (2, 4, 8, 3), (4, 8, 8, None),
              (1, 4, 16, None), (1, 13, 2, None), (1, 15, 1, 2)]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-9)])
def test_pp_pair_strip_layouts_match_plain_and_k3(cuda, n, dtype, rtol):
    """Kernel (g3) on strips at every layout of PP_LAYOUTS, n stages of the
    card, 5 pairs of 70 x 700: against its plain version and K3, each
    layout's two runs equal; the layout is the one forced."""
    from historian_tpu_torch.parallel import pp_pairforward

    pairs = [_long6_pair(70, 700, dtype, cuda, offset=30 * k, pair=(k, (k + 2) % 6))
             for k in range(5)]
    batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
    ref = pairforward.pair_forward_lp(*batch, pairs[0][6])
    plain = pp_pairforward.pp_pair_forward_lp_plain(*batch, pairs[0][6], n)
    for lanes, warps, cluster, slots in PP_LAYOUTS:
        force = {k: v for k, v in dict(lanes=lanes, warps=warps, cluster=cluster,
                                       slots=slots).items() if v is not None}
        runs = [pp_pairforward._kernel(*batch, pairs[0][6], [cuda] * n, force)
                for _ in range(2)]
        torch.cuda.synchronize()
        lay = next(iter(pp_pairforward.LAST_LAUNCH["layouts"].values()))
        assert (lay["lanes"], lay["warps"], lay["cluster"]) == (lanes, warps, cluster)
        assert slots is None or lay["slots"] == slots
        assert torch.equal(runs[0], runs[1])
        _lp_close(runs[0], plain, rtol)
        _lp_close(runs[0], ref, rtol)


@pytest.mark.parametrize("n", [2, 4])
def test_pp_pair_kernel_past_8192_columns(cuda, n):
    """Kernel (g3) at Y + 1 = 8300 (past the one-block design's 8192), two
    pairs of 40 rows from long8x12k, float64, against its plain version:
    1e-9."""
    from historian_tpu_torch.parallel import pp_pairforward

    pairs = [_long6_pair(39, 8299, torch.float64, cuda, offset=o, pair=(a, b),
                         data="long8x12k.fa") for o, a, b in ((0, 0, 1), (50, 2, 3))]
    batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
    assert batch[0].shape == (2, 40, 8300)
    got = pp_pairforward.pp_pair_forward_lp(*batch, pairs[0][6],
                                            mesh=_card_mesh(cuda, n, ("pp",)))
    plain = pp_pairforward.pp_pair_forward_lp_plain(*batch, pairs[0][6], n)
    _lp_close(got, plain, 1e-9)


def test_pp_pair_kernel_host_boundaries(cuda, monkeypatch):
    """Kernel (g3) with every stage boundary in pinned host memory at
    system scope (the buffer of two cards without peer access), 4 stages,
    float64, against K3."""
    from historian_tpu_torch.parallel import pp_pairforward

    pairs = [_long6_pair(90, 110, torch.float64, cuda, offset=9 * k) for k in range(5)]
    batch = [torch.stack([p[i] for p in pairs]) for i in range(5)]
    ref = pairforward.pair_forward_lp(*batch, pairs[0][6])
    monkeypatch.setattr(pp_pairforward, "_record_place", lambda writer, reader: "host")
    got = pp_pairforward.pp_pair_forward_lp(*batch, pairs[0][6],
                                            mesh=_card_mesh(cuda, 4, ("pp",)))
    assert pp_pairforward.LAST_LAUNCH["places"] == ["host"] * 3
    _lp_close(got, ref, 1e-9)
