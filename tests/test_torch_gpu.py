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

from historian_tpu_torch.ops import _kernels, colforward, guidedp, pairforward, tracedp
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
                 (200, 230, -2)]


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", BRANCH_SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in BRANCH_SHAPES])
def test_branchfill_kernel_matches_host_and_plain(cuda, shape, viterbi):
    """Kernel (e) against csrc/fill.cpp `branch_fill` (Viterbi: bit for bit;
    Forward: 1e-12 relative, the card's exp and log1p against glibc's) and
    against its plain version (1e-12 relative); outside the mask every
    state is NEG.  Diagonals longer than a block (1300 x 1100), a mask with
    holes, grids of one row or column included."""
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


def test_branchfill_band_readback(cuda):
    """read_band on the card: the in-mask cells and their indices found
    and gathered there, copied to pinned memory, and the rest read as
    NEG."""
    from historian_tpu_torch.ops import branchdp, readback

    emit, ins, mask, trans = _branch_inputs(300, 280, 8, seed=5)
    t = [torch.as_tensor(a, device=cuda) for a in (emit, ins, mask, trans)]
    grid = branchdp.branch_fill(*t, True)
    full = grid.cpu().numpy()
    cells = branchdp.read_band(grid, t[2])
    assert readback.READBACKS[-1]["bytes"] == mask.sum() * (24 + 8)
    assert readback.READBACKS[-1]["kind"] == "branch"
    rng = np.random.default_rng(0)
    for x, y in zip(rng.integers(0, 300, 2000), rng.integers(0, 280, 2000)):
        assert np.array_equal(cells[x, y], full[x, y])


def test_branchfill_rejects_float32(cuda):
    from historian_tpu_torch.ops import branchdp

    t = [torch.as_tensor(a, device=cuda) for a in _branch_inputs(5, 5, -1, 0)]
    t[0] = t[0].float()
    with pytest.raises(ValueError, match="float64"):
        branchdp.branch_fill(*t, True)
