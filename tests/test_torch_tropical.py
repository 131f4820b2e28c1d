"""Kernel (f)'s plain version, the tropical pair DP
(historian_tpu_torch/ops/tropical.py), against the JAX package's
ops/tropical.py on the CPU.

Inputs: long6's first two sequences cut to 36 x 28 and 60 x 74 residues
(grids 37 x 29 and 61 x 75), preset lg, in float64 and float32, with the
full mask and with a diagonal band; the same arrays go to both packages.

- `tropical_pair_forward`: the cells above -1e29 within 1e-12 relative in
  float64 (1e-4 in float32), and a cell at or below -1e29 in one at or
  below -1e29 in the other; lp_best equal within the same tolerance, and
  no greater than the port's `pair_forward` lp_end (Viterbi under
  Forward).  Every max is exact, so only the scans' sums of b, associated
  otherwise than XLA's `associative_scan`, may round apart.
- A masked cell holds exactly NEG.
- `max_affine_scan` against the JAX one on seeded vectors (with NEG
  entries), the same tolerances.
"""

import os

import numpy as np
import pytest
import torch

from historian_tpu.ops import tropical as jax_trop
from historian_tpu_torch.ops import pairforward, tropical
from tests.torch_twins import band_mask, long6_pair

DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-4)}
SHAPES = [(36, 28), (60, 74)]


def _compare(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    live = ref > -1e29
    assert np.array_equal(got > -1e29, live)
    np.testing.assert_allclose(got[live], ref[live], rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("banded", [False, True])
def test_tropical_matches_jax(dtype, shape, banded):
    tdt, rtol = DTYPES[dtype]
    args = list(long6_pair(*shape, tdt))
    X1, Y1 = args[0].shape
    if banded:
        args[5] = band_mask(X1, Y1, 5)
    cells, lp_best = tropical.tropical_pair_forward(*args)
    j_cells, j_lp = jax_trop.tropical_pair_forward(*(a.numpy() for a in args))
    assert cells.shape == (X1, Y1, 5) and cells.dtype == tdt
    _compare(cells.numpy(), j_cells, rtol)
    _compare(lp_best.numpy()[None], np.asarray(j_lp)[None], rtol)
    assert float(lp_best) > -1e29
    masked = ~args[5].numpy()
    assert np.all(cells.numpy()[masked] == np.float32(-1e30) if tdt == torch.float32
                  else cells.numpy()[masked] == -1e30)
    _, lp_end = pairforward.pair_forward(*(a.double() if a.is_floating_point() else a
                                           for a in args))
    assert float(lp_best) <= float(lp_end) + 1e-9 * abs(float(lp_end))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 7, 64, 129])
def test_max_affine_scan_matches_jax(dtype, n):
    tdt, rtol = DTYPES[dtype]
    rng = np.random.default_rng(n)
    a = rng.normal(-20, 5, (3, n))
    b = rng.normal(-2, 1, (3, n))
    a[rng.random((3, n)) < 0.2] = -1e30
    b[rng.random((3, n)) < 0.1] = -1e30
    npdt = np.float32 if tdt == torch.float32 else np.float64
    a, b = a.astype(npdt), b.astype(npdt)
    got = tropical.max_affine_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.stack([np.asarray(jax_trop.max_affine_scan(a[k], b[k])) for k in range(3)])
    _compare(got, ref, rtol)


def test_tropical_checks_inputs():
    args = list(long6_pair(8, 9, torch.float64))
    with pytest.raises(ValueError, match="mask"):
        tropical.tropical_pair_forward(*args[:5], args[5][:, :-1], args[6])
    with pytest.raises(TypeError):
        tropical.tropical_pair_forward(*(a.half() if a.is_floating_point() else a for a in args))


# ---- the strip layout of kernels (f) and (g2) (ops/pairstrips.py) and the
# plain version by strips, the handoff the kernel does

#: chip_smoke.py's TROPICAL_RTOL, the kernel against its plain version
TROPICAL_RTOL = {"f64": 1e-12, "f32": 1e-5}

def _capacity(cap):
    return lambda lanes, warps, cluster: cap


@pytest.mark.parametrize("kernel", ["tropical", "sppairforward"])
@pytest.mark.parametrize("chains,sms,cap,force", [
    ([(0, 6100)], 132, 1024, {}),
    ([(0, 6100)], 132, 64, {}),
    ([(0, 11019)], 132, 1024, {}),
    ([(0, 29)], 132, 1024, {}),
    ([(0, 1)], 132, 1024, {}),
    ([(d * 752, 752 if d < 7 else 752 - 5) for d in range(8)], 132, 1024, {}),
    ([(d * 43, 43) for d in range(4)] * 8, 132, 1024, {}),
    ([(0, 6100)], 132, 4096, dict(lanes=1, warps=1, cluster=1)),
    ([(0, 6100)], 132, 4096, dict(lanes=2, warps=3, cluster=16)),
    ([(0, 2101)], 132, 4096, dict(lanes=4, warps=8, cluster=8)),
    ([(0, 700), (700, 300)], 16, 4096, dict(lanes=1, warps=2, cluster=3)),
], ids=["long12", "long12-cap64", "long8x12k", "narrow", "one-col", "8-shards", "batch",
        "1x1x1", "2x3x16", "4x8x8", "two-chains"])
def test_strip_plan_covers_each_column_once(kernel, chains, sms, cap, force):
    """Every column of every chain in exactly one strip, in order; every
    strip of a chain 32 * lanes * warps wide but its last; clusters of at
    most 16 filling the grid; edges of a chain's strips in one cluster
    through shared memory, across a cluster's end through a record, a
    chain's own ends NONE; the blocks within the capacity."""
    from historian_tpu_torch.ops import pairstrips as ps

    plan = ps.strip_plan(kernel, chains, sms, _capacity(cap), **force)
    if force:
        assert (plan.lanes, plan.warps, plan.cluster) == tuple(force.values())
    assert 1 <= plan.cluster <= ps.MAX_CLUSTER and plan.blocks % plan.cluster == 0
    assert plan.blocks <= cap and plan.threads == 32 * (plan.warps + 1)
    for j, (start, n) in enumerate(chains):
        k = np.flatnonzero(plan.chain == j)
        assert np.all(np.diff(k) == 1)
        cols = np.concatenate([np.arange(c, c + w) for c, w in zip(plan.c0[k], plan.nc[k])])
        assert np.array_equal(cols, np.arange(start, start + n))
        assert np.all(plan.nc[k[:-1]] == plan.width) and 1 <= plan.nc[k[-1]] <= plan.width
        assert plan.left[k[0]] == ps.NONE and plan.right[k[-1]] == ps.NONE
        inner = k[1:]
        want = np.where(inner % plan.cluster != 0, ps.CLUSTER_EDGE, ps.RECORD)
        assert np.array_equal(plan.left[inner], want)
        assert np.array_equal(plan.right[k[:-1]], want)
    idle = plan.chain < 0
    assert np.all(plan.nc[idle] == 0) and idle.sum() < plan.cluster
    assert np.all(plan.left[idle] == ps.NONE) and np.all(plan.right[idle] == ps.NONE)


@pytest.mark.parametrize("kernel,chains,sms,cap,want", [
    ("tropical", [(0, 6100)], 132, 1024, (1, 4)),
    ("tropical", [(0, 6100)], 40, 1024, (1, 8)),
    ("tropical", [(0, 11020)], 132, 1024, (1, 4)),
    ("tropical", [(0, 20000)], 132, 1024, (1, 8)),
    ("tropical", [(0, 6100)], 132, 20, (2, 8)),
    ("tropical", [(0, 6100)], 4, 12, (4, 8)),
    ("sppairforward", [(0, 6016)], 132, 1024, (1, 2)),
    ("sppairforward", [(d * 752, 752 if d < 7 else 752 - 5) for d in range(8)], 132, 1024,
     (1, 2)),
    ("sppairforward", [(0, 11020)], 132, 1024, (1, 4)),
    ("sppairforward", [(0, 6016)], 132, 40, (1, 8)),
    ("sppairforward", [(d * 43, 43) for d in range(4)] * 8, 132, 1024, (1, 2)),
], ids=["f-one-an-sm", "f-fewer-sms", "f-long8x12k", "f-wider", "f-capacity", "f-past-the-sms",
        "g2-one-an-sm", "g2-8-shards", "g2-long8x12k", "g2-capacity", "g2-batch"])
def test_strip_plan_rule(kernel, chains, sms, cap, want):
    """The rule: the narrowest shape of the kernel's ladder whose blocks
    fit one an SM and the capacity, else the narrowest that fits the
    capacity."""
    from historian_tpu_torch.ops import pairstrips as ps

    plan = ps.strip_plan(kernel, chains, sms, _capacity(cap))
    assert (plan.lanes, plan.warps) == want
    assert plan.cluster == min(ps.CLUSTER, -(-max(n for _, n in chains) // plan.width))


@pytest.mark.parametrize("kernel", ["tropical", "sppairforward"])
@pytest.mark.parametrize("chains,cap,force", [
    ([(0, 6100)], 5, {}),
    ([(0, 6100)], 100, dict(lanes=1, warps=1, cluster=1)),
    ([(0, 100)], 100, dict(lanes=3, warps=1, cluster=1)),
    ([(0, 100)], 100, dict(lanes=1, warps=9, cluster=1)),
    ([(0, 100)], 100, dict(lanes=1, warps=2, cluster=17)),
    ([(0, 0)], 100, {}),
], ids=["not-resident", "forced-not-resident", "lanes", "warps", "cluster", "empty"])
def test_strip_plan_raises(kernel, chains, cap, force):
    """A layout that cannot be resident, or a shape no kernel is built
    for, raises: nothing falls back to a narrower launch."""
    from historian_tpu_torch.ops import pairstrips as ps

    with pytest.raises(ValueError):
        ps.strip_plan(kernel, chains, 132, _capacity(cap), **force)


def test_strip_table_records():
    """The table of a plan: a record between the strips of a chain across a
    cluster's end (one buffer, written by the left strip and read by the
    right), a chain's own ends as given, the system-scope flag where a
    record crosses cards."""
    from historian_tpu_torch.ops import pairstrips as ps

    plan = ps.strip_plan("sppairforward", [(0, 600), (600, 200)], 132, _capacity(1024),
                         lanes=1, warps=2, cluster=4)
    host = (torch.zeros(7, 8), torch.zeros(1, dtype=torch.int32), True)
    table, records = ps.strip_table(plan, 7, torch.float64, torch.device("cpu"),
                                    {(1, "left"): host})
    assert table.shape == (plan.blocks, ps.ENTRY)
    assert len(records) == int(np.count_nonzero(plan.right == ps.RECORD))
    for k in np.flatnonzero(plan.right == ps.RECORD):
        assert table[k, 4] == ps.RECORD and table[k + 1, 3] == ps.RECORD
        assert table[k, 7] == table[k + 1, 5] != 0 and table[k, 8] == table[k + 1, 6] != 0
    first = np.flatnonzero(plan.chain == 1)[0]
    assert table[first, 3] == ps.RECORD and table[first, 5] == host[0].data_ptr()
    assert table[first, 9] == 1 and table[0, 9] == 0
    assert np.array_equal(table[:, 0], plan.chain)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("strips", [1, 2, 3, 8])
def test_tropical_plain_by_strips_matches_jax(dtype, strips):
    """The plain version with its two scans run strip by strip, the left
    strip's u carried in as the kernel hands it on, against the JAX
    function and the whole-row scans (banded, so the strips cross masked
    cells): TROPICAL_RTOL."""
    tdt, rtol = DTYPES[dtype][0], TROPICAL_RTOL[dtype]
    args = list(long6_pair(60, 74, tdt))
    args[5] = band_mask(61, 75, 9)
    cells, lp_best = tropical.tropical_pair_forward_plain(*args, strips=strips)
    j_cells, j_lp = jax_trop.tropical_pair_forward(*(a.numpy() for a in args))
    _compare(cells.numpy(), j_cells, rtol)
    _compare(lp_best.numpy()[None], np.asarray(j_lp)[None], rtol)
    whole, _ = tropical.tropical_pair_forward_plain(*args)
    _compare(cells.numpy(), whole.numpy(), rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("strips", [1, 3])
def test_tropical_past_8192_columns_matches_jax(dtype, strips):
    """A few rows at 8300 columns (past the one-block design's 8192) from
    long8x12k's first pair: the plain version, whole and by strips, against
    the JAX function."""
    from historian_tpu_torch.ops.pairforward import chain_pair_forward_arrays
    from tests.torch_twins import DATA, PORT

    tdt, rtol = DTYPES[dtype][0], TROPICAL_RTOL[dtype]
    seqs = PORT.seqs.read_fasta(os.path.join(DATA, "long8x12k.fa"))
    args, _ = chain_pair_forward_arrays(PORT.presets.named_model("lg"), seqs[0].seq[:3],
                                        seqs[1].seq[:8299], 0.5, 0.5, dtype=tdt)
    assert args[0].shape == (4, 8300)
    cells, lp_best = tropical.tropical_pair_forward_plain(*args, strips=strips)
    j_cells, j_lp = jax_trop.tropical_pair_forward(*(a.numpy() for a in args))
    _compare(cells.numpy(), j_cells, rtol)
    _compare(lp_best.numpy()[None], np.asarray(j_lp)[None], rtol)
