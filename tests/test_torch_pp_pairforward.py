"""Kernel (g3)'s plain version, the pipeline-parallel pair Forward
(historian_tpu_torch/parallel/pp_pairforward.py), against the JAX
package's parallel/pp_pairforward.py on the CPU, float64, on the 8
virtual CPU devices of tests/conftest.py.

Inputs: five pairs of long6's sequences cut to 37 x 45 residues (X + 1 =
38 rows, which 3 and 8 stages do not divide), preset lg; the same arrays
go to both packages.  At 1, 2, 3 and 8 stages, lp_end [PAIRS] within 1e-9
absolute of the JAX function on the same mesh and of the port's
`pair_forward` pair by pair; a stage with no real row (8 stages of 5 rows,
the last holding 3) passes the carry through.  The plain version by 1, 2,
3 and 8 strips (the kernel's hand-off of the scans' carries) against the
JAX function on 3 stages; Y + 1 = 8300 (past the one-block design's 8192)
through the entry point and by strips against the JAX function; kernel
(g3)'s layout (ops/pairstrips.py `slot_plan`: its slots, strips and rule)
and its items' stage order.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from historian_tpu.parallel import pp_pairforward as jax_pp
from historian_tpu_torch import device
from historian_tpu_torch.ops import pairforward
from historian_tpu_torch.parallel import mesh as port_mesh
from historian_tpu_torch.parallel import pp_pairforward
from tests.torch_twins import long6_pair

ATOL = 1e-9
PAIRS = ((0, (0, 1)), (40, (2, 3)), (120, (4, 5)), (300, (1, 2)), (7, (3, 0)))


@pytest.fixture(scope="module")
def batch():
    pairs = [long6_pair(37, 45, torch.float64, offset=o, pair=p) for o, p in PAIRS]
    lp_one = [float(pairforward.pair_forward(*p)[1]) for p in pairs]
    return [torch.stack([p[k] for p in pairs]) for k in range(5)], pairs[0][6], lp_one


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_pp_pair_forward_matches_jax(batch, n):
    arrays, trans, lp_one = batch
    device.select("cpu")
    jm = JaxMesh(np.array(jax.devices()[:n]), ("pp",))
    pm = port_mesh.Mesh(port_mesh.global_devices()[:n], ("pp",))
    lp = pp_pairforward.pp_pair_forward_lp(*arrays, trans, mesh=pm).numpy()
    lp_jax = np.asarray(jax_pp.pp_pair_forward_lp(*(a.numpy() for a in arrays), trans.numpy(),
                                                  mesh=jm))
    assert np.all(lp > -1e29)
    np.testing.assert_allclose(lp, lp_jax, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lp, lp_one, rtol=0, atol=ATOL)


def test_pp_stage_rows():
    """Stage k's rows: ceil(X1 / n) a stage, the last ones short or empty."""
    assert [pp_pairforward._stage_rows(38, 8, k) for k in range(8)] == [
        (0, 5), (5, 10), (10, 15), (15, 20), (20, 25), (25, 30), (30, 35), (35, 38)]
    assert pp_pairforward._stage_rows(5, 8, 7) == (7, 5)


_JAX_LP: dict = {}


def _jax_lp(key, arrays, trans, n: int) -> np.ndarray:
    """The JAX function's lp_end on n stages, once a case (it compiles for
    each call)."""
    if key not in _JAX_LP:
        jm = JaxMesh(np.array(jax.devices()[:n]), ("pp",))
        _JAX_LP[key] = np.asarray(jax_pp.pp_pair_forward_lp(
            *(a.numpy() for a in arrays), trans.numpy(), mesh=jm))
    return _JAX_LP[key]


@pytest.mark.parametrize("strips", [1, 2, 3, 8])
def test_pp_pair_forward_plain_by_strips_matches_jax(batch, strips):
    """The plain version with the row cut into strips, the scans' carries
    composed strip by strip as kernel (g3) hands them on, against the JAX
    function on 3 stages and `pair_forward`: 1e-9."""
    arrays, trans, lp_one = batch
    lp = pp_pairforward.pp_pair_forward_lp_plain(*arrays, trans, 3, strips).numpy()
    np.testing.assert_allclose(lp, _jax_lp("37x45", arrays, trans, 3), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lp, lp_one, rtol=0, atol=ATOL)


@pytest.mark.parametrize("strips", [1, 3])
def test_pp_pair_forward_past_8192_columns_matches_jax(strips):
    """Y + 1 = 8300 (past the one-block design's 8192): two pairs of
    long8x12k's first two sequences cut to 3 x 8299 residues on 2 stages
    of the CPU mesh, `pp_pair_forward_lp` (whole rows) and the plain version
    by strips against the JAX function: 1e-9."""
    import os

    from historian_tpu_torch.ops.pairforward import chain_pair_forward_arrays
    from tests.torch_twins import DATA, PORT

    seqs = PORT.seqs.read_fasta(os.path.join(DATA, "long8x12k.fa"))
    model = PORT.presets.named_model("lg")
    pairs = [chain_pair_forward_arrays(model, seqs[a].seq[o:o + 3], seqs[b].seq[:8299], 0.5,
                                       0.5, dtype=torch.float64)[0]
             for a, b, o in ((0, 1, 0), (2, 3, 40))]
    arrays = [torch.stack([p[k] for p in pairs]) for k in range(5)]
    trans = pairs[0][6]
    assert arrays[0].shape == (2, 4, 8300)
    device.select("cpu")
    pm = port_mesh.Mesh(port_mesh.global_devices()[:2], ("pp",))
    lp_jax = _jax_lp("8300", arrays, trans, 2)
    lp = pp_pairforward.pp_pair_forward_lp(*arrays, trans, mesh=pm).numpy()
    np.testing.assert_allclose(lp, lp_jax, rtol=0, atol=ATOL)
    lp_s = pp_pairforward.pp_pair_forward_lp_plain(*arrays, trans, 2, strips).numpy()
    np.testing.assert_allclose(lp_s, lp_jax, rtol=0, atol=ATOL)


def _capacity(cap):
    return lambda lanes, warps, cluster: cap


@pytest.mark.parametrize("items,pairs,Y1,cap,force", [
    (512, 128, 385, 1024, {}),
    (512, 128, 385, 100, {}),
    (24, 6, 3001, 792, {}),
    (4, 1, 11019, 792, {}),
    (3, 1, 5, 100, {}),
    (24, 6, 3001, 4096, dict(lanes=1, warps=2, cluster=8)),
    (24, 6, 3001, 4096, dict(lanes=1, warps=2, cluster=8, slots=5)),
    (10, 5, 700, 4096, dict(lanes=4, warps=1, cluster=3, slots=10)),
    (10, 5, 700, 4096, dict(lanes=1, warps=13, cluster=2, slots=4)),
], ids=["headline", "headline-cap100", "long", "long8x12k", "narrow", "forced", "forced-slots",
        "forced-4x1x3", "forced-1x13x2"])
def test_slot_plan_covers_each_slot(items, pairs, Y1, cap, force):
    """Kernel (g3)'s layout: every slot a chain of strips covering the Y1
    columns once, in order, every strip but the last 32 * lanes * warps
    wide; at most one slot an item; the blocks within the capacity; a
    slot's strips in one cluster through shared memory, across a
    cluster's end through a record."""
    from historian_tpu_torch.ops import pairstrips as ps

    plan = ps.slot_plan(items, pairs, Y1, 132, _capacity(cap), **force)
    slots = int(plan.chain.max()) + 1
    assert 1 <= slots <= items and plan.blocks <= cap
    if "slots" in force:
        assert slots == force["slots"]
    if "lanes" in force:
        assert (plan.lanes, plan.warps, plan.cluster) == (force["lanes"], force["warps"],
                                                          force["cluster"])
    for j in range(slots):
        k = np.flatnonzero(plan.chain == j)
        cols = np.concatenate([np.arange(c, c + w) for c, w in zip(plan.c0[k], plan.nc[k])])
        assert np.array_equal(cols, np.arange(Y1))
        assert np.all(plan.nc[k[:-1]] == plan.width)
        assert plan.left[k[0]] == ps.NONE and plan.right[k[-1]] == ps.NONE
        want = np.where(k[1:] % plan.cluster != 0, ps.CLUSTER_EDGE, ps.RECORD)
        assert np.array_equal(plan.left[k[1:]], want)


@pytest.mark.parametrize("items,pairs,Y1,cap,want", [
    (512, 128, 385, 1024, (1, 2, 146)),
    (512, 128, 385, 700, (1, 4, 175)),
    (512, 128, 385, 100, (1, 13, 100)),
    (24, 6, 3001, 792, (1, 2, 16)),
    (24, 6, 3001, 200, (1, 4, 8)),
    (24, 6, 3001, 20, (4, 8, 6)),
    (4, 1, 11019, 792, (1, 2, 4)),
    (3, 1, 5, 100, (1, 2, 3)),
], ids=["headline", "headline-cap700", "headline-cap100", "long", "long-cap200", "long-cap20",
        "long8x12k", "narrow"])
def test_slot_plan_rule(items, pairs, Y1, cap, want):
    """The rule: the narrowest shape of the ladder (a short row whole in
    one strip of up to 15 one-lane warps after the one-lane strips) whose
    slots take a stage's pairs, else the one with the most slots, with as
    many slots as fit (at most one an item)."""
    from historian_tpu_torch.ops import pairstrips as ps

    plan = ps.slot_plan(items, pairs, Y1, 132, _capacity(cap))
    assert (plan.lanes, plan.warps, int(plan.chain.max()) + 1) == want


@pytest.mark.parametrize("items,pairs,Y1,cap,force", [
    (4, 1, 11019, 8, {}),
    (4, 1, 3001, 792, dict(lanes=1, warps=1, cluster=1, slots=30)),
    (4, 1, 3001, 20, dict(lanes=1, warps=2, cluster=8, slots=2)),
    (0, 1, 300, 100, {}),
    (4, 1, 300, 100, dict(lanes=3, warps=1)),
    (4, 1, 300, 100, dict(lanes=2, warps=12)),
    (4, 1, 300, 100, dict(lanes=1, warps=16)),
], ids=["not-resident", "slots-past-items", "forced-not-resident", "no-items", "lanes",
        "wide-2-lanes", "warps-16"])
def test_slot_plan_raises(items, pairs, Y1, cap, force):
    from historian_tpu_torch.ops import pairstrips as ps

    with pytest.raises(ValueError):
        ps.slot_plan(items, pairs, Y1, 132, _capacity(cap), **force)


def test_pp_items_in_stage_order():
    """A card's items run stage by stage, so an item's dependency (the
    same pair on the stage before) comes earlier."""
    items = pp_pairforward._items([2, 3, 4], 5)
    assert items.shape == (15, 2) and items.dtype == np.int32
    for t, (k, p) in enumerate(items.tolist()):
        assert t == k * 5 + p
