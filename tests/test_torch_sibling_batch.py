"""Kernel (d')'s plain version, the batched sibling fill
(historian_tpu_torch/ops/siblingdp.py `sibling_forward_batch`) and
`SiblingMatrix.fill_batch`, against the JAX package's on the CPU, float64.

- `sibling_forward_batch` at K = 3 grids of mixed sizes padded to one
  shape (seeded synthetic inputs, a banded and two full masks): inside
  each item's corner the same NEG pattern (cells at or below -1e29) and
  the other cells within 1e-12 relative of the JAX function's; lp_end too;
  past the corner every cell at or below -1e29.
- `fill_batch` on the proposal grids of a 6-leaf UPGMA tree (as
  tests/test_sibling_batch.py builds them, with preset lg and a 60-column
  simulated alignment), each package building its own SiblingMatrix
  objects: the port's batch against the JAX package's batch and against
  the port's own per-matrix fills (csrc/fill.cpp): cells within 1e-9
  relative (-inf at the same cells), lp_end within 1e-6; mixed grid
  sizes in the batch.
- A batch whose widest diagonal holds more than 256 cells (kernel (d')'s
  strips of a cluster on the card), with unequal corners: against the
  JAX package's batch and each item's own fill (csrc/fill.cpp); and
  `batch_layout`, the kernel's clusters, lane groups and turns.
- `fill_batch([])` returns True.
"""

import importlib

import numpy as np
import pytest
import torch

from historian_tpu.ops import siblingdp as jax_sib
from historian_tpu_torch import device
from historian_tpu_torch.ops import siblingdp
from historian_tpu_torch.sampler.sibling import native_fill
from tests.test_torch_siblingdp import fill_inputs

ITEMS = [(30, 41, 5), (44, 37, None), (17, 25, None)]


def _batch(items=ITEMS):
    """Padded batch inputs (numpy) of `items` (X, Y, band): NEG for -inf,
    as fill_batch builds them."""
    K = len(items)
    X1 = max(x for x, _, _ in items) + 1
    Y1 = max(y for _, y, _ in items) + 1
    l_emit = np.full((K, X1 - 1), -1e30)
    r_emit = np.full((K, Y1 - 1), -1e30)
    match = np.full((K, X1, Y1), -1e30)
    mask = np.zeros((K, X1, Y1), bool)
    trans = np.empty((K, 35))
    ends = np.empty((K, 2), np.int32)
    for k, (X, Y, band) in enumerate(items):
        le, re, me, mk, tmat = fill_inputs(X, Y, band, seed=10 + k)
        l_emit[k, :X], r_emit[k, :Y] = le, re
        match[k, : X + 1, : Y + 1] = np.where(np.isfinite(me), me, -1e30)
        mask[k, : X + 1, : Y + 1] = mk
        trans[k] = siblingdp.pack_table(tmat)
        ends[k] = (X, Y)
    return l_emit, r_emit, match, mask, trans, ends


def test_sibling_forward_batch_matches_jax():
    arrays = _batch()
    cells, lp_end = siblingdp.sibling_forward_batch(*(torch.from_numpy(a) for a in arrays))
    j_cells, j_lp = (np.asarray(v) for v in jax_sib.sibling_forward_batch(*arrays))
    cells, lp_end = cells.numpy(), lp_end.numpy()
    assert cells.shape == j_cells.shape
    for k, (X, Y, _) in enumerate(ITEMS):
        got, ref = cells[k, : X + 1, : Y + 1], j_cells[k, : X + 1, : Y + 1]
        live = ref > -1e29
        assert np.array_equal(got > -1e29, live)
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-12, atol=0)
        assert np.all(cells[k, X + 1:] <= -1e29) and np.all(cells[k, :, Y + 1:] <= -1e29)
    assert np.all(j_lp > -1e29)
    np.testing.assert_allclose(lp_end, j_lp, rtol=1e-12, atol=0)


#: two items past 256 cells a diagonal, with unequal corners
WIDE_ITEMS = [(300, 262, None), (265, 300, 40)]


def test_sibling_forward_batch_wide_matches_jax_and_single_fills():
    """Items whose diagonals hold up to 263 and 266 cells: inside each
    corner the JAX function's NEG pattern and values (1e-12 relative) and
    fill.cpp's (-inf at the same cells, 1e-9 relative: the row scan's
    drift); lp_end likewise; NEG past the corner."""
    arrays = _batch(WIDE_ITEMS)
    cells, lp_end = (v.numpy() for v in siblingdp.sibling_forward_batch(
        *(torch.from_numpy(a) for a in arrays)))
    j_cells, j_lp = (np.asarray(v) for v in jax_sib.sibling_forward_batch(*arrays))
    for k, (X, Y, band) in enumerate(WIDE_ITEMS):
        got, ref = cells[k, : X + 1, : Y + 1], j_cells[k, : X + 1, : Y + 1]
        live = ref > -1e29
        assert np.array_equal(got > -1e29, live)
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-12, atol=0)
        assert np.all(cells[k, X + 1:] <= -1e29) and np.all(cells[k, :, Y + 1:] <= -1e29)
        host, host_lp = native_fill(*fill_inputs(X, Y, band, seed=10 + k))
        _same(np.where(got <= -1e29, -np.inf, got), host, lp_end[k], host_lp)
    np.testing.assert_allclose(lp_end, j_lp, rtol=1e-12, atol=0)


#: an H100's opt-in shared memory a block
H100_SMEM = 232448
#: sx -> kernel (d')'s layout by default and at a forced cluster on an H100
LAYOUTS = {(40, None): dict(cluster=1, groups=40, turns=1, rows=40, ring="shared"),
           (161, None): dict(cluster=4, groups=48, turns=1, rows=48, ring="shared"),
           (306, None): dict(cluster=4, groups=80, turns=1, rows=80, ring="shared"),
           (306, 2): dict(cluster=2, groups=160, turns=1, rows=160, ring="shared"),
           (306, 1): dict(cluster=1, groups=160, turns=2, rows=320, ring="shared"),
           (306, 8): dict(cluster=8, groups=40, turns=1, rows=40, ring="shared"),
           (3000, None): dict(cluster=8, groups=128, turns=3, rows=384, ring="shared"),
           (6000, None): dict(cluster=8, groups=152, turns=5, rows=760, ring="shared"),
           (7001, None): dict(cluster=8, groups=152, turns=6, rows=912, ring="device"),
           (11001, None): dict(cluster=8, groups=160, turns=9, rows=1440, ring="device")}


@pytest.mark.parametrize("case", list(LAYOUTS), ids=[str(c) for c in LAYOUTS])
def test_batch_layout(case):
    """`batch_layout`: the fewest blocks a cluster whose strips of
    BATCH_ROWS rows hold the grid's rows, a lane group a row (turns only
    past a cluster's lane groups), whole warps of lane groups; every row
    has a slot; the strip's planes in shared memory while a block's
    shared memory holds them, past that in device memory (any rows)."""
    sx, cluster = case
    lay = siblingdp.batch_layout(sx, H100_SMEM, cluster)
    assert lay == LAYOUTS[case]
    assert lay["cluster"] * lay["rows"] >= sx and lay["groups"] % 8 == 0
    with pytest.raises(ValueError, match="clusters"):
        siblingdp.batch_layout(300, H100_SMEM, 3)


def _proposal_mats(pkg: str, defer: bool) -> list:
    """Sibling matrices of `pkg` for the internal nodes of a 6-leaf UPGMA
    tree (at most 3), from a 60-column alignment simulated on it."""
    mod = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "core.alignpath", "core.tree", "engine.treealign", "models.presets",
        "sampler.sibling", "sampler.simulator", "utils.rng")}
    model = mod["models.presets"].named_model("lg")
    rng = np.random.RandomState(7)
    pts = np.sort(rng.uniform(0.1, 1.0, 6))
    dist = np.abs(pts[:, None] - pts[None, :]) + 0.1
    np.fill_diagonal(dist, 0.0)
    tree = mod["core.tree"].Tree.upgma([f"L{i}" for i in range(6)], dist)
    tree.assign_internal_node_names()
    stock = mod["sampler.simulator"].simulate_tree(mod["utils.rng"].MT19937(5), model, tree, 60)
    rows = tree.reorder_seqs(stock.gapped)
    out = []
    for node in range(tree.n_nodes()):
        if tree.is_leaf(node) or len(out) >= 3:
            continue
        l_child, r_child = tree.children(node)
        pwms = mod["engine.treealign"].get_conditional_pwms(
            model, tree, rows, {l_child: node, r_child: node})
        out.append(mod["sampler.sibling"].SiblingMatrix(
            model, pwms[l_child], pwms[r_child], tree.branch_length(l_child),
            tree.branch_length(r_child), mod["core.alignpath"].GuideAlignmentEnvelope(),
            np.arange(len(pwms[l_child]) + 1), np.arange(len(pwms[r_child]) + 1),
            l_child, r_child, node, defer_fill=defer))
    return out


def _same(got, ref, lp_got, lp_ref):
    assert got.shape == ref.shape
    live = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), live)
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-9, atol=0)
    assert abs(lp_got - lp_ref) < 1e-6


def test_fill_batch_matches_jax_and_single_fills(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_SIBLING", "0")
    device.select("cpu")
    port = _proposal_mats("historian_tpu_torch", True)
    jax_mats = _proposal_mats("historian_tpu", True)
    singles = _proposal_mats("historian_tpu_torch", False)
    assert len(port) == 3 and len({(m.x_size, m.y_size) for m in port}) >= 2
    assert type(port[0]).fill_batch(port) is True
    assert type(jax_mats[0]).fill_batch(jax_mats) is True
    for p, j, s in zip(port, jax_mats, singles):
        jc = np.where(np.asarray(j.cells) < -1e29, -np.inf, j.cells)
        _same(p.cells, jc, p.lp_end, j.lp_end)
        _same(p.cells, np.asarray(s.cells), p.lp_end, s.lp_end)


def test_fill_batch_empty():
    from historian_tpu_torch.sampler.sibling import SiblingMatrix

    assert SiblingMatrix.fill_batch([]) is True


def test_sibling_forward_batch_checks_inputs():
    arrays = [torch.from_numpy(a) for a in _batch()]
    bad = list(arrays)
    bad[5] = torch.tensor([[0, 0], [0, 0], [99, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="ends outside"):
        siblingdp.sibling_forward_batch(*bad)
    with pytest.raises(ValueError, match="trans"):
        siblingdp.sibling_forward_batch(*arrays[:4], arrays[4][:, :34], arrays[5])
