"""The branch fill (kernel (e)'s slice) on the CPU in float64: the port's
plain version (historian_tpu_torch/ops/branchdp.py) against the JAX
package's `branch_viterbi` / `branch_forward` (jit on the CPU) to 1e-12
relative, the port's csrc/fill.cpp `branch_fill` against the JAX
package's native one bit for bit, the plain version against fill.cpp to
1e-12, and the band readback against the full grid.  Inputs: seeded
emissions and transitions, full or banded masks of the refiner's shape
(boundary rows and columns always in)."""

import numpy as np
import pytest
import torch

from historian_tpu.native import get_native as jax_native
from historian_tpu.ops import branchdp as jax_branchdp
from historian_tpu_torch.native import get_native
from historian_tpu_torch.ops import branchdp, readback

#: (X + 1, Y + 1, band): band -1 is the full grid
SHAPES = [(37, 53, -1), (130, 97, 6), (64, 64, 0), (2, 9, -1)]


def inputs(X1, Y1, band, seed=0):
    """(match_emit, ins_emit, mask, trans): emissions of a PWM x PWM fill
    (NEG on row and column 0), a mask of cumulative-match offsets within
    `band` of each other, and the 8 log transitions of a pair HMM."""
    rng = np.random.default_rng(seed)
    emit = rng.normal(-4.0, 1.5, (X1, Y1))
    emit[0, :] = emit[:, 0] = branchdp.NEG
    ins = np.concatenate([[branchdp.NEG], rng.normal(-3.0, 0.5, Y1 - 1)])
    if band < 0:
        mask = np.ones((X1, Y1), dtype=bool)
    else:
        m1 = np.cumsum(rng.random(X1) < 0.8)
        m2 = np.cumsum(rng.random(Y1) < 0.8)
        mask = np.abs(m1[:, None] - m2[None, :]) <= band
    mask[0, :] = mask[:, 0] = mask[-1, :] = mask[:, -1] = True
    p = rng.dirichlet([8, 1, 1], 3)  # from M, I, D: to M, I, D
    trans = np.log(np.array([p[0, 0], p[0, 1], p[0, 2], p[1, 0], p[1, 1], p[1, 2],
                             p[2, 0] + p[2, 1], p[2, 2]]))
    return emit, ins, mask, trans


def native_fill(lib, emit, ins, mask, trans, viterbi):
    cells = np.empty((*emit.shape, 3))
    lib.branch_fill(emit.shape[0], emit.shape[1], np.ascontiguousarray(emit), ins,
                    np.ascontiguousarray(mask, dtype=np.uint8), trans, np.uint8(viterbi), cells)
    return cells


def plain(emit, ins, mask, trans, viterbi):
    t = [torch.as_tensor(a) for a in (emit, ins, mask, trans)]
    return branchdp.branch_fill(*t, viterbi).numpy()


def close(got, ref, rtol=1e-12):
    return np.all(np.abs(got - ref) <= rtol * np.maximum(1.0, np.abs(ref)))


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in SHAPES])
def test_plain_matches_jax(shape, viterbi):
    emit, ins, mask, trans = inputs(*shape)
    fill = jax_branchdp.branch_viterbi if viterbi else jax_branchdp.branch_forward
    ref = np.asarray(fill(emit, ins, mask, trans))
    got = plain(emit, ins, mask, trans, viterbi)
    assert got.shape == ref.shape == (*shape[:2], 3)
    assert close(got, ref)
    assert np.all(got[~mask] == branchdp.NEG)


@pytest.mark.parametrize("viterbi", [True, False], ids=["viterbi", "forward"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}b{c}" for a, b, c in SHAPES])
def test_native_matches_jax_native_and_plain(shape, viterbi):
    emit, ins, mask, trans = inputs(*shape, seed=1)
    got = native_fill(get_native(), emit, ins, mask, trans, viterbi)
    ref = native_fill(jax_native(), emit, ins, mask, trans, viterbi)
    assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
    assert close(plain(emit, ins, mask, trans, viterbi), got)


def test_wrapper_checks_and_counts():
    """A CPU tensor takes the plain version and launches nothing; bad
    shapes and a non-bool mask raise."""
    emit, ins, mask, trans = (torch.as_tensor(a) for a in inputs(9, 7, 1))
    before = branchdp.LAUNCHES
    assert branchdp.branch_fill(emit, ins, mask, trans, True).shape == (9, 7, 3)
    assert branchdp.LAUNCHES == before
    with pytest.raises(ValueError, match="shapes"):
        branchdp.branch_fill(emit, ins[:-1], mask, trans, True)
    with pytest.raises(ValueError, match="bool"):
        branchdp.branch_fill(emit, ins, mask.to(torch.uint8), trans, True)


@pytest.mark.parametrize("band", [-1, 3])
def test_read_band_reads_as_the_grid(band):
    """BandCells answers every cell as the full grid: in-mask cells from
    the band copied back, the rest NEG in all three states."""
    emit, ins, mask, trans = inputs(41, 33, band, seed=2)
    grid = branchdp.branch_fill(*(torch.as_tensor(a) for a in (emit, ins, mask, trans)), True)
    n = len(readback.READBACKS)
    band_cells = branchdp.read_band(grid, torch.as_tensor(mask))
    assert readback.READBACKS[n]["cells"] == mask.sum() and readback.READBACKS[n]["kind"] == "branch"
    assert readback.READBACKS[n]["bytes"] == mask.sum() * (24 + 8)  # the values, their indices
    full = grid.numpy()
    for x in range(41):
        for y in range(33):
            assert np.array_equal(band_cells[x, y], full[x, y])
            assert band_cells[x, y, 2] == full[x, y, 2]
            assert band_cells[x, 32 - y, 1] == full[x, 32 - y, 1]


@pytest.mark.parametrize("shape", SHAPES + [(1, 1, -1), (1, 6, -1), (6, 1, -1), (3, 3, 0),
                                            (50, 40, -2)])
def test_diagonal_ranges(shape):
    """xa, xb cover every in-mask interior cell of each diagonal (first and
    last row), and are empty (xa > xb) on a diagonal with none; band -2 is
    a random mask with holes."""
    X1, Y1, band = shape
    if band == -2:
        mask = np.random.default_rng(3).random((X1, Y1)) < 0.3
    else:
        mask = inputs(*shape)[2]
    xa, xb = (t.numpy() for t in branchdp.diagonal_ranges(torch.as_tensor(mask)))
    assert xa.shape == xb.shape == (X1 + Y1 - 1,) and xa.dtype == np.int32
    for k in range(X1 + Y1 - 1):
        rows = [x for x in range(1, X1 - 1) if 0 < k - x < Y1 - 1 and mask[x, k - x]]
        if rows:
            assert (xa[k], xb[k]) == (min(rows), max(rows))
        else:
            assert xa[k] > xb[k]
