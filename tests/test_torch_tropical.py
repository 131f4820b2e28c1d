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
