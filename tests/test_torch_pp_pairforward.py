"""Kernel (g3)'s plain version, the pipeline-parallel pair Forward
(historian_tpu_torch/parallel/pp_pairforward.py), against the JAX
package's parallel/pp_pairforward.py on the CPU, float64, on the 8
virtual CPU devices of tests/conftest.py.

Inputs: five pairs of long6's sequences cut to 37 x 45 residues (X + 1 =
38 rows, which 3 and 8 stages do not divide), preset lg; the same arrays
go to both packages.  At 1, 2, 3 and 8 stages, lp_end [PAIRS] within 1e-9
absolute of the JAX function on the same mesh and of the port's
`pair_forward` pair by pair; a stage with no real row (8 stages of 5 rows,
the last holding 3) passes the carry through.
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
