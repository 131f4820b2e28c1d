"""The port's banded Viterbi fill (historian_tpu_torch/ops/pairdp.py)
against the JAX package's `banded_viterbi_fill` on the CPU, float64, on
random emissions and start-gap scores with a sparse diagonal envelope
(and with every cell in the envelope).

The three planes must be bit-identical.  That holds: XLA's CPU code does
not contract the Delete chain's `base - i * d2d` into a fused
multiply-add here, and the port computes the product and the difference
as separate tensor ops, so both round each operation once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historian_tpu.ops.pairdp import banded_viterbi_fill as jax_fill
from historian_tpu_torch.ops.pairdp import banded_viterbi_fill, segmented_running_max


def _inputs(X, Y, seed, sparse):
    rng = np.random.default_rng(seed)
    emit = rng.normal(0, 2, (X + 1, Y + 1))
    ii = np.arange(X + 1)[:, None]
    jj = np.arange(Y + 1)[None, :]
    if sparse:
        diags = rng.integers(-X // 3, X // 3, X // 4)
        mask = np.isin(ii - jj, diags) | (np.abs(ii - jj - 3) <= 4)
    else:
        mask = np.ones((X + 1, Y + 1), bool)
    mask &= (ii >= 1) & (jj >= 1)
    start = rng.normal(-6, 1, (X + 1, Y + 1))
    trans = np.concatenate([np.log(rng.uniform(0.01, 0.9, 8)), [0.0, 0.0]])
    return emit, mask, start, trans


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "full"])
def test_fill_bit_identical_to_jax(sparse):
    emit, mask, start, trans = _inputs(130, 157, 3, sparse)
    ref = jax_fill(jnp.asarray(emit), jnp.asarray(mask), jnp.asarray(start), jnp.asarray(trans))
    got = banded_viterbi_fill(torch.tensor(emit), torch.tensor(mask), torch.tensor(start),
                              torch.tensor(trans))
    for r, g, name in zip(ref, got, ("mat", "ins", "del")):
        r, g = np.asarray(r), g.numpy()
        assert g.shape == (158, 131), name
        np.testing.assert_array_equal(g, r, err_msg=name)
    # the Delete chain really runs: some cells take del[i-1] + d2d
    assert (got[2].numpy() > -1e29).sum() > 100


def test_segmented_running_max():
    rng = np.random.default_rng(1)
    z = rng.normal(0, 1, 200)
    reset = rng.random(200) < 0.1
    want, run = [], -np.inf
    for v, r in zip(z, reset):
        run = v if r else max(run, v)
        want.append(run)
    got = segmented_running_max(torch.tensor(z), torch.tensor(reset)).numpy()
    np.testing.assert_array_equal(got, np.array(want))
