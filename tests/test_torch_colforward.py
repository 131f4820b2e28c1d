"""Port K1 (historian_tpu_torch/ops/colforward.py) against the JAX package.

The plain PyTorch column fill must match the XLA column kernel
(ops/colforward.py::col_pair_forward_cells) at 1e-9 in float64, and
both the XLA kernel and the Pallas kernel in interpret mode in float32
with tests/test_pallas.py's tolerance (identical liveness, rtol 2e-5,
atol 1e-3).  Inputs are made from a numpy seed as in tests/test_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historian_tpu.ops.colforward import col_pair_forward_cells
from historian_tpu.ops.pallas_colforward import pallas_col_forward_cells
from historian_tpu_torch.ops import colforward

NEG = -1e30


def _inputs(SX, SY, KY, reach, seed, dt, banded=True, nulls=8):
    """Chain x against a DAG y: in-edges up to `reach` columns back (first
    edge j-1, the last KY-2 padded), nulls, an optional diagonal band."""
    rng = np.random.default_rng(seed)
    a = dict(
        absorb_t=rng.normal(-5, 1, (SY, SX)).astype(dt),
        rsx=rng.normal(-2, 1, SX).astype(dt), isx=rng.normal(-2, 1, SX).astype(dt),
        rsy=rng.normal(-2, 1, SY).astype(dt), isy=rng.normal(-2, 1, SY).astype(dt),
        trans=rng.normal(-1, 0.5, 23).astype(dt),
    )
    mask = np.ones((SY, SX), bool)
    if banded:
        for j in range(SY):
            lo = max(0, j * SX // SY - 24)
            mask[j, :lo] = False
            mask[j, j * SX // SY + 24:] = False
    a["mask"] = mask
    a["x_ready"] = np.ones(SX, bool)
    a["x_ready"][-1] = False
    a["x_eos"] = np.ones(SX, bool)
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, reach, (SY, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    a["y_src"] = y_src.astype(np.int32)
    y_lp = rng.normal(-1, 0.5, (SY, KY)).astype(dt)
    y_lp[:, 2:] = NEG
    a["y_lp"] = y_lp
    a["y_null"] = np.zeros(SY, bool)
    a["y_null"][rng.choice(np.arange(1, SY), nulls, replace=False)] = True
    a["y_ready"] = np.ones(SY, bool)
    a["y_ready"][0] = False
    return a


def _xla(a):
    # importing historian_tpu.ops enables x64: float64 inputs stay float64
    return np.asarray(col_pair_forward_cells(
        jnp.asarray(a["absorb_t"]), jnp.asarray(a["rsx"]), jnp.asarray(a["isx"]),
        jnp.asarray(a["rsy"]), jnp.asarray(a["isy"]), jnp.asarray(a["mask"]),
        jnp.asarray(a["trans"]), jnp.asarray(a["x_ready"]), jnp.asarray(a["x_eos"]),
        jnp.asarray(a["y_src"]), jnp.asarray(a["y_lp"]),
        jnp.asarray(a["y_null"]), jnp.asarray(a["y_ready"]),
    ))  # [SY, SX, 5]


def _k1_args(a):
    """The Pallas kernel's argument layout, as numpy."""
    dt = a["absorb_t"].dtype
    y_flags = np.stack([a["y_null"], a["y_ready"], a["rsy"], a["isy"]], 1).astype(dt)
    xvec = np.stack([a["rsx"], a["isx"],
                     np.where(a["x_ready"], 0.0, NEG), np.where(a["x_eos"], 0.0, NEG)]).astype(dt)
    maskg = np.where(a["mask"], 0.0, NEG).astype(dt)
    return a["y_src"], a["y_lp"], y_flags, a["absorb_t"], maskg, xvec, a["trans"]


def _plain(a):
    args = [torch.as_tensor(x) for x in _k1_args(a)]
    return np.moveaxis(colforward.col_forward_planes(*args).numpy(), 0, -1)


@pytest.mark.parametrize("KY,reach,banded", [(4, 6, True), (2, 7, False), (1, 1, True)])
def test_plain_matches_xla_f64(KY, reach, banded):
    a = _inputs(96, 128, KY, reach, 17 + KY, np.float64, banded)
    ref = _xla(a)
    got = _plain(a)
    live = ref > -1e25
    assert np.array_equal(got > -1e25, live)
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-9, atol=1e-9)


def test_plain_matches_xla_f32():
    a = _inputs(128, 128, 4, 6, 31, np.float32)
    ref = _xla(a)
    got = _plain(a)
    live = ref > -1e25
    assert np.array_equal(got > -1e25, live)
    np.testing.assert_allclose(got[live], ref[live], rtol=2e-5, atol=1e-3)


def test_plain_matches_pallas_interpret_ring8():
    """The Pallas kernel as the JAX package's tests run it on the CPU
    (interpret mode), ring = 8: in-edge distances up to 7."""
    a = _inputs(128, 64, 2, 7, 23, np.float32)
    planes = np.asarray(pallas_col_forward_cells(
        *[jnp.asarray(x) for x in _k1_args(a)], interpret=True, ring=8
    ))
    ref = np.moveaxis(planes, 0, -1)
    got = _plain(a)
    live = ref > -1e25
    assert np.array_equal(got > -1e25, live)
    np.testing.assert_allclose(got[live], ref[live], rtol=2e-5, atol=1e-3)


def test_wrapper_plain_only_for_cpu_tensors():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on a device without a kernel raises instead of falling back."""
    a = _inputs(16, 16, 2, 3, 5, np.float64)
    args = [torch.as_tensor(x) for x in _k1_args(a)]
    before = colforward.LAUNCHES
    out = colforward.col_forward_planes(*args)
    assert out.shape == (5, 16, 16) and colforward.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel"):
        colforward.col_forward_planes(*[x.to("meta") for x in args])
    with pytest.raises(ValueError, match="shape"):
        colforward.col_forward_planes(*args[:4], args[4][:, :8].contiguous(), *args[5:])
