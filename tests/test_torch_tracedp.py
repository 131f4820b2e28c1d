"""Port trace walker and end gather (historian_tpu_torch/ops/tracedp.py)
against the JAX package's XLA versions (ops/tracedp.py end_lp_device,
pair_trace_device): the same float64 planes, edge tables and uniforms
must give identical best and sampled paths, and lp_end within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historian_tpu.ops.tracedp import end_lp_device, pair_trace_device
from historian_tpu_torch import convert
from historian_tpu_torch.ops import colforward, tracedp
from historian_tpu_torch.ops.devicedp import sorted_walk_edges

NEG = -1e30


def _walk_inputs(S, KY, seed, T=6):
    """float64 planes from the plain K1 over a DAG y (in-edges up to 6
    columns back, nulls), plus the walker's tables and uniforms."""
    rng = np.random.default_rng(seed)
    y_src = np.clip(np.arange(S)[:, None] - 1 - rng.integers(0, 6, (S, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(S) - 1, 0)
    y_src = y_src.astype(np.int32)
    y_lp = rng.normal(-1, 0.5, (S, KY))
    y_lp[:, 2:] = NEG
    y_null = np.zeros(S, bool)
    y_null[rng.choice(np.arange(1, S), S // 10, replace=False)] = True
    y_flags = np.stack([y_null, np.arange(S) > 0, rng.normal(-2, 1, S), rng.normal(-2, 1, S)], 1)
    xvec = np.stack([rng.normal(-2, 1, S), rng.normal(-2, 1, S), np.zeros(S), np.zeros(S)])
    planes = colforward.col_forward_planes_plain(
        *[torch.as_tensor(a) for a in (y_src, y_lp, y_flags.astype(float),
                                       rng.normal(-5, 1, (S, S)), np.zeros((S, S)),
                                       xvec, rng.normal(-1, 0.5, 23))]
    ).numpy()
    ws, wl = sorted_walk_edges(y_src, y_lp)
    tx = rng.normal(-0.1, 0.05, S)
    tx[0] = 0.0
    best = np.zeros(T, bool)
    best[0] = True
    return dict(
        planes=planes, y_src=ws, y_lp=wl, y_null=y_null, tx=tx,
        t6=rng.normal(-1, 0.5, (6, 6)), xe_src=S - 1, xe_lp=-0.3,
        ye_src=np.array([S - 4, S - 1], np.int32), ye_lp=np.array([-1.5, -0.2]),
        uniforms=rng.random((T, 2 * S)), is_best=best, n_steps_max=2 * S,
    )


ORDER = ("planes", "y_src", "y_lp", "y_null", "tx", "t6", "xe_src", "xe_lp",
         "ye_src", "ye_lp", "uniforms", "is_best", "n_steps_max")


def _port_args(w):
    """The walk tables through historian_tpu_torch.convert, as the bridge
    moves them; planes, uniforms and flags as tensors."""
    t = convert.walk_tensors(w, "cpu", torch.float64)
    for k in ("planes", "uniforms", "is_best"):
        t[k] = torch.as_tensor(w[k])
    t["n_steps_max"] = w["n_steps_max"]
    return [t[k] for k in ORDER]


def _port(w):
    return [x.numpy() for x in tracedp.pair_trace(*_port_args(w))]


def _jax(w):
    args = [w[k] if k == "n_steps_max" else jnp.asarray(w[k]) for k in ORDER]
    return [np.asarray(x) for x in pair_trace_device(*args)]


@pytest.mark.parametrize("S,KY,seed", [(60, 4, 1), (90, 2, 2)])
def test_walker_matches_jax(S, KY, seed):
    w = _walk_inputs(S, KY, seed)
    got, ref = _port(w), _jax(w)
    for name, a, b in zip(("pi", "pj", "ps", "vals", "n_steps"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert abs(float(got[5]) - float(ref[5])) < 1e-9
    assert got[4][0] > 0 and (got[4][1:] > 0).all()  # best and sampled walks ran


def test_end_lp_matches_jax():
    w = _walk_inputs(40, 2, 3)
    got = tracedp.end_lp(*(torch.as_tensor(w[k]) if k != "xe_lp" else w[k]
                           for k in ("planes", "t6", "xe_src", "xe_lp", "ye_src", "ye_lp")))
    ref = end_lp_device(*(jnp.asarray(w[k]) for k in
                          ("planes", "t6", "xe_src", "xe_lp", "ye_src", "ye_lp")))
    assert abs(float(got) - float(ref)) < 1e-9


def test_walker_plain_only_for_cpu_tensors():
    args = _port_args(_walk_inputs(20, 2, 4, T=2))
    before = tracedp.LAUNCHES
    tracedp.pair_trace(*args)
    assert tracedp.LAUNCHES == before
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        tracedp.pair_trace(*meta)
