"""The port's merge bridge (historian_tpu_torch/ops/devicedp.py) against
the JAX package's resident route on the CPU (ops/devicedp.py
col_forward_cells(keep=True) -> DeviceTraceFill), on one DPMatrix in
float64: the planes over the real region to 1e-9, the walker inputs
equal, and, fed through historian_tpu_torch.convert, the same lp_end and
best trace.  Each package builds the merge from its own classes.  The
JAX route pads to shape buckets; the port's sizes are exact."""

import numpy as np
import pytest
import torch

from historian_tpu.ops import devicedp as jax_devicedp
from historian_tpu_torch import convert
from historian_tpu_torch.ops import devicedp
from tests.test_torch_forward import _sampled_dag_merge
from tests.torch_twins import JAX, PORT, host_forward


@pytest.fixture
def merges(monkeypatch):
    """A chain x against a sampled-profile DAG y, filled by the host, in
    each package from its own classes: (JAX merge, port merge)."""
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    return tuple(host_forward(pkg, *_sampled_dag_merge(pkg), 4) for pkg in (JAX, PORT))


def test_bridge_planes_match_jax_route(merges, monkeypatch):
    merge, port_merge = merges
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "1")
    monkeypatch.setenv("HISTORIAN_DEVICE_TRACE", "1")
    monkeypatch.setenv("HISTORIAN_FACTORED_ABSORB", "1")  # the factored vector-mask route
    handle = jax_devicedp.col_forward_cells(merge, keep=True)
    ref = np.asarray(handle.planes)
    arrays = devicedp.fill_arrays(port_merge)
    got = devicedp.fill_planes(convert.fill_tensors(arrays, "cpu", torch.float64)).numpy()
    ny, nx = arrays["ny"], arrays["nx"]
    assert got.shape == (5, ny, nx)
    ref = ref[:, :ny, :nx]
    live = ref > -1e25
    assert np.array_equal(got > -1e25, live)
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-9, atol=1e-9)

    # walker inputs: the JAX handle's tables, cut to the real region
    w = devicedp.walk_arrays(port_merge)
    y_src, y_lp, y_null, tx, t6, xe_src, xe_lp, ye_src, ye_lp = (
        np.asarray(a) for a in handle._walk_args)
    K = w["y_src"].shape[1]
    np.testing.assert_array_equal(w["y_src"], y_src[:ny, :K])
    np.testing.assert_array_equal(w["y_lp"], y_lp[:ny, :K])
    assert (y_lp[:ny, K:] <= -1e29).all()
    np.testing.assert_array_equal(w["y_null"], y_null[:ny])
    np.testing.assert_array_equal(w["tx"], tx[:nx])
    np.testing.assert_array_equal(w["t6"], t6)
    assert (w["xe_src"], float(w["xe_lp"])) == (int(xe_src), float(xe_lp))
    KE = len(w["ye_src"])
    np.testing.assert_array_equal(w["ye_src"], ye_src[:KE])
    np.testing.assert_array_equal(w["ye_lp"], ye_lp[:KE])

    port = devicedp.TorchTraceFill(port_merge, torch.as_tensor(got), w)
    assert abs(port.lp_end - handle.lp_end) < 1e-9
    p_cells, p_vals = port.lp_end_and_traces(0, True, 0)[1][0]
    j_cells, j_vals = handle.lp_end_and_traces(0, True, 0)[1][0]
    assert p_cells == j_cells
    np.testing.assert_allclose(p_vals, j_vals, rtol=1e-9, atol=1e-9)
