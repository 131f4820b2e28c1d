"""The port's full-band route (historian_tpu_torch/ops/devicedp.py
`col_forward_cells`: the fill's planes, the in-envelope cells gathered
on the device and read back once, scattered into the host grid) against
the JAX package's full-readback routes on the CPU in float64
(historian_tpu/ops/devicedp.py `col_forward_cells` and, for two chains,
`chain_forward_cells`) and against the port's native host fill
(csrc/fill.cpp), each package on its own classes: the [nx, ny, 5] grids
to 1e-9 with the same cells at -inf.  Chain x chain and chain x DAG
merges, unbanded and banded (tests/test_torch_backward.py `root_merge`)."""

import numpy as np
import pytest
import torch

from historian_tpu.ops import devicedp as jax_devicedp
from historian_tpu_torch.ops import devicedp, readback
from tests.test_torch_backward import assert_cells_close, cpu64, root_merge  # noqa: F401
from tests.torch_twins import JAX, PORT, PortHostForwardMatrix

CASES = [(kind, banded) for kind in ("chain x chain", "chain x dag") for banded in (False, True)]


@pytest.mark.parametrize("kind,banded", CASES)
def test_fullband_cells_match_jax_and_host(cpu64, kind, banded):  # noqa: F811
    fwd = root_merge(PORT, kind, banded, counts=False)[0]
    assert fwd.route == "fullband" and fwd._trace_handle is None
    nx, ny = fwd.x_size - 1, fwd.y_size - 1
    band = int(np.count_nonzero(fwd.env_mask[:nx, :ny]))
    assert (band < nx * ny) == banded
    read = readback.READBACKS[-1]
    assert read["kind"] == "merge" and read["cells"] == band and read["bytes"] == band * 5 * 8
    got = fwd.cells[:nx, :ny]
    # the grid's last row and column (END) stay -inf, as in a host fill
    assert np.isneginf(fwd.cells[nx]).all() and np.isneginf(fwd.cells[:, ny]).all()

    ref_fwd = root_merge(JAX, kind, banded, counts=False)[0]
    assert_cells_close(got, jax_devicedp.col_forward_cells(ref_fwd))
    if kind == "chain x chain":
        assert_cells_close(got, jax_devicedp.chain_forward_cells(ref_fwd))
    host = PortHostForwardMatrix(fwd.x, fwd.y, fwd.hmm, fwd.parent_row, fwd.env)
    assert host.route == "host"
    assert_cells_close(fwd.cells, host.cells)
    assert fwd.lp_end == pytest.approx(host.lp_end, rel=1e-12)


def test_read_band_takes_the_planes_at_the_band():
    """`read_band` gathers the in-envelope cells (`band_index`: the host
    grid's row-major order of the mask), scatters them into the host grid
    and reads the semiring zero as -inf; every other cell stays -inf.
    With no envelope, every cell comes back."""
    g = torch.Generator().manual_seed(3)
    ny, nx = 7, 9
    planes = torch.randn((5, ny, nx), generator=g, dtype=torch.float64)
    planes[2, 3, 4] = devicedp.NEG
    mask = np.abs(np.arange(nx)[:, None] - np.arange(ny)[None, :]) <= 2  # [nx, ny]

    class Merge:  # the attributes read_band reads of a DPMatrix
        x_size, y_size, env_mask, env_vectors = nx + 1, ny + 1, np.pad(mask, ((0, 1), (0, 1))), ()

    idx = devicedp.band_index(Merge)
    ii, jj = np.nonzero(mask)
    assert idx.tolist() == (jj * nx + ii).tolist()
    full = planes.permute(2, 1, 0).numpy().copy()  # [nx, ny, 5]
    full[full < devicedp.NEG_CUTOFF] = -np.inf
    out = np.full((nx + 1, ny + 1, 5), -np.inf)
    devicedp.read_band(planes, Merge, out)
    np.testing.assert_array_equal(out[:nx, :ny][mask], full[mask])
    assert np.isneginf(out[:nx, :ny][~mask]).all() and np.isneginf(out[4, 3, 2])
    assert np.isneginf(out[nx]).all() and np.isneginf(out[:, ny]).all()
    assert readback.READBACKS[-1]["cells"] == mask.sum()
    Merge.env_vectors = None
    assert devicedp.band_index(Merge) is None
    out[:] = -np.inf
    devicedp.read_band(planes, Merge, out)
    np.testing.assert_array_equal(out[:nx, :ny], full)
    assert readback.READBACKS[-1]["cells"] == nx * ny
