"""Kernel (g2)'s plain version, the sequence-parallel pair Forward
(historian_tpu_torch/ops/sp_pairforward.py), against the JAX package's
ops/sp_pairforward.py on the CPU, float64, on the 8 virtual CPU devices of
tests/conftest.py (the JAX package's meshes over `jax.devices()`, the
port's over `parallel/mesh.py` `global_devices`, whose shards run in turn).

Inputs: long6's sequences cut short, preset lg; the same arrays go to both
packages.

- `sp_pair_forward` at 1, 2, 3, 4 and 8 shards against the JAX function on
  the same mesh and against the port's single-device `pair_forward`:
  1e-9 absolute;
- a banded mask with a Y + 1 that does not divide into the shards (the
  padding columns, masked);
- `sp_pair_forward_batch` on a 2 x 4 `dp` x `sp` mesh against the JAX
  function and against `pair_forward` pair by pair;
- a mesh that mixes device types raises;
- the plain version with each shard cut into strips (1, 2, 3, 8 strips at
  1 and 3 shards; the scans' carries composed strip by strip, as kernel
  (g2) hands them on) against the JAX function, and a few rows at 8300
  columns (past the one-block design's 8192 a shard) on one shard;
- the batch's waves on the card (ops/pairstrips.py `strip_waves`, a fake
  capacity): every pair in one wave, each wave resident at once.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from historian_tpu.ops import sp_pairforward as jax_sp
from historian_tpu_torch import device
from historian_tpu_torch.ops import pairforward, sp_pairforward
from historian_tpu_torch.parallel import mesh as port_mesh
from tests.torch_twins import band_mask, long6_pair

ATOL = 1e-9


def _meshes(shape: tuple, names: tuple):
    device.select("cpu")
    n = int(np.prod(shape))
    jm = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    pm = port_mesh.Mesh(np.array(port_mesh.global_devices()[:n], dtype=object).reshape(shape),
                        names)
    return jm, pm


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_sp_pair_forward_matches_jax(n):
    args = long6_pair(40, 52, torch.float64)
    jm, pm = _meshes((n,), ("sp",))
    lp = float(sp_pairforward.sp_pair_forward(*args, mesh=pm))
    lp_jax = float(jax_sp.sp_pair_forward(*(a.numpy() for a in args), mesh=jm))
    _, lp_one = pairforward.pair_forward(*args)
    assert abs(lp - lp_jax) < ATOL
    assert abs(lp - float(lp_one)) < ATOL


@pytest.mark.parametrize("n", [4, 8])
def test_sp_pair_forward_banded_padding(n):
    """Y + 1 = 30 over 4 and 8 shards: 2 masked padding columns each."""
    args = list(long6_pair(33, 29, torch.float64, offset=100, pair=(2, 3)))
    args[5] = band_mask(34, 30, 6)
    jm, pm = _meshes((n,), ("sp",))
    lp = float(sp_pairforward.sp_pair_forward(*args, mesh=pm))
    lp_jax = float(jax_sp.sp_pair_forward(*(a.numpy() for a in args), mesh=jm))
    _, lp_one = pairforward.pair_forward(*args)
    assert lp > -1e29
    assert abs(lp - lp_jax) < ATOL
    assert abs(lp - float(lp_one)) < ATOL


def test_sp_pair_forward_batch_dp_sp():
    pairs = [long6_pair(30, 41, torch.float64, offset=o, pair=p)
             for o, p in ((0, (0, 1)), (50, (2, 3)), (200, (4, 5)), (10, (1, 4)))]
    batch = [torch.stack([p[k] for p in pairs]) for k in range(5)]
    mask, trans = pairs[0][5], pairs[0][6]
    jm, pm = _meshes((2, 4), ("dp", "sp"))
    lp = sp_pairforward.sp_pair_forward_batch(*batch, mask, trans, mesh=pm).numpy()
    lp_jax = np.asarray(jax_sp.sp_pair_forward_batch(
        *(a.numpy() for a in batch), mask.numpy(), trans.numpy(), mesh=jm))
    lp_one = [float(pairforward.pair_forward(*p)[1]) for p in pairs]
    np.testing.assert_allclose(lp, lp_jax, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lp, lp_one, rtol=0, atol=ATOL)


def test_sp_pair_forward_mixed_mesh_raises():
    args = long6_pair(6, 7, torch.float64)
    mixed = port_mesh.Mesh([port_mesh.MeshDevice(0, 0, torch.device("cpu")),
                            port_mesh.MeshDevice(0, 1, torch.device("meta"))], ("sp",))
    with pytest.raises(RuntimeError, match="no kernel for a mesh"):
        sp_pairforward.sp_pair_forward(*args, mesh=mixed)
    with pytest.raises(ValueError, match="no axis"):
        sp_pairforward.sp_pair_forward(*args, mesh=_meshes((2,), ("dp",))[1])


_JAX_LP: dict = {}


def _jax_lp(key, args, n: int) -> float:
    """The JAX function's lp_end on n shards, once a case (it compiles for
    each call)."""
    if key not in _JAX_LP:
        jm, _ = _meshes((n,), ("sp",))
        _JAX_LP[key] = float(jax_sp.sp_pair_forward(*(a.numpy() for a in args), mesh=jm))
    return _JAX_LP[key]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("strips", [1, 2, 3, 8])
def test_sp_pair_forward_plain_by_strips_matches_jax(n, strips):
    """The plain version with each shard cut into strips, the scans'
    carries composed strip by strip as kernel (g2) hands them on, against
    the JAX function on the same mesh and `pair_forward`: 1e-9."""
    args = long6_pair(40, 52, torch.float64, offset=60)
    lp = float(sp_pairforward.sp_pair_forward_plain(*args, n, strips))
    lp_jax = _jax_lp(("40x52", n), args, n)
    _, lp_one = pairforward.pair_forward(*args)
    assert abs(lp - lp_jax) < ATOL
    assert abs(lp - float(lp_one)) < ATOL


@pytest.mark.parametrize("strips", [1, 3])
def test_sp_pair_forward_past_8192_columns_matches_jax(strips):
    """A few rows at 8300 columns (past the one-block design's 8192 a
    shard) from long8x12k's first pair on one shard: the plain version,
    whole and by strips, against the JAX function: 1e-9."""
    from historian_tpu_torch.ops.pairforward import chain_pair_forward_arrays
    from tests.torch_twins import DATA, PORT

    seqs = PORT.seqs.read_fasta(os.path.join(DATA, "long8x12k.fa"))
    args, _ = chain_pair_forward_arrays(PORT.presets.named_model("lg"), seqs[0].seq[:3],
                                        seqs[1].seq[:8299], 0.5, 0.5, dtype=torch.float64)
    assert args[0].shape == (4, 8300)
    lp = float(sp_pairforward.sp_pair_forward_plain(*args, 1, strips))
    lp_jax = _jax_lp("8300", args, 1)
    assert abs(lp - lp_jax) < ATOL


@pytest.mark.parametrize("groups,cap,force", [
    ([[(0, 385)]] * 128, 100, {}),
    ([[(0, 385)]] * 128, 1024, {}),
    ([[(d * 43, 43) for d in range(4)]] * 40, 30, {}),
    ([[(0, 6016)], [(0, 300)], [(0, 6016)], [(0, 64)]], 130, {}),
    ([[(0, 385)]] * 50, 40, dict(lanes=1, warps=2, cluster=7)),
], ids=["headline-cap100", "headline-fits", "4-shards", "mixed", "forced"])
def test_strip_waves_fit_and_cover(groups, cap, force):
    """(g2)'s batch in waves (a fake capacity): every group in exactly one
    wave, the waves consecutive and in order, each wave's layout resident
    at once, and no wave could take the next group."""
    from historian_tpu_torch.ops import pairstrips as ps

    capacity = lambda lanes, warps, cluster: cap  # noqa: E731
    waves = ps.strip_waves("sppairforward", groups, 132, capacity, **force)
    assert waves[0][0] == 0 and waves[-1][1] == len(groups)
    assert all(a[1] == b[0] for a, b in zip(waves, waves[1:]))
    for start, end in waves:
        assert end > start
        plan = ps.strip_plan("sppairforward", [c for g in groups[start:end] for c in g], 132,
                             capacity, **force)
        assert plan.blocks <= cap
        if end < len(groups):
            with pytest.raises(ValueError):
                ps.strip_plan("sppairforward", [c for g in groups[start:end + 1] for c in g],
                              132, capacity, **force)
    if cap >= 1024:
        assert waves == [(0, len(groups))]


def test_strip_waves_raise_where_a_pair_cannot_be_resident():
    from historian_tpu_torch.ops import pairstrips as ps

    with pytest.raises(ValueError):
        ps.strip_waves("sppairforward", [[(0, 6016)]], 132, lambda *a: 4)
