"""Multi-device merge routing: SP and DP engaged by `-mesh`.

Port of historian_tpu/parallel/spmerge.py.  The reference's progressive
merge loop (recon.cpp:917-1052) is sequential; SURVEY.md section 2.7
gives it two device-mesh axes, wired here into the merge router
(engine/forward.py `_fill_sp`) and the merge loop (recon.py):

- **SP (sequence parallel)**: a long merge's x chain shards over every
  mesh device and fills in kernel (g1) (ops/sp_colforward.py), K1's
  strip pipeline cut at shard boundaries, bit-equal to K1.
- **DP (data parallel)**: the merges take the mesh's devices round-robin
  (`dp_placement_devices`); the port's loop stays sequential.

Activation: `-mesh N` (or HISTORIAN_MESH) with N > 1 devices.
HISTORIAN_SP=1 sends every chain-x merge to the SP fill, =0 none, and
`auto` (the default) applies the rule of `sp_merge_wins`.
"""

from __future__ import annotations

import os

import numpy as np

#: the sharded-away x lanes a merge must have for the SP fill, nx * (1 -
#: 1/n) >= SP_MIN_SX (HISTORIAN_SP_MIN_SX), the JAX package's default.
#: The JAX package set it from its TPU's latencies; on H100s the crossover
#: is not measured: it needs a box with two cards or more, and on one card
#: a mesh has one device and SP never runs unless forced
SP_MIN_SX = int(float(os.environ.get("HISTORIAN_SP_MIN_SX", "8192")))


def _env() -> str:
    return os.environ.get("HISTORIAN_SP", "auto")


def sp_mesh():
    """This process's devices of the active `-mesh`, in mesh order, or None
    when HISTORIAN_SP=0 or fewer than two are active.  Where the mesh spans
    processes, each process fills a merge over its own devices (the JAX
    package's shard_map spans them all; here a kernel's shards exchange
    through memory a process can reach)."""
    if _env() == "0":
        return None
    from historian_tpu_torch.parallel.pcounts import active_mesh

    base = active_mesh()
    devs = None if base is None else base.local_devices()
    return devs if devs and len(devs) > 1 else None


def sp_merge_wins(dp, n_dev: int) -> bool:
    """Whether one merge takes the SP fill: a chain x against any y, and
    either HISTORIAN_SP=1 or enough x lanes sharded away."""
    if dp.x_empty or dp.y_empty or dp.x.as_chain() is None:
        return False
    if _env() == "1":
        return True
    nx = dp.x_size - 1
    return nx * (1.0 - 1.0 / n_dev) >= SP_MIN_SX


def sp_forward_cells(dp, devices: list, dtype, out: np.ndarray) -> None:
    """Fill one merge (chain x, any profile-DAG y) with the SP fill over
    `devices` and read its band into the host grid `out` [x_size, y_size,
    5] (float64, -inf outside the band), the contract of
    ops/devicedp.py `col_forward_cells`.  The emission and the band's
    lanes are built on the first device, as the JAX package builds them
    whole before sharding; the planes come back there for the readback."""
    from historian_tpu_torch import convert
    from historian_tpu_torch.ops import devicedp
    from historian_tpu_torch.ops.sp_colforward import sp_col_forward_planes

    t = convert.fill_tensors(devicedp.fill_arrays(dp), devices[0], dtype)
    absorb, maskg, lanes = devicedp.emission_and_lanes(t)
    planes = sp_col_forward_planes(t["y_src"], t["y_lp"], t["y_flags"], absorb, maskg,
                                   t["xvec"], t["trans"], lanes, devices)
    del absorb, maskg
    devicedp.read_band(planes, dp, out)


def dp_placement_devices():
    """This process's mesh devices, over which recon.py places its merges
    round-robin, or None when no mesh of two devices or more is active."""
    from historian_tpu_torch.parallel.pcounts import active_mesh

    base = active_mesh()
    if base is None:
        return None
    devs = base.local_devices()
    return devs if len(devs) > 1 else None
