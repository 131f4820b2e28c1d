"""Device meshes over the global device list.

The port's counterpart of the `jax.sharding.Mesh` objects the JAX
package's mesh paths use (historian_tpu/parallel/mesh.py).  A mesh
is an array of `MeshDevice`s of shape (dp,) or (dp, ep), with its axis
names; the global list is every process's devices, ordered by rank and
then by local device (`device.local_devices`: the visible CUDA devices
on the card; on the CPU the JAX package's virtual device count, each of
them the one CPU, whose shards run in turn).  A process runs the shards
of its own devices and meets the others in collectives
(parallel/pcounts.py).

The framework's parallel axes (SURVEY.md section 2.7): dp, data
parallel (datasets, alignment columns, merges); ep, mixture components;
sp, the sequence-parallel fill of one merge (parallel/spmerge.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from historian_tpu_torch import device as devmod


@dataclass(frozen=True)
class MeshDevice:
    """Device `index` of process `process`; `device` is its torch device
    in the process that owns it, None in the others."""

    process: int
    index: int
    device: torch.device | None

    @property
    def is_local(self) -> bool:
        return self.device is not None


class Mesh:
    """MeshDevices laid out over named axes."""

    def __init__(self, devices, axis_names: tuple):
        self.devices = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} with axes {axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def spans_processes(self) -> bool:
        return len({d.process for d in self.devices.flat}) > 1

    def local_devices(self) -> list:
        """This process's torch devices of the mesh, in mesh order."""
        return [d.device for d in self.devices.flat if d.is_local]


def _counts_by_process() -> list:
    """Every process's local device count (all-gathered in a group)."""
    from historian_tpu_torch.parallel import dist

    mine = len(devmod.local_devices())
    if dist.process_count() == 1:
        return [mine]
    import torch.distributed as tdist

    t = torch.tensor([mine], dtype=torch.int64, device=dist.comm_device())
    out = [torch.zeros_like(t) for _ in range(dist.process_count())]
    tdist.all_gather(out, t)
    return [int(x.item()) for x in out]


def global_devices() -> list:
    """Every process's devices, by rank, then by local index."""
    from historian_tpu_torch.parallel import dist

    me = dist.process_index()
    local = devmod.local_devices()
    return [MeshDevice(p, k, local[k] if p == me else None)
            for p, n in enumerate(_counts_by_process()) for k in range(n)]


def dp_ep_mesh(devices: list, dp: int, ep: int = 1) -> Mesh:
    """The first dp * ep of `devices` as a (dp,) mesh, or a (dp, ep) mesh
    when ep > 1."""
    if ep > 1:
        return Mesh(np.array(devices[: dp * ep], dtype=object).reshape(dp, ep), ("dp", "ep"))
    return Mesh(devices[:dp], ("dp",))
