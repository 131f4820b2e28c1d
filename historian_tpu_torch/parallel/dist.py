"""Multi-process initialization for the count, fit and mcmc paths, on
torch.distributed.

Port of historian_tpu/parallel/dist.py.  The same variables, with the
same precedence:

- HISTORIAN_DIST=1 forces a process group; without a coordinator it is a
  loopback group of one process at 127.0.0.1:12321, as in the JAX
  package;
- HISTORIAN_COORDINATOR (host:port) is the group's rendezvous,
  `init_method="tcp://host:port"`; HISTORIAN_NUM_PROCESSES and
  HISTORIAN_PROCESS_ID give its world size and this process's rank.
  Where the JAX package lets jax.distributed find a cluster's settings
  by itself, torch.distributed needs all three: a coordinator without
  the other two, or either of them without a coordinator, raises.

The backend is NCCL under `-platform gpu` and gloo under `-platform
cpu`, with no fallback from one to the other: a group that does not
start raises, and one all-reduce at start-up makes a broken NCCL fail
there.  Every process calls `init_from_env` before its first device use
(cli.main does); `global_mesh` then builds a mesh over every process's
devices (parallel/mesh.py), whose collectives (`pcounts.allreduce_counts`,
`allgather_bytes`) run over the group.
"""

from __future__ import annotations

import atexit
import os

import torch

#: the loopback rendezvous of a forced group of one (the JAX package's)
LOOPBACK = "127.0.0.1:12321"

_INITIALIZED = False
_BACKEND: str | None = None


def is_initialized() -> bool:
    return _INITIALIZED


def backend() -> str | None:
    """"nccl" or "gloo" once initialized, else None."""
    return _BACKEND


def init_from_env(platform: str = "gpu") -> bool:
    """Start the process group the environment describes, if any (or
    HISTORIAN_DIST=1 forces one); returns True when initialized.  A second
    call is a no-op."""
    global _INITIALIZED, _BACKEND
    if _INITIALIZED:
        return True
    coord = os.environ.get("HISTORIAN_COORDINATOR")
    nproc = os.environ.get("HISTORIAN_NUM_PROCESSES")
    pid = os.environ.get("HISTORIAN_PROCESS_ID")
    forced = os.environ.get("HISTORIAN_DIST") == "1"
    if not (forced or coord or nproc or pid):
        return False
    if forced and not coord:
        # explicit single-host bring-up: loopback rendezvous, one process
        coord = LOOPBACK
        nproc = nproc or "1"
        pid = pid or "0"
    missing = [name for name, v in (("HISTORIAN_COORDINATOR", coord),
                                    ("HISTORIAN_NUM_PROCESSES", nproc),
                                    ("HISTORIAN_PROCESS_ID", pid)) if not v]
    if missing:
        raise ValueError(f"a process group needs {', '.join(missing)} as well "
                         "(torch.distributed finds no cluster settings by itself)")
    world, rank = int(nproc), int(pid)
    if not 0 <= rank < world:
        raise ValueError(f"HISTORIAN_PROCESS_ID={rank} outside HISTORIAN_NUM_PROCESSES={world}")
    if platform == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group under -platform gpu needs a CUDA device "
                               "(its backend is NCCL; pass -platform cpu for gloo)")
        name = "nccl"
    elif platform == "cpu":
        name = "gloo"
    else:
        raise ValueError(f"unknown platform {platform!r} (expected gpu or cpu)")
    import torch.distributed as tdist

    tdist.init_process_group(name, init_method=f"tcp://{coord}", world_size=world, rank=rank)
    _BACKEND = name
    _INITIALIZED = True
    atexit.register(_shutdown)
    probe = torch.ones(1, device=comm_device())
    tdist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"the {name} group's all-reduce gave {probe.item()}, not {world}")
    return True


def _shutdown() -> None:
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()


def comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL,
    the CPU under gloo."""
    if _BACKEND == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    if not _INITIALIZED:
        return 1
    import torch.distributed as tdist

    return tdist.get_world_size()


def process_index() -> int:
    if not _INITIALIZED:
        return 0
    import torch.distributed as tdist

    return tdist.get_rank()


def global_mesh(n_devices: int | None = None):
    """A dp mesh over the global device list (every process's devices)."""
    from historian_tpu_torch.parallel.mesh import dp_ep_mesh, global_devices

    devices = global_devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices requested, {len(devices)} visible globally")
    return dp_ep_mesh(devices, n_devices)
