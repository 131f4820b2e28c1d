"""Device and dtype selection.

Counterpart of the JAX package's platform choice (historian_tpu/cli.py
`-platform`) and merge-fill dtype (historian_tpu/ops/devicedp.py
`fill_dtype`).  The device is always explicit: `gpu`, the default,
needs CUDA and raises without it -- there is no silent CPU fallback --
and `cpu` runs the kernels' plain PyTorch versions only when asked for.

`local_devices` are this process's devices for a mesh (parallel/mesh.py):
on the card its visible CUDA devices; on the CPU as many as the JAX
package's CPU platform has in the same environment, the count in
XLA_FLAGS' --xla_force_host_platform_device_count or 1, each of them the
one CPU, so that their shards run in turn.  `placed` makes a device the
current one for a block (a merge placed on a mesh device, recon.py).
"""

from __future__ import annotations

import contextlib
import os
import re

import torch

_DEVICE: torch.device | None = None
#: the fill dtype of a merge whose band the host reads, on every device and
#: whatever HISTORIAN_DEVICE_DTYPE says: its cells meet the host's float64
#: BackwardMatrix in posteriors exp(fwd + bwd - lp_end), and a float32
#: fill's rounding at |lp| ~ 1e4 nats moves those by whole units (PERF.md
#: section 6: a posterior of 7.99 at long6's first merge)
FULLBAND_DTYPE = torch.float64


def select(platform: str = "gpu") -> torch.device:
    """Pin the device every later merge runs on; returns it."""
    global _DEVICE
    if platform == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "-platform gpu needs a CUDA device and none is available "
                "(pass -platform cpu to run the plain PyTorch versions)"
            )
        dev = torch.device("cuda", torch.cuda.current_device())
    elif platform == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unknown platform {platform!r} (expected gpu or cpu)")
    # the emission matmul and every other float32 product stay full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _DEVICE = dev
    return dev


def current() -> torch.device:
    """The selected device; selects the default (`gpu`) on first use."""
    return _DEVICE if _DEVICE is not None else select("gpu")


def fill_dtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU; HISTORIAN_DEVICE_DTYPE=f32|f64
    overrides, as in the JAX package."""
    env = os.environ.get("HISTORIAN_DEVICE_DTYPE", "")
    if env == "f32":
        return torch.float32
    if env == "f64":
        return torch.float64
    return torch.float32 if device.type == "cuda" else torch.float64


def local_devices() -> list:
    """This process's devices, in order, on the selected platform."""
    dev = current()
    if dev.type == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    found = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                      os.environ.get("XLA_FLAGS", ""))
    return [dev] * (int(found.group(1)) if found else 1)


@contextlib.contextmanager
def placed(dev: torch.device):
    """`current()` is `dev` inside the block (and the current CUDA device
    is dev's)."""
    global _DEVICE
    prev = _DEVICE
    _DEVICE = dev
    try:
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                yield dev
        else:
            yield dev
    finally:
        _DEVICE = prev
