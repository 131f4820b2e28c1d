"""Device and dtype selection.

Counterpart of the JAX package's platform choice (historian_tpu/cli.py
`-platform`) and merge-fill dtype (historian_tpu/ops/devicedp.py
`fill_dtype`).  The device is always explicit: `gpu`, the default,
needs CUDA and raises without it -- there is no silent CPU fallback --
and `cpu` runs the kernels' plain PyTorch versions only when asked for.
"""

from __future__ import annotations

import os

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
