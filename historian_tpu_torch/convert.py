"""numpy -> port tensors for the merge fill and the trace walk.

The bridge (ops/devicedp.py) builds the same host arrays the JAX bridge
hands to `_oneshot_vecmask_pallas` and to the walker
(historian_tpu/ops/devicedp.py col_forward_cells / DeviceTraceFill),
at exact sizes; these functions move them to a device and dtype.  The
tests use them to feed the two packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

#: the one-program fill's inputs, by kind
FILL_FLOAT = ("y_lp", "y_flags", "ey_e", "ex_e", "shift_y", "shift_x", "xvec", "trans")
FILL_INT = ("y_src", "m2", "m1")
FILL_BOOL = ("yne", "xns")
FILL_SCALAR = ("dist", "ny", "nx")

#: the walker's inputs, by kind
WALK_FLOAT = ("y_lp", "tx", "t6", "xe_lp", "ye_lp")
WALK_INT = ("y_src", "ye_src")
WALK_BOOL = ("y_null",)
WALK_SCALAR = ("xe_src",)


def _to(arrays: dict, floats, ints, bools, scalars, device, dtype) -> dict:
    out = {}
    for k in floats:
        out[k] = torch.as_tensor(np.ascontiguousarray(arrays[k]), dtype=dtype, device=device)
    for k in ints:
        a = np.asarray(arrays[k])
        idt = torch.int32 if a.dtype == np.int32 else torch.int64
        out[k] = torch.as_tensor(np.ascontiguousarray(a), dtype=idt, device=device)
    for k in bools:
        out[k] = torch.as_tensor(np.ascontiguousarray(arrays[k], dtype=bool), device=device)
    for k in scalars:
        out[k] = int(arrays[k])
    return out


def fill_tensors(arrays: dict, device, dtype) -> dict:
    """The one-program fill's numpy inputs as tensors on `device`."""
    return _to(arrays, FILL_FLOAT, FILL_INT, FILL_BOOL, FILL_SCALAR, device, dtype)


def walk_tensors(arrays: dict, device, dtype) -> dict:
    """The walker's numpy inputs as tensors on `device`."""
    return _to(arrays, WALK_FLOAT, WALK_INT, WALK_BOOL, WALK_SCALAR, device, dtype)
