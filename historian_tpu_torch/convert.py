"""numpy -> port tensors for the merge fill, the trace walk and the guide.

The bridge (ops/devicedp.py) builds the same host arrays the JAX bridge
hands to `_oneshot_vecmask_pallas`, to the fused kernel and to the
walker (historian_tpu/ops/devicedp.py col_forward_cells /
DeviceTraceFill), at exact sizes; the guide stage
(engine/quickalign.py) builds the guide kernel's.  These functions move
them to a device and dtype.  The tests use them to feed the two
packages identical inputs; `rate_model` carries a model of the JAX
package across into the port's own RateModel as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

def rate_model(model):
    """The port's RateModel with the arrays of `model`, a RateModel of
    either package: substitution rate matrices, component and root
    (insertion) weights, indel parameters and the alphabet.  Reads the
    attributes only, so the port never imports the JAX package."""
    from historian_tpu_torch.models.ratemodel import RateModel

    return RateModel(
        str(model.alphabet.symbols),
        ins_rate=float(model.ins_rate),
        del_rate=float(model.del_rate),
        ins_ext_prob=float(model.ins_ext_prob),
        del_ext_prob=float(model.del_ext_prob),
        cpt_weight=np.array(model.cpt_weight, dtype=np.float64),
        ins_prob=np.array(model.ins_prob, dtype=np.float64),
        sub_rate=np.array(model.sub_rate, dtype=np.float64),
        wildcard=str(model.alphabet.wildcard),
    )


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

#: the guide kernel's inputs, by kind
GUIDE_FLOAT = ("submat", "trans", "sg", "end_x", "end_y")
GUIDE_INT = ("x_tok", "y_tok", "x_len", "y_len")
GUIDE_BOOL = ("lut",)

#: K2's inputs (the fused route), by kind
FUSED_FLOAT = ("y_lp", "y_flags", "ey", "ex_t", "xvec", "params")


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


def guide_tensors(arrays: dict, device, dtype) -> dict:
    """The guide kernel's numpy inputs (engine/quickalign.py
    `QuickAligner.guide_arrays`) as tensors on `device`."""
    return _to(arrays, GUIDE_FLOAT, GUIDE_INT, GUIDE_BOOL, (), device, dtype)


def fused_tensors(arrays: dict, device, dtype) -> dict:
    """K2's inputs packed from the one-program fill's numpy inputs
    (ops/devicedp.py `fill_arrays`), as historian_tpu/ops/devicedp.py
    packs them for `pallas_col_forward_cells_fused` at exact sizes:
    y_flags [SY, 8] (null, ready, rootsub_y, ins_y, m2, y_near_end,
    shift_y, 0), ey [SY, CA], ex_t [CA, SX], xvec [8, SX] (rootsub_x,
    ins_x, x_gate, x_eos, shift_x, m1, x_near_start, x_in_range) and
    params [32] (23 transitions, band distance, ny)."""
    ny, nx = arrays["ny"], arrays["nx"]
    y_flags = np.zeros((ny, 8))
    y_flags[:, :4] = arrays["y_flags"]
    y_flags[:, 4] = arrays["m2"]
    y_flags[:, 5] = arrays["yne"]
    y_flags[:, 6] = arrays["shift_y"]
    xvec = np.zeros((8, nx))
    xvec[:4] = arrays["xvec"]
    xvec[4] = arrays["shift_x"]
    xvec[5] = arrays["m1"]
    xvec[6] = arrays["xns"]
    xvec[7] = 1.0
    params = np.zeros(32)
    params[:23] = arrays["trans"]
    params[23] = arrays["dist"]
    params[24] = ny
    packed = dict(y_src=arrays["y_src"], y_lp=arrays["y_lp"], y_flags=y_flags,
                  ey=arrays["ey_e"], ex_t=np.asarray(arrays["ex_e"]).T, xvec=xvec,
                  params=params)
    return _to(packed, FUSED_FLOAT, ("y_src",), (), (), device, dtype)
