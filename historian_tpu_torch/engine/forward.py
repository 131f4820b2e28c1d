"""The merge fill hook: ForwardMatrix with its device fill on the port.

`TorchForwardMatrix` is historian_tpu/engine/forward.py::ForwardMatrix
(host data model, profile construction, trace bookkeeping: all reused)
with the three fill routes that reach jax replaced:

- `_fill_sp` (mesh-sharded fill): not ported, never taken;
- `_fill_device`: the resident fill and trace walks of
  ops/devicedp.py on the selected device, for every chain-x merge;
- `_fill_native`: the native host fill without the JAX router's rate
  bookkeeping, kept for merges with an empty profile, which the JAX
  device route also leaves to the host.
"""

from __future__ import annotations

import numpy as np

from historian_tpu.engine import bufpool
from historian_tpu.engine.forward import EEE, IMM, ForwardMatrix
from historian_tpu.native import csr_in_edges, get_native
from historian_tpu_torch import device as devmod
from historian_tpu_torch.ops import devicedp


class TorchForwardMatrix(ForwardMatrix):
    def _fill_sp(self) -> bool:
        return False

    def _fill_device(self) -> bool:
        if self.x_empty or self.y_empty:
            return False
        if self.x.as_chain() is None:
            raise NotImplementedError(
                "merge with a non-chain x profile (sampled-profile or DAG x DAG "
                "merges, ROADMAP queue 1 item 'sampled-profile and DAG x DAG merges')"
            )
        if not self._defer_cells or self.sumprod is not None:
            raise NotImplementedError(
                "full-band consumers of a merge (BackwardMatrix, counts) are not "
                "ported yet (ROADMAP queue 1 item 'full-readback/BackwardMatrix')"
            )
        dev = devmod.current()
        self._trace_handle = devicedp.col_forward_device(self, dev, devmod.fill_dtype(dev))
        self.cells = None
        self._lp_end = None  # lazy: the handle's end gather on first access
        self.start_cell = (0, 0, IMM)
        self.end_cell = (self.x_size - 1, self.y_size - 1, EEE)
        return True

    def _fill_native(self) -> bool:
        lib = get_native()
        if lib is None:
            return False
        self.cells = bufpool.get(self._pool_role, (self.x_size, self.y_size, 5), self)
        x_ptr, x_src, x_lp = csr_in_edges(self.x)
        y_ptr, y_src, y_lp = csr_in_edges(self.y)
        lib.forward_fill(
            self.x_size, self.y_size,
            x_ptr, x_src, x_lp, y_ptr, y_src, y_lp,
            self.x_null.astype(np.uint8), self.y_null.astype(np.uint8),
            self.x_ready.astype(np.uint8), self.y_ready.astype(np.uint8),
            self.x_emit_or_start.astype(np.uint8),
            np.uint8(self.x_empty), np.uint8(self.y_empty),
            self.insx, self.rootsubx, self.insy, self.rootsuby,
            np.ascontiguousarray(self.absorb), self.env_mask_u8,
            self._trans18(), self.cells,
        )
        self._finish_fill()
        return True
