"""One copy of a grid's band from the device to the host, timed and logged.

Both full-readback routes use it: a full-band merge's in-envelope cells
(ops/devicedp.py `read_band`) and a branch fill's in-mask cells
(ops/branchdp.py `read_band`).  The rows at the given indices are
gathered where the grid lies and copied once, into pinned memory on the
card, so the copy runs at the pinned rate.
"""

from __future__ import annotations

import time

import torch

#: one entry a readback: its kind ("merge" or "branch"), the cells read,
#: the bytes copied and the ms of the gather and the copies
READBACKS: list = []


def gather_to_host(kind: str, src: torch.Tensor, dim: int, idx: torch.Tensor | None,
                   *extra: torch.Tensor) -> list[torch.Tensor]:
    """`src.index_select(dim, idx)` (all of `src` when idx is None), then
    each of `extra` unchanged, copied to the host: one pinned buffer each
    and CUDA events around the gather and the copies on the card, plain
    copies and the host clock elsewhere.  Appends the readback to
    READBACKS and returns the host tensors."""
    cuda = src.device.type == "cuda"
    shape = list(src.shape)
    if idx is not None:
        shape[dim] = len(idx)
    host = [torch.empty(shape, dtype=src.dtype, pin_memory=cuda)]
    host += [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in extra]
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    host[0].copy_(src if idx is None else src.index_select(dim, idx), non_blocking=cuda)
    for h, t in zip(host[1:], extra):
        h.copy_(t, non_blocking=cuda)
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    READBACKS.append(dict(kind=kind, cells=shape[dim], ms=ms,
                          bytes=sum(h.numel() * h.element_size() for h in host)))
    return host
