"""Grow-only, role-keyed host buffer pool for the big DP cell tensors.

The progressive reconstruction allocates a few hundred MB of fresh cell
storage per merge (dense [Sx, Sy, 5] float64 forward + backward
tensors).  First-touch page faults on freshly mapped memory are very
slow on some hosts (measured ~13 s/GB here vs ~0.1 s/GB warm), so
repeatedly allocating and freeing these tensors can dominate wall
clock.  Merges run sequentially, so one buffer per *role* ("fwd-cells",
"bwd-cells") is reused across merges: the pool hands out reshaped views
of a grow-only flat arena, paying the fault cost once per high-water
mark instead of once per merge.

Safety: each arena remembers (a weak reference to) the object it was
last lent to.  If that owner is still alive at the next request -- e.g.
a test holding two ForwardMatrix objects at once -- the pool returns a
fresh unpooled allocation instead, so no live matrix is ever clobbered.
Callers that want pooling (the recon merge loop) drop their references
before building the next matrix.

Contents are NOT zeroed between uses -- every caller either fills the
whole tensor itself (the native fill pins masked cells) or explicitly
.fill()s it first, exactly as the previous np.full/np.empty code did,
so results are bit-identical to unpooled allocation.
"""

from __future__ import annotations

import mmap
import os
import sys
import time
import weakref

import numpy as np

_arenas: dict[str, np.ndarray] = {}
_owners: dict[str, "weakref.ref | None"] = {}
_DIAG = bool(os.environ.get("HISTFILL_DIAG"))


def _alloc_arena(n: int) -> np.ndarray:
    """Anonymous mmap arena, bulk-prefaulted.

    This host's first-touch page faults run through a virtualized
    demand-paging path that is slow and erratically VERY slow (measured
    0.02-1.6 GB/s); populating the whole arena once at allocation with
    the native threaded MADV_POPULATE_WRITE helper (native/fill.cpp
    prefault) moves that cost off the fill/matmul passes, which then run
    at warm-page speed.  (MADV_HUGEPAGE was tried and made things worse:
    with defrag=madvise each huge-page fault may do synchronous
    compaction.)"""
    try:
        mm = mmap.mmap(-1, n)
        arr = np.frombuffer(mm, dtype=np.uint8)
    except (OSError, ValueError):
        return np.empty(n, dtype=np.uint8)
    try:
        from historian_tpu_torch.native import get_native

        lib = get_native()
        if lib is not None:
            lib.prefault(arr.ctypes.data, n)
    except Exception:
        pass
    return arr


def get(role: str, shape: tuple[int, ...], owner, dtype=np.float64) -> np.ndarray:
    """An uninitialized array of `shape`, pooled per role when safe."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    prev = _owners.get(role)
    if prev is not None and prev() is not None and prev() is not owner:
        if _DIAG:
            print(f"[bufpool] {role} {n>>20}MB fresh-unpooled (owner alive)",
                  file=sys.stderr, flush=True)
        return np.empty(shape, dtype=dtype)  # previous borrower still alive
    arena = _arenas.get(role)
    if arena is None or arena.nbytes < n:
        t0 = time.perf_counter()
        arena = _alloc_arena(n)
        _arenas[role] = arena
        if _DIAG:
            print(f"[bufpool] {role} {n>>20}MB grow alloc+prefault "
                  f"{time.perf_counter()-t0:.3f}s",
                  file=sys.stderr, flush=True)
    elif _DIAG:
        print(f"[bufpool] {role} {n>>20}MB reuse",
              file=sys.stderr, flush=True)
    _owners[role] = weakref.ref(owner)
    return arena[:n].view(dtype).reshape(shape)


def clear() -> None:
    """Release all arenas (tests / memory pressure)."""
    _arenas.clear()
    _owners.clear()
