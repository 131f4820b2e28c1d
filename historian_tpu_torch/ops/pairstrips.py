"""The strip layout of kernels (f), (g2) and (g3): a row's columns over many SMs.

Kernels (f) (csrc/tropical.cu), (g2) (csrc/sppairforward.cu) and (g3)
(csrc/pppairforward.cu) cut each chain of columns (the pair's for (f),
each shard's of each pair for (g2), each slot's for (g3)) into strips of whole warps, 32 * lanes * warps columns (the chain's last
strip shorter), one block a strip on its own SM.  Adjacent strips of a
chain form thread block clusters of `cluster` blocks, in block order: a
strip hands its last column's five values a row to the next strip of its
cluster through distributed shared memory, and across a cluster's end
(or a (g2) shard boundary) through a record [X1, 8] with a counter in
global memory (csrc/pairstep.cuh, the strip section).

`strip_plan` is the route rule, a plan in the manner of
ops/branchdp.py `band_layout`: given the chains, the card's SM count and
the layout's capacity (blocks resident at once, for a block shape and
cluster size), it takes the first shape of the kernel's ladder
(`LADDERS`), narrowest first, whose blocks fit one an SM, else the first
that can be resident; a layout that cannot be resident raises.
`strip_table` gives the kernels' table and the records between clusters.
`strip_waves` cuts a batch that cannot be resident at once into waves,
one launch each, that can ((g2)'s `sp_pair_forward_batch`).
`slot_plan` lays out kernel (g3): its work items, a (stage, pair) each,
go round-robin in stage order to `slots` chains of strips of the row's
columns, as many as the card holds (csrc/pppairforward.cu).

The ladders come from a sweep on an H100 (`pair_bench.py --sweep`: 1, 2,
4 lanes a thread x 1, 2, 4, 8 warps x clusters of 1, 8, 16 at long12's
and long6's pairs): a row's time falls as strips narrow, towards one warp
step's latency, down to 4 warps of 1 lane (128 columns) for kernel (f)
and 2 warps of 1 lane (64 columns) for (g2), and rises again below them
(more strips, each hop a share of the row); wider strips than those only
where their blocks would not fit one an SM.  Clusters of 8 were within
a few per cent of the best at every fast shape; 16 put two blocks on an
SM at 4 warps and more, which slowed (g2)'s float64 step.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

#: lanes a thread the strip kernels are built for
LANES = (1, 2, 4)
#: row warps a strip at most (csrc/pairstep.cuh kStripWarps)
MAX_WARPS = 8
#: row warps of kernel (g3)'s whole-row strips (one lane a thread) at most
#: (csrc/pairstep.cuh kRowWarps)
ROW_WARPS = 15
#: blocks a cluster at most (8 portable, 16 with the non-portable attribute)
MAX_CLUSTER = 16
#: the rule's cluster: the portable size
CLUSTER = 8
#: the rule's block shapes (lanes a thread, row warps) of each kernel,
#: narrowest strip first
LADDERS = {"tropical": ((1, 4), (1, 8), (2, 8), (4, 8)),
           "sppairforward": ((1, 2), (1, 4), (1, 8), (2, 8), (4, 8)),
           "pppairforward": ((1, 2), (1, 4), (1, 8), (2, 8), (4, 8))}
#: the kinds of a strip's edges (csrc/pairstep.cuh kNone, kCluster, kRecordEdge)
NONE, CLUSTER_EDGE, RECORD = 0, 1, 2
#: int64 a block in the kernels' table (csrc/pairstep.cuh StripEntry)
ENTRY = 10


@dataclass(frozen=True)
class StripPlan:
    """A strip layout.  Per block, in launch order: `chain` (-1 for the
    idle blocks that fill the last cluster), its first column `c0` and
    columns `nc`, and the kind of its `left` and `right` edge (NONE: the
    chain's own end, CLUSTER_EDGE: the neighbour block of the same
    cluster, RECORD: a record in global memory)."""

    lanes: int
    warps: int
    cluster: int
    chain: np.ndarray
    c0: np.ndarray
    nc: np.ndarray
    left: np.ndarray
    right: np.ndarray

    @property
    def blocks(self) -> int:
        return int(self.chain.size)

    @property
    def threads(self) -> int:
        """Threads a block: the row warps and the io warp."""
        return 32 * (self.warps + 1)

    @property
    def width(self) -> int:
        return 32 * self.lanes * self.warps

    @property
    def strips(self) -> int:
        return int(np.count_nonzero(self.chain >= 0))

    def describe(self) -> dict:
        """The layout in a few numbers (the wrappers' LAST_LAUNCH)."""
        return dict(lanes=self.lanes, warps=self.warps, threads=self.threads, width=self.width,
                    cluster=self.cluster, strips=self.strips, blocks=self.blocks,
                    cluster_edges=int(np.count_nonzero(self.right == CLUSTER_EDGE)),
                    record_edges=int(np.count_nonzero(self.right == RECORD)))


def _layout(chains: list, lanes: int, warps: int, cluster: int) -> StripPlan:
    width = 32 * lanes * warps
    chain, c0, nc = [], [], []
    for j, (start, n) in enumerate(chains):
        for s in range(0, n, width):
            chain.append(j)
            c0.append(start + s)
            nc.append(min(width, n - s))
    pad = -len(chain) % cluster
    chain += [-1] * pad
    c0 += [0] * pad
    nc += [0] * pad
    chain, c0, nc = (np.asarray(v, dtype=np.int64) for v in (chain, c0, nc))
    nxt = np.append(chain[1:], -1)
    same = (chain >= 0) & (nxt == chain)  # block k's right neighbour is its chain's next strip
    idx = np.arange(chain.size)
    right = np.where(same, np.where((idx + 1) % cluster != 0, CLUSTER_EDGE, RECORD), NONE)
    left = np.append(NONE, right[:-1])
    return StripPlan(lanes, warps, cluster, chain, c0, nc, left, right)


def strip_plan(kernel: str, chains: list, sms: int, capacity, lanes: int | None = None,
               warps: int | None = None, cluster: int | None = None) -> StripPlan:
    """The layout of `chains`, (first column, columns) runs in block order
    (each at least one column), for `kernel` ("tropical" or
    "sppairforward") on a card of `sms` SMs.  `capacity(lanes, warps,
    cluster)` gives the blocks of that shape that can be resident at once.
    `lanes` and `warps` force a block shape and `cluster` a cluster size
    (tests, the sweep); else the rule: the first of the kernel's ladder
    whose blocks fit min(sms, capacity), else the first that fits the
    capacity, in clusters of min(CLUSTER, the longest chain's strips).
    Raises ValueError for a shape the kernels are not built for or a
    layout that cannot be resident."""
    if not chains or any(n < 1 for _, n in chains):
        raise ValueError(f"chains must be non-empty runs of columns, got {chains}")
    if (lanes is None) != (warps is None):
        raise ValueError("lanes and warps are forced together")
    shapes = LADDERS[kernel] if lanes is None else ((lanes, warps),)
    for m, w in shapes:
        wide = kernel == "pppairforward" and m == 1 and MAX_WARPS < w <= ROW_WARPS
        if m not in LANES or not (1 <= w <= MAX_WARPS or wide):
            raise ValueError(f"no strip kernel of {m} lanes a thread and {w} warps")
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} blocks, not {cluster}")
    plans = []
    for m, w in shapes:
        longest = max(-(-n // (32 * m * w)) for _, n in chains)
        plan = _layout(chains, m, w, cluster or min(CLUSTER, longest))
        cap = capacity(m, w, plan.cluster)
        plans.append((plan, cap))
        if plan.blocks <= min(sms, cap):
            return plan
    for plan, cap in plans:
        if plan.blocks <= cap:
            return plan
    plan, cap = plans[-1]
    raise ValueError(f"a strip layout of {plan.blocks} blocks ({plan.lanes} lanes a thread, "
                     f"{plan.warps} warps, clusters of {plan.cluster}) cannot be resident at "
                     f"once: {cap} can")


def strip_waves(kernel: str, groups: list, sms: int, capacity, **force) -> list:
    """`groups` (each a list of (first column, columns) chains that must run
    in one launch: the strips of one pair on one card) cut into waves of
    consecutive groups, each as many as `strip_plan` lays out resident at
    once (`force` as its keywords): [(first group, end group), ...].  A
    layout's blocks grow with its groups, so each wave's end is found by
    doubling, then bisection.  A group that cannot be resident alone
    raises ValueError."""
    def fits(start: int, end: int) -> bool:
        try:
            strip_plan(kernel, [c for g in groups[start:end] for c in g], sms, capacity, **force)
        except ValueError:
            return False
        return True

    waves, start = [], 0
    while start < len(groups):
        strip_plan(kernel, groups[start], sms, capacity, **force)  # raises where it cannot
        good, step = start + 1, 1
        while good < len(groups) and fits(start, min(good + step, len(groups))):
            good, step = min(good + step, len(groups)), 2 * step
        bad = min(good + step, len(groups) + 1)  # the first end known not to fit (or past)
        while bad - good > 1:
            mid = (good + bad) // 2
            good, bad = (mid, bad) if fits(start, mid) else (good, mid)
        waves.append((start, good))
        start = good
    return waves


def slot_plan(items: int, pairs: int, Y1: int, sms: int, capacity, lanes: int | None = None,
              warps: int | None = None, cluster: int | None = None,
              slots: int | None = None) -> StripPlan:
    """Kernel (g3)'s layout for `items` work items (a (stage, pair) each,
    `pairs` a stage) of rows Y1 columns wide on a card of `sms` SMs:
    `slots` chains of strips of the Y1 columns (the plan's chains; item t
    runs on slot t mod slots), every block resident at once (`capacity(
    lanes, warps, cluster)`), clusters of min(CLUSTER, a slot's strips).
    With as many slots as a stage has pairs, items in stage order never
    wait for a slot: each stage's pairs run side by side and a pair's
    stages one after another, so the time is the pair's rows at the
    strips' row time.  The rule, over LADDERS["pppairforward"]
    (narrowest first), with a row of 9 to ROW_WARPS warps of one lane whole
    in one strip (K3's block shape) tried after the one-lane strips: the
    first shape whose slots take a stage's pairs, else the shape with the
    most slots (the narrowest of equals); as many slots as fit, at most one
    an item.  `lanes` and `warps`, `cluster` and `slots` force.  Raises
    ValueError where not one slot can be resident."""
    if items < 1 or pairs < 1 or Y1 < 1:
        raise ValueError(f"(g3) needs items, pairs and columns, got {items}, {pairs}, {Y1}")
    if (lanes is None) != (warps is None):
        raise ValueError("lanes and warps are forced together")
    if slots is not None and not 1 <= slots <= items:
        raise ValueError(f"slots must be 1 to {items}, got {slots}")
    shapes = LADDERS["pppairforward"] if lanes is None else ((lanes, warps),)
    row = -(-Y1 // 32)
    if lanes is None and MAX_WARPS < row <= ROW_WARPS:
        k = sum(m == 1 for m, _ in shapes)
        shapes = shapes[:k] + ((1, row),) + shapes[k:]
    best = None
    for m, w in shapes:
        one = strip_plan("pppairforward", [(0, Y1)], sms, lambda *_: 1 << 30, lanes=m,
                         warps=w, cluster=cluster)
        cap = capacity(m, w, one.cluster)
        fit = min(items, cap // one.blocks)
        n = fit if slots is None else (slots if slots <= fit else 0)
        if n < 1:
            continue
        if best is None or n > best[3]:
            best = (m, w, one.cluster, n)
        if n >= min(items, pairs):
            best = (m, w, one.cluster, n)
            break
    if best is None:
        raise ValueError(f"(g3): no layout of {Y1} columns ({'forced ' if lanes else ''}"
                         f"{'%d slots' % slots if slots else 'one slot'}) can be resident")
    m, w, c, n = best
    return _layout([(0, Y1)] * n, m, w, c)


def strip_table(plan: StripPlan, X1: int, dtype, device, ends: dict | None = None,
                cluster_records: bool = False) -> tuple:
    """The kernels' table, int64 [blocks, ENTRY] on the host, and the
    records it points to: one (records [X1, 8], counter, system scope) on
    `device` for each RECORD edge of the plan (and each CLUSTER_EDGE with
    `cluster_records`: kernel (g1) where the y DAG reaches past its ring),
    and `ends` {(chain, "left" | "right"): record} for a chain's own ends
    (the shard boundaries of kernels (g2) and (g1), ops/sp_colforward.py
    `_record_buffer`), where the table sets RECORD.  Returns (table, the
    plan's records)."""
    from historian_tpu_torch.ops.sp_colforward import _record_buffer

    ends = ends or {}
    table = np.zeros((plan.blocks, ENTRY), dtype=np.int64)
    records = []
    out_of = {}  # block -> the record its right edge writes
    for k in range(plan.blocks):
        j = int(plan.chain[k])
        left, right = int(plan.left[k]), int(plan.right[k])
        kept = (RECORD, CLUSTER_EDGE) if cluster_records else (RECORD,)
        rec_in = out_of.get(k - 1) if left in kept else None
        rec_out = None
        if right in kept:
            rec_out = _record_buffer("device", device, X1, dtype)
            records.append(rec_out)
            out_of[k] = rec_out
        if j >= 0 and left == NONE and (j, "left") in ends:
            left, rec_in = RECORD, ends[(j, "left")]
        if j >= 0 and right == NONE and (j, "right") in ends:
            right, rec_out = RECORD, ends[(j, "right")]
        table[k, :5] = (j, plan.c0[k], plan.nc[k], left, right)
        if rec_in is not None:
            table[k, 5:7] = (rec_in[0].data_ptr(), rec_in[1].data_ptr())
        if rec_out is not None:
            table[k, 7:9] = (rec_out[0].data_ptr(), rec_out[1].data_ptr())
        table[k, 9] = int(any(r is not None and r[2] for r in (rec_in, rec_out)))
    return table, records


@lru_cache(maxsize=None)
def card_capacity(kernel: str, suffix: str, device_index: int, lanes: int, warps: int,
                  cluster: int) -> int:
    """Blocks of `kernel` ("tropical", "sppairforward" or "pppairforward")
    that can be resident at once on CUDA device `device_index` (the C library's
    `<kernel>_capacity_<suffix>`); raises on a CUDA error."""
    from historian_tpu_torch.ops import _kernels

    with torch.cuda.device(device_index):
        cap = getattr(_kernels.lib(), f"{kernel}_capacity_{suffix}")(lanes, warps, cluster)
    if cap < 0:
        raise RuntimeError(f"{kernel}: the capacity query failed: CUDA error {-cap}")
    return cap


def card_plan(kernel: str, dtype, device, chains: list, **force) -> StripPlan:
    """`strip_plan` of `chains` on the CUDA `device` for `kernel`, with its
    SM count and capacity."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return strip_plan(kernel, chains, sms,
                      lambda m, w, c: card_capacity(kernel, suffix, index, m, w, c), **force)
