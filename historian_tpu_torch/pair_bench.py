"""Times kernels (f), (g2) and (g3) at the shapes chip_smoke.py (q) gives
them, and K1, K2 and kernel (g1) at long12's first merge and at the main
path's largest merge ((p)), sweeps their strip layouts, and compares
checkouts on one card.

    python -m historian_tpu_torch.pair_bench --cases [--reps 5]
    python -m historian_tpu_torch.pair_bench --columns [--reps 5]
    python -m historian_tpu_torch.pair_bench --main-merge [--reps 5]
    python -m historian_tpu_torch.pair_bench --roots DIR [DIR ...] [--rounds 2] [--columns]
    python -m historian_tpu_torch.pair_bench --sweep [--reps 3]
    python -m historian_tpu_torch.pair_bench --parts [--reps 3]

`--cases` times, through the public entry points alone (so that an older
checkout runs them too): (f) `tropical_pair_forward` on long12's first
two sequences (t01 x t02, preset lg, branch lengths 0.5 / 0.5) in
float32 and float64, and cut to 400 x 1000 in float32; (g2)
`sp_pair_forward` on long6's first two in float64 at 1, 2, 4 and 8
shards of the card, and cut to 300 x 300 at 8 shards; and the kernels
that share their row step, K3 (bench.py's headline batch, float32 and
float64), K4 (its long batch, float32 and float64) and (g3)
(`pp_pair_forward_lp` on the headline and the long batch at 2, 4 and 8
stages, float64; long8x12k's first pair at 4 stages, where a version
that refuses it is listed as raising).  Each
case: a warm call, then `reps` calls each between CUDA events; the
median, every run, and a SHA-256 of the outputs (cells and lp_best;
lp_end), so that two versions' bits can be compared.  Its last line is a
JSON object.

`--columns` times K1 (`col_forward_planes`), K2
(`col_forward_planes_fused`) and (g1) (`sp_col_forward_planes` on 1, 2, 4
and 8 shards of the card) at long12's first-merge shape (6085 x 6100,
chain y, chip_smoke.py's `k1_inputs` / `k2_inputs`), float32 and float64,
and by part: x cut to one 128-lane strip and to two, at every column; and
(g1) on a DAG y (2048 x 2048, KY 4, float64).  A SHA-256 of every
output.

`--main-merge` times K1 and (g1) on 4 shards of the card at the shape of
the largest merge of `recon -fast` on small6 with HISTORIAN_SP=1
(MAIN_MERGE: 321 x 341, chain y; the full grid and chip_smoke.py's
diagonal band), float32 and float64: CUDA events around each call, as
chip_smoke.py (p) times it, and the card's own time a call under
torch.profiler (the kernels and copies it ran, each by name), so that a
wrapper's host time shows as the difference.

`--roots` runs `--cases` (or `--columns`, `--main-merge`) in each root in turn, parent
and change alternating (roots.compare_roots: P C C P for two roots and
two rounds), then prints a `{"compare": ...}` line of the medians.

`--sweep` (this checkout only) times every strip layout of LANES x WARPS
x CLUSTERS (ops/pairstrips.py) at those shapes, (f) f32 and f64 and (g2)
f64 at 1 and 8 shards (a layout that cannot be resident is listed as
such); (g3) f64 at 4 stages on the headline and the long batch at each
block shape of LANES x WARPS and the headline's row whole in one strip
of 13 one-lane warps (clusters of up to 8, the rule's) with as many
slots as fit, and at a half and a quarter of those (PP_SLOTS); and each
kernel's dependency floor: one warp alone on a strip of
32 lanes a thread's columns for all the pair's rows, whose time over the
rows is one warp step's latency; the floor of the full grid is the rows
times that; and the pipeline's parts (PARTS: one strip of 2 and 4 warps,
2 and 8 strips of one warp handing on through distributed shared memory
and through records) at every row, each a row's time.  Its last line is a
JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
#: the sweep's block shapes and clusters
LANES, WARPS, CLUSTERS = (1, 2, 4), (1, 2, 4, 8), (1, 8, 16)


def read_pair(name: str) -> tuple:
    from historian_tpu_torch.core.seqs import read_fasta

    seqs = [s.seq for s in read_fasta(os.path.join(DATA, name))]
    return seqs[0], seqs[1]


def pair_arrays(x: str, y: str, dtype) -> list:
    """The pair DP's inputs of x and y on the card (chip_smoke.py's)."""
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.ops import pairforward

    args, _ = pairforward.chain_pair_forward_arrays(named_model("lg"), x, y, 0.5, 0.5,
                                                    dtype=dtype)
    return [a.to("cuda") for a in args]


def card_mesh(n: int):
    """A mesh of the one card repeated n times."""
    from historian_tpu_torch.parallel.mesh import Mesh, MeshDevice

    devs = np.array([MeshDevice(0, k, torch.device("cuda", 0)) for k in range(n)], dtype=object)
    return Mesh(devs, ("sp",))


def timed(fn, reps: int) -> tuple:
    """fn's last output, the median and every run's ms (CUDA events around
    each call, after a warm call)."""
    out = fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b))
    return out, float(np.median(runs)), runs


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def run_cases(reps: int) -> dict:
    from historian_tpu_torch import bench
    from historian_tpu_torch.ops import pairforward, sp_pairforward, tropical
    from historian_tpu_torch.parallel import pp_pairforward
    from historian_tpu_torch.parallel.mesh import Mesh

    out = {}
    long12, long6 = read_pair("long12.fa"), read_pair("long6.fa")
    for name, (x, y, dt) in {"f_float32": (*long12, torch.float32),
                             "f_float64": (*long12, torch.float64),
                             "f_float32_400x1000": (long12[0][:400], long12[1][:1000],
                                                    torch.float32)}.items():
        args = pair_arrays(x, y, dt)
        (cells, lp), ms, runs = timed(lambda: tropical.tropical_pair_forward(*args), reps)
        out[name] = dict(ms=ms, runs=runs, lp=float(lp), sha256=digest(cells, lp))
        del cells, args
    for name, (x, y, shards) in {**{f"g2_float64_{n}": (*long6, n) for n in (1, 2, 4, 8)},
                                 "g2_float64_300x300_8": (long6[0][:300], long6[1][:300], 8)
                                 }.items():
        args = pair_arrays(x, y, torch.float64)
        lp, ms, runs = timed(lambda: sp_pairforward.sp_pair_forward(*args,
                                                                    mesh=card_mesh(shards)),
                             reps)
        out[name] = dict(ms=ms, runs=runs, lp=float(lp), sha256=digest(lp))
    for name, (workload, dt, fn) in {
            "k3_headline_float32": ("headline", torch.float32, pairforward.pair_forward_lp),
            "k3_headline_float64": ("headline", torch.float64, pairforward.pair_forward_lp),
            "k4_long_float32": ("long", torch.float32, pairforward.pair_forward_lp_tiled),
            "k4_long_float64": ("long", torch.float64, pairforward.pair_forward_lp_tiled),
            **{f"g3_{w}_float64_{n}": (w, torch.float64, lambda *a, n=n: (
                pp_pairforward.pp_pair_forward_lp(*a, mesh=Mesh(card_mesh(n).devices, ("pp",)))))
               for w in ("headline", "long") for n in (2, 4, 8)}}.items():
        args = bench.build(workload, torch.device("cuda"), dt)
        lp, ms, runs = timed(lambda: fn(*args), reps if workload == "headline" else 2)
        out[name] = dict(ms=ms, runs=runs, lp=float(lp.double().mean()), sha256=digest(lp))
    wide = read_pair("long8x12k.fa")
    args = [t[None].contiguous() for t in pair_arrays(*wide, torch.float64)[:5]]
    args.append(pair_arrays(*wide, torch.float64)[6])
    try:
        lp, ms, runs = timed(lambda: pp_pairforward.pp_pair_forward_lp(
            *args, mesh=Mesh(card_mesh(4).devices, ("pp",))), 1)
        out["g3_long8x12k_float64_4"] = dict(ms=ms, runs=runs, lp=float(lp[0]),
                                             sha256=digest(lp))
    except ValueError as e:  # a version that takes at most 8192 columns
        out["g3_long8x12k_float64_4"] = dict(raises=str(e))
    return out


def column_inputs():
    """chip_smoke.py's K1 / K2 input builders, from this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(DATA), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", os.path.abspath(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_columns(reps: int) -> dict:
    """K1, K2 and (g1) at long12's first-merge shape and by part (the
    module's note)."""
    from historian_tpu_torch.ops import colforward, sp_colforward

    cs = column_inputs()
    SX, SY = cs.long12_first_merge()
    cuda = torch.device("cuda")
    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        full = cs.k1_inputs(SX, SY, 1, False, 17, dt)
        for cols, label in ((128, "strip1"), (256, "strips2"), (SX, "full")):
            args = full if cols == SX else tuple(
                t[..., :cols].contiguous() if k in (3, 4, 5) else t for k, t in enumerate(full))
            got, ms, runs = timed(lambda: colforward.col_forward_planes(*args), reps)
            out[f"k1_{label}_{name}"] = dict(ms=ms, runs=runs, us_a_column=ms * 1e3 / SY,
                                             sha256=digest(got))
            for n in ((1,) if cols == 128 else (1, 2) if cols == 256 else (1, 2, 4, 8)):
                got, ms, runs = timed(lambda: sp_colforward.sp_col_forward_planes(
                    *args, None, [cuda] * n), reps)
                out[f"g1_{label}_{name}_{n}"] = dict(ms=ms, runs=runs, us_a_column=ms * 1e3 / SY,
                                                     sha256=digest(got))
        del full, args, got
    band = cs.k1_inputs(SX, SY, 1, True, 17, torch.float32)
    lanes = colforward.lanes_from_mask(band[4] == 0)
    got, ms, runs = timed(lambda: colforward.col_forward_planes(*band, lanes=lanes), reps)
    out["k1_band_float32"] = dict(ms=ms, runs=runs, sha256=digest(got))
    got, ms, runs = timed(lambda: sp_colforward.sp_col_forward_planes(
        *band, lanes, [cuda] * 8), reps)
    out["g1_band_float32_8"] = dict(ms=ms, runs=runs, sha256=digest(got))
    k2 = cs.k2_inputs(SX, SY, 1, 23, torch.float32)
    got, ms, runs = timed(lambda: colforward.col_forward_planes_fused(*k2), reps)
    out["k2_float32"] = dict(ms=ms, runs=runs, sha256=digest(got))
    dag = cs.k1_inputs(2048, 2048, 4, True, 17, torch.float64)
    lanes = colforward.lanes_from_mask(dag[4] == 0)
    got, ms, runs = timed(lambda: colforward.col_forward_planes(*dag, lanes=lanes), reps)
    out["k1_dag_float64"] = dict(ms=ms, runs=runs, sha256=digest(got))
    for n in (1, 8):
        got, ms, runs = timed(lambda: sp_colforward.sp_col_forward_planes(
            *dag, lanes, [cuda] * n), reps)
        out[f"g1_dag_float64_{n}"] = dict(ms=ms, runs=runs, sha256=digest(got))
    return out


#: the largest merge of small6 `recon -fast` under HISTORIAN_SP=1 (SX, SY)
MAIN_MERGE = (321, 341)


def device_ms(fn, reps: int) -> tuple:
    """The card's time a call of fn under torch.profiler, after a warm
    call: the device time of every kernel and copy summed, and each by
    name (ms a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us:
            parts[e.key] = us / 1e3 / reps
    return sum(parts.values()), parts


def run_main_merge(reps: int) -> dict:
    """K1 and (g1) on 4 shards at MAIN_MERGE (the module's note)."""
    from historian_tpu_torch.ops import colforward, sp_colforward

    cs = column_inputs()
    cuda = torch.device("cuda")
    out = {}
    for banded in (False, True):
        for dt in (torch.float32, torch.float64):
            name = f"{'band' if banded else 'full'}_{str(dt)[6:]}"
            args = cs.k1_inputs(*MAIN_MERGE, 1, banded, 17, dt)
            lanes = colforward.lanes_from_mask(args[4] == 0) if banded else None
            for label, fn in (("k1", lambda: colforward.col_forward_planes(*args, lanes=lanes)),
                              ("g1", lambda: sp_colforward.sp_col_forward_planes(
                                  *args, lanes, [cuda] * 4))):
                got, ms, runs = timed(fn, reps)
                dev_ms, parts = device_ms(fn, reps)
                out[f"{label}_{name}"] = dict(ms=ms, runs=runs, device_ms=dev_ms,
                                              device_parts=parts, sha256=digest(got))
                print(f"{label} {name}: {ms:.3f} ms (events), {dev_ms:.3f} ms on the card",
                      flush=True)
    return out


def run_sweep(reps: int) -> dict:
    from historian_tpu_torch.ops import sp_pairforward, tropical

    long12, long6 = read_pair("long12.fa"), read_pair("long6.fa")
    trop = {dt: pair_arrays(*long12, dt) for dt in (torch.float32, torch.float64)}
    sp = pair_arrays(*long6, torch.float64)
    calls = {"f_float32": lambda **kw: tropical.tropical_pair_forward(*trop[torch.float32], **kw),
             "f_float64": lambda **kw: tropical.tropical_pair_forward(*trop[torch.float64], **kw)}
    for n in (1, 8):
        calls[f"g2_float64_{n}"] = (lambda n=n, **kw: sp_pairforward.sp_pair_forward(
            *sp, mesh=card_mesh(n), **kw))
    rows = {"f_float32": trop[torch.float32][0].shape[0],
            "f_float64": trop[torch.float64][0].shape[0], "g2_float64_1": sp[0].shape[0],
            "g2_float64_8": sp[0].shape[0]}
    out = {}
    for case, call in calls.items():
        table, base = [], None
        for m in LANES:
            for w in WARPS:
                for c in CLUSTERS:
                    try:
                        got, ms, runs = timed(lambda: call(lanes=m, warps=w, cluster=c), reps)
                    except ValueError as e:  # the layout cannot be resident
                        table.append(dict(lanes=m, warps=w, cluster=c, resident=False,
                                          why=str(e)))
                        continue
                    lp = float(got[1] if isinstance(got, tuple) else got)
                    base = lp if base is None else base
                    launch = (tropical if case.startswith("f") else sp_pairforward).LAST_LAUNCH
                    lay = launch if case.startswith("f") else launch["layouts"][0]
                    table.append(dict(lanes=m, warps=w, cluster=c, resident=True, ms=ms,
                                      runs=runs, us_a_row=ms * 1e3 / rows[case],
                                      strips=lay["strips"], blocks=lay["blocks"],
                                      cluster_edges=lay["cluster_edges"],
                                      record_edges=lay["record_edges"], lp=lp,
                                      lp_rel_diff=abs(lp - base) / abs(base)))
                    print(f"sweep {case} lanes {m} warps {w} cluster {c}: {ms:.3f} ms "
                          f"({ms * 1e3 / rows[case]:.3f} us a row), {lay['strips']} strips, "
                          f"{lay['cluster_edges']} cluster / {lay['record_edges']} record edges",
                          flush=True)
        out[case] = table
    # the dependency floors: one warp alone on 32 * lanes columns, every row
    floors = {}
    for m in LANES:
        for case, (x, y, dt) in {"f_float32": (long12[0], long12[1], torch.float32),
                                  "f_float64": (long12[0], long12[1], torch.float64),
                                  "g2_float64": (long6[0], long6[1], torch.float64)}.items():
            args = pair_arrays(x, y[:32 * m - 1], dt)
            if case.startswith("f"):
                fn = lambda: tropical.tropical_pair_forward(*args, lanes=m, warps=1, cluster=1)  # noqa: E731
            else:
                fn = lambda: sp_pairforward.sp_pair_forward(*args, mesh=card_mesh(1), lanes=m,  # noqa: E731
                                                            warps=1, cluster=1)
            _, ms, runs = timed(fn, reps)
            X1 = args[0].shape[0]
            full = rows[case if case.startswith("f") else "g2_float64_1"]
            step_ns = ms * 1e6 / X1
            floors[f"{case}_lanes{m}"] = dict(ms=ms, rows=X1, step_ns=step_ns,
                                             floor_ms=full * step_ns * 1e-6)
            print(f"floor {case} one warp of {m} lanes a thread: {ms:.3f} ms for {X1} rows, "
                  f"{step_ns:.1f} ns a warp step; floor of the grid {full * step_ns * 1e-6:.3f} "
                  f"ms", flush=True)
    return dict(layouts=out, floors=floors, pp=run_pp_sweep(reps), parts=run_parts(reps))


#: the share of the most slots that fit at which (g3) is also timed
PP_SLOTS = (1, 2, 4)


def run_pp_sweep(reps: int) -> dict:
    """(g3) f64 on 4 stages of the card, headline and long batches: each
    block shape in the rule's clusters, the slots that fit (and a half
    and a quarter of them)."""
    from historian_tpu_torch import bench
    from historian_tpu_torch.ops import pairstrips
    from historian_tpu_torch.parallel import pp_pairforward

    out = {}
    for workload in ("headline", "long"):
        args = bench.build(workload, torch.device("cuda"), torch.float64)
        P, X1, Y1 = args[0].shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows, base = [], None
        shapes = [(m, w) for m in LANES for w in WARPS]
        if WARPS[-1] < -(-Y1 // 32) <= pairstrips.ROW_WARPS:  # the row whole in one strip
            shapes.append((1, -(-Y1 // 32)))
        for m, w in shapes:
            try:
                most = pairstrips.slot_plan(4 * P, P, Y1, sms, lambda *k: (
                    pairstrips.card_capacity("pppairforward", "f64", 0, *k)), lanes=m,
                                            warps=w)
            except ValueError as e:
                rows.append(dict(lanes=m, warps=w, resident=False, why=str(e)))
                continue
            fit = int(most.chain.max()) + 1
            for share in PP_SLOTS:
                slots = max(1, fit // share)
                lp, ms, runs = timed(lambda: pp_pairforward._kernel(
                    *args, [torch.device("cuda", 0)] * 4, dict(lanes=m, warps=w, slots=slots)),
                    reps if workload == "headline" else 1)
                base = lp if base is None else base
                rows.append(dict(lanes=m, warps=w, cluster=most.cluster, slots=slots,
                                 ms=ms, runs=runs,
                                 us_a_row=ms * 1e3 / X1,
                                 rel_diff=float(((lp - base).abs() / base.abs()).max())))
                print(f"sweep g3 {workload} lanes {m} warps {w} slots {slots}: {ms:.3f} ms",
                      flush=True)
        out[workload] = rows
    return out


#: the pipeline's parts (columns, lanes, warps, cluster): one warp alone,
#: one strip of 2 and 4 warps, 2 and 8 one-warp strips handing on through
#: distributed shared memory and through records, 8 strips of 4 warps
PARTS = ((32, 1, 1, 1), (64, 1, 2, 1), (128, 1, 4, 1), (64, 1, 1, 2), (64, 1, 1, 1),
         (256, 1, 1, 8), (256, 1, 1, 1), (1024, 1, 4, 8))


def run_parts(reps: int) -> dict:
    """Where a row's time goes: each kernel at every row of its pair on
    the narrow grids of PARTS, its time a row beside one warp alone's."""
    from historian_tpu_torch.ops import sp_pairforward, tropical

    long12, long6 = read_pair("long12.fa"), read_pair("long6.fa")
    out = {}
    for case, (x, y, dt) in {"f_float32": (long12[0], long12[1], torch.float32),
                              "f_float64": (long12[0], long12[1], torch.float64),
                              "g2_float64": (long6[0], long6[1], torch.float64)}.items():
        rows = []
        for cols, m, w, c in PARTS:
            args = pair_arrays(x, y[:cols - 1], dt)
            if case.startswith("f"):
                fn = lambda: tropical.tropical_pair_forward(*args, lanes=m, warps=w, cluster=c)  # noqa: E731
            else:
                fn = lambda: sp_pairforward.sp_pair_forward(*args, mesh=card_mesh(1), lanes=m,  # noqa: E731
                                                            warps=w, cluster=c)
            _, ms, runs = timed(fn, reps)
            X1 = args[0].shape[0]
            rows.append(dict(cols=cols, lanes=m, warps=w, cluster=c, ms=ms,
                             us_a_row=ms * 1e3 / X1))
            print(f"part {case} {cols} columns, {m} lanes x {w} warps, cluster {c}: {ms:.3f} ms, "
                  f"{ms * 1e3 / X1:.3f} us a row", flush=True)
        out[case] = rows
    # (g2) at 8 shards of whole strips (704 columns a shard) and of a part
    # strip (706), beside 1 shard
    args = pair_arrays(*long6, torch.float64)
    rows = []
    for cols in (5632, 5648, 6016):
        cut = [args[0][:, :cols], args[1], args[2][:cols], args[3], args[4][:cols],
               args[5][:, :cols], args[6]]
        cut = [t.contiguous() for t in cut]
        for n in (1, 8):
            _, ms, runs = timed(lambda: sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(n)),
                                reps)
            rows.append(dict(cols=cols, shards=n, ms=ms,
                             last_strip=sp_pairforward.LAST_LAUNCH["cols"][-1] % 64))
            print(f"part g2_float64 {cols} columns on {n} shards: {ms:.3f} ms", flush=True)
    out["g2_float64_shards"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", action="store_true")
    ap.add_argument("--columns", action="store_true", help="K1, K2 and (g1)")
    ap.add_argument("--main-merge", action="store_true",
                    help="K1 and (g1) at the main path's largest merge")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--parts", action="store_true", help="the pipeline's parts alone")
    ap.add_argument("--pp-sweep", action="store_true", help="(g3)'s part of --sweep alone")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        mode = "columns" if opts.columns else "main_merge" if opts.main_merge else "cases"
        return compare_roots(__file__, [f"--{mode.replace('_', '-')}", "--reps",
                                        str(opts.reps)], opts.roots,
                             opts.rounds, "pair_bench",
                             keep=lambda rec: {c: r.get("ms") for c, r in rec[mode].items()})
    if not torch.cuda.is_available():
        raise RuntimeError("pair_bench times the card: no CUDA device")
    rec = dict(card=card(), device=torch.cuda.get_device_name(0))
    if opts.sweep:
        rec["sweep"] = run_sweep(opts.reps)
    elif opts.pp_sweep:
        rec["pp_sweep"] = run_pp_sweep(opts.reps)
    elif opts.parts:
        rec["parts"] = run_parts(opts.reps)
    if opts.columns:
        rec["columns"] = run_columns(opts.reps)
    if opts.main_merge:
        rec["main_merge"] = run_main_merge(opts.reps)
    if opts.cases or not (opts.sweep or opts.parts or opts.columns or opts.pp_sweep
                          or opts.main_merge):
        rec["cases"] = run_cases(opts.reps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
