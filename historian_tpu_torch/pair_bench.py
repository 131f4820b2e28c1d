"""Times kernels (f) and (g2) at the shapes chip_smoke.py (q) gives them,
sweeps their strip layouts, and compares checkouts on one card.

    python -m historian_tpu_torch.pair_bench --cases [--reps 5]
    python -m historian_tpu_torch.pair_bench --roots DIR [DIR ...] [--rounds 2]
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
(`pp_pair_forward_lp` on the headline batch at 4 stages, float64).  Each
case: a warm call, then `reps` calls each between CUDA events; the
median, every run, and a SHA-256 of the outputs (cells and lp_best;
lp_end), so that two versions' bits can be compared.  Its last line is a
JSON object.

`--roots` runs `--cases` in each root in turn, parent and change
alternating (roots.compare_roots: P C C P for two roots and two rounds),
then prints a `{"compare": ...}` line of the medians.

`--sweep` (this checkout only) times every strip layout of LANES x WARPS
x CLUSTERS (ops/pairstrips.py) at those shapes, (f) f32 and f64 and (g2)
f64 at 1 and 8 shards (a layout that cannot be resident is listed as
such), and each kernel's dependency floor: one warp alone on a strip of
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
            "g3_headline_float64_4": ("headline", torch.float64, lambda *a: (
                pp_pairforward.pp_pair_forward_lp(*a, mesh=Mesh(card_mesh(4).devices,
                                                                ("pp",)))))}.items():
        args = bench.build(workload, torch.device("cuda"), dt)
        lp, ms, runs = timed(lambda: fn(*args), reps if workload == "headline" else 2)
        out[name] = dict(ms=ms, runs=runs, lp=float(lp.double().mean()), sha256=digest(lp))
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
    return dict(layouts=out, floors=floors, parts=run_parts(reps))


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
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--parts", action="store_true", help="the pipeline's parts alone")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        return compare_roots(__file__, ["--cases", "--reps", str(opts.reps)], opts.roots,
                             opts.rounds, "pair_bench",
                             keep=lambda rec: {c: r["ms"] for c, r in rec["cases"].items()})
    if not torch.cuda.is_available():
        raise RuntimeError("pair_bench times the card: no CUDA device")
    rec = dict(card=card(), device=torch.cuda.get_device_name(0))
    if opts.sweep:
        rec["sweep"] = run_sweep(opts.reps)
    elif opts.parts:
        rec["parts"] = run_parts(opts.reps)
    if opts.cases or not (opts.sweep or opts.parts):
        rec["cases"] = run_cases(opts.reps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
