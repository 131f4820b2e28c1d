"""Wall time and device profile of `recon` on the card.

    python -m historian_tpu_torch.profile_recon [--routes fused default]
        [--cprofile] [--parent DIR [--walls PAIRS]] -- <recon arguments>

For each route (`fused`: HISTORIAN_PALLAS_FUSED=1, every merge through
K2; `default`: the emission matmul and K1), in float32: one warm-up run,
one timed run (host clock around the CLI entry, ending in a
synchronize), then one run under torch.profiler, which gives the device
busy time (the union of the kernels' and copies' intervals), the idle
share of the wall, and the kernels that take the most device time; with
--cprofile, one more run under cProfile, which gives the port's functions
with the most cumulative host time and the functions with the most time
of their own.  Prints the card's name and power
limit, then one JSON line per route.

With --parent DIR (a checkout of another commit, e.g. unpacked with
`git archive` into build/parent), compares the two in one call: this
file runs in a fresh process for each side, in the order parent, this
checkout, this checkout, parent, with that side's root as its working
directory, so that `historian_tpu_torch` and the recon arguments' paths
resolve there (only this checkout's runs take --cprofile).  Prints each
run's lines as it goes, tagged with its side and order, then one
`{"compare": ...}` line: per route, each side's timed walls, device busy
times and idle shares in run order.

With --parent DIR --walls PAIRS, times walls only, on the first route:
one worker process a side, warmed up once, then PAIRS pairs of timed
runs alternating P C, C P, ...; prints each run's wall and the process's
CPU time over it, then their quartiles and the change's minus the
parent's in each pair.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

#: kernels and host functions listed a run
TOP = 6


def run(cli, args: list) -> float:
    """One `recon` run on the card; returns its wall in seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["recon", "-platform", "gpu", *args])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"recon {args} returned {rc}")
    return time.perf_counter() - t0


def union_us(spans: list) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_profile(cli, args: list) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(cli, args)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = union_us(spans) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
                top=[dict(name=k[:90], calls=c, ms=us / 1e3) for k, (c, us) in ranked])


def host_profile(cli, args: list) -> tuple[list, list]:
    """(the port's functions with the most cumulative time, every function
    with the most time of its own: numpy's array arithmetic, which
    cProfile does not see as calls, counts in its caller's own time)."""
    pr = cProfile.Profile()
    pr.enable()
    run(cli, args)
    pr.disable()
    stats = pstats.Stats(pr)

    def name(f, line, fn):
        return f"{os.path.basename(f)}:{line} {fn}"

    rows = [(fn, ct) for fn, (_, _, _, ct, _) in stats.stats.items()
            if "historian_tpu_torch" in fn[0]]
    rows.sort(key=lambda r: -r[1])
    own = sorted(stats.stats.items(), key=lambda r: -r[1][2])
    return ([dict(fn=name(*fn), cum_s=ct) for fn, ct in rows[:2 * TOP]],
            [dict(fn=name(*fn), own_s=st[2], cum_s=st[3], calls=st[1]) for fn, st in own[:2 * TOP]])


def compare(parent: str, routes: list, cprofile: bool, args: list) -> int:
    """Parent, this checkout, this checkout, parent, each in a fresh
    process run from its root; prints their lines and the comparison."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    me = os.path.abspath(__file__)
    code = f"import runpy, sys; sys.argv[0] = {me!r}; runpy.run_path({me!r}, run_name='__main__')"
    table = {r: {"parent": [], "change": []} for r in routes}
    for order, side in enumerate(("parent", "change", "change", "parent")):
        root = os.path.abspath(parent) if side == "parent" else here
        flags = ["--routes", *routes] + (["--cprofile"] if cprofile and side == "change" else [])
        proc = subprocess.run([sys.executable, "-c", code, *flags, "--", *args], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"profile_recon: the {side} run in {root} failed")
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                print(f"{side} {order}: {line}", flush=True)
                continue
            rec = json.loads(line)
            print(json.dumps(dict(side=side, order=order, **rec)), flush=True)
            prof = rec["profile"]
            table[rec["route"]][side].append(dict(
                timed_wall_s=rec["timed_wall_s"], device_busy_s=prof["device_busy_s"],
                idle_share=prof["idle_share"]))
    print(json.dumps({"compare": dict(args=args, parent=os.path.abspath(parent), routes=table)}),
          flush=True)
    return 0


def walls(parent: str, route: str, pairs: int, args: list) -> int:
    """Timed walls only, parent and this checkout alternating: one worker
    process a side, each run from its root and warmed up once, then
    `pairs` pairs in the order P C, C P, P C, ...  Prints each run, then
    one `{"walls": ...}` line: for the walls and the CPU times, each
    side's in run order, their quartiles, and the change's minus the
    parent's per pair."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    me = os.path.abspath(__file__)
    code = f"import runpy, sys; sys.argv[0] = {me!r}; runpy.run_path({me!r}, run_name='__main__')"
    roots = {"parent": os.path.abspath(parent), "change": here}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    workers = {side: subprocess.Popen(
        [sys.executable, "-c", code, "--serve", "--routes", route, "--", *args], cwd=root,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True) for side, root in roots.items()}

    def one(side: str) -> dict:
        w = workers[side]
        w.stdin.write("run\n")
        w.stdin.flush()
        line = w.stdout.readline()
        if not line:
            raise RuntimeError(f"profile_recon: the {side} worker in {roots[side]} failed")
        return json.loads(line)

    try:
        for side in workers:
            print(json.dumps(dict(side=side, warmup=one(side))), flush=True)
        got = {"parent": [], "change": []}
        for k in range(pairs):
            for side in ("parent", "change") if k % 2 == 0 else ("change", "parent"):
                got[side].append(one(side))
                print(json.dumps(dict(side=side, pair=k, **got[side][-1])), flush=True)
    finally:
        for w in workers.values():
            w.stdin.close()
            w.wait()
    out = dict(args=args, route=route, roots=roots)
    for key in ("wall_s", "cpu_s"):
        v = {side: [r[key] for r in runs] for side, runs in got.items()}
        out[key] = dict(v, quartiles={side: [float(q) for q in np.percentile(x, [25, 50, 75])]
                                      for side, x in v.items()},
                        change_minus_parent=[c - p for p, c in zip(v["parent"], v["change"])])
    print(json.dumps({"walls": out}), flush=True)
    return 0


def serve(cli, args: list) -> int:
    """One timed run per `run` line on stdin: its wall and the process's
    CPU time over it (all threads, a synchronize's spin included) as a
    JSON line."""
    for line in sys.stdin:
        if line.strip() == "run":
            c0 = time.process_time()
            wall = run(cli, args)
            print(json.dumps(dict(wall_s=wall, cpu_s=time.process_time() - c0)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routes", nargs="+", default=["fused", "default"],
                    choices=["fused", "default"])
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--parent", help="a checkout to compare with, run P, C, C, P")
    ap.add_argument("--walls", type=int, metavar="PAIRS",
                    help="with --parent: timed walls only, PAIRS alternating pairs")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("recon_args", nargs=argparse.REMAINDER)
    opts = ap.parse_args(argv)
    args = [a for a in opts.recon_args if a != "--"]
    if not torch.cuda.is_available():
        print("profile_recon: no CUDA device", file=sys.stderr)
        return 1
    if opts.parent and opts.walls:
        return walls(opts.parent, opts.routes[0], opts.walls, args)
    if opts.parent:
        return compare(opts.parent, opts.routes, opts.cprofile, args)
    from historian_tpu_torch import cli

    os.environ["HISTORIAN_DEVICE_DTYPE"] = "f32"
    if opts.serve:
        os.environ["HISTORIAN_PALLAS_FUSED"] = "1" if opts.routes[0] == "fused" else "0"
        return serve(cli, args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for route in opts.routes:
        os.environ["HISTORIAN_PALLAS_FUSED"] = "1" if route == "fused" else "0"
        warm = run(cli, args)
        out = dict(route=route, args=args, package=os.path.dirname(os.path.abspath(cli.__file__)),
                   warmup_wall_s=warm, timed_wall_s=run(cli, args),
                   profile=device_profile(cli, args))
        if opts.cprofile:
            out["host_top"], out["host_own"] = host_profile(cli, args)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
