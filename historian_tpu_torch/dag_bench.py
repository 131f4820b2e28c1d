"""Times kernel (a), the DAG x DAG merge fill, on one merge's saved
arguments, and compares checkouts of the package on the same card.

    python -m historian_tpu_torch.dag_bench --inputs F.pkl [--reps 5]
    python -m historian_tpu_torch.dag_bench --inputs F.pkl --roots DIR ... [--rounds 2]

F.pkl holds one merge's ForwardMatrix arguments (x, y, hmm, parent row,
envelope) pickled (chip_smoke.py --parent writes long12's first
sampled-x merge there).  One run fills the merge on the host (fill.cpp),
then prints, as its last line, a JSON object: the host plan's ms (median
of 3; by part where the package times its parts), the upload's bytes
and ms, and kernel (a)'s ms (CUDA events, median of `reps` after a warm
launch): `dag_fill_band` on the uploaded inputs (in a package with a
plan kernel, that kernel and the fill; alone each where it has one).
With --roots, each root's run in turn, parent and change alternating
(roots.compare_roots), then a `{"compare": ...}` line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import time

import numpy as np
import torch


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def measure(path: str, reps: int) -> dict:
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.ops import dagforward

    if not torch.cuda.is_available():
        raise RuntimeError("dag_bench times the card: no CUDA device")

    class HostFill(forward.ForwardMatrix):
        def _fill_device(self):
            return False

    with open(path, "rb") as f:
        host = HostFill(*pickle.load(f))
    plan_ms, parts = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        p = dagforward.plan(host)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(getattr(p, "host_ms", {}))
    k = int(np.argsort(plan_ms)[1])
    inp = dagforward.upload_band(p, torch.device("cuda"))
    up = dagforward.UPLOADS[-1]
    out = dict(shape=[host.x_size - 1, host.y_size - 1], cells=len(p.cells),
               wavefronts=len(p.wave) - 1, card=torch.cuda.get_device_name(0),
               plan_ms=plan_ms[k], plan_parts=parts[k], upload_bytes=up["bytes"],
               upload_ms=up["ms"], pack_ms=up["pack_ms"],
               kernel_ms=median_ms(lambda: dagforward.dag_fill_band(inp), reps))
    if hasattr(dagforward, "plan_records"):
        planned = dagforward.plan_records(inp)
        out["plan_kernel_ms"] = median_ms(lambda: dagforward.plan_records(inp), reps)
        out["fill_ms"] = median_ms(lambda: dagforward.dag_fill_band(inp, planned), reps)
        out["design"] = dagforward.LAST_LAUNCH.get("design")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        return compare_roots(__file__, ["--inputs", opts.inputs, "--reps", str(opts.reps)],
                             opts.roots, opts.rounds, "dag_bench")
    print(json.dumps(measure(opts.inputs, opts.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
