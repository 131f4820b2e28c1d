"""Times kernel (d), the sibling fill, on one fill's saved inputs, and
compares checkouts of the package on the same card.

    python -m historian_tpu_torch.sibling_bench --inputs F.pkl [--reps 5]
    python -m historian_tpu_torch.sibling_bench --inputs F.pkl --roots DIR ... [--rounds 2]
    python -m historian_tpu_torch.sibling_bench --batch B.pkl [--sweep | --roots DIR ...]

F.pkl holds one sibling fill's host inputs pickled: match_emit and mask
[X+1, Y+1], l_emit [X], r_emit [Y] and the [12, 12] transition table
(chip_smoke.py --parent writes long6's banded node-align fill and its
full-mask prune-and-regraft fill there).  One run takes the band of the
mask (ops/branchdp.py `interior_hull`, `band_layout`), uploads it and
prints, as its last line, a JSON object: kernel (d)'s ms (CUDA events,
median of `reps` after a warm launch) through `sibling_fill_band` (in a
package with a plan kernel, that kernel and the fill; alone each where
the design has a plan), the launch's design, and a SHA-256 of the cells
and lp_end, so that two versions' bits can be compared.  With --batch,
B.pkl holds kernel (d')'s batch pickled, `SiblingMatrix.batch_arrays` of
the grids (chip_smoke.py --parent writes bench.py:566's 16 grids under
build/bench_inputs/): the run times `sibling_forward_batch` on them and
prints its ms, the launch's layout and a SHA-256 of the cells and
lp_end; --sweep times it at each cluster size twice, in mirrored order
(1, 2, 4, 8, 8, 4, 2, 1), so that each pair of sizes is compared both
ways in one process.  With --roots,
each root's run in turn, parent and change alternating
(roots.compare_roots), then a `{"compare": ...}` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys

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
    from historian_tpu_torch.ops import branchdp, siblingdp

    if not torch.cuda.is_available():
        raise RuntimeError("sibling_bench times the card: no CUDA device")
    with open(path, "rb") as f:
        match, mask, l_emit, r_emit, tmat = pickle.load(f)
    hull = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
    layout = branchdp.band_layout(*hull, *mask.shape)
    inp = siblingdp.upload_band(layout, match, mask, l_emit, r_emit, tmat, torch.device("cuda"))
    cells, lp_end = siblingdp.sibling_fill_band(inp)
    digest = hashlib.sha256(cells.cpu().numpy().tobytes() + lp_end.cpu().numpy().tobytes())
    launch = dict(siblingdp.LAST_LAUNCH)
    del cells
    X1, Y1 = mask.shape
    out = dict(shape=[X1 - 1, Y1 - 1], band_cells=layout.n, diagonals=X1 + Y1 - 1,
               card=torch.cuda.get_device_name(0), launch=launch, cells_sha256=digest.hexdigest(),
               kernel_ms=median_ms(lambda: siblingdp.sibling_fill_band(inp), reps))
    if launch.get("design") == "ring":
        planned = siblingdp.plan_records(inp)
        out["plan_kernel_ms"] = median_ms(lambda: siblingdp.plan_records(inp), reps)
        out["fill_ms"] = median_ms(lambda: siblingdp.sibling_fill_band(inp, planned), reps)
    return out


def measure_batch(path: str, reps: int, cluster: int | None = None) -> dict:
    """Kernel (d') on a pickled batch: ms (median of `reps` after a warm
    launch), the launch's layout and the SHA-256 of cells and lp_end."""
    from historian_tpu_torch.ops import siblingdp

    if not torch.cuda.is_available():
        raise RuntimeError("sibling_bench times the card: no CUDA device")
    with open(path, "rb") as f:
        arrays = pickle.load(f)
    t = [torch.from_numpy(a).to("cuda") for a in arrays]
    def run():
        if cluster is None:
            return siblingdp.sibling_forward_batch(*t)
        return siblingdp._forward_batch(*t, cluster=cluster)

    cells, lp_end = run()
    digest = hashlib.sha256(cells.cpu().numpy().tobytes() + lp_end.cpu().numpy().tobytes())
    del cells, lp_end
    ends = arrays[5]
    return dict(items=len(ends), grid=list(arrays[2].shape[1:]),
                diagonals=int((ends[:, 0] + ends[:, 1]).max()) + 1,
                card=torch.cuda.get_device_name(0), launch=dict(siblingdp.LAST_BATCH),
                cells_sha256=digest.hexdigest(),
                kernel_ms=median_ms(run, reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--inputs")
    src.add_argument("--batch")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    # each root's run starts in that root: the inputs by their absolute path
    what = (["--batch", os.path.abspath(opts.batch)] if opts.batch
            else ["--inputs", os.path.abspath(opts.inputs)])
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        return compare_roots(__file__, what + ["--reps", str(opts.reps)], opts.roots,
                             opts.rounds, "sibling_bench")
    if opts.batch and opts.sweep:
        for cluster in (1, 2, 4, 8, 8, 4, 2, 1):
            print(json.dumps(dict(cluster=cluster, **measure_batch(opts.batch, opts.reps,
                                                                   cluster))), flush=True)
        return 0
    if opts.batch:
        print(json.dumps(measure_batch(opts.batch, opts.reps)), flush=True)
        return 0
    print(json.dumps(measure(opts.inputs, opts.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
