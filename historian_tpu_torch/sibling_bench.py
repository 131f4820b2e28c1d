"""Times kernel (d), the sibling fill, on one fill's saved inputs, and
compares checkouts of the package on the same card.

    python -m historian_tpu_torch.sibling_bench --inputs F.pkl [--reps 5]
    python -m historian_tpu_torch.sibling_bench --inputs F.pkl --roots DIR ... [--rounds 2]

F.pkl holds one sibling fill's host inputs pickled: match_emit and mask
[X+1, Y+1], l_emit [X], r_emit [Y] and the [12, 12] transition table
(chip_smoke.py --parent writes long6's banded node-align fill and its
full-mask prune-and-regraft fill there).  One run takes the band of the
mask (ops/branchdp.py `interior_hull`, `band_layout`), uploads it and
prints, as its last line, a JSON object: kernel (d)'s ms (CUDA events,
median of `reps` after a warm launch) through `sibling_fill_band` (in a
package with a plan kernel, that kernel and the fill; alone each where
the design has a plan), the launch's design, and a SHA-256 of the cells
and lp_end, so that two versions' bits can be compared.  With --roots,
each root's run in turn, parent and change alternating
(roots.compare_roots), then a `{"compare": ...}` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
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
                             opts.roots, opts.rounds, "sibling_bench")
    print(json.dumps(measure(opts.inputs, opts.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
