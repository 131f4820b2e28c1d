"""Times kernel (e), the branch fill, on one fill's saved inputs, and
compares checkouts of the package on the same card.

    python -m historian_tpu_torch.branch_bench --inputs F.npz [--reps 5]
    python -m historian_tpu_torch.branch_bench --inputs F.npz --sweep
    python -m historian_tpu_torch.branch_bench --inputs F.npz --roots DIR ... [--rounds 2]

F.npz holds one fill's `match_emit` [X+1, Y+1], `ins_emit` [Y+1], `mask`
(bool [X+1, Y+1]) and `trans` [8] (chip_smoke.py --parent writes long6's
first refine fill there, and long6 `mcmc`'s full-mask Forward fill under
build/bench_inputs/).  One run prints, as its last line, a JSON object
with the kernel's ms in each mode (CUDA events, median of `reps` after a
warm launch): the kernel alone (the band entry `branchdp.branch_fill_band`
on the band already on the card) and the whole `branchdp.branch_fill`
wrapper, the design and layout of the launch, and a SHA-256 of each
mode's band cells, so that two versions' bits can be compared.  --sweep
times the strip design at every layout of SWEEP (rows a strip x lead) in
both modes and prints one JSON line a layout, then the fastest of each
mode.  With --roots, each root's run in turn, parent and change
alternating (roots.compare_roots), then a `{"compare": ...}` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

#: the strip layouts --sweep times: rows a strip x lead
SWEEP = [(rows, lead) for rows in (32, 64, 96, 128, 192) for lead in (2, 8, 16, 64)]


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


def load(path: str) -> tuple:
    """The fill's inputs on the card and its band's layout and inputs."""
    from historian_tpu_torch.ops import branchdp

    if not torch.cuda.is_available():
        raise RuntimeError("branch_bench times the card: no CUDA device")
    dev = torch.device("cuda")
    with np.load(path) as f:
        args = [torch.as_tensor(f[k], device=dev)
                for k in ("match_emit", "ins_emit", "mask", "trans")]
    hull = (t.cpu().numpy() for t in branchdp.interior_hull(args[2]))
    layout = branchdp.band_layout(*hull, *args[0].shape)
    return args, layout, branchdp.band_inputs(layout, args[0], args[2], args[1], args[3])


def measure(path: str, reps: int) -> dict:
    from historian_tpu_torch.ops import branchdp

    args, layout, inp = load(path)
    out = dict(shape=list(args[0].shape), in_mask=int(args[2].sum()), band_cells=layout.n,
               diagonals=sum(args[0].shape) - 1, card=torch.cuda.get_device_name(0),
               design=layout.design())
    for viterbi, mode in ((True, "viterbi"), (False, "forward")):
        cells = branchdp.branch_fill_band(inp, viterbi)
        out[f"{mode}_sha256"] = hashlib.sha256(cells.cpu().numpy().tobytes()).hexdigest()
        out[f"{mode}_launch"] = dict(getattr(branchdp, "LAST_LAUNCH", {}))
        del cells
        out[f"{mode}_ms"] = median_ms(lambda: branchdp.branch_fill_band(inp, viterbi), reps)
        out[f"{mode}_wrapper_ms"] = median_ms(lambda: branchdp.branch_fill(*args, viterbi), reps)
    return out


def sweep(path: str, reps: int) -> int:
    """The strip design at every layout of SWEEP, both modes: one JSON line
    a layout (ms, us a diagonal, the SHA-256 of the cells), then the
    fastest layout of each mode."""
    from historian_tpu_torch.ops import branchdp

    args, layout, inp = load(path)
    K = sum(args[0].shape) - 1
    best = {}
    for viterbi, mode in ((True, "viterbi"), (False, "forward")):
        digests = set()
        for rows, lead in SWEEP:
            def run():
                return branchdp._fill_band(inp, viterbi, design="strip", strip_rows=rows,
                                           lead=lead)

            digests.add(hashlib.sha256(run().cpu().numpy().tobytes()).hexdigest())
            ms = median_ms(run, reps)
            rec = dict(mode=mode, rows=rows, lead=lead, ms=ms, us_per_diagonal=ms * 1e3 / K,
                       launch=dict(branchdp.LAST_LAUNCH))
            print(json.dumps(rec), flush=True)
            if mode not in best or ms < best[mode]["ms"]:
                best[mode] = rec
        best[mode]["same_bits_at_every_layout"] = len(digests) == 1
    print(json.dumps(dict(shape=list(args[0].shape), card=torch.cuda.get_device_name(0),
                          best=best)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if opts.sweep:
        return sweep(opts.inputs, opts.reps)
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        # each root's run starts in that root: the inputs by their absolute path
        return compare_roots(__file__, ["--inputs", os.path.abspath(opts.inputs), "--reps",
                                        str(opts.reps)], opts.roots, opts.rounds, "branch_bench")
    print(json.dumps(measure(opts.inputs, opts.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
