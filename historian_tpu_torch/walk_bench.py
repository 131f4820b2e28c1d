"""Trace walker timing at long12's first merge (t01 x t02) on the card.

    python -m historian_tpu_torch.walk_bench [--reps N] [--merges N ...]
        [--roots DIR ... [--rounds R]]

Fills K1's planes over the full grid of a chain y at that shape (the
inputs of chip_smoke.py's long12 case: seed 17), then times the walker
as chip_smoke.py walks them (seed 5): a best-only walk in float32 (the
`-fast` path's case), one best plus one sampled walk in float64, and one
best plus ten sampled walks in float32 (a merge of the default `recon`:
the sampled walks one after another over one draw buffer).  Each
call is timed alone with CUDA events; the median of --reps after a warm
call is kept.  Prints the card's name and power limit, then one JSON
line with each case's ms, its steps (the best walk's and the sampled
walks' together, whichever is longer, as the two run side by side) and
us a step.

With --merges, the line also holds one chain-x merge of the default
`recon` on each route a merge can take, for each length N: t01 and t02
of tests/data/long12.fa cut to N aa, as `recon` builds its first merge
(preset lg, the port's guide stage, the default band, branch lengths
0.1); the fill with its lp_end read, then the best and 10 sampled traces
on one mt19937 seed.  The device route is K1 and the walker, the host
route `csrc/fill.cpp` and the host walks; each is timed on the host
clock, ending in a synchronize (median of --reps after a warm run).

With --roots (checkouts of other versions of the package, e.g. unpacked
with `git archive` into build/), runs this file in a fresh process from
each root, in the order given and then reversed, --rounds times, so that
versions of the kernel compare in one call; prints each run's line
tagged with its root, then one `{"compare": ...}` line with each root's
times in run order.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NEG = -1e30
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")


def first_merge_shape() -> tuple:
    """(SX, SY) of long12's first merge: START plus t01's and t02's residues."""
    from historian_tpu_torch.core.seqs import read_fasta

    seqs = {s.name: s.seq for s in read_fasta(os.path.join(DATA, "long12.fa"))}
    return len(seqs["t01"]) + 1, len(seqs["t02"]) + 1


def walk_args(SX: int, SY: int, n_samples: int, dtype, dev) -> tuple:
    """K1's planes of a chain y over the full grid and the walker's
    arguments over them: the best walk and n_samples sampled walks."""
    from historian_tpu_torch.ops import colforward

    rng = np.random.default_rng(17)
    absorb = rng.normal(-5, 1, (SY, SX))
    rng.integers(0, 6, (SY, 1))  # chip_smoke's DAG edges, unused by a chain y
    y_src = np.maximum(np.arange(SY) - 1, 0)[:, None]
    y_lp = rng.normal(-1, 0.5, (SY, 1))
    y_ready = np.ones(SY, bool)
    y_ready[0] = False
    flags = np.stack([np.zeros(SY), y_ready, rng.normal(-2, 1, SY), rng.normal(-2, 1, SY)], 1)
    x_ready = np.ones(SX, bool)
    x_ready[-1] = False
    xvec = np.stack([rng.normal(-2, 1, SX), rng.normal(-2, 1, SX),
                     np.where(x_ready, 0.0, NEG), np.zeros(SX)])

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    planes = colforward.col_forward_planes(
        t(y_src, torch.int32), t(y_lp), t(flags), t(absorb), t(np.zeros((SY, SX))), t(xvec),
        t(rng.normal(-1, 0.5, 23)))
    rng = np.random.default_rng(5)
    tx = rng.normal(-0.1, 0.05, SX)
    tx[0] = 0.0
    L = SX + SY
    return (planes, t(y_src, torch.int32), t(y_lp), t(np.zeros(SY), torch.bool), t(tx),
            t(rng.normal(-1, 0.5, (6, 6))), SX - 1, -0.3,
            t(np.array([SY - 3, SY - 1]), torch.int32), t(np.array([-1.5, -0.2])),
            t(rng.random(max(n_samples, 1) * L)), True, n_samples, L)


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def measure(reps: int) -> dict:
    from historian_tpu_torch.ops import tracedp

    dev = torch.device("cuda")
    SX, SY = first_merge_shape()
    out = {}
    for case, n, dtype in (("best_f32", 0, torch.float32), ("best_sampled_f64", 1, torch.float64),
                           ("best_10_sampled_f32", 10, torch.float32)):
        walk = walk_args(SX, SY, n, dtype, dev)
        ms = median_ms(lambda: tracedp.pair_trace(*walk), reps)
        n_steps = tracedp.pair_trace(*walk)[4]
        steps = max(int(n_steps[0]), int(n_steps[1:].sum()))
        out[case] = dict(ms=ms, steps=steps, us_step=ms * 1e3 / steps)
        del walk
    return out


def merge_inputs(n: int) -> tuple:
    """(x, y, hmm, env) of t01 x t02 of long12 cut to n aa."""
    from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu_torch.core.seqs import read_fasta
    from historian_tpu_torch.engine.pairhmm import PairHMM
    from historian_tpu_torch.engine.profile import Profile
    from historian_tpu_torch.models.ratemodel import ProbModel
    from historian_tpu_torch.recon import DEFAULT_MAX_DISTANCE_FROM_GUIDE, Reconstructor

    seqs = {s.name: s.seq for s in read_fasta(os.path.join(DATA, "long12.fa"))}
    recon = Reconstructor()
    recon.preset_model_name = "lg"
    recon.load_model()
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "pair.fa")
        with open(fa, "w") as f:
            f.write(f">t01\n{seqs['t01'][:n]}\n>t02\n{seqs['t02'][:n]}\n")
        recon.seq_filenames.append(fa)
        recon.load_seqs()
    ds, model = recon.datasets[0], recon.model
    leaves = [node for node in range(ds.tree.n_nodes()) if ds.tree.is_leaf(node)]
    x, y = (Profile.from_sequence(model.components, model.alphabet,
                                  ds.seqs[ds.node_to_seq_index[node]], node) for node in leaves)
    hmm = PairHMM(ProbModel(model, 0.1), ProbModel(model, 0.1), model.ins_prob)
    env = GuideAlignmentEnvelope(ds.guide, ds.closest_leaf[leaves[0]],
                                 ds.closest_leaf[leaves[1]], DEFAULT_MAX_DISTANCE_FROM_GUIDE)
    return x, y, hmm, env


def merge_routes(n: int, reps: int) -> dict:
    """One merge at length n on each route: median fill and walk ms, and
    whether both routes walked the same traces."""
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.utils.rng import MT19937

    class HostForwardMatrix(forward.ForwardMatrix):
        def _fill_device(self) -> bool:
            return False

    x, y, hmm, env = merge_inputs(n)
    out, paths = dict(length=n), {}
    for route, cls in (("device", forward.ForwardMatrix), ("host", HostForwardMatrix)):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd = cls(x, y, hmm, len(x.seqs) + len(y.seqs), env, defer_cells=True)
            fwd.lp_end
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rng = MT19937(5489)
            if route == "device":
                paths[route] = fwd._device_traces(10, True, rng)
            else:
                paths[route] = [fwd.best_trace()] + [fwd.sample_trace(rng) for _ in range(10)]
            torch.cuda.synchronize()
            times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            del fwd
        fill, walk = np.median(times[1:], axis=0)
        out[route] = dict(fill_ms=float(fill), walk_ms=float(walk), ms=float(fill + walk))
    out["same_traces"] = paths["device"] == paths["host"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--merges", type=int, nargs="+", default=[])
    ap.add_argument("--roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_bench: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if opts.roots:
        from historian_tpu_torch.roots import compare_roots

        return compare_roots(__file__, ["--reps", str(opts.reps)], opts.roots, opts.rounds,
                             "walk_bench")
    out = measure(opts.reps)
    if opts.merges:
        out["merges"] = [merge_routes(n, opts.reps) for n in opts.merges]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
