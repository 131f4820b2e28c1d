"""Pair-Forward throughput: the port of bench.py's batched chain x chain
workloads, the path that runs kernels K3 and K4.

    python -m historian_tpu_torch.bench [headline|codon|long|wide] [-platform gpu|cpu]
    python -m historian_tpu_torch.bench --roots DIR [DIR ...] [--rounds R]

Workloads, built as the JAX package's bench.py builds them:

- `headline` (`bench_device`): preset lg, RandomState(42), 8 distinct
  pairs of random 384 x 384 sequences tiled to 128, branch lengths
  0.5/0.5, through K3;
- `codon` (`bench_codon`): preset ECMrest, RandomState(11), 4 pairs of
  random 192 x 192 codon sequences tiled to 32, through K3;
- `long`: 6 pairs of tests/data/long12.fa (t01 x t02, ..., t11 x t12)
  cut to 3000 aa, branch lengths 0.5/0.5, through K4 with X streamed in
  tiles;
- `wide`: as `long`, cut to 5900 aa (5901 lanes: 6 lanes a thread in
  float32, where `long` takes 4).

Prints one JSON line: the workload, the kernel, the dtype, the device it
ran on, the kernel time (CUDA events over 8 launches after a warm one;
with `-platform cpu` the plain version by host clock), state-cells/s
counted as bench.py counts them (B (X+1) (Y+1) 5 a launch over that
time) and the mean lp_end.

`--roots` compares checkouts on one card (each a directory holding a
`historian_tpu_torch` package, e.g. a `git archive` of another commit):
round by round, the roots in turn (reversed every other round: P C C P
for two roots and two rounds), each in a fresh process that imports that
root's package and times `CASES` with this file's code.  One JSON line a
root and round, then a `compare` line of the kernel times by case.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from historian_tpu_torch.ops import pairforward

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")


@dataclass(frozen=True)
class Workload:
    preset: str
    seed: int | None  # None: the pairs come from long12.fa
    n_pairs: int
    batch: int
    x_len: int
    y_len: int
    kernel: str  # "k3" or "k4"


WORKLOADS = {
    "headline": Workload("lg", 42, 8, 128, 384, 384, "k3"),
    "codon": Workload("ECMrest", 11, 4, 32, 192, 192, "k3"),
    "long": Workload("lg", None, 6, 6, 3000, 3000, "k4"),
    "wide": Workload("lg", None, 6, 6, 5900, 5900, "k4"),
}


def _pairs(w: Workload, model) -> list:
    """The workload's distinct (x, y) sequence pairs."""
    if w.seed is None:
        from historian_tpu_torch.core.seqs import read_fasta

        seqs = [s.seq for s in read_fasta(os.path.join(DATA, "long12.fa"))]
        return [(seqs[2 * k][: w.x_len], seqs[2 * k + 1][: w.y_len]) for k in range(w.n_pairs)]
    rng = np.random.RandomState(w.seed)
    n_tok = model.alphabet.size
    syms = [model.alphabet.symbol(i) for i in range(n_tok)]

    def random_seq(n):
        return "".join(syms[i] for i in rng.randint(0, n_tok, size=n))

    return [(random_seq(w.x_len), random_seq(w.y_len)) for _ in range(w.n_pairs)]


def build(name: str, device, dtype=torch.float32) -> tuple:
    """(absorb, rsx, rsy, ix, iy, trans) of a workload on `device`: the
    distinct pairs' arrays stacked, then tiled to the batch."""
    from historian_tpu_torch.models.presets import named_model

    w = WORKLOADS[name]
    model = named_model(w.preset)
    arrays = [pairforward.chain_pair_forward_arrays(model, x, y, 0.5, 0.5, dtype=dtype)[0]
              for x, y in _pairs(w, model)]
    tile = w.batch // w.n_pairs
    out = [torch.stack([a[k] for a in arrays]).repeat(tile, *([1] * arrays[0][k].dim()))
           for k in range(5)]
    return tuple(t.to(device).contiguous() for t in out) + (arrays[0][6].to(device),)


def kernel_of(name: str):
    """The wrapper that runs a workload: K3 or K4."""
    k = WORKLOADS[name].kernel
    return pairforward.pair_forward_lp if k == "k3" else pairforward.pair_forward_lp_tiled


def state_cells(args) -> int:
    b, x1, y1 = args[0].shape
    return b * x1 * y1 * 5


#: what `--roots` times in each root: (workload, dtype)
CASES = (("headline", torch.float32), ("codon", torch.float32), ("long", torch.float32),
         ("wide", torch.float32), ("headline", torch.float64), ("long", torch.float64))


def run(name: str, device, reps: int = 8, dtype=torch.float32) -> dict:
    """One workload through its kernel: times and rate (see the module
    docstring).  On a CUDA device the kernel runs; on the CPU its plain
    version, timed by host clock."""
    args = build(name, device, dtype)
    fn = kernel_of(name)
    lp = fn(*args)  # warm: builds the kernels on first use
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{name}: non-finite lp_end")
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / reps
        where = torch.cuda.get_device_name(args[0].device)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        where = "cpu"
    w = WORKLOADS[name]
    return {
        "workload": f"{name}: {w.preset} batch={w.batch} {w.x_len}x{w.y_len}",
        "kernel": w.kernel, "dtype": str(dtype).replace("torch.", ""), "device": where, "ms": ms,
        "state_cells_per_s": state_cells(args) / (ms / 1e3), "lp_mean": float(lp.mean()),
    }


def run_cases(device) -> dict:
    """Every case of `CASES` on `device`, keyed "<workload>_<dtype>"."""
    out = {}
    for name, dtype in CASES:
        r = run(name, device, dtype=dtype)
        out[f"{name}_{r['dtype']}"] = {k: r[k] for k in ("ms", "state_cells_per_s", "lp_mean")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="historian_tpu_torch.bench")
    ap.add_argument("workload", nargs="?", default="headline", choices=sorted(WORKLOADS))
    ap.add_argument("-platform", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--roots", nargs="+", help="checkouts to time in turn on the card")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", action="store_true", help="time every case of CASES on the card")
    a = ap.parse_args(argv)
    from historian_tpu_torch import device as devmod

    if a.roots:
        from historian_tpu_torch.roots import compare_roots

        devmod.select("gpu")
        return compare_roots(__file__, ["--cases"], a.roots, a.rounds, "bench",
                             keep=lambda rec: {c: r["ms"] for c, r in rec["cases"].items()})
    if a.cases:
        dev = devmod.select("gpu")
        print(json.dumps(dict(device=torch.cuda.get_device_name(dev), cases=run_cases(dev))))
        return 0
    print(json.dumps(run(a.workload, devmod.select(a.platform))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
