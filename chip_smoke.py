"""Smoke run of historian_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  (a) card check: CUDA present; prints the card's name and power limit;
  (b) build: compiles every kernel in historian_tpu_torch/csrc, timed;
  (c) K1, the column fill, against its plain PyTorch version on the card,
      float32 and float64: a DAG y (KY = 4, null states, a diagonal band)
      at SX = SY = 3072, a chain y over the full grid at the shape of
      long12's first merge (t01 x t02, ~6100 x 6100), the main path's,
      and a chain y with a diagonal band at that shape.  Each line gives
      the strips, their width NS and the share of (strip, column) pairs
      that worked; a banded case runs with the mask's lanes (timed, active
      share below 0.5) and with every lane; the full grid takes more than
      one strip;
  (d) the trace walker against its plain version on the planes of (c):
      the best walk and sampled walks, the sampled ones one after another
      over one draw buffer (the DAG y in float64; long12's first merge
      best only in float32 and float64, the `-fast` path's case, 1 + 2 in
      float32 and 1 + 1 in float64), and 1 + 10 in float32 at long12's
      first merge, a default merge's walks, timed, with the last walk
      checked alone from the draw where the nine before it stopped; each
      prints us a step and its bound, counted from the paths walked;
  (e) end to end through the CLI entry: `recon -fast -noband` on small4
      (4 x 300 aa from tests/data/long8.fa) in float64 on the card must
      be byte-identical to the CPU float64 run; then `recon -fast -noband`
      on tests/data/long12 (12 x ~6000 aa, 11 merges) in float32, whose
      kernel launches are counted;
  (f) K2, the fused column fill, against its plain version on the card:
      float32 and float64 on a DAG y (KY = 4) at 3072 x 3072 with a band
      (m1 = i, m2 = j, distance 10, a few lanes near the start of x and
      rows near the end of y), and on a chain y at long12's first-merge
      shape with 20 emission factors; active share below 0.5;
  (g) the guide kernel against its plain version, float32 and float64, on
      8 pairs of long12's sequences cut to 3000 aa with the sparse
      `-kmatchn 3` envelopes: steps, ends, lead cells and scores
      identical; prints each pair's kept diagonals ND and us a column;
  (h) end to end with the guide stage and the built tree: `recon -fast`
      on small6 (tests/data/long6.fa cut to 240-340 aa) in float64 on the
      card, default and fused (HISTORIAN_PALLAS_FUSED=1) routes, each
      byte-identical to the CPU float64 run; then `recon -fast` on
      tests/data/long12.fa with no tree in float32 on the fused route
      (K2 and the guide kernel, no K1) and on the default route (K1, no
      K2), each with its launches counted and its wall;
  (i) the batched pair-Forward kernels K3 and K4: first the port's bench
      path (historian_tpu_torch/bench.py), whose launches are counted:
      bench.py's headline workload (lg, 128 pairs of 384 x 384) and its
      codon workload (ECMrest, 32 pairs of 192 x 192) through K3, and 6
      pairs of long12 cut to 3000 x 3000 through K4; then a line with
      every compiled K3/K4 instance's registers, local (spill) bytes and
      warps a block; then K3 and K4 against their plain version on the
      card at those three shapes (the headline and the long shape in
      float32 and float64, 3001 lanes being more than one lane a thread
      at float64's 16 warps, the codon in float32; K4 always with x_tile
      below X), each with its us a warp step (kernel time over X + 1 + W);
  (j) the default `recon` (sampled profiles): small6 in float64 on the
      card, default and fused routes, each byte-identical to the CPU
      float64 run; then tests/data/long12.fa with no tree and no profile
      flags on the default route in float32, the main path's run, and in
      float64 from the guide and tree that the float32 run saved, each
      with its wall; the two `#=GF LP` within 50 nats (the bound of
      tests/test_f32_drift.py).  Each run
      prints its merges and fills on each route, its launches of K1, K2,
      the walker and the guide kernel, its sampled walks and the mt19937
      draws they took; K1 (K2) launches must equal the fills whose x is a
      chain and the host fills those whose x is a sampled profile (a log
      of every fill's x, kept apart from the routes' counters), and some
      sampled walks must run on the card;
  (k) counts, EM and ancestral prediction on (j)'s long12 float32
      reconstruction (23 rows, more than 6166 columns, so the device fill):
      `count -stockrecon` and `fit -stockrecon -maxiter 2` on the card and
      on the CPU, counts and fitted model within 1e-9; `sum` of the two
      count files; `recon -ancseq -ancprob -stockholm <(j)'s guide>` in
      float32 on the card, whose rows must be (j)'s with the wildcards
      filled and whose ancestral rows and PP lines must equal the CPU
      engine's on that reconstruction; the long12 runs must take the
      device fill and contraction (engine/sumprod.py ROUTES).  Then small6
      `recon -ancseq -ancprob` f64, card == CPU byte for byte; a
      complex-spectrum codon case of 6000 columns (ECMunrest plus a seeded
      cyclic term), the card's complex128 contraction against the numpy
      formulation; and the card times of fill_up, fill_down,
      node_post_prob and the contraction (CUDA events, median of 5 after a
      warm call) beside their bytes bounds, printed as a JSON line;
  (l) the full-band paths (merges whose band the host reads: posterior
      profiles, -savedot, counting while reconstructing): small6 in
      float64, card == CPU byte for byte, `recon -careful -norefine` on the
      default and the fused route, `recon -profminpost 0.01 -savedot F
      -dotpost 0.02` (alignment and dot file) and `count` on unaligned small6,
      each with its merges on each route and readback bytes; then
      tests/data/long6.fa (6 x ~6000 aa) `recon -careful` in float32 (its
      full-band merges and branch fills in float64), the main path's run: the
      guide kernel over every diagonal of all 15 pairs, K1's launches and
      ms, each merge's readback bytes and ms beside its bound (bytes over
      the pinned card-to-host rate measured in the same call), the
      BackwardMatrix and posterior-profile host seconds and the profiles'
      sizes, peak device and host memory; at its first leaf merge the
      posteriors of a float32 fill against the float64 one (the largest of
      each, their largest difference, the cells that cross the 0.001 cut;
      float64's at most 1 + 1e-6); then long6 in float64 from the float32
      run's saved guide and tree with `-norefine`, `#=GF LP` within 50
      nats of the float32 run's LP before refining.  The float32 run's
      refiner prints its refine steps and improvements, LP
      before and after, kernel (e)'s launches (every step's fill) and ms,
      each branch band's readback bytes and ms, and the refiner's seconds
      by phase and on the host; and first the lane strips K1 and K2 hold
      resident at once (colforward_capacity_*, both dtypes).  Prints a
      {"readback": ...} JSON line;
  (m) kernel (e), the branch fill: small6 `recon -careful` in
      float64 on the card, every refine step's fill on the kernel
      (HISTORIAN_DEVICE_BRANCH=1) and on the automatic route (these fills,
      below 2e6 state-cells, on the host), each byte-identical to the CPU
      run; then the kernel against its plain version and against
      csrc/fill.cpp (Viterbi bit for bit) in both modes, at the forced
      small6 run's first fill and at (l)'s first long6 fill (6000-odd
      squared), with ms, the plain version's and fill.cpp's ms and the
      bound.  Prints a {"branchfill": ...} JSON line.
Prints the Felsenstein times, the readbacks and the branch fills as JSON
lines, the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.  A kernel's
`launches` sums the main-path runs that drive it, each counted from 0:
K1 in (e), (h) default, (j) long12 f32 and (l) long6 f32, K2 in (h) fused
and (l) small6 fused, the guide kernel in (h) fused, (j) long12 f32 and
(l) long6 f32, the walker in (e) and (j) long12 f32, kernel (e) in (l)
long6 f32.

Each kernel's `bound_ms` is the least time an H100 SXM could take for
the same work at the shape its `ms` was taken: the larger of the bytes
it must move (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (float32, outside the
tensor cores) or 34 TFLOP/s (float64).  Operations are counted from the
kernel's recurrence: each add, maximum or compare one operation, each
log-sum-exp five (maximum, difference, exp, log1p, add).  No PyTorch
call computes these recurrences, so `library_ms` is null.  K2's band
leaves most cells at NEG, so its operations are counted on the in-band
cells only.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

NEG = -1e30
REPO = os.path.dirname(os.path.abspath(__file__))
#: K1 float32 tolerance: identical liveness at > -1e25, then rtol/atol as
#: tests/test_pallas.py holds the Pallas kernel to the XLA kernel
F32_RTOL, F32_ATOL = 2e-5, 1e-3
#: float64: the kernel and the plain version differ only in summation order
F64_TOL = 1e-9
#: K3/K4 float32 tolerance on lp_end, relative to |lp|: tests/test_pallas.py
#: holds the Pallas kernel to abs 1e-3 at an lp near 1e3.  The kernels and
#: their plain version differ in the association order of the row scans
#: (warp blocks, then warp totals, then tiles, against Hillis-Steele), which
#: moves a float32 lp_end by ~3e-7 relative at the headline shape.
PF_F32_RTOL = 1e-6
#: float32 `#=GF LP` against float64 on one input, in nats: the bound of
#: tests/test_f32_drift.py
F32_LP_DRIFT = 50.0

#: an H100 SXM's peaks: device memory bytes/s, and operations/s outside the
#: tensor cores by dtype (from NVIDIA's H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
#: operations per cell of each recurrence (see the module docstring)
K1_OPS_PER_CELL = 156  # chain y: 61 adds and maxima, 19 log-sum-exps
PF_OPS_PER_CELL = 91  # K3/K4: 26 adds, maxima and compares, 13 log-sum-exps
GUIDE_OPS_PER_CELL = 20  # three-state Viterbi step with its back-pointer choice
#: kernel (e), an in-mask cell: Viterbi 10 adds and 5 maxima; Forward 10
#: adds and 5 log-sum-exps
BRANCH_VITERBI_OPS = 15
BRANCH_FORWARD_OPS = 35
#: kernel (e) against its plain version (and Forward against fill.cpp):
#: relative, on the cells above the semiring zero; the plain version's
#: Delete scan (base - x dd, then + x dd) and the card's exp and log1p
#: round otherwise than the kernel's per-cell order
BRANCH_RTOL = 1e-12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bound(n_bytes: int, ops: float, dtype) -> dict:
    """bound_ms and bound_by of work that moves n_bytes and does `ops`."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def read_fasta(path: str) -> list:
    seqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                seqs.append([line[1:].split()[0], ""])
            elif line:
                seqs[-1][1] += line
    return seqs


def long12_first_merge() -> tuple:
    """(SX, SY) of long12's first merge, t01 x t02: START plus the residues."""
    seqs = dict(read_fasta(os.path.join(REPO, "tests", "data", "long12.fa")))
    return len(seqs["t01"]) + 1, len(seqs["t02"]) + 1


def k1_inputs(SX: int, SY: int, KY: int, banded: bool, seed: int, dtype,
              dev=torch.device("cuda")) -> tuple:
    """K1 arguments on `dev` (the card): y in-edges (first edge j-1, others
    up to 6 columns back, the last KY-2 padded; with KY = 1 a chain y),
    nulls when KY > 1, a diagonal band or the full grid."""
    rng = np.random.default_rng(seed)
    absorb = rng.normal(-5, 1, (SY, SX))
    mask = np.ones((SY, SX), bool)
    if banded:
        mask = np.abs(np.arange(SX)[None, :] - np.arange(SY)[:, None]) < 24
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, 6, (SY, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (SY, KY))
    y_lp[:, 2:] = NEG
    y_null = np.zeros(SY, bool)
    if KY > 1:
        y_null[rng.choice(np.arange(1, SY), SY // 64, replace=False)] = True
    y_ready = np.ones(SY, bool)
    y_ready[0] = False
    flags = np.stack([y_null, y_ready, rng.normal(-2, 1, SY), rng.normal(-2, 1, SY)], 1)
    x_ready = np.ones(SX, bool)
    x_ready[-1] = False
    xvec = np.stack([rng.normal(-2, 1, SX), rng.normal(-2, 1, SX),
                     np.where(x_ready, 0.0, NEG), np.zeros(SX)])

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(flags.astype(float)),
            t(np.where(mask, absorb, NEG)), t(np.where(mask, 0.0, NEG)), t(xvec),
            t(rng.normal(-1, 0.5, 23)))


def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms_median(fn, reps: int = 5) -> float:
    """Median of per-call event times: for a wrapper that reads the card
    between its launches, where one slow host step would skew a mean."""
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


def host_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_planes(what: str, got, ref, dtype) -> float:
    """Identical liveness (> -1e25), then the dtype's tolerance on the live
    cells; returns the largest absolute error."""
    g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
    live = r > -1e25
    if not np.array_equal(g > -1e25, live):
        raise AssertionError(f"{what}: liveness differs")
    rtol, atol = (F32_RTOL, F32_ATOL) if dtype == torch.float32 else (F64_TOL, F64_TOL)
    np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)
    return float(np.abs(g[live] - r[live]).max())


def last_launch(colforward) -> dict:
    """K1's or K2's last launch record with its active share."""
    launch = dict(colforward.LAST_LAUNCH)
    return dict(launch, active_share=colforward.active_share(launch))


def strips_line(launch: dict) -> str:
    return (f"{launch['strips']} strips of {launch['ns']} lanes, "
            f"active share {launch['active_share']:.4f}")


def phase_k1(colforward) -> dict:
    """K1 against its plain version: a banded DAG y at 3072 x 3072, a chain
    y over the full grid at the shape of long12's first merge, and a
    banded chain y at that shape.  A banded case runs with the mask's
    lanes (timed; fewer than half the strips work in a column) and with
    every lane (checked).  The full grid must take more than one strip.
    Returns the largest error, the full-grid long12 float32 times, and the
    planes of the first two cases for the walker (float64, and float32 at
    long12's shape)."""
    SX, SY = long12_first_merge()
    err, times, walk_planes = 0.0, {}, {}
    for name, sx, sy, KY, banded in (("dag", 3072, 3072, 4, True),
                                     ("long12", SX, SY, 1, False),
                                     ("long12 band", SX, SY, 1, True)):
        for dtype in (torch.float32, torch.float64):
            args = k1_inputs(sx, sy, KY, banded, 17, dtype)
            lanes = colforward.lanes_from_mask(args[4] == 0) if banded else None
            ref, p_ms = host_ms(lambda: colforward.col_forward_planes_plain(*args))
            for use in ((lanes, None) if banded else (None,)):
                got = colforward.col_forward_planes(*args, lanes=use)
                launch = last_launch(colforward)
                k_ms = cuda_ms(lambda: colforward.col_forward_planes(*args, lanes=use))
                e = check_planes(f"K1 {name} {dtype}", got, ref, dtype)
                err = max(err, e)
                print(f"(c) K1 {name} SX={sx} SY={sy} KY={KY} {str(dtype)[6:]}"
                      f"{' lanes' if use is not None else ''}: kernel {k_ms:.3f} ms, "
                      f"plain {p_ms:.1f} ms, max abs err {e:.3e}, {strips_line(launch)}",
                      flush=True)
                if launch["strips"] < 2 or (use is not None and launch["active_share"] >= 0.5):
                    raise AssertionError(f"K1 {name} {dtype}: {launch}")
                if use is lanes:
                    times[(name, dtype)] = (k_ms, p_ms)
                    if (name, dtype) in (("dag", torch.float64), ("long12", torch.float64),
                                         ("long12", torch.float32)):
                        walk_planes[(name, dtype)] = (got, args)
                    if (name, dtype) == ("long12", torch.float32):
                        bnd = bound(nbytes(*args, got), K1_OPS_PER_CELL * sx * sy, dtype)
    k_ms, p_ms = times[("long12", torch.float32)]
    return dict(err=err, ms=k_ms, plain_ms=p_ms, walk_planes=walk_planes, times=times, **bnd)


def walk_bound(walk, got) -> dict:
    """bound_ms of the walks in `got`, counted from the paths walked: the
    first step reads the end cells' 5 KE values and the end edges; a step
    out of IMM, IDM or IMI reads the 5 KY values of its y-move candidates
    (KY at a null row, where one state a source is live) and the row's
    edges (source and lp), one out of IMD or IIW the 5 values of its x-move;
    a sampled walk reads one uniform a step, the best walk none.  Every
    output ([T, L] path entries i, j, s, value and n_steps) is written
    once.  Operations per live candidate: two adds and a compare (best),
    two adds, an exp, the ptot add, the subtraction and its compare
    (sampled)."""
    from historian_tpu_torch.ops.tracedp import IDM, IMI, IMM

    planes, y_src, y_null, ye_src = walk[0], walk[1], walk[3], walk[8]
    include_best = walk[11]
    KY, KE, item = y_src.shape[1], ye_src.shape[0], planes.element_size()
    pj, ps = got[1].cpu().numpy(), got[2].cpu().numpy()
    null = y_null.cpu().numpy()
    n_bytes, ops = 0, 0
    for t, n in enumerate(got[4].tolist()):
        s, j = ps[t, :n - 1], pj[t, :n - 1]  # the cells that steps 2..n leave
        ymove = np.isin(s, (IMM, IDM, IMI))
        values = 5 * KE + int(np.where(ymove, np.where(null[j], KY, 5 * KY), 5).sum())
        sampled = not (include_best and t == 0)
        n_bytes += (values * item + (KE + int(ymove.sum()) * KY) * (4 + item)
                    + (n * item if sampled else 0))
        ops += values * (6 if sampled else 3)
    T, L = ps.shape
    return bound(n_bytes + T * L * (12 + item) + T * 4, ops, planes.dtype)


def phase_walker(tracedp, name: str, planes, args, n_samples: int, check: bool = True) -> dict:
    """The walker against its plain version on planes of (c): the best walk
    and n_samples sampled walks, one after another over one draw buffer;
    paths must be identical (check False: the kernel is timed, and only
    its last sampled walk is checked, walked alone by the plain version
    from the draw where the walks before it stopped).  Prints the kernel's
    us a step (of the best walk or of the sampled walks together,
    whichever is longer: the two run side by side)."""
    y_src, y_lp = args[0].cpu().numpy(), args[1].cpu().numpy()
    pad = y_lp <= NEG / 2
    order = np.argsort(np.where(pad, np.iinfo(np.int32).max, y_src), axis=1, kind="stable")
    rows = np.arange(y_src.shape[0])[:, None]
    _, SY, SX = planes.shape
    rng = np.random.default_rng(5)
    dev, dt = planes.device, planes.dtype
    tx = rng.normal(-0.1, 0.05, SX)
    tx[0] = 0.0
    L = SX + SY
    walk = (
        planes,
        torch.as_tensor(y_src[rows, order], device=dev),
        torch.as_tensor(y_lp[rows, order], dtype=dt, device=dev),
        (args[2][:, 0] > 0.5).contiguous(),
        torch.as_tensor(tx, dtype=dt, device=dev),
        torch.as_tensor(rng.normal(-1, 0.5, (6, 6)), dtype=dt, device=dev),
        SX - 1, -0.3,
        torch.tensor([SY - 3, SY - 1], dtype=torch.int32, device=dev),
        torch.tensor([-1.5, -0.2], dtype=dt, device=dev),
        torch.as_tensor(rng.random(max(n_samples, 1) * L), dtype=dt, device=dev),
        True, n_samples, L,
    )
    got = tracedp.pair_trace(*walk)
    k_ms = cuda_ms(lambda: tracedp.pair_trace(*walk))
    n_steps = got[4].tolist()
    if check:
        ref, p_ms = host_ms(lambda: tracedp.pair_trace_plain(*walk))
        for a, b, what in zip(got, ref, ("pi", "pj", "ps", "vals", "n_steps")):
            if not torch.equal(a, b):
                raise AssertionError(f"walker {name} {what} differs from the plain walker")
        lp_err = abs(float(got[5]) - float(ref[5]))
        checked = f"plain {p_ms:.1f} ms, paths identical, lp_end err {lp_err:.3e}"
    else:
        off = sum(n_steps[1:-1])
        ref = tracedp.pair_trace_plain(*walk[:10], walk[10][off:], False, 1, L)
        for a, b, what in zip(got, ref, ("pi", "pj", "ps", "vals", "n_steps")):
            if not torch.equal(a[-1:], b):
                raise AssertionError(f"walker {name}: the last walk's {what} differs from the "
                                     f"plain walker's from draw {off}")
        lp_err, p_ms = abs(float(got[5]) - float(ref[5])), float("nan")
        checked = f"timed; the last walk, from draw {off}, identical to the plain walker's"
    bnd = walk_bound(walk, got)
    if not lp_err <= F64_TOL:
        raise AssertionError(f"walker {name} lp_end differs by {lp_err}")
    us_step = k_ms * 1e3 / max(n_steps[0], sum(n_steps[1:]))
    print(f"(d) walker {name} SX={SX} SY={SY} {str(dt)[6:]}, 1 best + {n_samples} sampled, "
          f"steps {n_steps}: kernel {k_ms:.3f} ms ({us_step:.3f} us a step), {checked}, "
          f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']})", flush=True)
    return dict(err=lp_err, ms=k_ms, plain_ms=p_ms, **bnd)


def run_cli(cli, args: list, dtype: str, command: str = "recon") -> str:
    os.environ["HISTORIAN_DEVICE_DTYPE"] = dtype
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([command, *args])
    if rc != 0:
        raise AssertionError(f"{command} {args} returned {rc}")
    return buf.getvalue()


def write_small4(d: str) -> tuple:
    """small4: the first 4 sequences of tests/data/long8.fa cut to 300 aa."""
    seqs = read_fasta(os.path.join(REPO, "tests", "data", "long8.fa"))
    fa, nh = os.path.join(d, "small4.fa"), os.path.join(d, "small4.nh")
    with open(fa, "w") as f:
        for k, (_, s) in enumerate(seqs[:4]):
            f.write(f">t{k + 1}\n{s[:300]}\n")
    with open(nh, "w") as f:
        f.write("((t1:0.12,t2:0.12):0.1,(t3:0.12,t4:0.12):0.1)root;\n")
    return fa, nh


def stockholm_rows_lp(text: str) -> tuple:
    rows = [ln for ln in text.splitlines() if ln and not ln.startswith("#") and ln != "//"]
    lp = [float(ln.split()[2]) for ln in text.splitlines() if ln.startswith("#=GF LP")]
    return rows, lp[0]


def phase_e2e(cli, colforward, tracedp) -> dict:
    with tempfile.TemporaryDirectory() as d:
        fa, nh = write_small4(d)
        small = ["-fast", "-noband", "-tree", nh, fa]
        gpu = run_cli(cli, ["-platform", "gpu", *small], "f64")
        cpu = run_cli(cli, ["-platform", "cpu", *small], "f64")
    if gpu != cpu:
        raise AssertionError("small4 f64: card output differs from the CPU output")
    none_oversized("(e) small4")
    rows, lp = stockholm_rows_lp(gpu)
    print(f"(e) small4 f64 card == cpu, {len(rows)} rows, LP {lp}", flush=True)

    data = os.path.join(REPO, "tests", "data")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    colforward.LAUNCHES = tracedp.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_cli(cli, ["-platform", "gpu", "-fast", "-noband", "-tree",
                        os.path.join(data, "long12.nh"), os.path.join(data, "long12.fa")], "f32")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(colforward=colforward.LAUNCHES, pairtrace=tracedp.LAUNCHES)
    rows, lp = stockholm_rows_lp(out)
    if len(rows) != 23 or not math.isfinite(lp):
        raise AssertionError(f"long12: {len(rows)} rows, LP {lp}")
    if launches["colforward"] != 11 or launches["pairtrace"] < 11:
        raise AssertionError(f"long12 launches {launches}")
    none_oversized("(e) long12")
    print(f"(e) long12 -fast -noband f32: {len(rows)} rows, LP {lp}, wall {wall:.2f} s, "
          f"launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches


def k2_inputs(SX: int, SY: int, KY: int, seed: int, dtype, CA: int = 20,
              dev=torch.device("cuda")) -> tuple:
    """K2 arguments on `dev` (the card): y in-edges and nulls drawn as
    k1_inputs draws them, CA positive emission factors, and the band
    |m2 - m1| <= 10 with m1 = i, m2 = j, widened by the first 3 x lanes
    (near the start) and the last 3 y rows (near the end)."""
    rng = np.random.default_rng(seed)
    y_src = np.clip(np.arange(SY)[:, None] - 1 - rng.integers(0, 6, (SY, KY)), 0, None)
    y_src[:, 0] = np.maximum(np.arange(SY) - 1, 0)
    y_lp = rng.normal(-1, 0.5, (SY, KY))
    y_lp[:, 2:] = NEG
    y_flags = np.zeros((SY, 8))
    if KY > 1:
        y_flags[rng.choice(np.arange(1, SY), SY // 64, replace=False), 0] = 1.0
    y_flags[1:, 1] = 1.0
    y_flags[:, 2] = rng.normal(-2, 1, SY)
    y_flags[:, 3] = rng.normal(-2, 1, SY)
    y_flags[:, 4] = np.arange(SY)
    y_flags[SY - 3:, 5] = 1.0
    y_flags[:, 6] = rng.normal(-1, 0.5, SY)
    xvec = np.zeros((8, SX))
    xvec[0] = rng.normal(-2, 1, SX)
    xvec[1] = rng.normal(-2, 1, SX)
    xvec[2, -1] = NEG
    xvec[4] = rng.normal(-1, 0.5, SX)
    xvec[5] = np.arange(SX)
    xvec[6, :3] = 1.0
    xvec[7] = 1.0
    params = np.zeros(32)
    params[:23] = rng.normal(-1, 0.5, 23)
    params[23], params[24] = 10, SY

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(y_flags), t(rng.uniform(0.05, 1, (SY, CA))),
            t(rng.uniform(0.05, 1, (CA, SX))), t(xvec), t(params))


def phase_k2(colforward) -> dict:
    """K2 against its plain version (the emission and band planes built in
    torch, then K1's plain version): a banded DAG y at 3072 x 3072 and a
    banded chain y at long12's first-merge shape, the main path's, in
    float32 and float64; fewer than half the strips may work in a column.
    Returns the largest error and the long12-shape times; the bound counts
    the recurrence on the in-band cells only (the others are NEG)."""
    SX, SY = long12_first_merge()
    err, times = 0.0, {}
    for name, sx, sy, KY in (("dag", 3072, 3072, 4), ("long12", SX, SY, 1)):
        for dtype in (torch.float32, torch.float64):
            args = k2_inputs(sx, sy, KY, 23, dtype)
            got = colforward.col_forward_planes_fused(*args)
            launch = last_launch(colforward)
            ref, p_ms = host_ms(lambda: colforward.col_forward_planes_fused_plain(*args))
            k_ms = cuda_ms(lambda: colforward.col_forward_planes_fused(*args))
            band = int(colforward.fused_band_mask(*args[2:3], *args[5:]).sum())
            if band in (0, sx * sy):
                raise AssertionError(f"K2 {name} {dtype}: the band gates no cell or every cell")
            e = check_planes(f"K2 {name} {dtype}", got, ref, dtype)
            err = max(err, e)
            print(f"(f) K2 {name} SX={sx} SY={sy} KY={KY} CA=20 {str(dtype)[6:]}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, max abs err {e:.3e}, "
                  f"{band / (sx * sy):.4f} of cells in the band, {strips_line(launch)}",
                  flush=True)
            if launch["strips"] < 2 or launch["active_share"] >= 0.5:
                raise AssertionError(f"K2 {name} {dtype}: {launch}")
            times[(name, dtype)] = (k_ms, p_ms)
            if (name, dtype) == ("long12", torch.float32):
                ca = args[3].shape[1]  # the emission as 2 CA operations, log, two shifts, band test
                bnd = bound(nbytes(*args, got), (K1_OPS_PER_CELL + 2 * ca + 6) * band, dtype)
    k_ms, p_ms = times[("long12", torch.float32)]
    return dict(err=err, ms=k_ms, plain_ms=p_ms, times=times, **bnd)


GUIDE_ORDER = ("x_tok", "y_tok", "lut", "x_len", "y_len", "submat", "trans", "sg",
               "end_x", "end_y")
GUIDE_PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (0, 6), (3, 9))


def guide_inputs(dtype) -> tuple:
    """The guide kernel's arguments on the card for GUIDE_PAIRS of long12
    cut to 3000 aa, preset lg at time 1, the `-fast` envelopes
    (`-kmatchn 3`), built by the port's QuickAligner; and the share of
    diagonals the envelopes keep."""
    from historian_tpu_torch.engine.quickalign import pair_guide_tensors

    seqs = [s[:3000] for _, s in read_fasta(os.path.join(REPO, "tests", "data", "long12.fa"))]
    t = pair_guide_tensors([(seqs[a], seqs[b]) for a, b in GUIDE_PAIRS], "lg", 3, 1.0,
                           torch.device("cuda"), dtype)
    kept = (t["lut"].sum(1) / (t["x_len"] + t["y_len"] - 1)).tolist()
    return [t[k] for k in GUIDE_ORDER], kept


def phase_guide(guidedp) -> dict:
    """The guide kernel against its plain version (the torch fill on the
    card plus the host walk): every output identical."""
    err, times = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        args, kept = guide_inputs(dtype)
        if max(kept) >= 1.0:
            raise AssertionError(f"guide envelopes are not sparse: {kept}")
        got = guidedp.guide_align(*args)
        ref, p_ms = host_ms(lambda: guidedp.guide_align_plain(*args))
        # the wrapper reads each pair's kept diagonals to the host before it
        # launches, so its calls are timed one by one
        k_ms = cuda_ms_median(lambda: guidedp.guide_align(*args))
        for what, a, b in zip(("steps", "n_steps", "x_end", "y_end", "lead_i", "lead_j", "score"),
                              got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"guide kernel {str(dtype)[6:]}: {what} differs from "
                                     "the plain version")
        err = max(err, float((got[6] - ref[6]).abs().max()))
        nd = guidedp.diagonal_ranks(args[2], args[3], args[4], args[1].shape[1])["nd"]
        us_col = k_ms * 1e3 / int(args[4].max())  # the pairs run side by side
        print(f"(g) guide kernel {len(GUIDE_PAIRS)} pairs of 3000 aa {str(dtype)[6:]}, "
              f"envelopes keep {min(kept):.3f}-{max(kept):.3f} of the diagonals (ND "
              f"{nd.tolist()}), steps {got[1].tolist()}: kernel {k_ms:.3f} ms "
              f"({us_col:.3f} us a column), plain {p_ms:.1f} ms, outputs identical", flush=True)
        times[dtype] = (k_ms, p_ms)
        if dtype == torch.float32:
            bnd = bound(nbytes(*args, *got), GUIDE_OPS_PER_CELL * envelope_cells(args), dtype)
    k_ms, p_ms = times[torch.float32]
    return dict(err=err, ms=k_ms, plain_ms=p_ms, **bnd)


def envelope_cells(args) -> int:
    """Cells (i, j), 1 <= i <= X, 1 <= j <= Y, on the envelopes' diagonals."""
    lut, x_len, y_len = args[2].cpu().numpy(), args[3].cpu().numpy(), args[4].cpu().numpy()
    py = args[1].shape[1]
    n = 0
    for b in range(lut.shape[0]):
        d = np.nonzero(lut[b])[0] - py  # d = i - j
        X, Y = int(x_len[b]), int(y_len[b])
        n += int(np.clip(np.minimum(X, Y + d) - np.maximum(1, 1 + d) + 1, 0, None).sum())
    return n


def write_small6(d: str) -> str:
    """small6: the 6 sequences of tests/data/long6.fa cut to 240-340 aa."""
    seqs = read_fasta(os.path.join(REPO, "tests", "data", "long6.fa"))
    fa = os.path.join(d, "small6.fa")
    with open(fa, "w") as f:
        for (name, s), n in zip(seqs, (240, 260, 280, 300, 320, 340)):
            f.write(f">{name}\n{s[:n]}\n")
    return fa


def phase_guide_e2e(cli, colforward, tracedp, guidedp) -> dict:
    with tempfile.TemporaryDirectory() as d:
        small = ["-fast", write_small6(d)]
        os.environ["HISTORIAN_PALLAS_FUSED"] = "0"
        cpu = run_cli(cli, ["-platform", "cpu", *small], "f64")
        for fused in ("0", "1"):
            os.environ["HISTORIAN_PALLAS_FUSED"] = fused
            colforward.LAUNCHES = colforward.FUSED_LAUNCHES = guidedp.LAUNCHES = 0
            gpu = run_cli(cli, ["-platform", "gpu", *small], "f64")
            if gpu != cpu:
                raise AssertionError(f"small6 f64 fused={fused}: card output differs from "
                                     "the CPU output")
            none_oversized(f"(h) small6 fused={fused}")
            counts = (colforward.LAUNCHES, colforward.FUSED_LAUNCHES, guidedp.LAUNCHES)
            rows, lp = stockholm_rows_lp(gpu)
            print(f"(h) small6 -fast (no tree) f64 fused={fused}: card == cpu, {len(rows)} rows, "
                  f"LP {lp}, launches K1/K2/guide {counts}", flush=True)
            if len(rows) != 11 or counts[2] < 1 or counts[int(fused)] < 5 \
                    or counts[1 - int(fused)] != 0:
                raise AssertionError(f"small6 fused={fused}: {len(rows)} rows, launches {counts}")

    walls, counts = {}, {}
    for fused in ("1", "0"):
        route = "fused" if fused == "1" else "default"
        os.environ["HISTORIAN_PALLAS_FUSED"] = fused
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        colforward.LAUNCHES = colforward.FUSED_LAUNCHES = tracedp.LAUNCHES = guidedp.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run_cli(cli, ["-platform", "gpu", "-fast",
                            os.path.join(REPO, "tests", "data", "long12.fa")], "f32")
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        launches = dict(colforward=colforward.LAUNCHES,
                        colforward_fused=colforward.FUSED_LAUNCHES,
                        pairtrace=tracedp.LAUNCHES, guidealign=guidedp.LAUNCHES)
        rows, lp = stockholm_rows_lp(out)
        if len(rows) != 23 or not math.isfinite(lp) or "#=GF NH" not in out:
            raise AssertionError(f"long12 {route}: {len(rows)} rows, LP {lp}")
        none_oversized(f"(h) long12 {route}")
        fill, other = (("colforward_fused", "colforward") if fused == "1"
                       else ("colforward", "colforward_fused"))
        if (launches[other] != 0 or launches[fill] < 11
                or launches["guidealign"] < 1 or launches["pairtrace"] < 11):
            raise AssertionError(f"long12 {route} launches {launches}")
        print(f"(h) long12 -fast (no tree, {route} route) f32: {len(rows)} rows, LP {lp}, "
              f"wall {walls[route]:.2f} s, launches {launches}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        counts[route] = launches
    del os.environ["HISTORIAN_PALLAS_FUSED"]
    print(f"(h) long12 -fast f32 wall: fused route (K2) {walls['fused']:.2f} s, default route "
          f"(K1) {walls['default']:.2f} s", flush=True)
    return counts


PF_CASES = (("headline", torch.float32), ("headline", torch.float64),
            ("codon", torch.float32), ("long", torch.float32), ("long", torch.float64))


def pf_instances_line(pairforward) -> str:
    """Registers, local (spill) bytes a thread and warps a block of every
    compiled K3/K4 instance, each at the widest row it takes, as the
    launcher reports them for every width of whole warps."""
    parts = []
    for dtype in (torch.float32, torch.float64):
        for kid, tiled in (("K3", False), ("K4", True)):
            widest = {}
            for y1 in range(32, pairforward.MAX_LANES[dtype] + 1, 32):
                at = pairforward.kernel_attrs(y1, dtype, tiled)
                widest[at["lanes_per_thread"]] = at
            parts += [f"{kid} {str(dtype)[6:]} m={m}: {at['registers']} regs, "
                      f"{at['local_bytes']} B local, {at['warps']} warps"
                      for m, at in sorted(widest.items())]
    return "(i) instances: " + "; ".join(parts)


def phase_pairforward(pairforward, bench, dev) -> dict:
    """K3 and K4: the port's bench path with its launches counted, then
    each kernel against the plain version at the three shapes.  Returns
    the launches, the largest lp_end errors, and the times and bounds
    of K3 at the headline shape and K4 at the long shape, in float32."""
    pairforward.LAUNCHES = pairforward.TILED_LAUNCHES = 0
    for name in ("headline", "codon", "long"):
        r = bench.run(name, dev, reps=5)
        print(f"(i) bench {r['workload']} via {r['kernel']}: {r['ms']:.3f} ms, "
              f"{r['state_cells_per_s']:.4g} state-cells/s, mean lp {r['lp_mean']:.4f}", flush=True)
    launches = dict(pairforward_lp=pairforward.LAUNCHES,
                    pairforward_lp_tiled=pairforward.TILED_LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f"pair-Forward bench launches {launches}")

    print(pf_instances_line(pairforward), flush=True)
    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    out = dict(launches=launches, err={"K3": 0.0, "K4": 0.0})
    for name, dtype in PF_CASES:
        args = bench.build(name, dev, dtype)
        B, X1, Y1 = args[0].shape
        ref, p_ms = host_ms(lambda: pairforward.pair_forward_lp_plain(*args))
        ref = ref.double()
        rows = pairforward.k4_rows(Y1, args[0].element_size(), 512, smem)
        if rows >= X1 - 1:
            raise AssertionError(f"K4 {name}: one tile of {rows} rows covers X")
        tol = PF_F32_RTOL if dtype == torch.float32 else F64_TOL
        for kname, fn in (("K3", lambda: pairforward.pair_forward_lp(*args)),
                          ("K4", lambda: pairforward.pair_forward_lp_tiled(*args, x_tile=512))):
            got = fn().double()
            rel = float(((got - ref).abs() / ref.abs()).max())
            if not (torch.isfinite(ref).all() and rel <= tol):
                raise AssertionError(f"{kname} {name} {dtype}: lp_end rel err {rel:.3e} > {tol}")
            k_ms = cuda_ms(fn, reps=5)
            rate = bench.state_cells(args) / (k_ms / 1e3)
            at = pairforward.kernel_attrs(Y1, dtype, kname == "K4")
            m, warps = at["lanes_per_thread"], at["warps"]
            print(f"(i) {kname} {name} B={B} X={X1 - 1} Y={Y1 - 1} {str(dtype)[6:]}"
                  f"{f' x_tile {rows}' if kname == 'K4' else ''}: kernel {k_ms:.3f} ms "
                  f"({k_ms * 1e3 / (X1 + warps):.3f} us a warp step, {warps} warps of {m} "
                  f"lanes a thread), plain {p_ms:.1f} ms, max lp err "
                  f"{float((got - ref).abs().max()):.3e} ({rel:.3e} of |lp|), "
                  f"{rate:.4g} state-cells/s", flush=True)
            out["err"][kname] = max(out["err"][kname], float((got - ref).abs().max()))
            if dtype == torch.float32 and (kname, name) in (("K3", "headline"), ("K4", "long")):
                ops = PF_OPS_PER_CELL * B * X1 * Y1
                out[kname] = dict(ms=k_ms, plain_ms=p_ms, **bound(nbytes(*args) + B * 4, ops, dtype))
    return out


@contextlib.contextmanager
def fill_log(forward):
    """Records, fill by fill, whether the merge's x is a chain: the fills
    each route must have taken, counted apart from the routes' own
    counters."""
    log = []
    fill = forward.ForwardMatrix._fill

    def logged(self):
        log.append(not (self.x_empty or self.y_empty) and self.x.as_chain() is not None)
        return fill(self)

    forward.ForwardMatrix._fill = logged
    try:
        yield log
    finally:
        forward.ForwardMatrix._fill = fill


def none_oversized(what: str) -> None:
    """No merge of the runs so far left the card for the host because it
    did not fit (recon.MERGES and forward.FILLS "oversized")."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward

    if recon.MERGES["oversized"] or forward.FILLS["oversized"]:
        raise AssertionError(f"{what}: a merge did not fit the card and filled on the host: "
                             f"merges {recon.MERGES}, fills {forward.FILLS}")


def recon_counts(recon, forward, colforward, tracedp, guidedp) -> dict:
    """The launch and route counters since `zero_counts`; fails if a merge
    took the oversized route."""
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp

    none_oversized("recon")
    return dict(colforward=colforward.LAUNCHES, colforward_fused=colforward.FUSED_LAUNCHES,
                pairtrace=tracedp.LAUNCHES, guidealign=guidedp.LAUNCHES,
                branchfill=branchdp.LAUNCHES, merges=dict(recon.MERGES),
                fills=dict(forward.FILLS), sampled=dict(forward.SAMPLED),
                branch_fills=dict(branchmatrix.FILLS))


def zero_counts(recon, forward, colforward, tracedp, guidedp) -> None:
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp

    colforward.LAUNCHES = colforward.FUSED_LAUNCHES = tracedp.LAUNCHES = guidedp.LAUNCHES = 0
    branchdp.LAUNCHES = 0
    for d in (recon.MERGES, forward.FILLS, forward.SAMPLED, branchmatrix.FILLS):
        for k in d:
            d[k] = 0


def check_routes(what: str, counts: dict, log: list, fused: bool) -> None:
    """K1 (or K2) launches are the chain-x fills, the host fills the fills
    of a sampled x, and sampled walks were made."""
    chain, dag = sum(log), len(log) - sum(log)
    fill, other = (("colforward_fused", "colforward") if fused
                   else ("colforward", "colforward_fused"))
    if (counts[fill] != chain or counts[other] != 0 or counts["fills"]["device"] != chain
            or counts["fills"]["host"] != dag or dag < 1
            or counts["sampled"]["device_walks"] < 1 or counts["pairtrace"] < 1):
        raise AssertionError(f"{what}: {chain} chain-x and {dag} sampled-x fills, counts {counts}")


def phase_default_recon(cli, colforward, tracedp, guidedp, work: str) -> dict:
    """(j) The default `recon` (sampled profiles, no -fast): small6 card f64
    == CPU f64 on the default and the fused route; then long12 with no tree
    and no profile flags on the card, default route (K1), in float32 and in
    float64 from the float32 run's guide and tree, whose `#=GF LP` must
    agree within F32_LP_DRIFT.  Each run's K1
    (K2) launches must equal its chain-x fills and its host fills the
    fills whose x is a sampled profile.  The float32 run's reconstruction
    and its guide stay in `work` (work/long12_f32.sto, work/long12_guide.sto)
    for phase (k).  Returns the float32 run's counts."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward

    counters = (recon, forward, colforward, tracedp, guidedp)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        small = [write_small6(d)]
        os.environ["HISTORIAN_PALLAS_FUSED"] = "0"
        cpu = run_cli(cli, ["-platform", "cpu", *small], "f64")
        for fused in ("0", "1"):
            os.environ["HISTORIAN_PALLAS_FUSED"] = fused
            zero_counts(*counters)
            with fill_log(forward) as log:
                gpu = run_cli(cli, ["-platform", "gpu", *small], "f64")
            counts = recon_counts(*counters)
            if gpu != cpu:
                raise AssertionError(f"small6 default f64 fused={fused}: card output differs "
                                     "from the CPU output")
            check_routes(f"small6 fused={fused}", counts, log, fused == "1")
            rows, lp = stockholm_rows_lp(gpu)
            print(f"(j) small6 default recon f64 fused={fused}: card == cpu, {len(rows)} rows, "
                  f"LP {lp}, {counts}", flush=True)
        os.environ["HISTORIAN_PALLAS_FUSED"] = "0"
        # the float64 run takes the float32 run's guide and tree, so that the
        # two differ in their merges only
        guide = os.path.join(work, "long12_guide.sto")
        inputs = {"f32": ["-saveguide", guide, os.path.join(REPO, "tests", "data", "long12.fa")],
                  "f64": ["-stockholm", guide]}
        source = {"f32": "its guide stage and tree", "f64": "the f32 run's guide and tree"}
        for dtype in ("f32", "f64"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(*counters)
            t0 = time.perf_counter()
            with fill_log(forward) as log:
                out = run_cli(cli, ["-platform", "gpu", *inputs[dtype]], dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = recon_counts(*counters)
            rows, lp = stockholm_rows_lp(out)
            if len(rows) != 23 or not math.isfinite(lp) or "#=GF NH" not in out:
                raise AssertionError(f"long12 default {dtype}: {len(rows)} rows, LP {lp}")
            check_routes(f"long12 default {dtype}", counts, log, False)
            print(f"(j) long12 default recon (no profile flags; {source[dtype]}) "
                  f"{dtype}: {len(rows)} rows, LP {lp}, wall {wall:.2f} s, merges "
                  f"{counts['merges']}, fills {counts['fills']}, launches K1 "
                  f"{counts['colforward']} K2 {counts['colforward_fused']} walker "
                  f"{counts['pairtrace']} guide {counts['guidealign']}, sampled walks and "
                  f"draws {counts['sampled']}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
            runs[dtype] = (lp, counts)
            if dtype == "f32":
                with open(os.path.join(work, "long12_f32.sto"), "w") as f:
                    f.write(out)
    del os.environ["HISTORIAN_PALLAS_FUSED"]
    drift = abs(runs["f32"][0] - runs["f64"][0])
    if not drift < F32_LP_DRIFT:
        raise AssertionError(f"long12 default: f32 LP is {drift} nats off f64")
    print(f"(j) long12 default f32 LP - f64 LP: {drift:.6f} nats (limit {F32_LP_DRIFT})",
          flush=True)
    return runs["f32"][1]


#: the card's counts and fitted model against the CPU's (phase (k)): both in
#: float64, the products in another order
COUNT_RTOL = 1e-9


@contextlib.contextmanager
def reconstructors(recon_mod):
    """Records each Reconstructor a CLI run builds, so that its counts,
    model and datasets can be read after the run."""
    seen = []
    init = recon_mod.Reconstructor.__init__

    def recorded(self):
        init(self)
        seen.append(self)

    recon_mod.Reconstructor.__init__ = recorded
    try:
        yield seen
    finally:
        recon_mod.Reconstructor.__init__ = init


def complex_codon_model(seed: int):
    """ECMunrest with a cyclic term added to its rates (codon i -> i + 1 mod
    A at a seeded rate): a non-reversible codon model whose spectrum is
    complex.  Every preset's spectrum is real under numpy's eig, ECMunrest's
    included."""
    from historian_tpu_torch.models.presets import named_model

    model = named_model("ECMunrest")
    rng = np.random.default_rng(seed)
    rate = model.sub_rate.copy()
    idx = np.arange(rate.shape[1])
    rate[0, idx, (idx + 1) % rate.shape[1]] += 2.0 + rng.random(rate.shape[1])
    np.fill_diagonal(rate[0], 0.0)
    np.fill_diagonal(rate[0], -rate[0].sum(axis=1))
    model.sub_rate = rate
    return model


def synthetic_rows(model, tree, L: int, seed: int) -> list:
    """Rows of a reconstruction with one root a column, made from `seed`:
    the column's root is the tree's root (60 %) or another node, a node
    under an ungapped parent is gapped at 15 % and everything under a gap
    is gapped; leaves take random symbols, internal nodes `*`."""
    rng = np.random.default_rng(seed)
    n = tree.n_nodes()
    syms = np.array([model.alphabet.symbol(i) for i in range(model.alphabet.size)])
    top = np.where(rng.random(L) < 0.6, tree.root(), rng.integers(0, n - 1, L))
    open_ = np.zeros((n, L), bool)
    for node in reversed(range(n)):  # preorder
        p = tree.parent(node)
        under = open_[p] & (rng.random(L) >= 0.15) if p >= 0 else np.zeros(L, bool)
        open_[node] = (top == node) | under
    rows = []
    for node in range(n):
        fill = syms[rng.integers(0, len(syms), L)] if tree.is_leaf(node) else np.full(L, "*")
        rows.append("".join(np.where(open_[node], fill, "-")))
    return rows


def felsenstein_bound(L: int, N: int, C: int, A: int, what: str, cplx: bool = False) -> dict:
    """bound_ms of one Felsenstein function on [L, N, C, A] float64 messages:
    the tensors it reads and writes, once each, over the memory rate, or
    its multiply-adds over the float64 peak (complex128: four real
    products each).  root_counts reads the roots' [C, A] rows only."""
    big, small = 8 * L * N * C * A, 8 * L * N * C
    io = {"fill_up": 2 * big + 2 * small + 4 * N * L,  # tokens in; F, E, logF, logE out
          "fill_down": 2 * big + 2 * small + L * N,  # E, logE, gaps in; G, logG out
          "node_post_prob": 2 * big + 2 * small + 8 * L * N * A,  # F, G, logs in; [L, N, A] out
          "eigen_counts": 3 * big + 3 * small + L * N,  # F, E, G, logs, mask in
          "root_counts": 8 * L * (C * A + C + 2)}[what]  # each column's root row in
    flops = {"fill_up": 2 * L * N * C * A * A, "fill_down": 2 * L * N * C * A * A,
             "node_post_prob": 8 * L * N * C * A, "eigen_counts": 6 * L * N * C * A * A,
             "root_counts": 4 * L * C * A}[what] * (4 if cplx else 1)
    return bound(io, flops, torch.float64)


def felsenstein_calls(engine, rows: list) -> dict:
    """The Felsenstein functions of ops/felsenstein.py as zero-argument
    calls on `rows`, their inputs made once on the engine's device."""
    from historian_tpu_torch.ops import felsenstein as fs

    dev = engine.device
    tokens = fs.tokenize_alignment(engine.model.alphabet, rows)
    arrays = engine.arrays
    sub, ins, lw = engine.tensors()
    L = tokens.shape[1]
    F, logF, E, logE, cpt_ll, col_ll = fs.fill_up(tokens, arrays, sub, ins, lw)
    gap = tokens.T == fs.GAP_TOK
    is_gap = torch.as_tensor(gap, device=dev)
    G, logG = fs.fill_down(E, logE, is_gap, arrays, sub, ins)
    parent_safe = np.maximum(arrays.parent, 0)
    mask = (~gap) & (arrays.parent >= 0)[None, :] & ~gap[:, parent_safe]
    parent_gap = np.where(arrays.parent[None, :] >= 0, gap[:, parent_safe], True)
    roots = ~gap & parent_gap
    cols = np.nonzero(roots.any(axis=1))[0]
    cols_t = torch.as_tensor(cols, device=dev)
    r = torch.as_tensor(np.argmax(roots, axis=1)[cols], device=dev)
    w = torch.ones(L, dtype=torch.float64, device=dev)
    e = engine.eigen
    real = engine.count_device_ok

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a.real if real else a), device=dev)

    count_args = (F, logF, E, logE, G, logG, col_ll, torch.as_tensor(parent_safe, device=dev),
                  torch.as_tensor(np.maximum(arrays.sibling, 0), device=dev),
                  torch.as_tensor(mask, device=dev), w, lw, t(e.evec), t(e.evec_inv),
                  t(engine.branch_eigen_sub_count))
    contract = fs.eigen_counts if real else fs.eigen_counts_cplx
    return {"fill_up": lambda: fs.fill_up(tokens, arrays, sub, ins, lw),
            "fill_down": lambda: fs.fill_down(E, logE, is_gap, arrays, sub, ins),
            "node_post_prob": lambda: fs.node_post_prob(F, logF, G, logG, col_ll, lw),
            "eigen_counts": lambda: contract(*count_args),
            "root_counts": lambda: fs.root_counts(F[cols_t, r], logF[cols_t, r], col_ll[cols_t],
                                                  w[cols_t], lw, ins)}


def time_felsenstein(model, tree, rows: list, names=None) -> dict:
    """Each Felsenstein function on `rows`: its card time (CUDA events,
    median of 5 after a warm call), the same code's time on this machine's
    CPU (host clock, median of 3 after a warm call), and its bound."""
    from historian_tpu_torch.engine.sumprod import SumProductEngine

    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        engine = SumProductEngine(model, tree, dev)
        for name, fn in felsenstein_calls(engine, rows).items():
            if names is not None and name not in names:
                continue
            if dev.type == "cuda":
                out[name] = dict(ms=cuda_ms_median(fn, reps=5))
            else:
                fn()
                out[name]["cpu_ms"] = float(np.median([host_ms(fn)[1] for _ in range(3)]))
    N, L = len(rows), len(rows[0])
    C, A = model.components, model.alphabet_size
    cplx = not engine.count_device_ok
    for name, tm in out.items():
        tm.update(felsenstein_bound(L, N, C, A, name, cplx=cplx and name == "eigen_counts"))
    return out


def pp_lines(post_prob: dict, names: list) -> list:
    return [f"{names[row]} PP {col + 1} {ch} {prob:.6f}"
            for row, by_col in sorted(post_prob.items())
            for col, by_char in sorted(by_col.items())
            for ch, prob in sorted(by_char.items())]


def phase_counts(cli, work: str) -> dict:
    """(k) Counts, EM and ancestral prediction on long12's float32
    reconstruction from (j), through the CLI entry:
    `count -stockrecon` and `fit -stockrecon -maxiter 2` on the card and on
    the CPU (counts and fitted model within COUNT_RTOL), `sum` of the two
    count files, and `recon -ancseq -ancprob -stockholm <(j)'s guide>` in
    float32 on the card, whose rows must be (j)'s with the wildcards
    filled and whose ancestral rows and PP lines must equal those of the
    CPU's SumProductEngine on the same reconstruction.  The long12 runs
    must take the device fill and the device contraction (sumprod.ROUTES).
    Then small6 `recon -ancseq -ancprob` in float64, card == CPU byte for
    byte; a complex-spectrum codon alignment of 6000 columns made from a
    seed, the card's complex128 contraction against the CPU's numpy
    formulation (the route below 512 columns, 500 columns a fill); and the
    card times of the Felsenstein functions on long12's reconstruction and
    of the complex contraction.  Returns the long12 card runs' routes."""
    from historian_tpu_torch import recon as recon_mod
    from historian_tpu_torch.core.tree import Tree
    from historian_tpu_torch.engine import sumprod
    from historian_tpu_torch.models.counts import EventCounts

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    recon_path = os.path.join(work, "long12_f32.sto")
    card_routes = {}

    def timed(platform, args, command, dtype="f64"):
        sumprod.ROUTES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with reconstructors(recon_mod) as seen:
            out = run_cli(cli, ["-platform", platform, *args], dtype, command)
        torch.cuda.synchronize()
        routes = dict(sumprod.ROUTES)
        if platform == "gpu":
            for k, v in routes.items():
                card_routes[k] = card_routes.get(k, 0) + v
        return out, time.perf_counter() - t0, routes, seen[-1] if seen else None

    # count and fit, card against CPU
    results = {}
    for command, args in (("count", ["-stockrecon", recon_path]),
                          ("fit", ["-stockrecon", recon_path, "-maxiter", "2"])):
        runs = {}
        for platform in ("gpu", "cpu"):
            out, wall, routes, rc = timed(platform, args, command)
            dev = "cuda" if platform == "gpu" else "cpu"
            iters = 1 if command == "count" else 2
            # after an M-step the rates need not have an exactly-real
            # eigensystem, and the contraction then runs in complex128
            contractions = routes.get(f"counts:{dev}:real", 0) + routes.get(
                f"counts:{dev}:complex", 0)
            if (routes.get(f"fill:{dev}") != iters or routes.get(f"down:{dev}") != iters
                    or contractions != iters or len(routes) > 4
                    or routes.get(f"counts:{dev}:real", 0) < 1):
                raise AssertionError(f"long12 {command} -platform {platform}: routes {routes}, "
                                     f"expected {iters} device fills and contractions")
            runs[platform] = (out, rc)
            print(f"(k) long12 {command} -platform {platform}: wall {wall:.2f} s, routes {routes}",
                  flush=True)
        (g, grc), (c, crc) = runs["gpu"], runs["cpu"]
        if command == "count":
            pairs = [(grc.data_counts.root_count, crc.data_counts.root_count),
                     (grc.data_counts.sub_count, crc.data_counts.sub_count),
                     *((np.array(getattr(grc.data_counts.indel, k)),
                        np.array(getattr(crc.data_counts.indel, k)))
                       for k in ("ins", "del_", "ins_ext", "del_ext", "ins_time", "del_time", "lp"))]
            for p, out in (("gpu", g), ("cpu", c)):
                with open(os.path.join(work, f"counts_{p}.json"), "w") as f:
                    f.write(out)
        else:
            def rates(m):
                return np.array([m.ins_rate, m.del_rate, m.ins_ext_prob, m.del_ext_prob])

            pairs = [(rates(grc.model), rates(crc.model)), (grc.model.sub_rate, crc.model.sub_rate),
                     (grc.model.ins_prob, crc.model.ins_prob)]
        err = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) for a, b in pairs)
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=COUNT_RTOL, atol=1e-12 * np.abs(b).max())
        results[command] = err
        print(f"(k) long12 {command}: card and CPU agree, largest relative difference {err:.3e}",
              flush=True)

    out, wall, _, _ = timed("gpu", [os.path.join(work, f"counts_{p}.json") for p in ("gpu", "cpu")],
                            "sum")
    total, parts = (EventCounts.from_json_string(out),
                    [EventCounts.from_file(os.path.join(work, f"counts_{p}.json"))
                     for p in ("gpu", "cpu")])
    if total.indel.ins != parts[0].indel.ins + parts[1].indel.ins:
        raise AssertionError("sum: indel counts are not the files' sum")
    np.testing.assert_allclose(total.sub_count, parts[0].sub_count + parts[1].sub_count, rtol=1e-5)
    print(f"(k) sum of the card's and the CPU's long12 counts: wall {wall:.3f} s", flush=True)

    # ancestral prediction on the card from (j)'s guide, f32 merges
    out, wall, routes, rc = timed("gpu", ["-ancseq", "-ancprob", "-stockholm",
                                          os.path.join(work, "long12_guide.sto")], "recon", "f32")
    # the ancestral fill on the card, then the `#=GF LP` rescore's fill of
    # the distinct columns (engine/treealign.py log_likelihood; on the host
    # below 2^17 column-node cells, as in the JAX package)
    fills = routes.get("fill:cuda", 0) + routes.get("fill:native", 0)
    if (routes.get("fill:cuda", 0) < 1 or fills != 2 or routes.get("down:cuda") != 1
            or routes.get("post:cuda") != 1 or len(routes) > 4):
        raise AssertionError(f"long12 -ancseq: routes {routes}")
    with open(recon_path) as f:
        j_rows = dict(ln.split() for ln in f.read().splitlines()
                      if ln and not ln.startswith("#") and ln != "//")
    k_rows = dict(ln.split() for ln in out.splitlines()
                  if ln and not ln.startswith("#") and ln != "//")
    # (j) merged on its tree's exact branch lengths, this run on the guide
    # file's 6-digit ones: in float32 a near-tie of the best or a sampled
    # pick can go the other way, so a difference is reported, not fatal
    wild = rc.model.wildcard
    differ = [name for name, row in j_rows.items()
              if len(k_rows.get(name, "")) != len(row)
              or any(a != b and not (a == wild and b != "-") for a, b in zip(row, k_rows[name]))]
    same = (f"equal to (j)'s f32 rows but for the "
            f"{sum(r.count(wild) for r in j_rows.values())} predicted residues" if not differ else
            f"{len(differ)} of them differ from (j)'s f32 rows beyond the predicted residues "
            f"(widths {len(next(iter(j_rows.values())))} and {len(next(iter(k_rows.values())))})")
    ds = rc.datasets[0]
    rows = [s.seq for s in ds.gapped_recon]
    names = [s.name for s in ds.gapped_ancestral_recon]
    host = sumprod.SumProductEngine(rc.model, ds.tree, cpu).fill(rows)
    if host.ancestral_gapped_rows(rows) != [s.seq for s in ds.gapped_ancestral_recon]:
        raise AssertionError("long12 -ancseq: card's ancestral rows differ from the CPU engine's")
    card_pp = pp_lines(ds.ancestral_post_prob, names)
    if pp_lines(host.ancestral_post_probs(rows), names) != card_pp:
        raise AssertionError("long12 -ancseq: card's PP lines differ from the CPU engine's")
    print(f"(k) long12 recon -ancseq -ancprob -stockholm (j)'s guide, f32, card: wall {wall:.2f} s, "
          f"{len(k_rows)} rows, {same}; ancestral rows and {len(card_pp)} PP lines equal the "
          f"CPU engine's; routes {routes}", flush=True)

    # small6 -ancseq -ancprob, f64, card == CPU
    small = ["-ancseq", "-ancprob", write_small6(work)]
    outs = {p: timed(p, small, "recon", "f64") for p in ("gpu", "cpu")}
    if outs["gpu"][0] != outs["cpu"][0]:
        raise AssertionError("small6 -ancseq -ancprob f64: card output differs from the CPU's")
    print(f"(k) small6 recon -ancseq -ancprob f64: card == cpu ({outs['gpu'][0].count(' PP ')} PP "
          f"lines), walls {outs['gpu'][1]:.2f} / {outs['cpu'][1]:.2f} s, card routes "
          f"{outs['gpu'][2]}", flush=True)

    # a complex spectrum: the card's complex128 contraction against numpy
    model = complex_codon_model(seed=11)
    with open(os.path.join(REPO, "tests", "data", "long12.nh")) as f:
        tree = Tree(f.read())
    L = 6000
    rows = synthetic_rows(model, tree, L, seed=12)
    w = np.random.default_rng(13).random(L)
    c, a = model.components, model.alphabet_size
    sumprod.ROUTES.clear()
    card = sumprod.SumProductEngine(model, tree, cuda)
    got = (np.zeros((c, a)), np.zeros((c, a, a), complex))
    card.fill(rows).accumulate_eigen_counts(*got, w)
    if dict(sumprod.ROUTES) != {"fill:cuda": 1, "down:cuda": 1, "counts:cuda:complex": 1}:
        raise AssertionError(f"complex case: routes {dict(sumprod.ROUTES)}")
    host = sumprod.SumProductEngine(model, tree, cpu)
    want = (np.zeros((c, a)), np.zeros((c, a, a), complex))
    for lo in range(0, L, 500):
        host.fill([r[lo:lo + 500] for r in rows]).accumulate_eigen_counts(*want, w[lo:lo + 500])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=COUNT_RTOL, atol=1e-12 * np.abs(r).max())
    cplx_err = max(float(np.max(np.abs(g - r)) / np.abs(r).max()) for g, r in zip(got, want))
    print(f"(k) complex spectrum (ECMunrest + cyclic term, max |Im eigenvalue| "
          f"{np.abs(card.eigen.eval.imag).max():.3f}), {L} synthetic codon columns x "
          f"{tree.n_nodes()} nodes: card complex128 contraction == numpy within "
          f"{cplx_err:.3e} of the largest count", flush=True)

    # card times of the Felsenstein functions
    long12_rows = [s.seq for s in ds.gapped_recon]
    times = time_felsenstein(rc.model, ds.tree, long12_rows)
    times["eigen_counts_cplx"] = time_felsenstein(model, tree, rows, ["eigen_counts"])["eigen_counts"]
    for name, tm in times.items():
        where = (f"{L} x {tree.n_nodes()} codon" if name.endswith("cplx") else
                 f"long12 {len(long12_rows[0])} x {len(long12_rows)}")
        print(f"(k) {name} ({where}, f64): card {tm['ms']:.3f} ms, CPU {tm['cpu_ms']:.3f} ms, "
              f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})", flush=True)
    return dict(routes=card_routes, times=times, count_err=results["count"],
                fit_err=results["fit"], cplx_err=cplx_err)

#: the posterior cut of `-careful` (its -profminpost), at which phase (l)
#: counts the cells that a float32 fill would move across it
CAREFUL_CUT = 1e-3
#: a posterior above 1 by more than this is a fault of the full-band route
POST_SLACK = 1e-6


@contextlib.contextmanager
def cuda_timed(module, name: str):
    """module.<name> wrapped with a pair of CUDA events around each call;
    yields the list of pairs (read them after a synchronize).  Records
    only: no synchronize inside the run."""
    fn = getattr(module, name)
    pairs = []

    def timed(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        pairs.append((a, b))
        return out

    setattr(module, name, timed)
    try:
        yield pairs
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def host_timed(cls, name: str):
    """cls.<name> wrapped with the host clock; yields [(seconds, result)]."""
    fn = getattr(cls, name)
    calls = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(cls, name, timed)
    try:
        yield calls
    finally:
        setattr(cls, name, fn)


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def peak_host_memory():
    """The process's largest resident set while the block runs, sampled
    every 20 ms by a thread that the block's end stops: {"peak": bytes}."""
    box = {"peak": rss_bytes()}
    stop = threading.Event()

    def poll():
        while not stop.wait(0.02):
            box["peak"] = max(box["peak"], rss_bytes())

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        yield box
    finally:
        stop.set()
        t.join()
        box["peak"] = max(box["peak"], rss_bytes())


def d2h_bytes_per_s() -> float:
    """The card-to-host copy rate into pinned memory: 256 MiB, median of 5."""
    n = 256 << 20
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    ms = cuda_ms_median(lambda: dst.copy_(src, non_blocking=True))
    return n / (ms / 1e3)


def posterior_error(merge: tuple) -> dict:
    """At one full-band merge (x, y, hmm, parent row, envelope): the
    BackwardMatrix posteriors exp(fwd + bwd - lp_end) over the band with
    the Forward cells filled in float32 on the card against float64 (the
    route's dtype, device.FULLBAND_DTYPE): the largest posterior of each,
    their largest difference, the cells on the two sides of CAREFUL_CUT,
    and each fill's forward/backward disagreement (the check of
    BackwardMatrix trips above 0.01)."""
    from historian_tpu_torch import device as devmod
    from historian_tpu_torch.engine import forward

    x, y, hmm, row, env = merge
    route_dtype = devmod.FULLBAND_DTYPE
    post, out = {}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        devmod.FULLBAND_DTYPE = dtype
        try:
            fwd = forward.ForwardMatrix(x, y, hmm, row, env)
        finally:
            devmod.FULLBAND_DTYPE = route_dtype
        bwd = forward.BackwardMatrix(fwd)
        nx, ny = fwd.x_size - 1, fwd.y_size - 1
        ii, jj = np.nonzero(fwd.env_mask[:nx, :ny])
        with np.errstate(invalid="ignore"):
            p = np.exp(fwd.cells[ii, jj] + bwd.cells[ii, jj] - fwd.lp_end)
        post[name] = np.nan_to_num(p, nan=0.0)
        out[name] = dict(lp_end=fwd.lp_end, max_post=float(post[name].max()),
                         fwd_bwd_rel=abs(bwd.lp_start - fwd.lp_end)
                         / max(abs(bwd.lp_start), abs(fwd.lp_end)))
        out["shape"] = (nx, ny, len(ii))
        del fwd, bwd
    out["max_abs_err"] = float(np.abs(post["f32"] - post["f64"]).max())
    out["crossing"] = int(np.count_nonzero((post["f32"] > CAREFUL_CUT)
                                           != (post["f64"] > CAREFUL_CUT)))
    out["above_cut"] = int(np.count_nonzero(post["f64"] > CAREFUL_CUT))
    return out


def readback_summary(reads: list, rate: float) -> dict:
    n = sum(r["bytes"] for r in reads)
    return dict(merges=len(reads), bytes=n, ms=sum(r["ms"] for r in reads),
                bound_ms=n / rate * 1e3)


def phase_careful(cli, colforward, tracedp, guidedp, work: str) -> dict:
    """(l) The full-band paths: merges whose band the host reads (posterior
    profiles, -savedot, counting while reconstructing).  small6 in float64,
    card == CPU byte for byte: `recon -careful -norefine` on the default
    and the fused (K2) route, `recon -profminpost 0.01 -savedot F -dotpost 0.02`
    (the alignment and the dot file), `count` on the unaligned input; each
    prints its merges on each route and its readback bytes.  First the
    strip capacities of K1 and K2.  Then long6 (tests/data/long6.fa, 6 x
    5961-6087 aa) `recon -careful` in float32 on the card, the main path's
    run (its full-band merges fill in float64, `device.FULLBAND_DTYPE`,
    then the refiner, `refine_summary`): wall, the guide kernel's ms at the
    full envelope, K1's launches and ms, each merge's readback bytes and ms
    beside its bound (bytes over the pinned card-to-host rate measured
    here), the BackwardMatrix and posterior-profile host seconds, the
    posterior profiles' sizes, peak device and host memory.  At its first
    leaf merge, the posteriors of a float32 fill against the float64 one
    (`posterior_error`); the float64 posteriors must stay within 1 +
    POST_SLACK.  Then long6 `-careful -norefine` in float64 from the
    float32 run's saved guide and tree: its `#=GF LP` within F32_LP_DRIFT
    of the float32 run's before refining.  Returns the float32 run's
    launches, the fused small6 run's K2 launches and the float32 run's
    first branch fill's arguments (emit, ins, mask, trans, on the card) and
    its first BranchMatrix's (the refine step's PWMs and envelope)."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward, quickalign
    from historian_tpu_torch.ops import branchdp, devicedp, readback
    from historian_tpu_torch.sampler import refiner

    counters = (recon, forward, colforward, tracedp, guidedp)
    caps = strip_capacities(colforward)
    print(f"(l) strips resident at once: {caps}", flush=True)
    rate = d2h_bytes_per_s()
    print(f"(l) card-to-host copy into pinned memory: {rate / 1e9:.2f} GB/s", flush=True)
    with tempfile.TemporaryDirectory() as d:
        fa6 = write_small6(d)
        dots = {p: os.path.join(d, f"{p}.dot") for p in ("cpu", "gpu")}
        cases = (("recon -careful -norefine", "recon", ["-careful", "-norefine", fa6], "0"),
                 ("recon -careful -norefine fused", "recon", ["-careful", "-norefine", fa6], "1"),
                 ("recon -profminpost 0.01 -savedot -dotpost 0.02", "recon",
                  ["-profminpost", "0.01", "-savedot", "{dot}", "-dotpost", "0.02", fa6], "0"),
                 ("count (unaligned)", "count", [fa6], "0"))
        k2 = 0
        for what, command, args, fused in cases:
            os.environ["HISTORIAN_PALLAS_FUSED"] = fused
            outs = {}
            for platform in ("cpu", "gpu"):
                zero_counts(*counters)
                n_read = len(readback.READBACKS)
                argv = [a.replace("{dot}", dots[platform]) for a in args]
                outs[platform] = run_cli(cli, ["-platform", platform, *argv], "f64", command)
                if "{dot}" in args:
                    with open(dots[platform]) as f:
                        outs[platform] += f.read()
            counts = recon_counts(*counters)
            reads = merge_reads(readback.READBACKS[n_read:])
            if outs["gpu"] != outs["cpu"]:
                raise AssertionError(f"small6 {what} f64: card output differs from the CPU's")
            fill = "colforward_fused" if fused == "1" else "colforward"
            if counts["merges"]["fullband"] < 1 or counts[fill] < counts["merges"]["fullband"]:
                raise AssertionError(f"small6 {what}: no full-band merge on the card, {counts}")
            if fused == "1":
                k2 += counts["colforward_fused"]
            print(f"(l) small6 {what} f64: card == cpu ({len(outs['gpu'])} bytes), merges "
                  f"{counts['merges']}, launches K1 {counts['colforward']} K2 "
                  f"{counts['colforward_fused']}, readback {sum(r['bytes'] for r in reads)} "
                  f"bytes in {len(reads)} copies", flush=True)
        del os.environ["HISTORIAN_PALLAS_FUSED"]

    guide = os.path.join(work, "long6_guide.sto")
    inputs = {"f32": ["-careful", "-saveguide", guide,
                      os.path.join(REPO, "tests", "data", "long6.fa")],
              "f64": ["-careful", "-norefine", "-stockholm", guide]}
    labels = {"f32": "-careful", "f64": "-careful -norefine (from the f32 run's guide)"}
    runs, first = {}, []
    fullband = devicedp.col_forward_cells

    def capture(dp, *args):
        if not first:
            first.append((dp.x, dp.y, dp.hmm, dp.parent_row, dp.env))
        return fullband(dp, *args)

    for dtype in ("f32", "f64"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(*counters)
        n_read = len(readback.READBACKS)
        devicedp.col_forward_cells = capture
        refiner.LAST.clear()
        t0 = time.perf_counter()
        try:
            with cuda_timed(quickalign, "guide_align") as guide_ev, \
                    cuda_timed(devicedp, "col_forward_planes") as k1_ev, \
                    first_call(branchdp, "branch_fill") as branch_args, \
                    first_call(refiner, "BranchMatrix") as matrix_args, \
                    cuda_timed(branchdp, "branch_fill") as branch_ev, \
                    host_timed(forward.BackwardMatrix, "__init__") as bwd_t, \
                    host_timed(forward.BackwardMatrix, "post_prob_profile") as prof_t, \
                    peak_host_memory() as host_mem:
                out = run_cli(cli, ["-platform", "gpu", *inputs[dtype]], dtype)
                torch.cuda.synchronize()
        finally:
            devicedp.col_forward_cells = fullband
        wall = time.perf_counter() - t0
        counts = recon_counts(*counters)
        reads = merge_reads(readback.READBACKS[n_read:])
        rows, lp = stockholm_rows_lp(out)
        if dtype == "f32":
            refine = refine_summary(refiner.LAST, counts, lp, branch_ev,
                                    [r for r in readback.READBACKS[n_read:]
                                     if r["kind"] == "branch"])
            branch_inputs = branch_args[0][:4]  # emit, ins, mask, trans
            matrix_inputs = matrix_args[0]
        elif counts["branchfill"] or refiner.LAST:
            raise AssertionError(f"long6 -careful -norefine f64 refined: {counts}")
        if len(rows) != 11 or not math.isfinite(lp) or "#=GF NH" not in out:
            raise AssertionError(f"long6 -careful {dtype}: {len(rows)} rows, LP {lp}")
        if counts["merges"]["fullband"] < 1 or counts["colforward"] < counts["merges"]["fullband"] \
                or len(reads) != counts["fills"]["fullband"]:
            raise AssertionError(f"long6 -careful {dtype}: routes {counts}, {len(reads)} readbacks")
        guide_ms = [a.elapsed_time(b) for a, b in guide_ev]
        k1_ms = [a.elapsed_time(b) for a, b in k1_ev]
        print(f"(l) long6 recon {labels[dtype]} {dtype} on the card: "
              f"{len(rows)} rows, LP {lp}, "
              f"wall {wall:.2f} s, merges {counts['merges']}, fills {counts['fills']}, launches "
              f"K1 {counts['colforward']} K2 {counts['colforward_fused']} walker "
              f"{counts['pairtrace']} guide {counts['guidealign']}; guide kernel "
              f"{[round(t, 3) for t in guide_ms]} ms; K1 {[round(t, 3) for t in k1_ms]} ms; "
              f"BackwardMatrix {[round(t, 3) for t, _ in bwd_t]} s; posterior profiles "
              f"{[round(t, 3) for t, _ in prof_t]} s, sizes {[p.size for _, p in prof_t]} "
              f"states; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"peak host memory {host_mem['peak'] / 1e9:.2f} GB", flush=True)
        for k, r in enumerate(reads):
            print(f"(l) long6 {dtype} readback {k}: {r['cells']} cells, {r['bytes']} bytes in "
                  f"{r['ms']:.3f} ms, bound {r['bytes'] / rate * 1e3:.3f} ms", flush=True)
        runs[dtype] = dict(lp=lp, counts=counts, wall=wall, guide_ms=guide_ms, k1_ms=k1_ms,
                           readback=readback_summary(reads, rate))
    drift = abs(refine["lp_before"] - runs["f64"]["lp"])
    if not drift < F32_LP_DRIFT:
        raise AssertionError(f"long6 -careful: f32 LP is {drift} nats off f64")
    print(f"(l) long6 -careful f32 LP before refining - f64 -norefine LP: {drift:.6f} nats "
          f"(limit {F32_LP_DRIFT})", flush=True)

    t0 = time.perf_counter()
    err = posterior_error(first[0])
    nx, ny, band = err["shape"]
    print(f"(l) long6 first leaf merge ({nx} x {ny}, {band} band cells), posteriors of the "
          f"float32 fill against float64: largest f64 {err['f64']['max_post']!r}, f32 "
          f"{err['f32']['max_post']!r}, largest difference {err['max_abs_err']:.3e}, cells on "
          f"the two sides of {CAREFUL_CUT}: {err['crossing']} of {err['above_cut']} above it; "
          f"forward/backward disagreement f64 {err['f64']['fwd_bwd_rel']:.3e}, f32 "
          f"{err['f32']['fwd_bwd_rel']:.3e}; lp_end f64 {err['f64']['lp_end']!r}, f32 "
          f"{err['f32']['lp_end']!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not err["f64"]["max_post"] <= 1 + POST_SLACK or err["f64"]["fwd_bwd_rel"] > 0.01:
        raise AssertionError(f"long6 first merge: float64 posteriors {err['f64']}")
    print(json.dumps({"readback": dict(
        d2h_bytes_per_s=rate, posterior=err, strip_capacity=caps, refine=refine,
        **{dtype: dict(run["readback"], wall_s=run["wall"], guide_ms=run["guide_ms"],
                       k1_ms=run["k1_ms"]) for dtype, run in runs.items()})}), flush=True)
    return dict(f32=runs["f32"]["counts"], fused_k2=k2, branch_args=branch_inputs,
                matrix_args=matrix_inputs)


def merge_reads(reads: list) -> list:
    """The full-band merges' readbacks among `reads` (readback.READBACKS)."""
    return [r for r in reads if r["kind"] == "merge"]


def strip_capacities(colforward) -> dict:
    """colforward_capacity_* and colforward_fused_capacity_*: the lane
    strips K1 and K2 hold resident at once, in each dtype (K2 at lg's 20
    emission factors, at both strip widths); a merge needing more strips
    fills on the host (devicedp.merge_fits)."""
    dev = torch.cuda.current_device()
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        out[f"colforward_capacity_{tag}"] = colforward._capacity(
            "colforward", dtype, colforward.STRIP_WIDTH, 0, dev)
        for ns in (colforward.STRIP_WIDTH, colforward.NARROW_STRIP_WIDTH):
            out[f"colforward_fused_capacity_{tag}_ns{ns}_ca20"] = colforward._capacity(
                "colforward_fused", dtype, ns, 20, dev)
    return out


@contextlib.contextmanager
def first_call(module, name: str):
    """module.<name> wrapped to keep its first call's positional arguments;
    yields the list that holds them."""
    fn = getattr(module, name)
    box = []

    def keep(*args, **kw):
        if not box:
            box.append(args)
        return fn(*args, **kw)

    setattr(module, name, keep)
    try:
        yield box
    finally:
        setattr(module, name, fn)


def refine_summary(last: dict, counts: dict, lp: float, branch_ev: list, reads: list) -> dict:
    """The refiner's run in long6 `-careful` f32: steps, improvements, LP
    before and after, kernel (e)'s launches and ms, the band readbacks,
    the refiner's seconds by phase and its host seconds (its wall less
    the kernel's and the copies' ms).  Every step's fill must be on the
    card (a long6 branch is ~10^8 state-cells), the written LP the
    refiner's last, and no lower than before it."""
    kernel_ms = [a.elapsed_time(b) for a, b in branch_ev]
    sec = last["seconds"]
    out = dict(steps=last["steps"], improvements=last["improvements"],
               lp_before=last["lp_before"], lp_after=last["lp_after"],
               launches=counts["branchfill"], kernel_ms=sum(kernel_ms),
               kernel_ms_each=kernel_ms, readbacks=len(reads),
               readback_bytes=sum(r["bytes"] for r in reads),
               readback_ms=sum(r["ms"] for r in reads), seconds=sec)
    out["host_s"] = sec["total"] - (out["kernel_ms"] + out["readback_ms"]) / 1e3
    if not (counts["branchfill"] == last["steps"] == counts["branch_fills"]["device"]
            == len(reads) and last["steps"] >= 10):
        raise AssertionError(f"long6 -careful: {last['steps']} refine steps, routes {counts}, "
                             f"{len(reads)} band readbacks")
    if f"{last['lp_after']:.6f}" != f"{lp:.6f}" or last["lp_after"] < last["lp_before"]:
        raise AssertionError(f"long6 -careful: LP {lp}, refiner {last}")
    print(f"(l) long6 -careful f32 refiner: {out['steps']} steps, {out['improvements']} "
          f"improvements, LP {out['lp_before']!r} -> {out['lp_after']!r}; kernel (e) "
          f"{out['launches']} launches, {out['kernel_ms']:.1f} ms in all "
          f"({min(kernel_ms):.1f}-{max(kernel_ms):.1f} ms each); {len(reads)} band readbacks, "
          f"{out['readback_bytes']} bytes in {out['readback_ms']:.2f} ms; refiner seconds "
          f"{ {k: round(v, 3) for k, v in sec.items()} }, host {out['host_s']:.2f} s", flush=True)
    for k, r in enumerate(reads):
        print(f"(l) long6 f32 branch readback {k}: {r['cells']} cells, {r['bytes']} bytes in "
              f"{r['ms']:.3f} ms", flush=True)
    return out


def branch_host(args, viterbi: bool) -> tuple:
    """csrc/fill.cpp `branch_fill` on host copies of a branch fill's
    arguments: (cells, ms)."""
    from historian_tpu_torch.native import get_native

    emit, ins, mask, trans = (a.cpu().numpy() for a in args)
    cells = np.empty((*emit.shape, 3))
    t0 = time.perf_counter()
    get_native().branch_fill(emit.shape[0], emit.shape[1], emit, ins, mask.astype(np.uint8),
                             trans, np.uint8(viterbi), cells)
    return cells, (time.perf_counter() - t0) * 1e3


def branch_bound(args, viterbi: bool) -> dict:
    """Kernel (e)'s bound: the mask, the insert vector and the transitions
    read once, the emission at the in-mask cells only (a cell outside the
    mask is NEG whatever its emission), the [X+1, Y+1, 3] float64 grid
    written once; operations on the in-mask cells (a cell outside the mask
    is only stored)."""
    emit, ins, mask, trans = args
    in_mask = int(mask.sum())
    n_bytes = nbytes(ins, mask, trans) + in_mask * emit.element_size() + emit.numel() * 3 * 8
    ops = in_mask * (BRANCH_VITERBI_OPS if viterbi else BRANCH_FORWARD_OPS)
    return bound(n_bytes, ops, torch.float64)


def branch_err(what: str, got, ref) -> float:
    """Identical semiring zeros (below -1e25), then 1e-12 relative on the
    rest; returns the largest absolute error."""
    g, r = got.cpu().numpy() if isinstance(got, torch.Tensor) else got, \
        ref.cpu().numpy() if isinstance(ref, torch.Tensor) else ref
    live = r > -1e25
    if not np.array_equal(g > -1e25, live):
        raise AssertionError(f"{what}: semiring zeros differ")
    err = np.abs(g[live] - r[live])
    if not np.all(err <= BRANCH_RTOL * np.maximum(1.0, np.abs(r[live]))):
        raise AssertionError(f"{what}: off by {err.max()}")
    return float(err.max()) if err.size else 0.0


#: state-cells of the branches on which branch_routes times both routes,
#: around branchmatrix.DEVICE_MIN_CELLS (2e6)
ROUTE_SWEEP = (500_000, 1_000_000, 2_000_000, 4_000_000, 8_000_000, 32_000_000)


def branch_routes(matrix_args) -> list:
    """A BranchMatrix end to end, Viterbi, on each route: the host's
    emission and mask, then the fill and the best traceback, on fill.cpp
    (HISTORIAN_DEVICE_BRANCH=0) or on the card (=1: the uploads, the NEG
    grid, kernel (e), the band's search and readback, the traceback
    through BandCells).  At long6's first refine branch cut to n x n for
    each of ROUTE_SWEEP's state-cells, and whole; the routes alternate,
    3 times each, median wall ms.  Both routes must give the same path."""
    from historian_tpu_torch import device
    from historian_tpu_torch.engine.branchmatrix import BranchMatrix

    device.select("gpu")
    model, x_pwm, y_pwm, dist, env, x_pos, y_pos, x_row, y_row = matrix_args
    out = []
    for cells in (*ROUTE_SWEEP, None):
        nx, ny = len(x_pwm), len(y_pwm)
        if cells is not None:
            n = int(math.sqrt(cells / 3))
            nx, ny = min(n, nx), min(n, ny)
        args = (model, x_pwm[:nx], y_pwm[:ny], dist, env, x_pos[:nx + 1], y_pos[:ny + 1],
                x_row, y_row)
        ms, paths = {"host": [], "device": []}, {}
        for _ in range(3):
            for route, flag in (("host", "0"), ("device", "1")):
                os.environ["HISTORIAN_DEVICE_BRANCH"] = flag
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = BranchMatrix(*args, viterbi=True).best()
                torch.cuda.synchronize()
                ms[route].append((time.perf_counter() - t0) * 1e3)
                paths[route] = path
        del os.environ["HISTORIAN_DEVICE_BRANCH"]
        if any(not np.array_equal(paths["host"][r], paths["device"][r]) for r in paths["host"]):
            raise AssertionError(f"branch {nx} x {ny}: the routes' best paths differ")
        row = dict(x=nx, y=ny, state_cells=(nx + 1) * (ny + 1) * 3,
                   host_ms=float(np.median(ms["host"])), device_ms=float(np.median(ms["device"])))
        print(f"(m) BranchMatrix + best, long6 branch cut to {nx} x {ny} "
              f"({row['state_cells']} state-cells): fill.cpp route {row['host_ms']:.2f} ms, "
              f"kernel (e) route {row['device_ms']:.2f} ms (medians of 3: "
              f"{[round(t, 2) for t in ms['host']]}, {[round(t, 2) for t in ms['device']]})",
              flush=True)
        out.append(row)
    return out


def phase_branch(cli, colforward, tracedp, guidedp, long6_args, matrix_args) -> dict:
    """(m) Kernel (e), the branch fill.  small6 `recon -careful` in float64
    on the card, once with HISTORIAN_DEVICE_BRANCH=1 (every refine step's
    fill on the kernel) and once on the automatic route (these small fills
    on the host), each byte-identical to the CPU run.  Then the kernel
    against its plain version (1e-12 relative) and against csrc/fill.cpp
    (Viterbi bit for bit, Forward 1e-12 relative), in both modes, at the
    first fill of the forced small6 run and at the first long6 fill of
    (l): ms (CUDA events, median of 5 after a warm launch), the plain
    version's ms and fill.cpp's, and the bound.  Then both routes of a
    BranchMatrix around the route rule's threshold (`branch_routes`)."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.ops import branchdp
    from historian_tpu_torch.sampler import refiner

    counters = (recon, forward, colforward, tracedp, guidedp)
    with tempfile.TemporaryDirectory() as d:
        fa6 = write_small6(d)
        cpu = run_cli(cli, ["-platform", "cpu", "-careful", fa6], "f64")
        for route, env in (("forced", "1"), ("automatic", "auto")):
            os.environ["HISTORIAN_DEVICE_BRANCH"] = env
            zero_counts(*counters)
            with first_call(branchdp, "branch_fill") as small_args:
                gpu = run_cli(cli, ["-platform", "gpu", "-careful", fa6], "f64")
            counts = recon_counts(*counters)
            steps = refiner.LAST["steps"]
            if gpu != cpu:
                raise AssertionError(f"small6 -careful f64 ({route} route): card output differs "
                                     f"from the CPU's")
            want = (dict(device=steps, host=0) if route == "forced"
                    else dict(device=0, host=steps))
            if counts["branch_fills"] != want or counts["branchfill"] != want["device"]:
                raise AssertionError(f"small6 -careful {route}: {steps} steps, {counts}")
            if route == "forced":
                small = small_args[0][:4]  # emit, ins, mask, trans
            print(f"(m) small6 recon -careful f64, {route} branch route: card == cpu "
                  f"({len(gpu)} bytes, LP {stockholm_rows_lp(gpu)[1]}), {steps} refine steps, "
                  f"{refiner.LAST['improvements']} improvements, branch fills "
                  f"{counts['branch_fills']}, kernel (e) launches {counts['branchfill']}",
                  flush=True)
        del os.environ["HISTORIAN_DEVICE_BRANCH"]

    out = {}
    for name, args in (("small6", small), ("long6", long6_args)):
        X1, Y1 = args[0].shape
        for viterbi in (True, False):
            mode = "viterbi" if viterbi else "forward"
            got = branchdp.branch_fill(*args, viterbi)
            torch.cuda.synchronize()
            plain, plain_ms = host_ms(lambda: branchdp.branch_fill_plain(*args, viterbi))
            err = branch_err(f"{name} {mode} kernel vs plain", got, plain)
            del plain
            host, fill_cpp_ms = branch_host(args, viterbi)
            if viterbi:
                if not np.array_equal(got.cpu().numpy().view(np.uint64), host.view(np.uint64)):
                    raise AssertionError(f"{name} viterbi: kernel cells differ from fill.cpp's")
                vs_host = "bit-equal"
            else:
                vs_host = f"max abs err {branch_err(f'{name} forward vs fill.cpp', got, host):.3e}"
            del got, host
            ms = cuda_ms_median(lambda: branchdp.branch_fill(*args, viterbi))
            bnd = branch_bound(args, viterbi)
            print(f"(m) kernel (e) {name} {mode} {X1} x {Y1} ({int(args[2].sum())} in-mask "
                  f"cells): {ms:.3f} ms, plain {plain_ms:.1f} ms, fill.cpp {fill_cpp_ms:.1f} ms; "
                  f"vs plain max abs err {err:.3e}, vs fill.cpp {vs_host}; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
            out[(name, mode)] = dict(ms=ms, plain_ms=plain_ms, fill_cpp_ms=fill_cpp_ms,
                                     err=err, **bnd)
    main_path = out[("long6", "viterbi")]
    routes = branch_routes(matrix_args)
    print(json.dumps({"branchfill": {f"{n} {m}": v for (n, m), v in out.items()},
                      "routes": routes}), flush=True)
    return dict(main_path, err=max(v["err"] for v in out.values()))


def main() -> int:
    from historian_tpu_torch import bench, cli
    from historian_tpu_torch.ops import _kernels, colforward, guidedp, pairforward, tracedp

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"(a) {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _kernels.lib()
    print(f"(b) kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    k1 = phase_k1(colforward)
    walk_planes = k1.pop("walk_planes")
    f32, f64 = torch.float32, torch.float64
    dag_err = phase_walker(tracedp, "dag", *walk_planes.pop(("dag", f64)), 3)["err"]
    for dt in (f32, f64):
        phase_walker(tracedp, "long12 best only", *walk_planes[("long12", dt)], 0)
    sampled_err = phase_walker(tracedp, "long12 in order", *walk_planes[("long12", f32)], 2)["err"]
    phase_walker(tracedp, "long12 in order", *walk_planes.pop(("long12", f32)), 10, check=False)
    walker = phase_walker(tracedp, "long12", *walk_planes.pop(("long12", f64)), 1)
    launches = phase_e2e(cli, colforward, tracedp)
    k2 = phase_k2(colforward)
    guide = phase_guide(guidedp)
    launches_h = phase_guide_e2e(cli, colforward, tracedp, guidedp)
    pf = phase_pairforward(pairforward, bench, torch.device("cuda"))
    with tempfile.TemporaryDirectory() as work:
        launches_j = phase_default_recon(cli, colforward, tracedp, guidedp, work)
        routes_k = phase_counts(cli, work)
        launches_l = phase_careful(cli, colforward, tracedp, guidedp, work)
    branch = phase_branch(cli, colforward, tracedp, guidedp, launches_l.pop("branch_args"),
                          launches_l.pop("matrix_args"))

    kernels = [
        dict(name="colforward", route="cuda", source="historian_tpu_torch/csrc/colforward.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:364",
             launches=(launches["colforward"] + launches_h["default"]["colforward"]
                       + launches_j["colforward"] + launches_l["f32"]["colforward"]),
             max_abs_err=k1["err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="pairtrace", route="cuda", source="historian_tpu_torch/csrc/tracedp.cu",
             replaces="historian_tpu/ops/tracedp.py:85",
             launches=launches["pairtrace"] + launches_j["pairtrace"],
             max_abs_err=max(dag_err, sampled_err, walker["err"]),
             ms=walker["ms"], plain_ms=walker["plain_ms"], bound_ms=walker["bound_ms"],
             bound_by=walker["bound_by"], library_ms=None),
        dict(name="colforward_fused", route="cuda",
             source="historian_tpu_torch/csrc/colforward_fused.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:318",
             launches=launches_h["fused"]["colforward_fused"] + launches_l["fused_k2"],
             max_abs_err=k2["err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="guidealign", route="cuda", source="historian_tpu_torch/csrc/guidealign.cu",
             replaces="historian_tpu/ops/guidedp.py:161",
             launches=(launches_h["fused"]["guidealign"] + launches_j["guidealign"]
                       + launches_l["f32"]["guidealign"]),
             max_abs_err=guide["err"],
             ms=guide["ms"], plain_ms=guide["plain_ms"], bound_ms=guide["bound_ms"],
             bound_by=guide["bound_by"], library_ms=None),
    ]
    kernels.append(dict(
        name="branchfill", route="cuda", source="historian_tpu_torch/csrc/branchfill.cu",
        replaces="historian_tpu/ops/branchdp.py:41", launches=launches_l["f32"]["branchfill"],
        max_abs_err=branch["err"], ms=branch["ms"], plain_ms=branch["plain_ms"],
        bound_ms=branch["bound_ms"], bound_by=branch["bound_by"], library_ms=None))
    for name, kid, line in (("pairforward_lp", "K3", 142), ("pairforward_lp_tiled", "K4", 301)):
        kernels.append(dict(
            name=name, route="cuda", source="historian_tpu_torch/csrc/pairforward.cu",
            replaces=f"historian_tpu/ops/pallas_pairforward.py:{line}",
            launches=pf["launches"][name], max_abs_err=pf["err"][kid], library_ms=None,
            **pf[kid]))
    routes = routes_k["routes"]
    real, cplx = routes.get("counts:cuda:real", 0), routes.get("counts:cuda:complex", 0)
    launches_k = {"fill_up": routes.get("fill:cuda", 0), "fill_down": routes.get("down:cuda", 0),
                  "node_post_prob": routes.get("post:cuda", 0), "eigen_counts": real,
                  "eigen_counts_cplx": cplx, "root_counts": real + cplx}
    print(json.dumps({"felsenstein": dict(
        routes=routes, count_rel_err=routes_k["count_err"], fit_rel_err=routes_k["fit_err"],
        complex_rel_err=routes_k["cplx_err"],
        **{name: dict(tm, launches=launches_k[name]) for name, tm in routes_k["times"].items()})}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
