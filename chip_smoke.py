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
      pairs of long12 cut to 3000 x 3000 through K4; then K3 and K4
      against their plain version on the card at those three shapes
      (the headline in float32 and float64, the others in float32, K4
      always with x_tile below X);
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
      sampled walks must run on the card.
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.  A kernel's
`launches` sums the main-path runs that drive it, each counted from 0:
K1 in (e), (h) default and (j) long12 f32, K2 in (h) fused, the guide
kernel in (h) fused and (j) long12 f32, the walker in (e) and (j) long12
f32.

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


def run_cli(cli, args: list, dtype: str) -> str:
    os.environ["HISTORIAN_DEVICE_DTYPE"] = dtype
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["recon", *args])
    if rc != 0:
        raise AssertionError(f"recon {args} returned {rc}")
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
            ("codon", torch.float32), ("long", torch.float32))


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
            print(f"(i) {kname} {name} B={B} X={X1 - 1} Y={Y1 - 1} {str(dtype)[6:]}"
                  f"{f' x_tile {rows}' if kname == 'K4' else ''}: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.1f} ms, max lp err {float((got - ref).abs().max()):.3e} "
                  f"({rel:.3e} of |lp|), {rate:.4g} state-cells/s", flush=True)
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


def recon_counts(recon, forward, colforward, tracedp, guidedp) -> dict:
    return dict(colforward=colforward.LAUNCHES, colforward_fused=colforward.FUSED_LAUNCHES,
                pairtrace=tracedp.LAUNCHES, guidealign=guidedp.LAUNCHES,
                merges=dict(recon.MERGES), fills=dict(forward.FILLS),
                sampled=dict(forward.SAMPLED))


def zero_counts(recon, forward, colforward, tracedp, guidedp) -> None:
    colforward.LAUNCHES = colforward.FUSED_LAUNCHES = tracedp.LAUNCHES = guidedp.LAUNCHES = 0
    for d in (recon.MERGES, forward.FILLS, forward.SAMPLED):
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


def phase_default_recon(cli, colforward, tracedp, guidedp) -> dict:
    """(j) The default `recon` (sampled profiles, no -fast): small6 card f64
    == CPU f64 on the default and the fused route; then long12 with no tree
    and no profile flags on the card, default route (K1), in float32 and in
    float64 from the float32 run's guide and tree, whose `#=GF LP` must
    agree within F32_LP_DRIFT.  Each run's K1
    (K2) launches must equal its chain-x fills and its host fills the
    fills whose x is a sampled profile.  Returns the float32 run's counts."""
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
        guide = os.path.join(d, "long12_guide.sto")
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
    del os.environ["HISTORIAN_PALLAS_FUSED"]
    drift = abs(runs["f32"][0] - runs["f64"][0])
    if not drift < F32_LP_DRIFT:
        raise AssertionError(f"long12 default: f32 LP is {drift} nats off f64")
    print(f"(j) long12 default f32 LP - f64 LP: {drift:.6f} nats (limit {F32_LP_DRIFT})",
          flush=True)
    return runs["f32"][1]


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
    launches_j = phase_default_recon(cli, colforward, tracedp, guidedp)

    kernels = [
        dict(name="colforward", route="cuda", source="historian_tpu_torch/csrc/colforward.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:364",
             launches=(launches["colforward"] + launches_h["default"]["colforward"]
                       + launches_j["colforward"]),
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
             launches=launches_h["fused"]["colforward_fused"], max_abs_err=k2["err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="guidealign", route="cuda", source="historian_tpu_torch/csrc/guidealign.cu",
             replaces="historian_tpu/ops/guidedp.py:161",
             launches=launches_h["fused"]["guidealign"] + launches_j["guidealign"],
             max_abs_err=guide["err"],
             ms=guide["ms"], plain_ms=guide["plain_ms"], bound_ms=guide["bound_ms"],
             bound_by=guide["bound_by"], library_ms=None),
    ]
    for name, kid, line in (("pairforward_lp", "K3", 142), ("pairforward_lp_tiled", "K4", 301)):
        kernels.append(dict(
            name=name, route="cuda", source="historian_tpu_torch/csrc/pairforward.cu",
            replaces=f"historian_tpu/ops/pallas_pairforward.py:{line}",
            launches=pf["launches"][name], max_abs_err=pf["err"][kid], library_ms=None,
            **pf[kid]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
