"""Smoke run of historian_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  (a) card check: CUDA present; prints the card's name and power limit;
  (b) build: compiles every kernel in historian_tpu_torch/csrc, timed;
  (c) K1, the column fill, against its plain PyTorch version on the card,
      float32 and float64: a DAG y (KY = 4, null states, a diagonal band)
      at SX = SY = 3072, and a chain y over the full grid at the shape of
      long12's first merge (t01 x t02, ~6100 x 6100), the main path's;
  (d) the trace walker against its plain version on the float64 planes
      of both cases of (c), best and sampled traces;
  (e) end to end through the CLI entry: `recon -fast -noband` on small4
      (4 x 300 aa from tests/data/long8.fa) in float64 on the card must
      be byte-identical to the CPU float64 run; then `recon -fast -noband`
      on tests/data/long12 (12 x ~6000 aa, 11 merges) in float32, whose
      kernel launches are counted;
  (f) K2, the fused column fill, against its plain version on the card:
      float32 and float64 on a DAG y (KY = 4) at 3072 x 3072 with a band
      (m1 = i, m2 = j, distance 10, a few lanes near the start of x and
      rows near the end of y), and float32 at long12's first-merge shape
      with 20 emission factors;
  (g) the guide kernel against its plain version, float32 and float64, on
      8 pairs of long12's sequences cut to 3000 aa with the sparse
      `-kmatchn 3` envelopes: steps, ends, lead cells and scores
      identical;
  (h) end to end with the guide stage and the built tree: `recon -fast`
      on small6 (tests/data/long6.fa cut to 240-340 aa) in float64 on the
      card, default and fused (HISTORIAN_PALLAS_FUSED=1) routes, each
      byte-identical to the CPU float64 run; then `recon -fast` on
      tests/data/long12.fa with no tree in float32 on the fused route,
      whose kernel launches are counted (K2 and the guide kernel, no K1).
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.
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


def k1_inputs(SX: int, SY: int, KY: int, banded: bool, seed: int, dtype) -> tuple:
    """K1 arguments on the card: y in-edges (first edge j-1, others up to
    6 columns back, the last KY-2 padded; with KY = 1 a chain y), nulls
    when KY > 1, a diagonal band or the full grid."""
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
    dev = torch.device("cuda")

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


def host_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_k1(colforward) -> dict:
    """K1 against its plain version: a DAG y at 3072 x 3072, and a chain y
    over the full grid at the shape of long12's first merge.  Returns the
    largest error, the long12-shape float32 times, and the float64 planes
    of both cases for the walker."""
    SX, SY = long12_first_merge()
    err, times, planes64 = 0.0, {}, {}
    for name, sx, sy, KY, banded in (("dag", 3072, 3072, 4, True),
                                     ("long12", SX, SY, 1, False)):
        for dtype in (torch.float32, torch.float64):
            args = k1_inputs(sx, sy, KY, banded, 17, dtype)
            got = colforward.col_forward_planes(*args)
            ref, p_ms = host_ms(lambda: colforward.col_forward_planes_plain(*args))
            k_ms = cuda_ms(lambda: colforward.col_forward_planes(*args))
            g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
            live = r > -1e25
            if not np.array_equal(g > -1e25, live):
                raise AssertionError(f"K1 {name} {dtype}: liveness differs")
            rtol, atol = (F32_RTOL, F32_ATOL) if dtype == torch.float32 else (F64_TOL, F64_TOL)
            np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)
            e = float(np.abs(g[live] - r[live]).max())
            err = max(err, e)
            print(f"(c) K1 {name} SX={sx} SY={sy} KY={KY} {str(dtype)[6:]}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, max abs err {e:.3e}", flush=True)
            times[(name, dtype)] = (k_ms, p_ms)
            if dtype == torch.float64:
                planes64[name] = (got, args)
    k_ms, p_ms = times[("long12", torch.float32)]
    return dict(err=err, ms=k_ms, plain_ms=p_ms, planes64=planes64)


def phase_walker(tracedp, name: str, planes, args, T: int) -> dict:
    """The walker against its plain version on float64 planes of (c):
    trace 0 best, the others sampled; paths must be identical."""
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
        torch.as_tensor(rng.random((T, L)), dtype=dt, device=dev),
        torch.arange(T, device=dev) == 0,
        L,
    )
    got = tracedp.pair_trace(*walk)
    ref, p_ms = host_ms(lambda: tracedp.pair_trace_plain(*walk))
    k_ms = cuda_ms(lambda: tracedp.pair_trace(*walk))
    for a, b, what in zip(got, ref, ("pi", "pj", "ps", "vals", "n_steps")):
        if not torch.equal(a, b):
            raise AssertionError(f"walker {name} {what} differs from the plain walker")
    lp_err = abs(float(got[5]) - float(ref[5]))
    if not lp_err <= F64_TOL:
        raise AssertionError(f"walker {name} lp_end differs by {lp_err}")
    print(f"(d) walker {name} SX={SX} SY={SY} f64, 1 best + {T - 1} sampled, steps "
          f"{got[4].tolist()}: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, "
          f"paths identical, lp_end err {lp_err:.3e}", flush=True)
    return dict(err=lp_err, ms=k_ms, plain_ms=p_ms)


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


def k2_inputs(SX: int, SY: int, KY: int, seed: int, dtype, CA: int = 20) -> tuple:
    """K2 arguments on the card: y in-edges and nulls drawn as k1_inputs
    draws them, CA positive emission factors, and the band
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
    dev = torch.device("cuda")

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (t(y_src, torch.int32), t(y_lp), t(y_flags), t(rng.uniform(0.05, 1, (SY, CA))),
            t(rng.uniform(0.05, 1, (CA, SX))), t(xvec), t(params))


def phase_k2(colforward) -> dict:
    """K2 against its plain version (the emission and band planes built in
    torch, then K1's plain version): a banded DAG y at 3072 x 3072 in
    float32 and float64, and a banded chain y at long12's first-merge
    shape in float32, the main path's.  Returns the largest error and the
    long12-shape times."""
    SX, SY = long12_first_merge()
    err, times = 0.0, {}
    for name, sx, sy, KY, dtypes in (("dag", 3072, 3072, 4, (torch.float32, torch.float64)),
                                     ("long12", SX, SY, 1, (torch.float32,))):
        for dtype in dtypes:
            args = k2_inputs(sx, sy, KY, 23, dtype)
            got = colforward.col_forward_planes_fused(*args)
            ref, p_ms = host_ms(lambda: colforward.col_forward_planes_fused_plain(*args))
            k_ms = cuda_ms(lambda: colforward.col_forward_planes_fused(*args))
            g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
            live = r > -1e25
            if not np.array_equal(g > -1e25, live):
                raise AssertionError(f"K2 {name} {dtype}: liveness differs")
            if live.all() or not live.any():
                raise AssertionError(f"K2 {name} {dtype}: the band gates no cell or every cell")
            rtol, atol = (F32_RTOL, F32_ATOL) if dtype == torch.float32 else (F64_TOL, F64_TOL)
            np.testing.assert_allclose(g[live], r[live], rtol=rtol, atol=atol)
            e = float(np.abs(g[live] - r[live]).max())
            err = max(err, e)
            print(f"(f) K2 {name} SX={sx} SY={sy} KY={KY} CA=20 {str(dtype)[6:]}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, max abs err {e:.3e}, "
                  f"{live[0].mean():.4f} of cells live", flush=True)
            times[(name, dtype)] = (k_ms, p_ms)
    k_ms, p_ms = times[("long12", torch.float32)]
    return dict(err=err, ms=k_ms, plain_ms=p_ms)


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
        k_ms = cuda_ms(lambda: guidedp.guide_align(*args))
        for what, a, b in zip(("steps", "n_steps", "x_end", "y_end", "lead_i", "lead_j", "score"),
                              got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"guide kernel {str(dtype)[6:]}: {what} differs from "
                                     "the plain version")
        err = max(err, float((got[6] - ref[6]).abs().max()))
        print(f"(g) guide kernel {len(GUIDE_PAIRS)} pairs of 3000 aa {str(dtype)[6:]}, "
              f"envelopes keep {min(kept):.3f}-{max(kept):.3f} of the diagonals, steps "
              f"{got[1].tolist()}: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, outputs identical",
              flush=True)
        times[dtype] = (k_ms, p_ms)
    k_ms, p_ms = times[torch.float32]
    return dict(err=err, ms=k_ms, plain_ms=p_ms)


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

    os.environ["HISTORIAN_PALLAS_FUSED"] = "1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    colforward.LAUNCHES = colforward.FUSED_LAUNCHES = tracedp.LAUNCHES = guidedp.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_cli(cli, ["-platform", "gpu", "-fast",
                        os.path.join(REPO, "tests", "data", "long12.fa")], "f32")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(colforward=colforward.LAUNCHES, colforward_fused=colforward.FUSED_LAUNCHES,
                    pairtrace=tracedp.LAUNCHES, guidealign=guidedp.LAUNCHES)
    del os.environ["HISTORIAN_PALLAS_FUSED"]
    rows, lp = stockholm_rows_lp(out)
    if len(rows) != 23 or not math.isfinite(lp) or "#=GF NH" not in out:
        raise AssertionError(f"long12: {len(rows)} rows, LP {lp}")
    if (launches["colforward"] != 0 or launches["colforward_fused"] < 11
            or launches["guidealign"] < 1 or launches["pairtrace"] < 11):
        raise AssertionError(f"long12 launches {launches}")
    print(f"(h) long12 -fast (no tree, fused) f32: {len(rows)} rows, LP {lp}, wall {wall:.2f} s, "
          f"launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches


def main() -> int:
    from historian_tpu_torch import cli
    from historian_tpu_torch.ops import _kernels, colforward, guidedp, tracedp

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
    planes64 = k1.pop("planes64")
    dag_err = phase_walker(tracedp, "dag", *planes64.pop("dag"), T=4)["err"]
    walker = phase_walker(tracedp, "long12", *planes64.pop("long12"), T=2)
    launches = phase_e2e(cli, colforward, tracedp)
    k2 = phase_k2(colforward)
    guide = phase_guide(guidedp)
    launches_h = phase_guide_e2e(cli, colforward, tracedp, guidedp)

    kernels = [
        dict(name="colforward", route="cuda", source="historian_tpu_torch/csrc/colforward.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:364",
             launches=launches["colforward"], max_abs_err=k1["err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="pairtrace", route="cuda", source="historian_tpu_torch/csrc/tracedp.cu",
             replaces="historian_tpu/ops/tracedp.py:85",
             launches=launches["pairtrace"], max_abs_err=max(dag_err, walker["err"]),
             ms=walker["ms"], plain_ms=walker["plain_ms"]),
        dict(name="colforward_fused", route="cuda",
             source="historian_tpu_torch/csrc/colforward_fused.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:318",
             launches=launches_h["colforward_fused"], max_abs_err=k2["err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"]),
        dict(name="guidealign", route="cuda", source="historian_tpu_torch/csrc/guidealign.cu",
             replaces="historian_tpu/ops/guidedp.py:161",
             launches=launches_h["guidealign"], max_abs_err=guide["err"],
             ms=guide["ms"], plain_ms=guide["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
