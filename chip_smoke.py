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
      kernel launches are counted.
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


def main() -> int:
    from historian_tpu_torch import cli
    from historian_tpu_torch.ops import _kernels, colforward, tracedp

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

    kernels = [
        dict(name="colforward", route="cuda", source="historian_tpu_torch/csrc/colforward.cu",
             replaces="historian_tpu/ops/pallas_colforward.py:364",
             launches=launches["colforward"], max_abs_err=k1["err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="pairtrace", route="cuda", source="historian_tpu_torch/csrc/tracedp.cu",
             replaces="historian_tpu/ops/tracedp.py:85",
             launches=launches["pairtrace"], max_abs_err=max(dag_err, walker["err"]),
             ms=walker["ms"], plain_ms=walker["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
