"""Smoke run of historian_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  (a) card check: CUDA present; prints the card's name and power limit;
  (b) build: compiles every kernel in historian_tpu_torch/csrc, timed;
  (c) K1, the column fill, against its plain PyTorch version on the card,
      float32 and float64: a DAG y (KY = 4, null states, a diagonal band)
      at SX = SY = 2048, a chain y over the full grid at the shape of
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
      float32 and float64 on a DAG y (KY = 4) at 2048 x 2048 with a band
      (m1 = i, m2 = j, distance 10, a few lanes near the start of x and
      rows near the end of y), and in float32 on a chain y at long12's
      first-merge shape with 20 emission factors; active share below 0.5;
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
      chain, and kernel (a)'s launches plus the host fills those whose x
      is a sampled profile (a log of every fill's x, kept apart from the
      routes' counters), and some sampled walks must run on the card;
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
      before and after, kernel (e)'s launches (every step's fill) by design
      and ms, each step's band upload (bytes, the copy's ms, the host's
      packing ms) and band readback (bytes, ms), and the refiner's seconds
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
      squared), through the full-grid entry and the band entry, with the
      band entry's ms (the kernel alone) and us a diagonal, the design it
      took, the plain version's and fill.cpp's ms, the band's byte bound
      and the dependency floor (diagonals times one Delete step, timed on
      the card); then both routes of a BranchMatrix around the route
      rule's threshold.  With `--parent DIR` (a checkout of another
      version unpacked there), kernel (e) of that version and of this one
      at long6's first fill, in turns (historian_tpu_torch/branch_bench.py,
      roots.compare_roots).  Prints a {"branchfill": ...} JSON line;
  (n) MCMC with kernel (d), the sibling fill, and kernel (e) in Forward
      mode: `mcmc -samples 3 -seed 7` on small6 in float64 (for the
      automatic route small6 cut to 150-200 aa: small6 and small4 each
      have a fill that crosses the sibling route rule) on the CPU and on
      the card's automatic route (every fill on the host), output
      and -trace file byte-identical; then with every sibling and branch
      fill forced onto the kernels, launches equal to fills, each fill held
      against csrc/fill.cpp on the same inputs (1e-9), and whether the
      output still equals the CPU's printed (an MH decision may turn at
      round-off).  Kernel (d) at small6's node-align fill against its
      plain version and fill.cpp.  Then the main path's run, `mcmc
      -stockrecon <(l)'s long6 float32 reconstruction> -samples 2 -seed 7`
      on the card: wall, steps, proposals, accepts and seconds by move,
      the fills on each route, kernel (d)'s launches and kernel (e)'s by
      mode and design, uploads and readbacks, peak device and host
      memory; then one proposal of each alignment move on its history
      from a seeded mt19937 (kernel (d) banded and full-mask, kernel (e)
      Forward ring and strip, each fill held against fill.cpp), and kernel
      (d) at long6's banded node-align fill (the ring design) and a
      full-mask prune-and-regraft fill (the strip design), each against
      fill.cpp (1e-9, the bit-equal share printed) and the plain version
      (1e-12 relative): the design, lanes a cell, the block shape and the
      ring's slots or the strips, ms and us a diagonal, at the banded fill
      the plan kernel against the plain plan (byte for byte) and the plan
      kernel's and the fill's ms alone, at the full mask the strip design
      at strips of 16, 32 and 64 rows (the same bits), the plain
      version's and fill.cpp's ms, the band's bytes up and back and the
      copies' ms, the bound and both dependency floors (a lane group a
      cell; one thread a cell, the first design's); with `--parent DIR`,
      kernel (d) of that version and of this one at both fills, in turns
      (historian_tpu_torch/sibling_bench.py, roots.compare_roots), and
      whether their cells are the same bits; kernel (e) Forward at a ring
      and a full-mask MCMC fill (the strip design), each against fill.cpp,
      with its ms, us a diagonal, layout and ratio to the dependency
      floor, and at the full mask the same inputs in Viterbi mode (bit
      for bit against fill.cpp, timed), the plain version (timed) and the
      bound; with `--parent DIR`, that fill's inputs saved under
      build/bench_inputs/ and kernel (e) of that version and of this one
      on them in turns (branch_bench.py, SHA-256 of the cells); then both
      routes of the node-align
      proposal's SiblingMatrix cut at ~0.3-2e6 in-mask state-cells,
      banded and with a full mask (the sweep behind the route rule).
      Prints an {"mcmc": ...} JSON line;
  (o) kernel (a), the DAG x DAG merge fill: small6 default and small6
      `-careful -norefine` in float64 with every merge of a sampled or
      posterior x forced onto the kernel, each byte-identical to (j)'s and
      (l)'s CPU run, kernel (a)'s launches equal to those merges' fills;
      then the main path's run, long12 default in float32 from (j)'s guide
      and tree on the automatic route (wall, merges and fills by route,
      kernel (a)'s launches, at least one and equal to FILLS["dag"], and
      ms) and with every such merge on fill.cpp (wall; whether the two
      outputs are equal is printed, not required: a sampled pick may turn
      at round-off); kernel (a) at that run's first sampled-x merge against
      fill.cpp (1e-9, the bit-equal share printed) and its plain version
      (1e-12 relative), its plan kernel against the plain plan: in-envelope
      cells, band cells, wavefronts, terms, the design, lanes a cell and
      blocks, the in-degrees (kx, ky, kx ky: mean and largest) and the
      terms read from the ring, ms and us a wavefront (the plan kernel and
      the fill, and each alone), the plain version's and fill.cpp's ms,
      the host plan's ms by part, the copies, the bound and both
      dependency floors (a state a lane; one thread a cell, the first
      design's); with `--parent DIR`, kernel (a) of that version and of
      this one at the same merge, in turns (historian_tpu_torch/
      dag_bench.py, roots.compare_roots), with each one's host plan; then
      both routes of whole ForwardMatrix builds at small6's first
      sampled-x merge and at long6's t1-t4 cut to 500-4000 aa (the sweep
      behind DAG_DEVICE_MIN_CELLS).  Prints a {"dagfill": ...} JSON line;
  (p) the mesh paths: kernel (g1), the sequence-parallel column fill, at
      1, 2, 4 and 8 shards on the card, bit-equal to K1 at long12's
      first-merge shape (full grid and banded) in float32 and float64 and
      on a DAG y in float64, timed beside K1, with its exchange bytes and
      bound, and against its plain version; by part (one strip, two, the
      48 with every edge a record and in the rule's clusters), each beside
      K1; `recon -fast` on small6 with
      HISTORIAN_SP=1 on four shards of the card == the CPU; `count` and
      `fit -maxiter 2` with `-mesh 1` on (j)'s long12 reconstruction ==
      the plain run (1e-9); `-mesh 2` raises; HISTORIAN_DIST=1 (a one-rank
      NCCL group) `count` and `mcmc -samples 1` == the plain run.  Prints
      a {"spcolforward": ...} JSON line;
  (q) the last four modules, each on its hand-written kernel (see
      `phase_pair_modules`): first each entry point once at full width,
      its launches counted from 0 (`tropical_pair_forward` on long12's
      t01 x t02 in float32, `SiblingMatrix.fill_batch` on bench.py:566's 16
      proposal grids, `sp_pair_forward` on long6's first two sequences at
      8 shards of the card and `sp_pair_forward_batch` on 8 headline pairs
      over 2 x 4, `pp_pair_forward_lp` on K3's headline batch at 4 stages,
      float64); then kernel (f) against its plain version on the pair's
      first 400 rows at all 6100 columns (float32, float64), at full size
      timed beside K4 with its first rows bit-equal to the cut's and
      lp_best <= K4's lp_end; kernel (d') against fill.cpp, kernel (d)
      (bit for bit) and its plain version, timed beside 16 fills on kernel
      (d) and on fill.cpp, its layout (clusters of strips) and us a
      diagonal; with `--parent DIR`, kernel (d') of that version and of
      this one on the 16 grids (pickled under build/bench_inputs/) in
      turns (sibling_bench.py --batch, SHA-256 of the cells); kernel
      (g2) at 1, 2, 4 and 8 shards against K4 (long6, f32; cut to 4095
      columns in f64), the full pair in f64
      against the 8-shard run, and against its plain version on the
      first 300 rows at all columns (at 1, 4 and 8 shards), the batch
      against K3; kernels (f) and (g2) at seven strip layouts (every
      edge a record, clusters of 4 to 16, 1 to 4 lanes a thread) on their
      pairs cut to 200 rows against their plain versions, each lanes a
      thread's layouts bit-equal, (g2)'s shard boundaries through pinned
      host memory equal to the card's own, and long8x12k's first pair
      (10979 x 11019) through (f) in float32 and float64 and (g2) at one
      shard against their plain versions on its first rows, timed at full
      size (see `phase_strips`); kernel (g3) at 2, 4 and 8 stages against
      K3 (the headline batch) and K4 (6 x 3000 x 3000) in float64 and its
      plain version, and on 4 stages at K4's long shape and long8x12k's
      first pair against its plain version on their first 64 rows at all
      columns, timed at full size (long8x12k's lp_end against (g2)'s);
      (g2)'s batch past what one launch holds (headline pairs), in waves,
      against K3.  Prints a {"pairmodules": ...} JSON line.
Prints the Felsenstein times, the readbacks, the branch fills, the MCMC
and kernel (a) as JSON lines, the kernel table as one JSON line, the card
line, and last {"ok": true, "device": {...}}.  Exits non-zero without
CUDA.  A kernel's `launches` sums the main-path runs that drive it, each
counted from 0: K1 in (e), (h) default, (j) long12 f32 and (l) long6 f32,
K2 in (h) fused and (l) small6 fused, the guide kernel in (h) fused, (j)
long12 f32 and (l) long6 f32, the walker in (e) and (j) long12 f32,
kernel (e) in (l) long6 f32 and (n) long6's run, by design (the ring's
line: (m)'s long6 Viterbi fill; the strips' line: (n)'s full-mask
Forward fill), kernel (d) and its plan kernel in (n) long6's run,
kernel (a) and its plan kernel in (o)'s long12 run on the automatic
route, kernel (g1) in (p)'s small6 run on four shards, kernels (f), (d'),
(g2) and (g3) in (q)'s main-path calls (their lines' ms, plain_ms and bound
at one shape each: (f) long12's t01 x t02 cut to 400 rows in float32,
(d') the 16 grids, (g2) long6's first pair cut to 300 rows at 8 shards
and (g3) 8 headline pairs at 4 stages, both float64).

Each kernel's `bound_ms` is the least time an H100 SXM could take for
the same work at the shape its `ms` was taken: the larger of the bytes
it must move (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (float32, outside the
tensor cores) or 34 TFLOP/s (float64).  Operations are counted from the
kernel's recurrence: each add, maximum or compare one operation, each
log-sum-exp five (maximum, difference, exp, log1p, add); kernel (d)'s
bytes are the band's 11 states written (88 B a cell) and its emission
and mask byte read (9 B), its operations 98 an in-mask cell; its plan
kernel's, the records written (48 B a cell slot of each diagonal) and
the band's emission and mask read; kernel
(a)'s bytes are the band's 5 states written (40 B a cell), each
in-envelope cell's plan entry read (8 B) and the per-state arrays (the
absorb factors among them), its operations DAG_OPS by each cell's
in-edges; its plan kernel's, the records (64 B a cell) and terms (32 B
each) written and the band and its source map (44 B a band cell) set.
Kernel (f)'s operations are TROPICAL_OPS_PER_CELL a cell; (g2)'s and
(g3)'s are K3's, and their bytes add the records or boundary rows
written and read once; (d')'s are kernel (d)'s over the padded grids'
cells written and the in-mask cells' operations.  No PyTorch
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
    """K1 against its plain version: a banded DAG y at 2048 x 2048, a chain
    y over the full grid at the shape of long12's first merge, and a
    banded chain y at that shape.  A banded case runs with the mask's
    lanes (timed; fewer than half the strips work in a column) and with
    every lane (checked).  The full grid must take more than one strip.
    Returns the largest error, the full-grid long12 float32 times, and the
    planes of the first two cases for the walker (float64, and float32 at
    long12's shape)."""
    SX, SY = long12_first_merge()
    err, times, walk_planes = 0.0, {}, {}
    for name, sx, sy, KY, banded in (("dag", 2048, 2048, 4, True),
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
    torch, then K1's plain version): a banded DAG y at 2048 x 2048 in
    float32 and float64, and a banded chain y at long12's first-merge
    shape, the main path's, in float32; fewer than half the strips may work
    in a column.
    Returns the largest error and the long12-shape times; the bound counts
    the recurrence on the in-band cells only (the others are NEG)."""
    SX, SY = long12_first_merge()
    err, times = 0.0, {}
    for name, sx, sy, KY in (("dag", 2048, 2048, 4), ("long12", SX, SY, 1)):
        for dtype in (torch.float32, torch.float64) if name == "dag" else (torch.float32,):
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


def write_small6(d: str, lengths=(240, 260, 280, 300, 320, 340), name="small6") -> str:
    """small6: the 6 sequences of tests/data/long6.fa cut to 240-340 aa (or
    to `lengths`, into `name`.fa)."""
    seqs = read_fasta(os.path.join(REPO, "tests", "data", "long6.fa"))
    fa = os.path.join(d, f"{name}.fa")
    with open(fa, "w") as f:
        for (seq_name, s), n in zip(seqs, lengths):
            f.write(f">{seq_name}\n{s[:n]}\n")
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
    from historian_tpu_torch.ops import branchdp, dagforward

    none_oversized("recon")
    return dict(colforward=colforward.LAUNCHES, colforward_fused=colforward.FUSED_LAUNCHES,
                pairtrace=tracedp.LAUNCHES, guidealign=guidedp.LAUNCHES,
                dagfill=dagforward.LAUNCHES, dagplan=dagforward.PLAN_LAUNCHES,
                branchfill=branchdp.LAUNCHES, branch_designs=dict(branchdp.DESIGNS),
                branch_modes=dict(branchdp.MODES), merges=dict(recon.MERGES),
                fills=dict(forward.FILLS), sampled=dict(forward.SAMPLED),
                branch_fills=dict(branchmatrix.FILLS))


def zero_counts(recon, forward, colforward, tracedp, guidedp) -> None:
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp, dagforward

    colforward.LAUNCHES = colforward.FUSED_LAUNCHES = tracedp.LAUNCHES = guidedp.LAUNCHES = 0
    branchdp.LAUNCHES = dagforward.LAUNCHES = dagforward.PLAN_LAUNCHES = 0
    for d in (recon.MERGES, forward.FILLS, forward.SAMPLED, branchmatrix.FILLS, branchdp.DESIGNS,
              branchdp.MODES):
        for k in d:
            d[k] = 0


def check_routes(what: str, counts: dict, log: list, fused: bool) -> None:
    """K1 (or K2) launches are the chain-x fills, the fills of a sampled x
    are kernel (a)'s launches and the host fills, and sampled walks were
    made."""
    chain, dag = sum(log), len(log) - sum(log)
    fill, other = (("colforward_fused", "colforward") if fused
                   else ("colforward", "colforward_fused"))
    if (counts[fill] != chain or counts[other] != 0 or counts["fills"]["device"] != chain
            or counts["fills"]["host"] + counts["fills"]["dag"] != dag or dag < 1
            or not counts["dagfill"] == counts["fills"]["dag"] == counts["dagplan"]
            or counts["sampled"]["device_walks"] < 1 or counts["pairtrace"] < 1):
        raise AssertionError(f"{what}: {chain} chain-x and {dag} sampled-x fills, counts {counts}")


def phase_default_recon(cli, colforward, tracedp, guidedp, work: str) -> dict:
    """(j) The default `recon` (sampled profiles, no -fast): small6 card f64
    == CPU f64 on the default and the fused route; then long12 with no tree
    and no profile flags on the card, default route (K1), in float32 and in
    float64 from the float32 run's guide and tree, whose `#=GF LP` must
    agree within F32_LP_DRIFT.  Each run's K1
    (K2) launches must equal its chain-x fills and its kernel (a) launches
    plus host fills the fills whose x is a sampled profile.  The float32 run's reconstruction
    and its guide stay in `work` (work/long12_f32.sto, work/long12_guide.sto)
    for phase (k).  Returns the float32 run's counts."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward

    counters = (recon, forward, colforward, tracedp, guidedp)
    runs = {}
    small = [write_small6(work)]
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
    return dict(runs["f32"][1], small6_cpu=cpu)


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
    first branch fill's arguments (its band layout and the host's emission,
    mask, ins and trans) and its first BranchMatrix's (the refine step's
    PWMs and envelope)."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward, quickalign
    from historian_tpu_torch.ops import branchdp, devicedp, readback
    from historian_tpu_torch.sampler import refiner

    counters = (recon, forward, colforward, tracedp, guidedp)
    caps = strip_capacities(colforward)
    print(f"(l) strips resident at once: {caps}", flush=True)
    rate = d2h_bytes_per_s()
    print(f"(l) card-to-host copy into pinned memory: {rate / 1e9:.2f} GB/s", flush=True)
    fa6 = write_small6(work)
    with tempfile.TemporaryDirectory() as d:
        dots = {p: os.path.join(d, f"{p}.dot") for p in ("cpu", "gpu")}
        cases = (("recon -careful -norefine", "recon", ["-careful", "-norefine", fa6], "0"),
                 ("recon -careful -norefine fused", "recon", ["-careful", "-norefine", fa6], "1"),
                 ("recon -profminpost 0.01 -savedot -dotpost 0.02", "recon",
                  ["-profminpost", "0.01", "-savedot", "{dot}", "-dotpost", "0.02", fa6], "0"),
                 ("count (unaligned)", "count", [fa6], "0"))
        k2, cpu_outs = 0, {}
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
            cpu_outs.setdefault(what, outs["cpu"])
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
        n_read, n_up = len(readback.READBACKS), len(branchdp.UPLOADS)
        devicedp.col_forward_cells = capture
        refiner.LAST.clear()
        t0 = time.perf_counter()
        try:
            with cuda_timed(quickalign, "guide_align") as guide_ev, \
                    cuda_timed(devicedp, "col_forward_planes") as k1_ev, \
                    first_call(branchdp, "upload_band") as branch_args, \
                    first_call(refiner, "BranchMatrix") as matrix_args, \
                    cuda_timed(branchdp, "branch_fill_band") as branch_ev, \
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
                                     if r["kind"] == "branch"], branchdp.UPLOADS[n_up:])
            branch_inputs = branch_args[0][:5]  # layout, emit, mask, ins, trans
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
        runs[dtype] = dict(lp=lp, out=out, counts=counts, wall=wall, guide_ms=guide_ms,
                           k1_ms=k1_ms,
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
                matrix_args=matrix_inputs, long6_recon=runs["f32"]["out"],
                small6_careful_cpu=cpu_outs["recon -careful -norefine"])


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


def refine_summary(last: dict, counts: dict, lp: float, branch_ev: list, reads: list,
                   uploads: list) -> dict:
    """The refiner's run in long6 `-careful` f32: steps, improvements, LP
    before and after, kernel (e)'s launches by design and ms, the band
    uploads and readbacks, the refiner's seconds by phase and its host
    seconds (its wall less the kernel's and the copies' ms).  Every step's
    fill must be on the card (a long6 branch is ~10^8 state-cells) with
    one upload and one readback, the written LP the refiner's last, and no
    lower than before it."""
    kernel_ms = [a.elapsed_time(b) for a, b in branch_ev]
    sec = last["seconds"]
    out = dict(steps=last["steps"], improvements=last["improvements"],
               lp_before=last["lp_before"], lp_after=last["lp_after"],
               launches=counts["branchfill"], designs=counts["branch_designs"],
               kernel_ms=sum(kernel_ms), kernel_ms_each=kernel_ms, readbacks=len(reads),
               readback_bytes=sum(r["bytes"] for r in reads),
               readback_ms=sum(r["ms"] for r in reads), uploads=len(uploads),
               upload_bytes=sum(u["bytes"] for u in uploads),
               upload_ms=sum(u["ms"] for u in uploads),
               upload_pack_ms=sum(u["pack_ms"] for u in uploads), seconds=sec)
    out["host_s"] = sec["total"] - (out["kernel_ms"] + out["readback_ms"]
                                    + out["upload_ms"]) / 1e3
    if not (counts["branchfill"] == last["steps"] == counts["branch_fills"]["device"]
            == len(reads) == len(uploads) and last["steps"] >= 10):
        raise AssertionError(f"long6 -careful: {last['steps']} refine steps, routes {counts}, "
                             f"{len(reads)} band readbacks, {len(uploads)} uploads")
    if f"{last['lp_after']:.6f}" != f"{lp:.6f}" or last["lp_after"] < last["lp_before"]:
        raise AssertionError(f"long6 -careful: LP {lp}, refiner {last}")
    print(f"(l) long6 -careful f32 refiner: {out['steps']} steps, {out['improvements']} "
          f"improvements, LP {out['lp_before']!r} -> {out['lp_after']!r}; kernel (e) "
          f"{out['launches']} launches {out['designs']}, {out['kernel_ms']:.1f} ms in all "
          f"({min(kernel_ms):.3f}-{max(kernel_ms):.3f} ms each); {len(uploads)} band uploads, "
          f"{out['upload_bytes']} bytes, copies {out['upload_ms']:.2f} ms, packing "
          f"{out['upload_pack_ms']:.1f} ms; {len(reads)} band readbacks, "
          f"{out['readback_bytes']} bytes in {out['readback_ms']:.2f} ms; refiner seconds "
          f"{ {k: round(v, 3) for k, v in sec.items()} }, host {out['host_s']:.2f} s", flush=True)
    for k, (r, u) in enumerate(zip(reads, uploads)):
        print(f"(l) long6 f32 refine step {k}: upload {u['bytes']} bytes, copy {u['ms']:.3f} ms, "
              f"packing {u['pack_ms']:.2f} ms; readback {r['cells']} cells, {r['bytes']} bytes "
              f"in {r['ms']:.3f} ms", flush=True)
    return out


def branch_host(args, viterbi: bool) -> tuple:
    """csrc/fill.cpp `branch_fill` on a branch fill's host arguments (emit,
    ins, mask, trans): (cells, ms)."""
    from historian_tpu_torch.native import get_native

    emit, ins, mask, trans = args
    cells = np.empty((*emit.shape, 3))
    t0 = time.perf_counter()
    get_native().branch_fill(emit.shape[0], emit.shape[1], np.ascontiguousarray(emit), ins,
                             np.ascontiguousarray(mask, dtype=np.uint8), trans, np.uint8(viterbi),
                             cells)
    return cells, (time.perf_counter() - t0) * 1e3


def branch_bound(layout, mask: np.ndarray, viterbi: bool) -> dict:
    """Kernel (e)'s bound on the band: each band cell's M, I, D written
    once (24 B) and its emission and mask byte read once (9 B), the rows'
    rowpos and off, the diagonals' (xa, xb), ins and trans read once;
    operations on the in-mask cells (a cell outside the mask is only
    stored).  Beside it the PR 11 form, which wrote the whole NEG grid."""
    X1, Y1 = layout.shape
    in_mask = int(mask.sum())
    n_bytes = (layout.n * (24 + 8 + 1) + 4 * X1 + 4 * (X1 + 1) + 8 * (X1 + Y1 - 1)
               + 8 * Y1 + 8 * 8)
    ops = in_mask * (BRANCH_VITERBI_OPS if viterbi else BRANCH_FORWARD_OPS)
    out = bound(n_bytes, ops, torch.float64)
    grid_bytes = mask.size * (1 + 3 * 8) + in_mask * 8 + 8 * Y1 + 8 * 8
    out["grid_bound_ms"] = grid_bytes / HBM_BYTES_PER_S * 1e3
    return out


def chain_step_ns(trans: np.ndarray, viterbi: bool) -> float:
    """The dependency floor's step: one Delete step of kernel (e)'s
    recurrence waiting on the one before (csrc/branchfill.cu
    `branchfill_chain`, one thread), in ns, from CUDA events around
    200000 steps, median of 3."""
    from historian_tpu_torch.ops import _kernels

    tr = torch.as_tensor(trans, dtype=torch.float64, device="cuda")
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    steps = 200_000

    def run():
        _kernels.check(_kernels.lib().branchfill_chain_f64(
            tr.data_ptr(), steps, int(viterbi), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "branchfill_chain")

    return cuda_ms_median(run, 3) * 1e6 / steps


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
ROUTE_SWEEP = (500_000, 1_000_000, 2_000_000, 4_000_000, 8_000_000)


def branch_routes(matrix_args) -> list:
    """A BranchMatrix end to end, Viterbi, on each route: the host's
    emission and mask, then the fill and the best traceback, on fill.cpp
    (HISTORIAN_DEVICE_BRANCH=0) or on the card (=1: the band's hull, its
    upload, kernel (e), its readback, the traceback through BandCells).
    At long6's first refine branch cut to n x n for
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


def phase_branch(cli, colforward, tracedp, guidedp, long6_args, matrix_args,
                 parent: str | None) -> dict:
    """(m) Kernel (e), the branch fill.  small6 `recon -careful` in float64
    on the card, once with HISTORIAN_DEVICE_BRANCH=1 (every refine step's
    fill on the kernel) and once on the automatic route (these small fills
    on the host), each byte-identical to the CPU run.  Then, at the first
    fill of the forced small6 run and at the first long6 fill of (l), in
    both modes: the full-grid entry `branch_fill` against its plain
    version (1e-12 relative) and against csrc/fill.cpp (Viterbi bit for
    bit, Forward 1e-12 relative), the band entry `branch_fill_band` on the
    uploaded band against fill.cpp at the band; the band entry's ms (CUDA
    events, median of 5 after a warm launch: the kernel alone) and us a
    diagonal, its design, the plain version's and fill.cpp's ms, the
    band's byte bound and the dependency floor.  Then both routes of a
    BranchMatrix around the route rule's threshold (`branch_routes`), and
    with `parent`, the parent's kernel (e) beside this one at long6's
    first fill (`branch_parent`)."""
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
            with first_call(branchdp, "upload_band") as small_args:
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
                small = small_args[0][:5]  # layout, emit, mask, ins, trans
            print(f"(m) small6 recon -careful f64, {route} branch route: card == cpu "
                  f"({len(gpu)} bytes, LP {stockholm_rows_lp(gpu)[1]}), {steps} refine steps, "
                  f"{refiner.LAST['improvements']} improvements, branch fills "
                  f"{counts['branch_fills']}, kernel (e) launches {counts['branchfill']} "
                  f"{counts['branch_designs']}", flush=True)
        del os.environ["HISTORIAN_DEVICE_BRANCH"]

    dev = torch.device("cuda")
    out = {}
    for name, (layout, emit, mask, ins, trans) in (("small6", small), ("long6", long6_args)):
        X1, Y1 = emit.shape
        K = X1 + Y1 - 1
        host_args = (emit, ins, mask, trans)
        args = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in host_args]
        band = branchdp.upload_band(layout, emit, mask, ins, trans, dev)
        idx = layout.flat_index()
        for viterbi in (True, False):
            mode = "viterbi" if viterbi else "forward"
            got = branchdp.branch_fill(*args, viterbi)
            torch.cuda.synchronize()
            plain, plain_ms = host_ms(lambda: branchdp.branch_fill_plain(*args, viterbi))
            err = branch_err(f"{name} {mode} kernel vs plain", got, plain)
            del plain
            host, fill_cpp_ms = branch_host(host_args, viterbi)
            got = got.cpu().numpy()
            before = dict(branchdp.DESIGNS)
            got_band = branchdp.branch_fill_band(band, viterbi).cpu().numpy()
            design = next(k for k in before if branchdp.DESIGNS[k] > before[k])
            host_band = host.reshape(-1, 3)[idx]
            if viterbi:
                if not (np.array_equal(got.view(np.uint64), host.view(np.uint64))
                        and np.array_equal(got_band.view(np.uint64), host_band.view(np.uint64))):
                    raise AssertionError(f"{name} viterbi: kernel cells differ from fill.cpp's")
                vs_host = "bit-equal (grid and band)"
            else:
                e_grid = branch_err(f"{name} forward vs fill.cpp", got, host)
                e_band = branch_err(f"{name} forward band vs fill.cpp", got_band, host_band)
                vs_host = f"max abs err {max(e_grid, e_band):.3e}"
            del got, host, got_band, host_band
            ms = cuda_ms_median(lambda: branchdp.branch_fill_band(band, viterbi))
            grid_ms = cuda_ms_median(lambda: branchdp.branch_fill(*args, viterbi))
            bnd = branch_bound(layout, mask, viterbi)
            step_ns = chain_step_ns(trans, viterbi)
            floor_ms = K * step_ns / 1e6
            print(f"(m) kernel (e) {name} {mode} {X1} x {Y1} ({int(mask.sum())} in-mask cells, "
                  f"{layout.n} band cells, widest diagonal {layout.widest}, {design} design): "
                  f"{ms:.3f} ms ({ms * 1e3 / K:.4f} us a diagonal over {K}), full-grid entry "
                  f"{grid_ms:.3f} ms, plain {plain_ms:.1f} ms, fill.cpp {fill_cpp_ms:.1f} ms; vs "
                  f"plain max abs err {err:.3e}, vs fill.cpp {vs_host}; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; the NEG grid's "
                  f"{bnd['grid_bound_ms']:.4f}), dependency floor {floor_ms:.3f} ms ({K} x "
                  f"{step_ns:.2f} ns)", flush=True)
            out[(name, mode)] = dict(ms=ms, us_per_diagonal=ms * 1e3 / K, grid_entry_ms=grid_ms,
                                     plain_ms=plain_ms, fill_cpp_ms=fill_cpp_ms, err=err,
                                     design=design, band_cells=layout.n,
                                     dependency_floor_ms=floor_ms, step_ns=step_ns, **bnd)
        del args, band
    main_path = out[("long6", "viterbi")]
    routes = branch_routes(matrix_args)
    line = {"branchfill": {f"{n} {m}": v for (n, m), v in out.items()}, "routes": routes}
    if parent:
        line["parent"] = branch_parent(parent, long6_args)
    print(json.dumps(line), flush=True)
    return dict(main_path, err=max(v["err"] for v in out.values()))


def branch_parent(parent: str, long6_args) -> dict:
    """Kernel (e) of the checkout in `parent` and of this one at long6's
    first refine fill, both modes: historian_tpu_torch/branch_bench.py in
    fresh processes, parent, this, this, parent (roots.compare_roots);
    returns each root's runs."""
    t_start = time.perf_counter()
    from historian_tpu_torch.roots import compare_roots

    _, emit, mask, ins, trans = long6_args
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "long6_branch.npz")
        np.savez(path, match_emit=emit, ins_emit=ins, mask=mask, trans=trans)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compare_roots(os.path.join(REPO, "historian_tpu_torch", "branch_bench.py"),
                          ["--inputs", path, "--reps", "5"], [parent, REPO], 2, "branch_bench")
    table = json.loads(buf.getvalue().splitlines()[-1])["compare"]
    for root, runs in table.items():
        tag = "parent" if root == os.path.abspath(parent) else "this"
        for r in runs:
            print(f"(m) kernel (e) at long6's first fill, {tag} ({root}): viterbi "
                  f"{r['viterbi_ms']:.3f} ms, forward {r['forward_ms']:.3f} ms (kernel alone, "
                  f"{r['design']}); wrapper {r['viterbi_wrapper_ms']:.3f} / "
                  f"{r['forward_wrapper_ms']:.3f} ms", flush=True)
    print(f"(m) the parent comparison took {time.perf_counter() - t_start:.1f} s", flush=True)
    return table


#: kernel (d), an in-mask cell of csrc/siblingfill.cu: 38 adds (31 transition
#: sums, 7 emissions) and 12 log-sum-exps (5 lists, 7 pairs)
SIBLING_OPS = 98
#: kernel (d) against fill.cpp: absolute, on the cells that are not -inf
#: (the same per-cell order; the card's exp and log against glibc's)
SIBLING_TOL = 1e-9
#: kernel (d) and fill.cpp against the plain version: relative, on the
#: cells that are not -inf.  The plain version follows the JAX package's
#: row scan, whose doubling steps along y associate the sums otherwise
#: than the per-cell order, and the drift grows with the row: the JAX scan
#: itself is 1.25e-9 from fill.cpp at 3000 columns (tests/sibling_drift.py).
#: At long6 (6000 columns, cells near -5e4) the plain version is ~1.2e-8
#: from the kernel and from fill.cpp alike, ~2e-13 relative, so 1e-9
#: absolute holds there against fill.cpp only
SIBLING_PLAIN_RTOL = 1e-12
#: strip heights at which (n) times the strip design at long6's full mask
SIBLING_STRIP_ROWS = (16, 32, 64)
#: MCMC samples a node in (n)'s runs
MCMC_SAMPLES = {"small": "3", "long6": "2"}


def sibling_host(args) -> tuple:
    """csrc/fill.cpp on a sibling fill's host arguments (match_emit, mask,
    l_emit, r_emit, tmat), through sampler/sibling.py `native_fill`: (cells
    [X+1, Y+1, 11], lp_end, the fill's ms, its -inf grid made before)."""
    from historian_tpu_torch.sampler.sibling import native_fill

    match, mask, l_emit, r_emit, tmat = args
    cells = np.full(match.shape + (11,), -np.inf)
    t0 = time.perf_counter()
    _, lp = native_fill(l_emit, r_emit, match, mask, tmat, cells)
    return cells, lp, (time.perf_counter() - t0) * 1e3


def sibling_err(what: str, got: np.ndarray, ref: np.ndarray, rtol: float = 0.0) -> float:
    """The same -inf cells, then SIBLING_TOL on the rest (with rtol: rtol
    relative to max(1, |ref|)); the largest absolute error."""
    if not np.array_equal(got == -np.inf, ref == -np.inf):
        raise AssertionError(f"{what}: the -inf cells differ")
    live = np.isfinite(ref)
    diff = np.abs(got[live] - ref[live])
    err = float(diff.max()) if live.any() else 0.0
    ok = (np.all(diff <= rtol * np.maximum(1.0, np.abs(ref[live]))) if rtol
          else err <= SIBLING_TOL)
    if not ok:
        raise AssertionError(f"{what}: off by {err}")
    return err


def band_of(mask: np.ndarray, hull=None):
    from historian_tpu_torch.ops import branchdp

    if hull is None:
        hull = (t.numpy() for t in branchdp.interior_hull(torch.from_numpy(mask)))
    return branchdp.band_layout(*hull, *mask.shape)


@contextlib.contextmanager
def watched_fills(check: tuple = (), keep: dict | None = None):
    """Every SiblingMatrix and BranchMatrix fill while the block runs, one
    record each: kind ("sibling", "branch"), its grid's and its mask's
    state-cells, whether the mask is full, the route it took ("device",
    "host") and, for a device fill of a kind in `check`, its largest
    absolute error against csrc/fill.cpp on the same host inputs, compared
    at the band (the same -inf cells; the rest within SIBLING_TOL, a branch
    fill's within BRANCH_RTOL; a sibling lp_end within SIBLING_TOL
    relative).  `keep` gets the host arguments of the first banded
    ("banded") and the first full-mask ("full") device sibling fill.
    Yields the list of records."""
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import siblingdp
    from historian_tpu_torch.sampler import sibling

    fills = []
    sib_fill, branch_fill = sibling.SiblingMatrix._fill, branchmatrix.BranchMatrix._fill_cells

    def record(kind, mask, device, err):
        states = 11 if kind == "sibling" else 3
        fills.append(dict(kind=kind, state_cells=mask.size * states,
                          in_mask=int(np.count_nonzero(mask)) * states, full=bool(mask.all()),
                          route="device" if device else "host", err=err))

    def sib(self):
        before = sibling.FILLS["device"]
        sib_fill(self)
        device, err = sibling.FILLS["device"] > before, None
        if device:
            args = (self.match_emit, self.mask, self.l_emit, self.r_emit,
                    siblingdp.transition_table(self))
            if keep is not None:
                keep.setdefault("full" if self.mask.all() else "banded", args)
            if "sibling" in check:
                host, lp, _ = sibling_host(args)
                err = sibling_err("sibling fill vs fill.cpp", self.cells.vals,
                                  host.reshape(-1, 11)[band_of(self.mask).flat_index()])
                if not abs(self.lp_end - lp) <= SIBLING_TOL * max(1.0, abs(lp)):
                    raise AssertionError(f"sibling fill lp_end {self.lp_end!r}, fill.cpp {lp!r}")
        record("sibling", self.mask, device, err)

    def branch(match_emit, ins_emit, mask, trans, viterbi, hull=None):
        before = branchmatrix.FILLS["device"]
        cells = branch_fill(match_emit, ins_emit, mask, trans, viterbi, hull)
        device, err = branchmatrix.FILLS["device"] > before, None
        if device and "branch" in check:
            host, _ = branch_host((match_emit, ins_emit, mask, trans), viterbi)
            err = branch_err("branch fill vs fill.cpp", cells.vals,
                             host.reshape(-1, 3)[band_of(mask, hull).flat_index()])
        record("branch", mask, device, err)
        return cells

    sibling.SiblingMatrix._fill = sib
    branchmatrix.BranchMatrix._fill_cells = staticmethod(branch)
    try:
        yield fills
    finally:
        sibling.SiblingMatrix._fill = sib_fill
        branchmatrix.BranchMatrix._fill_cells = staticmethod(branch_fill)


def fill_summary(fills: list) -> dict:
    """Of watched_fills' records: by kind, the fills on each route, the
    device fills with a full mask, the largest grid and mask in
    state-cells, and the largest error against fill.cpp."""
    out = {}
    for kind in ("sibling", "branch"):
        mine = [f for f in fills if f["kind"] == kind]
        errs = [f["err"] for f in mine if f["err"] is not None]
        out[kind] = dict(
            device=sum(f["route"] == "device" for f in mine),
            host=sum(f["route"] == "host" for f in mine),
            device_full=sum(f["route"] == "device" and f["full"] for f in mine),
            largest=max((f["state_cells"] for f in mine), default=0),
            largest_in_mask=max((f["in_mask"] for f in mine), default=0),
            checked=len(errs), err=max(errs, default=None))
    return out


def mcmc_counts() -> dict:
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp, siblingdp
    from historian_tpu_torch.sampler import sibling

    return dict(siblingfill=siblingdp.LAUNCHES, siblingplan=siblingdp.PLAN_LAUNCHES,
                sibling_designs=dict(siblingdp.DESIGNS), branchfill=branchdp.LAUNCHES,
                branch_designs=dict(branchdp.DESIGNS), branch_modes=dict(branchdp.MODES),
                sibling_fills=dict(sibling.FILLS), branch_fills=dict(branchmatrix.FILLS))


def zero_mcmc_counts() -> None:
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp, siblingdp
    from historian_tpu_torch.sampler import sibling

    siblingdp.LAUNCHES = siblingdp.PLAN_LAUNCHES = branchdp.LAUNCHES = 0
    for d in (siblingdp.DESIGNS, branchdp.DESIGNS, branchdp.MODES, sibling.FILLS,
              branchmatrix.FILLS):
        for k in d:
            d[k] = 0


def run_mcmc_cli(cli, args: list, trace_dir: str) -> tuple:
    """stdout and the -trace file of `mcmc <args> -trace trace_dir/trace`."""
    trace = os.path.join(trace_dir, "trace")
    out = run_cli(cli, [*args, "-trace", trace], "f64", "mcmc")
    with open(f"{trace}.1") as f:
        return out, f.read()


def small_mcmc(cli, d: str, sibling_args: dict) -> dict:
    """(n), small: `mcmc -samples 3 -seed 7` in float64 from FASTA on the
    CPU and on the card's automatic route, on small6 cut to 150-200 aa
    (small6 and small4 each have a sibling fill above the route rule's
    threshold): its fills all stay on the host, and its output and -trace
    file are byte-identical to the CPU's.  Then small6 on the CPU and with
    HISTORIAN_DEVICE_SIBLING=1 HISTORIAN_DEVICE_BRANCH=1 (every sibling and
    branch fill on kernels (d) and (e), launches equal to fills, each fill
    held against fill.cpp on the same inputs; whether the output still
    equals the CPU's is printed, not required: an MH decision may turn on
    the last bits)."""
    base = ["-samples", MCMC_SAMPLES["small"], "-seed", "7"]
    name = "small6 cut to 150-200 aa"
    inp = [write_small6(d, (150, 160, 170, 180, 190, 200), "small6-200")]
    sub = {p: os.path.join(d, f"{name}-{p}") for p in ("cpu", "auto")}
    for p in sub.values():
        os.makedirs(p, exist_ok=True)
    cpu = run_mcmc_cli(cli, ["-platform", "cpu", *base, *inp], sub["cpu"])
    zero_mcmc_counts()
    with watched_fills() as fills:
        auto = run_mcmc_cli(cli, ["-platform", "gpu", *base, *inp], sub["auto"])
    counts, seen = mcmc_counts(), fill_summary(fills)
    if auto != cpu:
        raise AssertionError(f"(n) {name} mcmc f64 automatic route: the card's output or "
                             f"-trace file differs from the CPU's")
    if counts["siblingfill"] or counts["branchfill"] or counts["sibling_fills"]["device"] \
            or counts["branch_fills"]["device"]:
        raise AssertionError(f"(n) {name} automatic route took the card: {counts}")
    print(f"(n) {name} mcmc -samples {MCMC_SAMPLES['small']} f64, automatic route: card == cpu "
          f"(output {len(auto[0])} bytes, LP {stockholm_rows_lp(auto[0])[1]}, -trace "
          f"{len(auto[1])} bytes); fills {seen}, routes {counts['sibling_fills']} "
          f"{counts['branch_fills']}", flush=True)
    auto_name = name
    name, inp = "small6", [write_small6(d)]
    sub = {p: os.path.join(d, f"small6-{p}") for p in ("cpu", "forced")}
    for p in sub.values():
        os.makedirs(p, exist_ok=True)
    cpu = run_mcmc_cli(cli, ["-platform", "cpu", *base, *inp], sub["cpu"])
    os.environ["HISTORIAN_DEVICE_SIBLING"] = os.environ["HISTORIAN_DEVICE_BRANCH"] = "1"
    try:
        zero_mcmc_counts()
        with watched_fills(("sibling", "branch"), sibling_args) as fills:
            forced = run_mcmc_cli(cli, ["-platform", "gpu", *base, *inp], sub["forced"])
        counts, seen = mcmc_counts(), fill_summary(fills)
    finally:
        del os.environ["HISTORIAN_DEVICE_SIBLING"], os.environ["HISTORIAN_DEVICE_BRANCH"]
    if (any(f["route"] != "device" or f["err"] is None for f in fills)
            or counts["siblingfill"] != seen["sibling"]["device"]
            or counts["branchfill"] != seen["branch"]["device"] or not counts["siblingfill"]
            or not counts["branchfill"]):
        raise AssertionError(f"(n) {name} forced route: {counts}, fills {seen}")
    same = forced == cpu
    print(f"(n) {name} mcmc f64, HISTORIAN_DEVICE_SIBLING=1 HISTORIAN_DEVICE_BRANCH=1: kernel "
          f"(d) {counts['siblingfill']} launches = sibling fills {counts['sibling_fills']}, "
          f"kernel (e) {counts['branchfill']} launches = branch fills {counts['branch_fills']} "
          f"{counts['branch_designs']} {counts['branch_modes']}; every fill within "
          f"{max(f['err'] for f in fills):.3e} of fill.cpp (same -inf cells); output "
          f"{'equals' if same else 'DIFFERS FROM'} the CPU's (LP {stockholm_rows_lp(forced[0])[1]}"
          f" against {stockholm_rows_lp(cpu[0])[1]})", flush=True)
    return dict(name=name, auto_name=auto_name, forced_equal=same,
                sibling_err=seen["sibling"]["err"], branch_err=seen["branch"]["err"])


def sibling_kernel_check(name: str, args, strip_rows=()) -> dict:
    """Kernel (d) at one fill: its band uploaded (bytes, copy ms), the band
    entry against fill.cpp (the bit-equal share printed) and against the
    plain version, and the plain version against fill.cpp; the design it
    took (lanes a cell, blocks and threads, the ring's slots or the strips);
    in the ring design the plan kernel against the plain plan (byte for
    byte) and each one's ms, and the fill alone; the kernel's ms (CUDA
    events, median of 5 after a warm launch) and us a diagonal, the plain
    version's and fill.cpp's ms, the band read back (bytes, ms), the bound
    and both dependency floors (a lane group a cell, this design's; one
    thread a cell, the first design's); and at each of `strip_rows`, the
    strip design's ms with strips of that height, its cells equal to the
    first launch's bit for bit."""
    from historian_tpu_torch.ops import readback, siblingdp

    match, mask, l_emit, r_emit, tmat = args
    X1, Y1 = match.shape
    K = X1 + Y1 - 1
    lay = band_of(mask)
    idx = lay.flat_index()
    dev = torch.device("cuda")
    inp = siblingdp.upload_band(lay, match, mask, l_emit, r_emit, tmat, dev)
    up = siblingdp.UPLOADS[-1]
    cells, lp = siblingdp.sibling_fill_band(inp)
    launch = dict(siblingdp.LAST_LAUNCH)
    n_read = len(readback.READBACKS)
    got, lp_end = siblingdp.read_band(cells, lp, lay)
    got = got.vals
    back = readback.READBACKS[n_read]
    host, host_lp, fill_cpp_ms = sibling_host(args)
    ref = host.reshape(-1, 11)[idx]
    del host
    err = sibling_err(f"{name} kernel (d) vs fill.cpp", got, ref)
    live = np.isfinite(got)
    bit_equal = float(np.mean(got[live] == ref[live]))
    if not abs(lp_end - host_lp) <= SIBLING_TOL * abs(host_lp):
        raise AssertionError(f"{name}: kernel (d) lp_end {lp_end!r}, fill.cpp {host_lp!r}")
    (plain, plain_lp), plain_ms = host_ms(lambda: siblingdp.sibling_fill_band_plain(inp))
    plain, plain_lp = plain.cpu().numpy(), plain_lp.item()
    plain_err = sibling_err(f"{name} kernel (d) vs plain", got, plain, SIBLING_PLAIN_RTOL)
    plain_host_err = sibling_err(f"{name} plain vs fill.cpp", plain, ref, SIBLING_PLAIN_RTOL)
    for what, a, b in (("kernel", lp_end, plain_lp), ("fill.cpp", host_lp, plain_lp)):
        if not abs(a - b) <= SIBLING_PLAIN_RTOL * abs(host_lp):
            raise AssertionError(f"{name}: plain lp_end {b!r}, {what} {a!r}")
    del got, ref, plain
    plan, plan_line = {}, "no plan (strip design)"
    if launch["design"] == "ring":
        planned = siblingdp.plan_records(inp)
        want, plain_plan_ms = host_ms(lambda: siblingdp.plan_records_plain(
            inp, launch["width"], launch["ring_rows"]))
        if not torch.equal(planned, want):
            raise AssertionError(f"{name}: the plan kernel's records differ from the plain plan's")
        del want
        plan_bytes = planned.numel() + lay.n * 9 + 8 * (X1 + Y1) + 4 * (2 * X1 + 1) + 8 * K
        plan = dict(plan_kernel_ms=cuda_ms_median(lambda: siblingdp.plan_records(inp)),
                    fill_ms=cuda_ms_median(lambda: siblingdp.sibling_fill_band(inp, planned)),
                    plain_plan_ms=plain_plan_ms, plan_bytes=int(planned.numel()),
                    plan_bound=bound(plan_bytes, 0.0, torch.float64))
        del planned
        plan_line = (f"plan kernel == plain plan ({plan['plan_bytes']} bytes of records): plan "
                     f"kernel {plan['plan_kernel_ms']:.3f} ms (bound "
                     f"{plan['plan_bound']['bound_ms']:.4f}), fill alone {plan['fill_ms']:.3f} ms, "
                     f"plain plan {plain_plan_ms:.1f} ms")
    ms = cuda_ms_median(lambda: siblingdp.sibling_fill_band(inp))
    heights = {}
    for H in strip_rows:
        other, other_lp = siblingdp.sibling_fill_band(inp, design="strip", strip_rows=H)
        if not (torch.equal(other, cells) and torch.equal(other_lp, lp)):
            raise AssertionError(f"{name}: strips of {H} rows differ from the first launch")
        del other
        heights[H] = dict(ms=cuda_ms_median(
            lambda: siblingdp.sibling_fill_band(inp, design="strip", strip_rows=H)),
            blocks=siblingdp.LAST_LAUNCH["blocks"], strips=siblingdp.LAST_LAUNCH["strips"])
    del cells
    in_mask = int(mask.sum())
    n_bytes = (lay.n * (88 + 8 + 1) + 8 * (X1 + Y1) + 144 * 8 + 4 * (2 * X1 + 1)
               + 8 * K)
    bnd = bound(n_bytes, in_mask * SIBLING_OPS, torch.float64)
    step_ns, first_step_ns = sibling_chain_ns(tmat, True), sibling_chain_ns(tmat, False)
    floor_ms, first_floor_ms = K * step_ns / 1e6, K * first_step_ns / 1e6
    shape = (f"{launch['blocks']} block(s) of {launch['threads']}, "
             + (f"{launch['width']} slots a diagonal, ring rows {launch['ring_rows']}"
                if launch["design"] == "ring" else
                f"{launch['strips']} strips of {launch['strip_rows']} rows"))
    swept = "; ".join(f"strips of {H}: {h['ms']:.3f} ms ({h['ms'] * 1e3 / K:.3f} us a diagonal, "
                      f"{h['strips']} strips, {h['blocks']} blocks)" for H, h in heights.items())
    print(f"(n) kernel (d) {name} {X1} x {Y1} ({in_mask} in-mask cells, {lay.n} band cells, "
          f"widest diagonal {lay.widest}; {launch['design']} design, {launch['lanes']} lanes a "
          f"cell, {shape}): {ms:.3f} ms ({ms * 1e3 / K:.3f} us a diagonal over {K}), plain "
          f"{plain_ms:.1f} ms, fill.cpp {fill_cpp_ms:.1f} ms; max abs err {err:.3e} against "
          f"fill.cpp (cells bit-equal: {bit_equal:.6f}), {plain_err:.3e} against plain; plain "
          f"against fill.cpp {plain_host_err:.3e}; {plan_line}; upload {up['bytes']} bytes in "
          f"{up['ms']:.3f} ms (packing {up['pack_ms']:.1f} ms), readback {back['bytes']} bytes "
          f"in {back['ms']:.3f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"dependency floor {floor_ms:.3f} ms ({K} x {step_ns:.1f} ns, a lane group a cell), "
          f"the first design's {first_floor_ms:.3f} ms ({K} x {first_step_ns:.1f} ns, one thread "
          f"a cell){'; ' + swept if swept else ''}", flush=True)
    return dict(ms=ms, us_per_diagonal=ms * 1e3 / K, plain_ms=plain_ms, fill_cpp_ms=fill_cpp_ms,
                err=max(err, plain_err), fill_cpp_err=err, plain_err=plain_err,
                plain_fill_cpp_err=plain_host_err, bit_equal_share=bit_equal, band_cells=lay.n,
                in_mask=in_mask, widest=lay.widest, diagonals=K, launch=launch,
                upload_bytes=up["bytes"], upload_ms=up["ms"], readback_bytes=back["bytes"],
                readback_ms=back["ms"], dependency_floor_ms=floor_ms, step_ns=step_ns,
                first_design_floor_ms=first_floor_ms, first_design_step_ns=first_step_ns,
                strip_heights=heights, **plan, **bnd)


def sibling_chain_ns(tmat: np.ndarray, split: bool) -> float:
    """A dependency floor's step, in ns, from CUDA events around 20000 steps,
    median of 3 (csrc/siblingfill.cu): `split`, this design's, a lane group
    computing one cell from the one before through shared memory
    (`siblingfill_chain_split`); else the first design's, one thread a
    cell's ~12 log-sum-exps in a row (`siblingfill_chain`)."""
    from historian_tpu_torch.ops import _kernels

    t = torch.as_tensor(tmat.reshape(-1), dtype=torch.float64, device="cuda")
    out = torch.empty(11, dtype=torch.float64, device="cuda")
    steps = 20_000

    def run():
        _kernels.check(_kernels.lib().siblingfill_chain_f64(
            t.data_ptr(), steps, int(split), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "siblingfill_chain")

    return cuda_ms_median(run, 3) * 1e6 / steps


def sibling_parent(parent: str, fills: dict) -> dict:
    """Kernel (d) of the checkout in `parent` and of this one at each fill
    (name: its host inputs, pickled): historian_tpu_torch/sibling_bench.py
    in fresh processes, parent, this, this, parent (roots.compare_roots),
    each run's ms (and, in the ring design, the plan kernel's and the fill's
    alone), its design and a hash of its cells; returns each fill's table
    and whether both versions' cells were the same bits."""
    t_start = time.perf_counter()
    import pickle

    from historian_tpu_torch.roots import compare_roots

    out = {}
    for name, args in fills.items():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "sibling_fill.pkl")
            with open(path, "wb") as f:
                pickle.dump(tuple(args), f, protocol=4)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                compare_roots(os.path.join(REPO, "historian_tpu_torch", "sibling_bench.py"),
                              ["--inputs", path, "--reps", "5"], [parent, REPO], 2,
                              "sibling_bench")
        table = json.loads(buf.getvalue().splitlines()[-1])["compare"]
        digests = {r["cells_sha256"] for runs in table.values() for r in runs}
        for root, runs in table.items():
            tag = "parent" if root == os.path.abspath(parent) else "this"
            for r in runs:
                extra = (f" = plan kernel {r['plan_kernel_ms']:.3f} + fill {r['fill_ms']:.3f}"
                         if "fill_ms" in r else "")
                print(f"(n) kernel (d) at {name}, {tag} ({root}): {r['kernel_ms']:.3f} ms{extra} "
                      f"({r['kernel_ms'] * 1e3 / r['diagonals']:.3f} us a diagonal; "
                      f"{json.dumps(r['launch'])})", flush=True)
        print(f"(n) kernel (d) at {name}: the parent's cells and this one's the same bits: "
              f"{len(digests) == 1}", flush=True)
        out[name] = dict(runs=table, same_bits=len(digests) == 1)
    print(f"(n) the parent comparison took {time.perf_counter() - t_start:.1f} s", flush=True)
    return out


def branch_forward_check(name: str, args, main: bool = False) -> dict:
    """Kernel (e) in Forward mode at an MCMC branch fill (layout, emit,
    mask, ins, trans): against fill.cpp, its ms (median of 5), us a
    diagonal, the design and its layout, and the ratio to the dependency
    floor.  With `main` (the full-mask fill, the strip design's kernel
    line) also the same inputs in Viterbi mode, against fill.cpp bit for
    bit and timed, the plain version's ms and the kernel against it, and
    the bound."""
    from historian_tpu_torch.ops import branchdp

    layout, emit, mask, ins, trans = args
    band = branchdp.upload_band(layout, emit, mask, ins, trans, torch.device("cuda"))
    got = branchdp.branch_fill_band(band, False)
    launch = dict(branchdp.LAST_LAUNCH)
    host, fill_cpp_ms = branch_host((emit, ins, mask, trans), False)
    idx = layout.flat_index()
    err = branch_err(f"{name} forward vs fill.cpp", got.cpu().numpy(), host.reshape(-1, 3)[idx])
    del host
    ms = cuda_ms_median(lambda: branchdp.branch_fill_band(band, False))
    K = sum(emit.shape) - 1
    step_ns = chain_step_ns(trans, False)
    floor_ms = K * step_ns / 1e6
    print(f"(n) kernel (e) Forward at {name} {emit.shape[0]} x {emit.shape[1]} ({layout.n} band "
          f"cells, {launch['design']} design {launch}): {ms:.3f} ms ({ms * 1e3 / K:.4f} us a "
          f"diagonal), {ms / floor_ms:.2f} x the dependency floor {floor_ms:.3f} ms ({K} x "
          f"{step_ns:.2f} ns); fill.cpp {fill_cpp_ms:.1f} ms, max abs err {err:.3e}", flush=True)
    out = dict(ms=ms, us_per_diagonal=ms * 1e3 / K, design=launch["design"], launch=launch,
               fill_cpp_ms=fill_cpp_ms, err=err, dependency_floor_ms=floor_ms,
               floor_ratio=ms / floor_ms)
    if not main:
        return out
    plain, plain_ms = host_ms(lambda: branchdp.branch_fill_band_plain(band, False))
    plain_err = branch_err(f"{name} forward vs plain", got, plain)
    del plain, got
    vit = branchdp.branch_fill_band(band, True).cpu().numpy()
    host, vit_cpp_ms = branch_host((emit, ins, mask, trans), True)
    if not np.array_equal(vit.view(np.uint64), host.reshape(-1, 3)[idx].view(np.uint64)):
        raise AssertionError(f"(n) {name} viterbi: kernel (e) cells differ from fill.cpp's")
    del vit, host
    vit_ms = cuda_ms_median(lambda: branchdp.branch_fill_band(band, True))
    vit_floor_ms = K * chain_step_ns(trans, True) / 1e6
    bnd = branch_bound(layout, mask, False)
    print(f"(n) kernel (e) Viterbi at {name}, the same inputs ({branchdp.LAST_LAUNCH}): "
          f"{vit_ms:.3f} ms ({vit_ms * 1e3 / K:.4f} us a diagonal), {vit_ms / vit_floor_ms:.2f} x "
          f"its dependency floor {vit_floor_ms:.3f} ms; bit-equal to fill.cpp ({vit_cpp_ms:.1f} "
          f"ms); Forward's plain version {plain_ms:.1f} ms, max abs err {plain_err:.3e}; bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    out.update(viterbi_ms=vit_ms, viterbi_dependency_floor_ms=vit_floor_ms,
               viterbi_fill_cpp_ms=vit_cpp_ms, viterbi_launch=dict(branchdp.LAST_LAUNCH),
               plain_ms=plain_ms, plain_err=plain_err, **bnd)
    return out


#: where chip_smoke.py --parent leaves the inputs of its P C C P benches
#: (build/ is not committed), for branch_bench.py and sibling_bench.py
BENCH_INPUTS = os.path.join(REPO, "build", "bench_inputs")


def branch_strip_parent(parent: str, args) -> dict:
    """Kernel (e) of the checkout in `parent` and of this one at long6
    `mcmc`'s full-mask Forward fill, both modes: its inputs saved to
    BENCH_INPUTS/long6_full_branch.npz, then historian_tpu_torch/
    branch_bench.py in fresh processes, parent, this, this, parent
    (roots.compare_roots), with a SHA-256 of each mode's cells; returns
    each root's runs and whether all bits agree."""
    t_start = time.perf_counter()
    from historian_tpu_torch.roots import compare_roots

    _, emit, mask, ins, trans = args
    os.makedirs(BENCH_INPUTS, exist_ok=True)
    path = os.path.join(BENCH_INPUTS, "long6_full_branch.npz")
    np.savez(path, match_emit=emit, ins_emit=ins, mask=mask, trans=trans)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        compare_roots(os.path.join(REPO, "historian_tpu_torch", "branch_bench.py"),
                      ["--inputs", path, "--reps", "5"], [parent, REPO], 2, "branch_bench")
    table = json.loads(buf.getvalue().splitlines()[-1])["compare"]
    digests = set()
    for root, runs in table.items():
        tag = "parent" if root == os.path.abspath(parent) else "this"
        for r in runs:
            digests.add((r["viterbi_sha256"], r["forward_sha256"]))
            print(f"(n) kernel (e) at long6's full-mask fill, {tag} ({root}): viterbi "
                  f"{r['viterbi_ms']:.3f} ms, forward {r['forward_ms']:.3f} ms (kernel alone, "
                  f"{r['design']} {r['forward_launch']}); wrapper {r['viterbi_wrapper_ms']:.3f} / "
                  f"{r['forward_wrapper_ms']:.3f} ms", flush=True)
    print(f"(n) kernel (e) at long6's full-mask fill: the parent's cells and this one's the same "
          f"bits in both modes: {len(digests) == 1}; the comparison took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(runs=table, same_bits=len(digests) == 1)


@contextlib.contextmanager
def captured_samplers():
    """Sampler.run wrapped to keep the samplers it ran: yields the list."""
    from historian_tpu_torch.sampler import sampler as sampler_mod

    run = sampler_mod.Sampler.run
    box = []

    def keep(samplers, *args, **kw):
        box.extend(samplers)
        return run(samplers, *args, **kw)

    sampler_mod.Sampler.run = staticmethod(keep)
    try:
        yield box
    finally:
        sampler_mod.Sampler.run = staticmethod(run)


@contextlib.contextmanager
def branch_uploads(keep: dict):
    """branchdp.upload_band wrapped to keep the first Forward upload's host
    arguments of each design (ring, wide) in keep."""
    from historian_tpu_torch.ops import branchdp

    fn = branchdp.upload_band

    def up(layout, emit, mask, ins, trans, device):
        keep.setdefault(layout.design(), (layout, emit, mask, ins, trans))
        return fn(layout, emit, mask, ins, trans, device)

    branchdp.upload_band = up
    try:
        yield
    finally:
        branchdp.upload_band = fn


def direct_proposals(sampler, fills: list) -> list:
    """One proposal of each alignment move on the long6 chain's history from
    a seeded mt19937, so that kernel (d) banded (node-align) and full-mask
    (prune-and-regraft), and kernel (e) Forward in the ring (branch-align)
    and the strip design (the full-mask branches) run at full width whatever
    the chain drew: each move's seed is the first of 1..8 whose proposal
    launches what the move is there for.  `fills`: watched_fills' list."""
    from historian_tpu_torch.ops import branchdp
    from historian_tpu_torch.utils.rng import MT19937

    history, lp = sampler.current_history, sampler.current_lp
    out = []
    for move in ("_branch_align_move", "_node_align_move", "_prune_regraft_move"):
        for seed in range(1, 9):
            designs, n = dict(branchdp.DESIGNS), len(fills)
            t0 = time.perf_counter()
            m = getattr(sampler, move)(history, lp, MT19937(seed))
            sec = time.perf_counter() - t0
            ring = branchdp.DESIGNS["ring"] - designs["ring"]
            strip = branchdp.DESIGNS["strip"] - designs["strip"]
            sib = [f["full"] for f in fills[n:] if f["kind"] == "sibling" and f["route"] == "device"]
            done = {"_branch_align_move": ring > 0,
                    "_node_align_move": not all(sib) and strip > 0,
                    "_prune_regraft_move": any(sib) and strip > 0}[move]
            print(f"(n) long6 {move.strip('_')} from seed {seed}: {sec:.2f} s, kernel (d) "
                  f"{len(sib)} launches ({sum(sib)} full-mask), kernel (e) ring {ring} strip "
                  f"{strip}, {'bypassed ' + m.comment if m.nullified else m.comment or 'proposed'}"
                  f", log accept {m.log_accept_prob:.3f}", flush=True)
            out.append(dict(move=move, seed=seed, seconds=sec, sibling=len(sib),
                            sibling_full=sum(sib), ring=ring, strip=strip, nullified=m.nullified))
            if done:
                break
        else:
            raise AssertionError(f"(n) long6 {move}: no seed of 1..8 launched its kernels")
    return out


#: the cuts n x n of the long6 node-align proposal's SiblingMatrix at which
#: sibling_routes times both routes, around the route rule's 1.0e6 in-mask
#: state-cells: under its guide envelope (0.7e6 at 1400, 1.0e6 at 2100,
#: 1.5e6 at 3000), and with a full mask (0.6e6 at 240, 1.0e6 at 301;
#: fill.cpp's OpenMP wavefront starts between 240 and 270)
SIBLING_ROUTE_CUTS = {"banded": (1400, 2100, 3000), "full": (240, 301)}


def sibling_routes(matrix_args) -> list:
    """A SiblingMatrix end to end on each route: the host's emission and
    mask, the fill and one sampled path, on fill.cpp
    (HISTORIAN_DEVICE_SIBLING=0) or on the card (=1: the band's hull, its
    upload, kernel (d), its readback, the traceback through BandCells).  At
    the long6 node-align proposal's matrix cut to n x n at each of
    SIBLING_ROUTE_CUTS, banded and under an uninitialised envelope (a full
    mask); the routes alternate, 3 times each, median wall ms.  Whether the
    two routes sampled the same path from one seed is printed (the cells
    differ in the last bits), and the route the rule takes."""
    from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu_torch.sampler.sibling import SiblingMatrix
    from historian_tpu_torch.utils.rng import MT19937

    model, l_pwm, r_pwm, l_dist, r_dist, env, l_pos, r_pos, *rows = matrix_args
    out = []
    for kind, cuts in SIBLING_ROUTE_CUTS.items():
        for n in cuts:
            nx, ny = min(n, len(l_pwm)), min(n, len(r_pwm))
            args = (model, l_pwm[:nx], r_pwm[:ny], l_dist, r_dist,
                    env if kind == "banded" else GuideAlignmentEnvelope(), l_pos[:nx + 1],
                    r_pos[:ny + 1], *rows)
            ms, paths = {"host": [], "device": []}, {}
            for _ in range(3):
                for route, flag in (("host", "0"), ("device", "1")):
                    os.environ["HISTORIAN_DEVICE_SIBLING"] = flag
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = SiblingMatrix(*args)
                    paths[route] = m.sample(MT19937(5))
                    torch.cuda.synchronize()
                    ms[route].append((time.perf_counter() - t0) * 1e3)
            del os.environ["HISTORIAN_DEVICE_SIBLING"]
            same = all(np.array_equal(paths["host"][r], paths["device"][r])
                       for r in paths["host"])
            row = dict(mask=kind, x=nx, y=ny, state_cells=(nx + 1) * (ny + 1) * 11,
                       in_mask_state_cells=int(np.count_nonzero(m.mask)) * 11,
                       rule="device" if m._want_device() else "host",
                       host_ms=float(np.median(ms["host"])),
                       device_ms=float(np.median(ms["device"])), same_path=same)
            print(f"(n) SiblingMatrix + sample, long6 node-align cut to {nx} x {ny}, {kind} "
                  f"({row['state_cells']} state-cells, {row['in_mask_state_cells']} in the "
                  f"mask: the rule takes the {row['rule']}): fill.cpp route "
                  f"{row['host_ms']:.2f} ms, kernel (d) route {row['device_ms']:.2f} ms (medians "
                  f"of 3: {[round(t, 2) for t in ms['host']]}, "
                  f"{[round(t, 2) for t in ms['device']]}); "
                  f"{'the same' if same else 'another'} sampled path", flush=True)
            out.append(row)
    return out


def phase_mcmc(cli, long6_recon: str, parent: str | None) -> dict:
    """(n) MCMC (`mcmc`, sampler/sampler.py) with kernel (d), the sibling
    fill, and kernel (e) in Forward mode.  `small_mcmc` (small6 on the CPU,
    the card's automatic and forced routes); kernel (d) at small6's
    node-align fill against its plain version and fill.cpp.  Then the main
    path's run, `mcmc -stockrecon <long6 float32 reconstruction> -samples 2
    -seed 7` on the card, its counts from 0: wall, steps, proposals,
    accepts and seconds by move type, fills on each route, kernel (d)'s
    launches and kernel (e)'s by mode and design, uploads and readbacks,
    peak device and host memory; it must launch both kernels.  Then, the
    counts from 0 again, one proposal of each alignment move on its history
    (`direct_proposals`), and kernel (d) at a long6 banded node-align fill
    and a full-mask prune-and-regraft fill against its plain version and
    fill.cpp, with the strip design's heights swept at the full mask
    (`sibling_kernel_check`), kernel (e) Forward at a ring and a wide MCMC
    fill, and both routes of the node-align proposal's SiblingMatrix around
    the route rule (`sibling_routes`).  With `parent`, kernel (d) of that
    checkout beside this one at both long6 fills (`sibling_parent`).  The
    kernel line's launches are the long6 run's."""
    from historian_tpu_torch.ops import branchdp, readback, siblingdp
    from historian_tpu_torch.sampler.sampler import MOVE_NAMES
    from historian_tpu_torch.sampler.sibling import SiblingMatrix

    small_args = {}
    with tempfile.TemporaryDirectory() as d:
        small = small_mcmc(cli, d, small_args)
    checks = {f"{small['name']} node-align": sibling_kernel_check(
        f"{small['name']} node-align", small_args["banded"])}
    del small_args

    work = tempfile.mkdtemp()
    path = os.path.join(work, "long6_recon.sto")
    with open(path, "w") as f:
        f.write(long6_recon)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_read, n_up = len(readback.READBACKS), (len(siblingdp.UPLOADS), len(branchdp.UPLOADS))
    long6_branch = {}
    zero_mcmc_counts()
    t0 = time.perf_counter()
    with captured_samplers() as samplers, peak_host_memory() as host_mem, \
            branch_uploads(long6_branch), watched_fills() as fills:
        out = run_cli(cli, ["-platform", "gpu", "-stockrecon", path, "-samples",
                            MCMC_SAMPLES["long6"], "-seed", "7"], "f32", "mcmc")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = mcmc_counts()
    peak_dev = torch.cuda.max_memory_allocated()
    os.remove(path)
    os.rmdir(work)
    s = samplers[0]
    steps = sum(s.moves_proposed)
    rows, lp = stockholm_rows_lp(out)
    if len(rows) != 11 or not math.isfinite(lp) or steps != 2 * 11:
        raise AssertionError(f"(n) long6 mcmc: {len(rows)} rows, LP {lp}, {steps} steps")
    if not (run_counts["siblingfill"] and run_counts["branch_modes"]["forward"]
            and run_counts["branch_designs"]["strip"]
            and run_counts["siblingplan"] == run_counts["sibling_designs"]["ring"]):
        raise AssertionError(f"(n) long6 mcmc did not launch kernels (d) and (e): {run_counts}")
    seen = fill_summary(fills)
    moves = {MOVE_NAMES[k]: dict(proposed=s.moves_proposed[k], accepted=s.moves_accepted[k],
                                 seconds=s.move_seconds[k]) for k in range(5)}
    reads = readback.READBACKS[n_read:]
    sib_up, br_up = siblingdp.UPLOADS[n_up[0]:], branchdp.UPLOADS[n_up[1]:]
    print(f"(n) long6 mcmc -samples {MCMC_SAMPLES['long6']} -seed 7 on the card (the main path): "
          f"wall {wall:.2f} s, {steps} steps, LP {lp}; moves {moves}; sibling fills "
          f"{run_counts['sibling_fills']}, branch fills {run_counts['branch_fills']}, by mask "
          f"{seen}; kernel (d) {run_counts['siblingfill']} launches "
          f"{run_counts['sibling_designs']} (plan kernel {run_counts['siblingplan']}), kernel (e) "
          f"{run_counts['branchfill']} launches {run_counts['branch_modes']} "
          f"{run_counts['branch_designs']}; uploads sibling "
          f"{len(sib_up)} ({sum(u['bytes'] for u in sib_up)} bytes, "
          f"{sum(u['ms'] for u in sib_up):.2f} ms), branch {len(br_up)} "
          f"({sum(u['bytes'] for u in br_up)} bytes, {sum(u['ms'] for u in br_up):.2f} ms); "
          f"readbacks sibling {sum(r['kind'] == 'sibling' for r in reads)} "
          f"({sum(r['bytes'] for r in reads if r['kind'] == 'sibling')} bytes, "
          f"{sum(r['ms'] for r in reads if r['kind'] == 'sibling'):.2f} ms), branch "
          f"{sum(r['kind'] == 'branch' for r in reads)} "
          f"({sum(r['bytes'] for r in reads if r['kind'] == 'branch')} bytes, "
          f"{sum(r['ms'] for r in reads if r['kind'] == 'branch'):.2f} ms); peak device memory "
          f"{peak_dev / 1e9:.2f} GB, peak host memory "
          f"{host_mem['peak'] / 1e9:.2f} GB", flush=True)

    keep = {}  # its sibling fills are held against fill.cpp below, at the same inputs
    zero_mcmc_counts()
    with watched_fills(("branch",), keep) as fills, branch_uploads(long6_branch), \
            first_call(SiblingMatrix, "__init__") as sib_init:
        proposals = direct_proposals(s, fills)
    direct = mcmc_counts()
    branch_errs = [f["err"] for f in fills if f["err"] is not None]
    print(f"(n) long6 direct proposals, counted from 0: kernel (d) {direct['siblingfill']} "
          f"launches, kernel (e) {direct['branchfill']} {direct['branch_modes']} "
          f"{direct['branch_designs']}; their branch fills within {max(branch_errs):.3e} of "
          f"fill.cpp", flush=True)
    long6_fills = {"long6 node-align": keep.pop("banded"), "long6 prune-regraft": keep.pop("full")}
    for name, args in long6_fills.items():
        checks[name] = sibling_kernel_check(
            name, args, SIBLING_STRIP_ROWS if name == "long6 prune-regraft" else ())
    forward = {d: branch_forward_check(f"long6 {d} branch", long6_branch[d], d == "strip")
               for d in ("ring", "strip")}
    routes = sibling_routes(sib_init[0][1:])  # the node-align proposal's, less self
    parent_runs = sibling_parent(parent, long6_fills) if parent else None
    if parent:
        forward["parent"] = branch_strip_parent(parent, long6_branch["strip"])
    del long6_fills
    main = checks["long6 node-align"]
    line = {"mcmc": dict(small=small, long6=dict(wall_s=wall, steps=steps, lp=lp, moves=moves,
                                                 counts=run_counts, fills=seen,
                                                 peak_device_bytes=peak_dev,
                                                 peak_host_bytes=host_mem["peak"]),
                         direct=dict(counts=direct, proposals=proposals), siblingfill=checks,
                         branch_forward=forward, routes=routes, parent=parent_runs)}
    print(json.dumps(line), flush=True)
    return dict(launches=run_counts["siblingfill"], plan_launches=run_counts["siblingplan"],
                plan_ms=main["plan_kernel_ms"], plain_plan_ms=main["plain_plan_ms"],
                plan_bound=main["plan_bound"],
                branch_launches=run_counts["branch_designs"], branch_strip=forward["strip"],
                err=max(max(c["err"] for c in checks.values()), small["sibling_err"]),
                branch_err=max(forward["ring"]["err"], forward["strip"]["err"],
                               small["branch_err"], max(branch_errs)),
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


#: kernel (a)'s cells against fill.cpp's (absolute, as the sibling fill's)
DAG_TOL = 1e-9
#: kernel (a) against its plain version on the card, relative: both keep
#: fill.cpp's per-cell order with the card's exp and log1p, so they agree to
#: round-off; a float32 or a wrong kernel does not
DAG_PLAIN_RTOL = 1e-12
#: kernel (a)'s operations a cell with kx x and ky y in-edges: each
#: x-edge 44 (IMD's and IIW's sums and their log-sum-exps, a log-sum-exp 5),
#: each y-edge 38, each (x, y) pair 32
DAG_OPS = (44, 38, 32)
#: the route sweep beyond small6's first sampled-x merge: long6's first
#: four sequences cut to these lengths, the root merge ((t1, t2), (t3, t4))
#: of two sampled profiles (below 500 aa its x is a chain: the sampled
#: traces agree)
DAG_SWEEP = (500, 2000)


@contextlib.contextmanager
def dag_threshold(value):
    """engine/forward.py DAG_DEVICE_MIN_CELLS["cuda"] set to `value` (0: every
    merge of a sampled x on kernel (a); None: every one on fill.cpp)."""
    from historian_tpu_torch.engine import forward

    old = forward.DAG_DEVICE_MIN_CELLS["cuda"]
    forward.DAG_DEVICE_MIN_CELLS["cuda"] = value
    try:
        yield
    finally:
        forward.DAG_DEVICE_MIN_CELLS["cuda"] = old


@contextlib.contextmanager
def dag_merges():
    """The ForwardMatrix arguments (x, y, hmm, row, env) of every merge of a
    non-chain x that the block fills on kernel (a), in order."""
    from historian_tpu_torch.engine import forward

    fill, box = forward.ForwardMatrix._fill_dag, []

    def keep(self):
        filled = fill(self)
        if filled:
            box.append((self.x, self.y, self.hmm, self.parent_row, self.env))
        return filled

    forward.ForwardMatrix._fill_dag = keep
    try:
        yield box
    finally:
        forward.ForwardMatrix._fill_dag = fill


def host_merge(args):
    """The merge filled by csrc/fill.cpp, and fill.cpp's ms (the native call
    alone)."""
    from historian_tpu_torch import native
    from historian_tpu_torch.engine import forward

    class HostFill(forward.ForwardMatrix):
        def _fill_device(self):
            return False

    with host_timed(native.get_native(), "forward_fill") as calls:
        fwd = HostFill(*args)
    return fwd, calls[0][0] * 1e3


def dag_chain_ns(trans: np.ndarray, split: bool) -> float:
    """A dependency floor's step, in ns, from CUDA events around 20000 steps,
    median of 3 (csrc/dagfill.cu): `split`, this design's, a lane group
    computing one emitting cell's terms a state a lane, the states shared
    through shared memory (`dagfill_chain_split`); else the first design's,
    one thread a cell's ~20 log-sum-exps in a row (`dagfill_chain`)."""
    from historian_tpu_torch.ops import _kernels

    t = torch.as_tensor(trans, dtype=torch.float64, device="cuda")
    out = torch.empty(5, dtype=torch.float64, device="cuda")
    steps = 20_000

    def run():
        _kernels.check(_kernels.lib().dagfill_chain_f64(
            t.data_ptr(), steps, int(split), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "dagfill_chain")

    return cuda_ms_median(run, 3) * 1e6 / steps


def dag_err(what: str, got: np.ndarray, ref: np.ndarray, rtol: float = 0.0) -> float:
    """The same -inf cells, the rest within DAG_TOL (or rtol relative);
    returns the largest absolute difference."""
    if not np.array_equal(got == -np.inf, ref == -np.inf):
        raise AssertionError(f"{what}: the -inf cells differ")
    live = np.isfinite(ref)
    diff = np.abs(got[live] - ref[live])
    limit = rtol * np.maximum(1.0, np.abs(ref[live])) if rtol else DAG_TOL
    if not np.all(diff <= limit):
        raise AssertionError(f"{what}: largest difference {diff.max():.3e}")
    return float(diff.max(initial=0.0))


def dag_plan_check(inp, planned) -> dict:
    """The plan kernel's records, terms and spans against the plain plan's
    on the same inputs on the card: every integer word and lp equal, the
    absorb values (the card's log of the same ordered sum) within 1e-15
    relative; returns the absorb's largest difference and its bit-equal
    share, and the plain plan's ms."""
    from historian_tpu_torch.ops import dagforward

    got, _ = planned
    want, plain_ms = host_ms(lambda: dagforward.plan_records_plain(inp))
    if not (torch.equal(got.spans, want.spans) and torch.equal(got.terms, want.terms)
            and torch.equal(got.recs[:, 2:], want.recs[:, 2:])):
        raise AssertionError("(o) the plan kernel's records differ from the plain plan's")
    a, b = got.recs.view(torch.float64)[:, 0], want.recs.view(torch.float64)[:, 0]
    live = torch.isfinite(b)
    if not (torch.equal(torch.isfinite(a), live) and torch.equal(a == 0, b == 0)):
        raise AssertionError("(o) the plan kernel's absorb differs from the plain plan's")
    diff = (a[live] - b[live]).abs()
    if not bool(torch.all(diff <= 1e-15 * b[live].abs().clamp(min=1.0))):
        raise AssertionError(f"(o) plan absorb: largest difference {float(diff.max()):.3e}")
    return dict(absorb_err=float(diff.max()) if len(diff) else 0.0,
                absorb_bit_equal=float((a[live] == b[live]).double().mean()),
                plain_plan_ms=plain_ms)


def dag_kernel_check(name: str, args) -> dict:
    """Kernel (a) at one merge: the host plan (in-envelope cells, band
    cells, wavefronts, its ms by part) and its upload; the plan kernel
    against the plain plan (`dag_plan_check`); the band against fill.cpp
    (DAG_TOL, the bit-equal share printed) and the plain version
    (DAG_PLAIN_RTOL); the design, lanes a cell, blocks, the in-degrees (kx,
    ky, kx ky over the cells) and the share of terms read from the ring;
    ms (CUDA events, median of 5 after a warm launch) of `dag_fill_band`
    (the plan kernel and the fill), of the plan kernel and of the fill
    alone, the plain version's and fill.cpp's ms, the band read back
    (bytes, ms), the bound and both dependency floors."""
    from historian_tpu_torch.ops import dagforward, readback

    host, fill_cpp_ms = host_merge(args)
    nx, ny = host.x_size - 1, host.y_size - 1
    t0 = time.perf_counter()
    p = dagforward.plan(host)
    plan_ms = (time.perf_counter() - t0) * 1e3
    inp = dagforward.upload_band(p, torch.device("cuda"))
    up = dagforward.UPLOADS[-1]
    out = np.full((host.x_size, host.y_size, 5), -np.inf)
    n_read = len(readback.READBACKS)
    dagforward.read_band(dagforward.dag_fill_band(inp), p.layout, out)
    launch = dict(dagforward.LAST_LAUNCH)
    back = readback.READBACKS[n_read]
    idx = p.layout.flat_index()
    got = out[:nx, :ny].reshape(-1, 5)[idx]
    ref = host.cells[:nx, :ny].reshape(-1, 5)[idx]
    del out
    err = dag_err(f"{name} kernel (a) vs fill.cpp", got, ref)
    live = np.isfinite(ref)
    bit_equal = float(np.mean(got[live] == ref[live]))
    planned = dagforward.plan_records(inp)
    plan_check = dag_plan_check(inp, planned)
    recs = planned[0]
    plain, plain_ms = host_ms(lambda: dagforward.dag_fill_band_plain(inp, recs))
    plain = plain.cpu().numpy()
    plain_err = dag_err(f"{name} kernel (a) vs plain", got, plain, DAG_PLAIN_RTOL)
    plain_host_err = dag_err(f"{name} plain vs fill.cpp", plain, ref)
    del got, ref, plain
    ms = cuda_ms_median(lambda: dagforward.dag_fill_band(inp))
    plan_kernel_ms = cuda_ms_median(lambda: dagforward.plan_records(inp))
    fill_ms = cuda_ms_median(lambda: dagforward.dag_fill_band(inp, planned))
    N, W = len(p.cells), len(p.wave) - 1
    T = recs.terms.shape[0]
    ring_share = float((recs.terms[:, 4] <= -2).double().mean()) if T else 0.0
    kx = np.diff(p.x_csr[0])[p.cells[:, 0]]
    ky = np.diff(p.y_csr[0])[p.cells[:, 1]]
    degrees = {k: dict(mean=float(v.mean()), max=int(v.max()))
               for k, v in (("kx", kx), ("ky", ky), ("kxky", kx * ky))}
    ops = float(np.sum(DAG_OPS[0] * kx + DAG_OPS[1] * ky + DAG_OPS[2] * kx * ky))
    ca = p.factors[0].shape[1]
    n_bytes = (p.layout.n * 40 + N * 8 + (nx + ny) * (8 * (3 + ca) + 4 + 1)
               + 12 * (len(p.x_csr[1]) + len(p.y_csr[1])) + 4 * (3 * nx + 2 * ny) + 4 * W)
    bnd = bound(n_bytes, ops, torch.float64)
    step_ns = dag_chain_ns(p.trans, True)
    first_step_ns = dag_chain_ns(p.trans, False)
    floor_ms, first_floor_ms = W * step_ns / 1e6, W * first_step_ns / 1e6
    parts = ", ".join(f"{k} {v:.1f}" for k, v in p.host_ms.items())
    print(f"(o) kernel (a) {name} {nx} x {ny} ({N} in-envelope cells, {p.layout.n} band cells, "
          f"{W} wavefronts, widest {p.widest}, {T} terms; {launch['design']} design, "
          f"{launch['lanes']} lanes a cell, {launch['blocks']} block(s) of "
          f"{launch['threads']}; in-degrees {json.dumps(degrees)}, terms from the ring "
          f"{ring_share:.4f}): {ms:.3f} ms ({ms * 1e3 / W:.3f} us a wavefront) = plan kernel "
          f"{plan_kernel_ms:.3f} + fill {fill_ms:.3f} ({fill_ms * 1e3 / W:.3f} us a wavefront); "
          f"plain {plain_ms:.1f} ms, plain plan {plan_check['plain_plan_ms']:.1f} ms, fill.cpp "
          f"{fill_cpp_ms:.1f} ms; max abs err {err:.3e} against fill.cpp (cells bit-equal: "
          f"{bit_equal:.4f}), {plain_err:.3e} against plain, plain against fill.cpp "
          f"{plain_host_err:.3e}; plan kernel == plain plan (absorb within "
          f"{plan_check['absorb_err']:.3e}, bit-equal {plan_check['absorb_bit_equal']:.4f}); "
          f"host plan {plan_ms:.1f} ms ({parts}), upload {up['bytes']} bytes in "
          f"{up['ms']:.3f} ms (packing {up['pack_ms']:.1f} ms), readback {back['bytes']} bytes "
          f"in {back['ms']:.3f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"dependency floor {floor_ms:.3f} ms ({W} x {step_ns:.1f} ns, a state a lane), the "
          f"first design's {first_floor_ms:.3f} ms ({W} x {first_step_ns:.1f} ns, one thread "
          f"a cell)", flush=True)
    return dict(ms=ms, us_per_wavefront=ms * 1e3 / W, plan_kernel_ms=plan_kernel_ms,
                fill_ms=fill_ms, plain_ms=plain_ms, fill_cpp_ms=fill_cpp_ms,
                err=max(err, plain_err), fill_cpp_err=err, plain_err=plain_err,
                plain_fill_cpp_err=plain_host_err, bit_equal_share=bit_equal, shape=[nx, ny],
                in_envelope=N, band_cells=p.layout.n, wavefronts=W, widest=p.widest, terms=T,
                design=launch["design"], lanes=launch["lanes"], blocks=launch["blocks"],
                degrees=degrees, ring_share=ring_share, plan_ms=plan_ms, plan_parts=p.host_ms,
                upload_bytes=up["bytes"], upload_ms=up["ms"], readback_bytes=back["bytes"],
                readback_ms=back["ms"], dependency_floor_ms=floor_ms, step_ns=step_ns,
                first_design_floor_ms=first_floor_ms, first_design_step_ns=first_step_ns,
                **plan_check, **bnd)


def dag_parent(parent: str, args) -> dict:
    """Kernel (a) of the checkout in `parent` and of this one at one merge
    (its ForwardMatrix arguments, pickled): historian_tpu_torch/dag_bench.py
    in fresh processes, parent, this, this, parent (roots.compare_roots):
    each run's host plan (ms, by part where timed) and `dag_fill_band` ms;
    returns each root's runs."""
    t_start = time.perf_counter()
    import pickle

    from historian_tpu_torch.roots import compare_roots

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dag_merge.pkl")
        with open(path, "wb") as f:
            pickle.dump(args, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compare_roots(os.path.join(REPO, "historian_tpu_torch", "dag_bench.py"),
                          ["--inputs", path, "--reps", "5"], [parent, REPO], 2, "dag_bench")
    table = json.loads(buf.getvalue().splitlines()[-1])["compare"]
    for root, runs in table.items():
        tag = "parent" if root == os.path.abspath(parent) else "this"
        for r in runs:
            extra = (f" = plan kernel {r['plan_kernel_ms']:.3f} + fill {r['fill_ms']:.3f} "
                     f"({r['design']})" if "fill_ms" in r else "")
            parts = ", ".join(f"{k} {v:.1f}" for k, v in r["plan_parts"].items())
            print(f"(o) kernel (a) at long12's first sampled-x merge, {tag} ({root}): "
                  f"{r['kernel_ms']:.3f} ms{extra}; host plan {r['plan_ms']:.1f} ms"
                  f"{' (' + parts + ')' if parts else ''}, upload {r['upload_bytes']} bytes in "
                  f"{r['upload_ms']:.3f} ms (packing {r['pack_ms']:.1f})", flush=True)
    print(f"(o) the parent comparison took {time.perf_counter() - t_start:.1f} s", flush=True)
    return table


def dag_routes(work: str, small6_merge) -> list:
    """Both routes of merges of a sampled x: small6's first (its ForwardMatrix
    arguments), then at DAG_SWEEP's sizes the root merge of `recon -tree`
    over long6's t1-t4 cut to n, f32 (that merge in float64 on either
    route): its ForwardMatrix built on fill.cpp and on kernel (a) in turns,
    3 each, median ms, with its in-envelope state-cells (what the route rule
    counts)."""
    from historian_tpu_torch import cli
    from historian_tpu_torch.engine import forward

    seqs = read_fasta(os.path.join(REPO, "tests", "data", "long6.fa"))[:4]
    tree = os.path.join(work, "four.nh")
    with open(tree, "w") as f:
        f.write("((t1:0.1,t2:0.1):0.08,(t3:0.1,t4:0.1):0.08)root;\n")
    rows = []
    for n in ("small6", *DAG_SWEEP):
        merges = [small6_merge]
        if n != "small6":
            fa = os.path.join(work, f"four_{n}.fa")
            with open(fa, "w") as f:
                for name, s in seqs:
                    f.write(f">{name}\n{s[:n]}\n")
            with dag_threshold(0), dag_merges() as merges:
                run_cli(cli, ["-platform", "gpu", "-tree", tree, fa], "f32")
            if not merges:
                raise AssertionError(f"(o) route sweep {n}: no merge of a non-chain x")
        args = merges[0]
        ms = {"host": [], "card": []}
        for _ in range(3):
            for route, value in (("host", None), ("card", 0)):
                with dag_threshold(value):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fwd = forward.ForwardMatrix(*args, defer_cells=True)
                    torch.cuda.synchronize()
                    ms[route].append((time.perf_counter() - t0) * 1e3)
                if fwd.route != ("dag" if value == 0 else "host"):
                    raise AssertionError(f"dag route sweep {n}: route {fwd.route}")
                nx, ny = fwd.x_size - 1, fwd.y_size - 1
                cells = int(np.count_nonzero(fwd.env_mask[:nx, :ny])) * 5
                del fwd
        row = dict(n=n, shape=[nx, ny], state_cells=cells,
                   host_ms=float(np.median(ms["host"])), card_ms=float(np.median(ms["card"])))
        rows.append(row)
        what = "small6's first" if n == "small6" else f"long6's t1-t4 cut to {n} aa, root"
        print(f"(o) route sweep: {what} merge {nx} x {ny}, "
              f"{cells} in-envelope state-cells: fill.cpp {row['host_ms']:.2f} ms, kernel (a) "
              f"{row['card_ms']:.2f} ms (whole ForwardMatrix, medians of 3)", flush=True)
    return rows


def phase_dag(cli, work: str, small6_cpu: str, careful_cpu: str, parent: str | None) -> dict:
    """(o) Kernel (a), the DAG x DAG merge fill: small6 default and small6
    `-careful -norefine` in float64 with every merge of a sampled or
    posterior x forced onto the kernel (DAG_DEVICE_MIN_CELLS["cuda"] = 0),
    each byte-identical to the CPU's run ((j)'s and (l)'s, on the same
    file in `work`, whose path the output names), kernel (a)'s launches
    equal to the fills of a non-chain x.  Then the main path's run: long12
    default in float32 from (j)'s guide and tree (in `work`) on the
    automatic route, its counts from 0: wall, merges and fills by route,
    kernel (a)'s launches (equal to FILLS["dag"], at least one) and ms;
    then the same with every merge on fill.cpp, its wall and whether its
    output equals the automatic run's (reported: a sampled pick may turn at
    round-off).  Kernel (a) at that run's first sampled-x merge
    (`dag_kernel_check`), and the route sweep (`dag_routes`)."""
    from historian_tpu_torch import recon
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.ops import colforward, dagforward, guidedp, tracedp

    counters = (recon, forward, colforward, tracedp, guidedp)
    fa6 = write_small6(work)
    os.environ["HISTORIAN_PALLAS_FUSED"] = "0"
    small, small_merge = {}, None
    for what, flags, cpu in (("default", [], small6_cpu),
                             ("-careful -norefine", ["-careful", "-norefine"], careful_cpu)):
        zero_counts(*counters)
        with dag_threshold(0), fill_log(forward) as log, dag_merges() as merges:
            gpu = run_cli(cli, ["-platform", "gpu", *flags, fa6], "f64")
        small_merge = small_merge or merges[0]
        counts = recon_counts(*counters)
        dag = len(log) - sum(log)
        if gpu != cpu:
            raise AssertionError(f"(o) small6 {what} f64, every sampled-x merge on kernel (a): "
                                 "card output differs from the CPU's")
        if not (dag >= 1 and counts["dagfill"] == dag == counts["fills"]["dag"]):
            raise AssertionError(f"(o) small6 {what}: {dag} fills of a non-chain x, {counts}")
        small[what] = dict(merges=counts["merges"], fills=counts["fills"],
                           dagfill=counts["dagfill"])
        print(f"(o) small6 {what} f64, every merge of a non-chain x on kernel (a): card == cpu, "
              f"kernel (a) {counts['dagfill']} launches, merges {counts['merges']}, fills "
              f"{counts['fills']}", flush=True)
    guide = os.path.join(work, "long12_guide.sto")
    runs = {}
    for route, value in (("auto", forward.DAG_DEVICE_MIN_CELLS["cuda"]), ("host", None)):
        zero_counts(*counters)
        n_up = len(dagforward.UPLOADS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dag_threshold(value), dag_merges() as merges, \
                cuda_timed(dagforward, "dag_fill_band") as dag_ev:
            out = run_cli(cli, ["-platform", "gpu", "-stockholm", guide], "f32")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = recon_counts(*counters)
        rows, lp = stockholm_rows_lp(out)
        if len(rows) != 23 or not math.isfinite(lp):
            raise AssertionError(f"(o) long12 default {route}: {len(rows)} rows, LP {lp}")
        kernel_ms = [a.elapsed_time(b) for a, b in dag_ev]
        ups = dagforward.UPLOADS[n_up:]
        runs[route] = dict(wall_s=wall, lp=lp, out=out, merges=counts["merges"],
                           fills=counts["fills"], dagfill=counts["dagfill"],
                           dagplan=counts["dagplan"], dagfill_ms=kernel_ms,
                           upload_bytes=sum(u["bytes"] for u in ups),
                           upload_ms=sum(u["ms"] for u in ups), first=merges[:1])
        print(f"(o) long12 default f32 from (j)'s guide, {route} route for the merges of a "
              f"sampled x: wall {wall:.2f} s, LP {lp}, merges {counts['merges']}, fills "
              f"{counts['fills']}, kernel (a) {counts['dagfill']} launches "
              f"{[round(t, 3) for t in kernel_ms]} ms, uploads {len(ups)} "
              f"({runs[route]['upload_bytes']} bytes)", flush=True)
    auto = runs["auto"]
    if not (auto["fills"]["dag"] >= 1 and auto["dagfill"] == auto["fills"]["dag"]
            == auto["dagplan"] and runs["host"]["dagfill"] == runs["host"]["dagplan"] == 0):
        raise AssertionError(f"(o) long12 default routes: {runs}")
    same = auto["out"] == runs["host"]["out"]
    print(f"(o) long12 default f32: automatic route == fill.cpp route: {same} (LP "
          f"{auto['lp']} vs {runs['host']['lp']}); walls {auto['wall_s']:.2f} s vs "
          f"{runs['host']['wall_s']:.2f} s", flush=True)
    check = dag_kernel_check("long12 first sampled-x merge", auto["first"][0])
    routes = dag_routes(work, small_merge)
    del os.environ["HISTORIAN_PALLAS_FUSED"]
    long12 = {route: {k: v for k, v in run.items() if k not in ("out", "first")}
              for route, run in runs.items()}
    line = dict(small6=small, long12=long12, same_output=same, kernel=check, routes=routes)
    if parent:
        line["parent"] = dag_parent(parent, auto["first"][0])
    print(json.dumps({"dagfill": line}), flush=True)
    plan_bytes = (check["in_envelope"] * (8 + 64) + check["terms"] * 32
                  + check["band_cells"] * (40 + 4))
    return dict(launches=auto["dagfill"], plan_launches=auto["dagplan"], err=check["err"],
                plan_err=check["absorb_err"], plan_ms=check["plan_kernel_ms"],
                plain_plan_ms=check["plain_plan_ms"], plan_bound=bound(plan_bytes, 0.0,
                                                                       torch.float64),
                **{k: check[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


@contextlib.contextmanager
def captured_sp_fills(sp):
    """The arguments of every (g1) fill the block makes through
    `sp_col_forward_planes`, its tensors cloned."""
    seen, real = [], sp.sp_col_forward_planes

    def wrapper(*args):
        seen.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real(*args)

    sp.sp_col_forward_planes = wrapper
    try:
        yield seen
    finally:
        sp.sp_col_forward_planes = real


def free_port() -> str:
    """host:port of a TCP port that is free on the loopback now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def phase_sp(cli, colforward, work: str, small6_cpu: str) -> dict:
    """(p) The mesh paths (ROADMAP item 7) on the one card.

    Kernel (g1), the sequence-parallel column fill, at long12's
    first-merge shape (chain y, full grid), with a diagonal band at that
    shape (the strips' lanes given) and on a DAG y (KY = 4, nulls, a band)
    at 2048 x 2048 (float64), in float32 and float64, with 1, 2, 4 and 8
    shards on the card: each result bit-equal to K1's launch on the same
    inputs, timed beside it (CUDA events, the wrappers' calls), with its
    exchange buffers' bytes and its bound (K1's bytes, plus the records
    written and read once); against its plain version (8 shards) on the
    DAG y in float64.  By part, float32 and float64, each bit-equal to K1
    and timed beside it: x cut to one 128-lane strip and to two (one and
    two shards), and the full grid with every strip edge a record
    (clusters of 1) and in the rule's clusters.  Then the main path: `recon -fast` on small6 in
    float64 with HISTORIAN_SP=1 on a mesh of four shards of the one card
    (a mesh of the card repeated, made here: `-mesh 4` asks for four cards
    and raises on this one), its launches counted from 0, byte for byte
    the CPU's plain run; then (g1) on the inputs of that run's largest
    merge, in float64 and float32 on its four shards, bit-equal to K1 and
    against its plain version (the kernel line's times: float64).  `count`
    and `fit -maxiter 2` with `-mesh 1` on (j)'s long12 f32 reconstruction
    within 1e-9 of the plain run; `-mesh 2` raises the JAX package's text;
    and under HISTORIAN_DIST=1 (a one-rank NCCL group, its loopback
    rendezvous on a free port) `count` and `mcmc -samples 1` on small6's
    reconstruction, equal to the plain run."""
    from historian_tpu_torch import recon as recon_mod
    from historian_tpu_torch.engine import forward
    from historian_tpu_torch.ops import sp_colforward as sp
    from historian_tpu_torch.parallel import dist, pcounts
    from historian_tpu_torch.parallel.mesh import Mesh, MeshDevice

    cuda = torch.device("cuda", 0)
    f32, f64 = torch.float32, torch.float64
    SX, SY = long12_first_merge()
    err, times, res = 0.0, {}, {}
    for name, sx, sy, KY, banded, dtypes in (("long12", SX, SY, 1, False, (f32, f64)),
                                             ("long12 band", SX, SY, 1, True, (f32, f64)),
                                             ("dag", 2048, 2048, 4, True, (f64,))):
        for dtype in dtypes:
            args = k1_inputs(sx, sy, KY, banded, 17, dtype)
            lanes = colforward.lanes_from_mask(args[4] == 0) if banded else None
            ref = colforward.col_forward_planes(*args, lanes=lanes)
            k1_ms = cuda_ms(lambda: colforward.col_forward_planes(*args, lanes=lanes))
            for n in (1, 2, 4, 8):
                devs = [cuda] * n
                got = sp.sp_col_forward_planes(*args, lanes, devs)
                torch.cuda.synchronize()
                launch = dict(sp.LAST_LAUNCH)
                if not torch.equal(got, ref):
                    raise AssertionError(f"(g1) {name} {dtype} {n} shards: not bit-equal to K1")
                ms = cuda_ms(lambda: sp.sp_col_forward_planes(*args, lanes, devs))
                exch = launch["exchange_bytes"]
                bnd = bound(nbytes(*args, got) + 2 * exch, K1_OPS_PER_CELL * sx * sy, dtype)
                times[(name, str(dtype)[6:], n)] = dict(ms=ms, k1_ms=k1_ms, exchange_bytes=exch,
                                                       **bnd)
                print(f"(p) (g1) {name} SX={sx} SY={sy} KY={KY} {str(dtype)[6:]}, {n} shards "
                      f"{launch['cuts']}: {ms:.3f} ms, K1 {k1_ms:.3f} ms in the same call, "
                      f"bit-equal to K1; exchange buffers {exch} B; bound {bnd['bound_ms']:.4f} "
                      f"ms ({bnd['bound_by']})", flush=True)
            if name == "dag":
                plain, p_ms = host_ms(lambda: sp.sp_col_forward_planes_plain(*args, 8))
                e = check_planes(f"(g1) {name} {dtype} against its plain version", got, plain,
                                 dtype)
                err = max(err, e)
                print(f"(p) (g1) {name} {str(dtype)[6:]}, 8 shards, against its plain version "
                      f"(8 shards): max abs err {e:.3e}, plain {p_ms:.1f} ms", flush=True)
            del args, ref, got

    # (g1) by part at long12's first merge: x cut to one strip and to two
    # (every column), and the full grid with every strip edge a record
    # (clusters of 1) beside the clusters of the rule
    parts = {}
    for dtype in (f32, f64):
        full = k1_inputs(SX, SY, 1, False, 17, dtype)
        for cols, n, cluster in ((128, 1, None), (256, 1, None), (256, 2, None), (SX, 1, 1),
                                 (SX, 1, None)):
            args = full if cols == SX else tuple(
                t[..., :cols].contiguous() if k in (3, 4, 5) else t for k, t in enumerate(full))
            ref = colforward.col_forward_planes(*args)
            got = sp._planes(*args, None, [cuda] * n, cluster)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"(g1) part {cols} lanes {n} shards {dtype}: not bit-equal")
            lay = sp.LAST_LAUNCH["layouts"][0]
            ms = cuda_ms(lambda: sp._planes(*args, None, [cuda] * n, cluster))
            k1_ms = cuda_ms(lambda: colforward.col_forward_planes(*args))
            key = f"{cols} lanes {n} shards cluster {lay['cluster']} {str(dtype)[6:]}"
            parts[key] = dict(ms=ms, k1_ms=k1_ms, us_a_column=ms * 1e3 / SY,
                              k1_us_a_column=k1_ms * 1e3 / SY, strips=lay["strips"])
            print(f"(p) (g1) part: {key} ({lay['strips']} strips): {ms:.3f} ms "
                  f"({ms * 1e3 / SY:.3f} us a column), K1 {k1_ms:.3f} ms "
                  f"({k1_ms * 1e3 / SY:.3f}); bit-equal", flush=True)
        del full, args, ref, got

    # the main path: recon -fast on small6 over four shards of the card
    fa = write_small6(work)
    cpu_out = run_cli(cli, ["-platform", "cpu", "-fast", fa], "f64")
    sp.LAUNCHES = 0
    fills0 = forward.FILLS["sp"]
    os.environ["HISTORIAN_SP"] = "1"
    pcounts._ACTIVE_MESH = Mesh([MeshDevice(0, k, cuda) for k in range(4)], ("dp",))
    try:
        with captured_sp_fills(sp) as fills:
            card_out = run_cli(cli, ["-platform", "gpu", "-fast", fa], "f64")
    finally:
        del os.environ["HISTORIAN_SP"]
    launches, sp_fills = sp.LAUNCHES, forward.FILLS["sp"] - fills0
    if card_out != cpu_out or not launches or sp_fills != launches:
        raise AssertionError(f"(p) small6 -fast on 4 shards: equal to the CPU "
                             f"{card_out == cpu_out}, launches {launches}, sp fills {sp_fills}")
    print(f"(p) small6 recon -fast f64, HISTORIAN_SP=1 on 4 shards of the card: == CPU f64, "
          f"{launches} (g1) launches, {sp_fills} merges on the sp route", flush=True)

    # (g1) at the main path's largest merge: bit-equal to K1, against its plain version
    *fill, lanes, devs = max(fills, key=lambda f: f[3].numel())
    SY, SX = fill[3].shape
    for dtype in (f64, f32):
        args = [t if t.dtype == torch.int32 else t.to(dtype) for t in fill]
        ref = colforward.col_forward_planes(*args, lanes=lanes)
        got = sp.sp_col_forward_planes(*args, lanes, devs)
        torch.cuda.synchronize()
        launch = dict(sp.LAST_LAUNCH)
        if not torch.equal(got, ref):
            raise AssertionError(f"(g1) small6's merge {dtype}: not bit-equal to K1")
        ms = cuda_ms(lambda: sp.sp_col_forward_planes(*args, lanes, devs))
        k1_ms = cuda_ms(lambda: colforward.col_forward_planes(*args, lanes=lanes))
        plain, p_ms = host_ms(lambda: sp.sp_col_forward_planes_plain(*args, len(devs)))
        e = check_planes(f"(g1) small6's merge {dtype} against its plain version", got, plain,
                         dtype)
        err = max(err, e)
        exch = launch["exchange_bytes"]
        bnd = bound(nbytes(*args, got) + 2 * exch, K1_OPS_PER_CELL * SX * SY, dtype)
        times[("small6 merge", str(dtype)[6:], len(devs))] = dict(
            ms=ms, k1_ms=k1_ms, plain_ms=p_ms, exchange_bytes=exch, **bnd)
        if dtype == f64:
            res = dict(ms=ms, plain_ms=p_ms, **bnd)
        print(f"(p) (g1) small6's largest merge SX={SX} SY={SY} KY={fill[0].shape[1]} "
              f"{str(dtype)[6:]}, {len(devs)} shards {launch['cuts']}: {ms:.3f} ms, K1 "
              f"{k1_ms:.3f} ms, bit-equal to K1; against its plain version ({len(devs)} "
              f"shards, {p_ms:.1f} ms): max abs err {e:.3e}; exchange buffers {exch} B; bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    del fills, fill, args, ref, got, plain

    # count and fit on -mesh 1, against the plain run
    recon_path = os.path.join(work, "long12_f32.sto")
    for command, extra in (("count", []), ("fit", ["-maxiter", "2"])):
        runs = []
        for mesh in ([], ["-mesh", "1"]):
            with reconstructors(recon_mod) as seen:
                run_cli(cli, ["-platform", "gpu", "-stockrecon", recon_path, *extra, *mesh],
                        "f64", command)
            rc = seen[-1]
            runs.append([rc.data_counts.root_count, rc.data_counts.sub_count,
                         np.array(rc.data_counts.indel.lp)] if command == "count" else
                        [rc.model.sub_rate, rc.model.ins_prob,
                         np.array([rc.model.ins_rate, rc.model.del_rate])])
        rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
                  for a, b in zip(*runs))
        for a, b in zip(*runs):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12 * np.abs(b).max())
        print(f"(p) long12 {command} -mesh 1 == the plain run, largest relative difference "
              f"{rel:.3e}", flush=True)
    try:
        run_cli(cli, ["-platform", "gpu", "-stockrecon", recon_path, "-mesh", "2"], "f64",
                "count")
    except SystemExit as e:
        if "-mesh 2 requests 2 devices but only 1 are visible" not in str(e):
            raise
        print(f"(p) -mesh 2 on one card: {e}", flush=True)
    else:
        raise AssertionError("-mesh 2 on one card did not raise")

    # a one-rank NCCL group: count and mcmc on small6's reconstruction
    small6_recon = os.path.join(work, "small6_p.sto")
    with open(small6_recon, "w") as f:
        f.write(small6_cpu)
    runs = {}
    # the group's fixed loopback rendezvous, on a free port here, so that
    # nothing else on the machine meets it
    dist.LOOPBACK = free_port()
    for group in (False, True):
        if group:
            os.environ["HISTORIAN_DIST"] = "1"
        try:
            runs[group] = [run_cli(cli, ["-platform", "gpu", "-stockrecon", small6_recon],
                                   "f64", "count"),
                           run_cli(cli, ["-platform", "gpu", "-samples", "1", "-seed", "7",
                                         "-stockrecon", small6_recon], "f64", "mcmc")]
        finally:
            os.environ.pop("HISTORIAN_DIST", None)
    if not (dist.is_initialized() and dist.backend() == "nccl" and dist.process_count() == 1):
        raise AssertionError(f"HISTORIAN_DIST=1: no one-rank NCCL group ({dist.backend()})")
    if runs[True] != runs[False]:
        raise AssertionError("HISTORIAN_DIST=1: count or mcmc differs from the plain run")
    print("(p) HISTORIAN_DIST=1: a one-rank NCCL group; small6 count and mcmc -samples 1 == "
          "the plain run", flush=True)
    print(json.dumps({"spcolforward": {f"{k[0]} {k[1]} {k[2]}": v for k, v in times.items()},
                      "spcolforward_parts": parts}), flush=True)
    return dict(res, err=err, launches=launches)


#: operations a cell of kernel (f)'s max-plus recurrence: 30 adds and 13
#: maxima (IMD 8, IIW 6, the IMM source 9, IMM 1, the scans' sources 6,
#: their a and b 4, the scans 4) and 5 gates, each one operation
TROPICAL_OPS_PER_CELL = 48
#: kernel (f) against its plain version, relative on the cells above
#: -1e29: every max is exact, only the scans' sums of b associate
#: otherwise (float32 rounds those at ~6e-8 a step)
TROPICAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: (g2) and (g3) against K3/K4 and their plain versions, relative on
#: lp_end: another association of the row scans; K3/K4's float32 takes
#: ex2.approx / lg2.approx
PAIR_RTOL = {torch.float32: 1e-5, torch.float64: 1e-9}
#: the rows at which (q) holds kernels (f), (g2) and (g3) against their
#: plain versions, every column kept (so at the block shape of the full pair)
TROPICAL_ROWS, SP_ROWS, PP_ROWS = 400, 300, 64


def pair_arrays(x: str, y: str, dtype, dev=torch.device("cuda")) -> list:
    """The pair-DP inputs (absorb, rootsub_x, rootsub_y, ins_x, ins_y,
    mask, trans) of x and y, preset lg, branch lengths 0.5 / 0.5, on dev."""
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.ops import pairforward

    args, _ = pairforward.chain_pair_forward_arrays(named_model("lg"), x, y, 0.5, 0.5,
                                                    dtype=dtype)
    return [a.to(dev) for a in args]


def event_ms(fn) -> tuple:
    """fn's result and its time on the card: CUDA events around one call
    (a kernel already built and loaded; for calls of a second or so, where
    more repeats would cost the script's time limit)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def rel_err(what: str, got, ref, rtol: float) -> float:
    """The largest relative error of lp values (tensors), which must be
    finite and within rtol."""
    g, r = (torch.as_tensor(v).double().cpu().reshape(-1) for v in (got, ref))
    if not (bool((r > -1e29).all()) and bool((g > -1e29).all())):
        raise AssertionError(f"{what}: an lp at the semiring zero: {g.tolist()} {r.tolist()}")
    e = float(((g - r).abs() / r.abs()).max())
    if e > rtol:
        raise AssertionError(f"{what}: relative error {e:.3e} > {rtol}")
    return e


def tropical_check(what: str, got, ref, rtol: float) -> float:
    """The -1e29 rule (a cell at or below -1e29 in one is in the other;
    the -inf cells the same), no NaN, then rtol on the rest; returns the
    largest absolute error."""
    g, r = got.double().cpu(), ref.double().cpu()
    live = r > -1e29
    if bool(g.isnan().any()) or bool(r.isnan().any()):
        raise AssertionError(f"{what}: NaN cells")
    if not torch.equal(g > -1e29, live):
        raise AssertionError(f"{what}: the cells at or below -1e29 differ")
    if not torch.equal(g == -math.inf, r == -math.inf):
        raise AssertionError(f"{what}: the -inf cells differ")
    d = (g[live] - r[live]).abs()
    if not bool((d <= rtol * r[live].abs()).all()):
        raise AssertionError(f"{what}: off by {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def cut_pair(args: list, x1: int, y1: int) -> list:
    """Pair-DP inputs cut to their first x1 rows and y1 columns."""
    absorb, rsx, rsy, ix, iy, mask, trans = args
    return [absorb[:x1, :y1].contiguous(), rsx[:x1].contiguous(), rsy[:y1].contiguous(),
            ix[:x1].contiguous(), iy[:y1].contiguous(), mask[:x1, :y1].contiguous(), trans]


def card_mesh(n: int, names=("sp",), shape=None):
    """A mesh of the one card repeated n times (`-mesh n` asks for n cards)."""
    from historian_tpu_torch.parallel.mesh import Mesh, MeshDevice

    devs = np.array([MeshDevice(0, k, torch.device("cuda", 0)) for k in range(n)], dtype=object)
    return Mesh(devs.reshape(shape or (n,)), names)


def batch_mats(K: int = 16) -> list:
    """bench.py:566's proposal grids in the port: preset lg, a 24-leaf
    UPGMA tree from RandomState(17), a 300-column alignment simulated on it
    from MT19937(3), a SiblingMatrix (fill deferred) for each of its first
    K internal nodes."""
    from historian_tpu_torch.core.alignpath import GuideAlignmentEnvelope
    from historian_tpu_torch.core.tree import Tree
    from historian_tpu_torch.engine.treealign import get_conditional_pwms
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.sampler.sibling import SiblingMatrix
    from historian_tpu_torch.sampler.simulator import simulate_tree
    from historian_tpu_torch.utils.rng import MT19937

    model = named_model("lg")
    rng = np.random.RandomState(17)
    pts = np.sort(rng.uniform(0.05, 1.0, 24))
    dist = np.abs(pts[:, None] - pts[None, :]) + 0.05
    np.fill_diagonal(dist, 0.0)
    tree = Tree.upgma([f"L{i}" for i in range(24)], dist)
    tree.assign_internal_node_names()
    rows = tree.reorder_seqs(simulate_tree(MT19937(3), model, tree, 300).gapped)
    mats = []
    for node in range(tree.n_nodes()):
        if tree.is_leaf(node) or len(mats) >= K:
            continue
        l_c, r_c = tree.children(node)
        pwms = get_conditional_pwms(model, tree, rows, {l_c: node, r_c: node})
        mats.append(SiblingMatrix(
            model, pwms[l_c], pwms[r_c], tree.branch_length(l_c), tree.branch_length(r_c),
            GuideAlignmentEnvelope(), np.arange(len(pwms[l_c]) + 1),
            np.arange(len(pwms[r_c]) + 1), l_c, r_c, node, defer_fill=True))
    return mats


#: the strip layouts (lanes a thread, warps, cluster) (q) holds kernels (f)
#: and (g2) to at a cut: every edge a record (cluster 1), portable and
#: non-portable clusters, each lanes a thread
STRIP_LAYOUTS = ((1, 1, 1), (1, 2, 8), (1, 4, 16), (2, 2, 4), (2, 4, 1), (4, 2, 16), (4, 8, 8))
#: rows of the strip checks' cut (all columns kept)
STRIP_ROWS = 200


def strip_layouts(what: str, run, plain, check, layouts=STRIP_LAYOUTS) -> list:
    """`run(lanes, warps, cluster)` at each layout against `plain` (the
    plain version's output, `check(what, got, plain)` -> its error), and
    the layouts of one lanes a thread bit-equal to each other: a strip
    boundary at a warp boundary passes what the warp ring passes.  Returns
    each layout's description and error."""
    out, by_lanes = [], {}
    for lanes, warps, cluster in layouts:
        got, launch = run(lanes, warps, cluster)
        e = check(f"{what} lanes {lanes} warps {warps} cluster {cluster}", got, plain)
        first = by_lanes.setdefault(lanes, got)
        same = all(torch.equal(g, f) for g, f in zip(
            got if isinstance(got, tuple) else (got,), first if isinstance(first, tuple)
            else (first,)))
        if not same:
            raise AssertionError(f"{what}: lanes {lanes} warps {warps} cluster {cluster} is "
                                 f"not bit-equal to lanes {lanes}'s first layout")
        out.append(dict(lanes=lanes, warps=warps, cluster=cluster, err=e,
                        cluster_edges=launch["cluster_edges"],
                        record_edges=launch["record_edges"]))
    return out


def phase_strips(long12: list, long6: list) -> dict:
    """(q)'s strip checks: kernels (f) and (g2) at every layout of
    STRIP_LAYOUTS on their main-path pairs cut to STRIP_ROWS rows (all
    columns) against their plain versions, each lanes a thread's layouts
    bit-equal; (g2)'s shard boundaries through pinned host memory at
    system scope (the boundary of two cards without peer access) equal to
    the card's own; then long8x12k's first pair (10979 x 11019, wider than
    one block of the one-block design took): (f) in float32 and float64
    and (g2) at 1 shard in float64, each against its plain version on its
    first STRIP_ROWS rows and at full size timed (the full run's rows
    above the cut's last bit-equal to the cut's)."""
    from historian_tpu_torch.ops import sp_pairforward, tropical

    f32, f64 = torch.float32, torch.float64
    name = lambda dt: str(dt)[6:]  # noqa: E731
    summary = {}
    for dt in (f32, f64):
        cut = cut_pair(pair_arrays(long12[0], long12[1], dt), STRIP_ROWS, len(long12[1]) + 1)
        plain = tropical.tropical_pair_forward_plain(*cut)

        def run(m, w, c):
            return tropical.tropical_pair_forward(*cut, lanes=m, warps=w, cluster=c), \
                dict(tropical.LAST_LAUNCH)

        def check(what, got, ref):
            return max(tropical_check(what, got[0], ref[0], TROPICAL_RTOL[dt]),
                       tropical_check(what, got[1][None], ref[1][None], TROPICAL_RTOL[dt]))
        summary[f"f {name(dt)}"] = strip_layouts(f"(q) strips (f) {name(dt)}", run, plain, check)
    cut = cut_pair(pair_arrays(long6[0], long6[1], f64), STRIP_ROWS, len(long6[1]) + 1)
    for n in (1, 8):
        plain = sp_pairforward.sp_pair_forward_plain(*cut, n)

        def run(m, w, c):
            got = sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(n), lanes=m, warps=w,
                                                 cluster=c)
            return got, sp_pairforward.LAST_LAUNCH["layouts"][0]
        summary[f"g2 float64 {n} shards"] = strip_layouts(
            f"(q) strips (g2) {n} shards", run, plain,
            lambda what, got, ref: rel_err(what, got, ref, PAIR_RTOL[f64]))
    own = sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(4))
    place = sp_pairforward._record_place
    sp_pairforward._record_place = lambda writer, reader: "host"
    try:
        host = sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(4))
        places = list(sp_pairforward.LAST_LAUNCH["places"])
    finally:
        sp_pairforward._record_place = place
    if places != ["host"] * 3 or not torch.equal(host, own):
        raise AssertionError(f"(q) strips (g2): shard boundaries in pinned host memory {places} "
                             f"give {float(host)!r}, the card's own {float(own)!r}")
    for what, rows in summary.items():
        errs = ", ".join(f"{r['lanes']}/{r['warps']}/{r['cluster']} {r['err']:.2e}" for r in rows)
        print(f"(q) strips {what}, {STRIP_ROWS} rows, lanes/warps/cluster and error against the "
              f"plain version: {errs}; each lanes a thread's layouts bit-equal", flush=True)
    print(f"(q) strips (g2) 4 shards, boundaries through pinned host memory (system scope): "
          f"lp_end equal to the card's own", flush=True)
    # long8x12k's first pair: wider than the one-block design's 8192 columns
    wide = [s for _, s in read_fasta(os.path.join(REPO, "tests", "data", "long8x12k.fa"))]
    for dt in (f32, f64):
        full = pair_arrays(wide[0], wide[1], dt)
        X1f, Y1f = full[0].shape
        cut = cut_pair(full, STRIP_ROWS, Y1f)
        ref, ref_lp = tropical.tropical_pair_forward_plain(*cut)
        got, got_lp = tropical.tropical_pair_forward(*cut)
        e = max(tropical_check(f"(q) long8x12k (f) {name(dt)} cut", got, ref, TROPICAL_RTOL[dt]),
                tropical_check(f"(q) long8x12k (f) {name(dt)} cut lp_best", got_lp[None],
                               ref_lp[None], TROPICAL_RTOL[dt]))
        (cells, lp_best), ms = event_ms(lambda: tropical.tropical_pair_forward(*full))
        launch = dict(tropical.LAST_LAUNCH)
        if not torch.equal(cells[:STRIP_ROWS - 1], got[:STRIP_ROWS - 1]) \
                or bool(cells.isnan().any()) or not -1e29 < float(lp_best) < 0:
            raise AssertionError(f"(q) long8x12k (f) {name(dt)}: the full run's first rows "
                                 f"differ from the cut's, or NaN cells, or no path")
        summary[f"long8x12k f {name(dt)}"] = dict(shape=[X1f, Y1f], ms=ms, cut_err=e, **launch)
        print(f"(q) long8x12k (f) {name(dt)} {X1f} x {Y1f} ({launch['strips']} strips of "
              f"{launch['width']}, {launch['lanes']} lanes x {launch['warps']} warps, clusters "
              f"of {launch['cluster']}): {ms:.3f} ms ({ms * 1e3 / X1f:.3f} us a row); first "
              f"{STRIP_ROWS} rows against the plain version {e:.3e}, bit-equal to the full "
              f"run's", flush=True)
        del cells, got, ref, full, cut
    full = pair_arrays(wide[0], wide[1], f64)
    cut = cut_pair(full, STRIP_ROWS, full[0].shape[1])
    got = sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(1))
    e = rel_err("(q) long8x12k (g2) cut", got, sp_pairforward.sp_pair_forward_plain(*cut, 1),
                PAIR_RTOL[f64])
    lp, ms = event_ms(lambda: sp_pairforward.sp_pair_forward(*full, mesh=card_mesh(1)))
    lay = sp_pairforward.LAST_LAUNCH["layouts"][0]
    if not -1e29 < float(lp) < 0:
        raise AssertionError(f"(q) long8x12k (g2): lp_end {float(lp)}")
    summary["long8x12k g2 float64 1"] = dict(ms=ms, cut_rel_err=e, lp=float(lp), **lay)
    print(f"(q) long8x12k (g2) f64 1 shard {tuple(full[0].shape)} ({lay['strips']} strips of "
          f"{lay['width']}): {ms:.3f} ms, lp_end {float(lp):.6f}; first {STRIP_ROWS} rows "
          f"{e:.3e} of |lp| from the plain version", flush=True)
    return summary


def batch_parent(parent: str, inputs: list) -> dict:
    """Kernel (d') of the checkout in `parent` and of this one on the 16
    grids: their batch pickled to BENCH_INPUTS/batch16.pkl, then
    historian_tpu_torch/sibling_bench.py --batch in fresh processes,
    parent, this, this, parent (roots.compare_roots), with a SHA-256 of
    each version's cells and lp_end."""
    import pickle

    t_start = time.perf_counter()
    from historian_tpu_torch.roots import compare_roots

    os.makedirs(BENCH_INPUTS, exist_ok=True)
    path = os.path.join(BENCH_INPUTS, "batch16.pkl")
    with open(path, "wb") as f:
        pickle.dump([t.cpu().numpy() for t in inputs], f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        compare_roots(os.path.join(REPO, "historian_tpu_torch", "sibling_bench.py"),
                      ["--batch", path, "--reps", "5"], [parent, REPO], 2, "sibling_bench")
    table = json.loads(buf.getvalue().splitlines()[-1])["compare"]
    digests = {r["cells_sha256"] for runs in table.values() for r in runs}
    for root, runs in table.items():
        tag = "parent" if root == os.path.abspath(parent) else "this"
        for r in runs:
            print(f"(q) (d') on the 16 grids, {tag} ({root}): {r['kernel_ms']:.3f} ms "
                  f"({r['kernel_ms'] * 1e3 / r['diagonals']:.3f} us a diagonal; "
                  f"{json.dumps(r['launch'])})", flush=True)
    print(f"(q) (d'): the parent's cells and this one's the same bits: {len(digests) == 1}; the "
          f"comparison took {time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(runs=table, same_bits=len(digests) == 1)


def phase_pair_modules(parent: str | None = None) -> dict:
    """(q) The last four modules the JAX package has, each on its
    hand-written kernel: (f) the tropical pair DP, (d') the batched sibling
    fill, (g2) the sequence-parallel and (g3) the pipeline-parallel pair
    Forward.

    The main path first, each entry point once with its launches counted
    from 0: `tropical_pair_forward` on long12's first two sequences (t01 x
    t02, ~6100 aa, float32), `SiblingMatrix.fill_batch` on bench.py:566's
    16 proposal grids, `sp_pair_forward` on long6's first two sequences at
    8 shards of the card (float64) and `sp_pair_forward_batch` on 8 pairs
    of K3's headline shape over 2 x 4 shards, `pp_pair_forward_lp` on K3's
    headline batch (128 x 384 x 384) at 4 stages (float64).  Then each
    kernel against its plain version at a cut and against its yardstick
    at full size, timed (CUDA events, the wrappers' calls):
    (f) cells on the pair's first TROPICAL_ROWS rows at all its columns (the
    full pair's block shape) in float32 and float64 (the -1e29 rule, the
    same -inf cells, TROPICAL_RTOL); at full size the rows above the cut's
    last bit-equal to the cut's, no NaN or +inf, its time beside K4's
    Forward time on the same pair and lp_best <= K4's lp_end (K4 float32:
    it takes at most 4096 lanes in float64);
    (d') the 16 grids in one launch against each matrix's fill.cpp fill
    (the same -inf cells, SIBLING_TOL) and kernel (d)'s fill alone (bit for
    bit), and against the plain version (SIBLING_PLAIN_RTOL); its time
    beside 16 fills on kernel (d) and on fill.cpp, and fill_batch's wall
    beside 16 SiblingMatrix fills on the device route;
    (g2) at 1, 2, 4 and 8 shards on the full long6 pair against K4 in
    float32, on the pair cut to 4095 columns against K4 in float64 (K4
    takes at most 4096 lanes there) and on the full pair in float64
    against the main path's 8-shard run (PAIR_RTOL), each timed (one call,
    CUDA events); against its plain version on the pair's first SP_ROWS
    rows at all its columns (the full pair's shards: float32 at 4 shards,
    float64 at 1, 4 and 8); the batch against K3;
    (f) and (g2): `phase_strips`;
    (g3) at 2, 4 and 8 stages on K3's headline shape and K4's long shape
    (6 x 3000 x 3000) against K3 / K4 in float64, timed; against its plain
    version on 8 pairs of the headline shape; on 4 stages at K4's long
    shape and long8x12k's first pair (10979 x 11019, past the one-block
    design's 8192 columns) against its plain version on the first PP_ROWS
    rows at every column, then timed at full size (long8x12k's lp_end
    against (g2)'s at one shard, PAIR_RTOL);
    (g2)'s batch of the card's capacity at its widest strip plus 9
    headline pairs, in waves, against K3 and (its first two pairs) the
    plain version.  Prints a {"pairmodules": ...} JSON line; returns each
    kernel's line entries."""
    from historian_tpu_torch import bench, device
    from historian_tpu_torch.ops import pairforward, pairstrips, siblingdp, sp_pairforward, tropical
    from historian_tpu_torch.parallel import pp_pairforward
    from historian_tpu_torch.sampler import sibling

    cuda = device.select("gpu")
    f32, f64 = torch.float32, torch.float64
    name = lambda dt: str(dt)[6:]  # noqa: E731
    long12 = [s for _, s in read_fasta(os.path.join(REPO, "tests", "data", "long12.fa"))]
    long6 = [s for _, s in read_fasta(os.path.join(REPO, "tests", "data", "long6.fa"))]
    trop_args = {dt: pair_arrays(long12[0], long12[1], dt) for dt in (f32, f64)}
    sp_args = {dt: pair_arrays(long6[0], long6[1], dt) for dt in (f32, f64)}
    head64 = bench.build("headline", cuda, f64)
    head8 = [t[:8].contiguous() for t in head64[:5]]
    mats = batch_mats()
    out, summary = {}, {}

    # ---- the main path, launches counted from 0
    tropical.LAUNCHES = siblingdp.BATCH_LAUNCHES = 0
    sp_pairforward.LAUNCHES = pp_pairforward.LAUNCHES = 0
    tropical.tropical_pair_forward(*trop_args[f32])
    if not sibling.SiblingMatrix.fill_batch(mats):
        raise AssertionError("fill_batch returned False")
    lp_sp8 = sp_pairforward.sp_pair_forward(*sp_args[f64], mesh=card_mesh(8))
    lp_spb = sp_pairforward.sp_pair_forward_batch(
        *head8, torch.ones(head8[0].shape[1:], dtype=torch.bool, device=cuda), head64[5],
        mesh=card_mesh(8, ("dp", "sp"), (2, 4)))
    lp_pp = pp_pairforward.pp_pair_forward_lp(*head64, mesh=card_mesh(4, ("pp",)))
    torch.cuda.synchronize()
    launches = dict(tropical=tropical.LAUNCHES, siblingbatch=siblingdp.BATCH_LAUNCHES,
                    sppairforward=sp_pairforward.LAUNCHES, pppairforward=pp_pairforward.LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f"(q) main path launches {launches}")
    print(f"(q) main path: tropical_pair_forward long12 t01 x t02 f32, fill_batch of 16 "
          f"grids, sp_pair_forward long6 f64 on 8 shards, sp_pair_forward_batch 8 headline "
          f"pairs on 2 x 4, pp_pair_forward_lp headline f64 on 4 stages: launches {launches}",
          flush=True)

    # ---- (f): against the plain version on the first rows at full width
    # (the full pair's block shape), at full size beside K4
    err_f = 0.0
    k4_args = [t[None].contiguous() for t in trop_args[f32][:5]] + [trop_args[f32][6]]
    k4_lp = pairforward.pair_forward_lp_tiled(*k4_args)
    k4_ms = cuda_ms(lambda: pairforward.pair_forward_lp_tiled(*k4_args), reps=1)
    for dt in (f32, f64):
        full = trop_args[dt]
        X1f, Y1f = full[0].shape
        cut = cut_pair(full, TROPICAL_ROWS, Y1f)
        (ref, ref_lp), p_ms = host_ms(lambda: tropical.tropical_pair_forward_plain(*cut))
        got, got_lp = tropical.tropical_pair_forward(*cut)
        e = max(tropical_check(f"(f) {name(dt)} cut cells", got, ref, TROPICAL_RTOL[dt]),
                tropical_check(f"(f) {name(dt)} cut lp_best", got_lp[None], ref_lp[None],
                               TROPICAL_RTOL[dt]))
        err_f = max(err_f, e)
        cut_inf = int((got == -math.inf).sum())
        ms_cut = cuda_ms(lambda: tropical.tropical_pair_forward(*cut))
        X1, Y1 = cut[0].shape
        bnd_cut = bound(nbytes(*cut, got, got_lp), TROPICAL_OPS_PER_CELL * X1 * Y1, dt)
        (cells, lp_best), ms_full = event_ms(lambda: tropical.tropical_pair_forward(*full))
        launch = dict(tropical.LAST_LAUNCH)
        # a row depends on the rows above alone (x is ready on every row but
        # the last): the full run's first rows are the cut run's, bit for bit
        if not torch.equal(cells[:X1 - 1], got[:X1 - 1]):
            raise AssertionError(f"(f) {name(dt)} full size: rows 0-{X1 - 2} differ from "
                                 f"the {X1}-row run's")
        if bool(cells.isnan().any()) or bool((cells == math.inf).any()) \
                or not -1e29 < float(lp_best) < 0:
            raise AssertionError(f"(f) {name(dt)} full size: NaN or +inf cells, or no path")
        full_inf = int((cells == -math.inf).sum())
        if not float(lp_best) <= float(k4_lp[0]) + 1e-5 * abs(float(k4_lp[0])):
            raise AssertionError(f"(f) {name(dt)}: lp_best {float(lp_best)} above K4's lp_end "
                                 f"{float(k4_lp[0])}")
        bnd_full = bound(nbytes(*full, cells, lp_best), TROPICAL_OPS_PER_CELL * X1f * Y1f, dt)
        summary[f"f {name(dt)}"] = dict(cut_ms=ms_cut, cut_plain_ms=p_ms, cut_err=e,
                                        cut_bound_ms=bnd_cut["bound_ms"], full_ms=ms_full,
                                        full_bound_ms=bnd_full["bound_ms"], k4_f32_ms=k4_ms,
                                        lp_best=float(lp_best), k4_lp_end=float(k4_lp[0]),
                                        cut_neg_inf_cells=cut_inf, full_neg_inf_cells=full_inf,
                                        lanes=launch["lanes"], warps=launch["warps"],
                                        strips=launch["strips"], cluster=launch["cluster"])
        print(f"(q) (f) {name(dt)}: {X1} x {Y1} (the first rows; {launch['strips']} strips of "
              f"{launch['lanes']} lanes x {launch['warps']} warps, clusters of "
              f"{launch['cluster']}) {ms_cut:.3f} ms, plain {p_ms:.1f} ms, max "
              f"abs err {e:.3e}, {cut_inf} -inf cells in both, bound {bnd_cut['bound_ms']:.4f} "
              f"ms ({bnd_cut['bound_by']}); full {X1f} x {Y1f} {ms_full:.3f} ms "
              f"({ms_full * 1e3 / X1f:.3f} us a row; rows 0-{X1 - 2} bit-equal to the cut's; "
              f"{full_inf} -inf cells: float32's log(0 + 1e-300) = -inf in row and column 0's "
              f"inputs, carried by max as in the JAX function), bound {bnd_full['bound_ms']:.4f} "
              f"ms; K4 f32 Forward on the pair {k4_ms:.3f} ms; lp_best {float(lp_best):.6f} <= "
              f"K4 lp_end {float(k4_lp[0]):.6f}", flush=True)
        if dt == f32:
            out["tropical"] = dict(ms=ms_cut, plain_ms=p_ms, **bnd_cut)
        del cells, got, ref
    out["tropical"]["err"] = err_f
    del trop_args, k4_args

    # ---- (d'): one launch against fill.cpp, kernel (d) and the plain version
    inputs = [torch.from_numpy(a).to(cuda) for a in sibling.SiblingMatrix.batch_arrays(mats)]
    cells, lp_end = siblingdp.sibling_forward_batch(*inputs)
    batch = dict(siblingdp.LAST_BATCH)
    ms = cuda_ms(lambda: siblingdp.sibling_forward_batch(*inputs))
    (plain, plain_lp), p_ms = host_ms(lambda: siblingdp.sibling_forward_batch_plain(*inputs))
    cells_h, lp_h, plain_h = cells.cpu().numpy(), lp_end.cpu().numpy(), plain.cpu().numpy()
    err_d, bit_equal, host_ms_sum, singles = 0.0, [], 0.0, []
    for k, m in enumerate(mats):
        sx, sy = m.x_size, m.y_size
        args = (m.match_emit, m.mask, m.l_emit, m.r_emit, siblingdp.transition_table(m))
        host, hlp, h_ms = sibling_host(args)
        host_ms_sum += h_ms
        got = cells_h[k, :sx, :sy]
        err_d = max(err_d, sibling_err(f"(d') item {k} vs fill.cpp", got, host))
        if not abs(lp_h[k] - hlp) <= SIBLING_TOL * abs(hlp):
            raise AssertionError(f"(d') item {k}: lp_end {lp_h[k]!r}, fill.cpp {hlp!r}")
        live = np.isfinite(host)
        bit_equal.append(float(np.mean(got[live] == host[live])))
        p = np.where(plain_h[k, :sx, :sy] <= -1e29, -np.inf, plain_h[k, :sx, :sy])
        sibling_err(f"(d') item {k} vs the plain version", got, p, SIBLING_PLAIN_RTOL)
        if not (np.all(cells_h[k, sx:] == -np.inf) and np.all(cells_h[k, :, sy:] == -np.inf)):
            raise AssertionError(f"(d') item {k}: a cell past its corner is not -inf")
        lay = band_of(m.mask)
        inp = siblingdp.upload_band(lay, *args, cuda)
        band, _ = siblingdp.sibling_fill_band(inp)
        if not np.array_equal(got.reshape(-1, 11)[lay.flat_index()], band.cpu().numpy()):
            raise AssertionError(f"(d') item {k}: not bit-equal to kernel (d)")
        singles.append(inp)
        if m.lp_end != lp_h[k] or not np.array_equal(np.asarray(m.cells), got):
            raise AssertionError(f"(d') item {k}: fill_batch's matrix differs from the launch")
    single_ms = cuda_ms(lambda: [siblingdp.sibling_fill_band(i) for i in singles])
    rebatch = batch_mats()
    _, batch_wall = host_ms(lambda: sibling.SiblingMatrix.fill_batch(rebatch))
    os.environ["HISTORIAN_DEVICE_SIBLING"] = "1"
    try:
        fresh = batch_mats()
        _, single_wall = host_ms(lambda: [m._fill() for m in fresh])
    finally:
        del os.environ["HISTORIAN_DEVICE_SIBLING"]
    in_mask = sum(int(np.count_nonzero(m.mask)) for m in mats)
    bnd = bound(nbytes(*inputs, cells, lp_end), SIBLING_OPS * in_mask, f64)
    K = len(mats)
    sizes = sorted((m.x_size, m.y_size) for m in mats)
    summary["d'"] = dict(ms=ms, plain_ms=p_ms, single_fills_ms=single_ms,
                         fill_cpp_ms=host_ms_sum, fill_batch_wall_ms=batch_wall,
                         single_device_walls_ms=single_wall, err=err_d,
                         bit_equal_min=min(bit_equal), **bnd)
    diagonals = max(x + y for x, y in sizes) - 1
    print(f"(q) (d') {K} grids ({sizes[0]} to {sizes[-1]}, padded to {tuple(inputs[2].shape[1:])}, "
          f"{in_mask} in-mask cells) in one launch (clusters of {batch['cluster']} blocks an "
          f"item, {batch['groups']} lane groups of {batch['lanes']} a block, {batch['turns']} "
          f"rows a lane group): {ms:.3f} ms ({ms * 1e3 / diagonals:.3f} us a diagonal over "
          f"{diagonals}); 16 single fills on kernel (d) {single_ms:.3f} ms, on "
          f"fill.cpp {host_ms_sum:.1f} ms; fill_batch wall {batch_wall:.1f} ms against 16 "
          f"device-route fills {single_wall:.1f} ms; plain {p_ms:.1f} ms; max abs err vs "
          f"fill.cpp {err_d:.3e} (bit-equal share >= {min(bit_equal):.6f}), bit-equal to "
          f"kernel (d); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    out["siblingbatch"] = dict(ms=ms, plain_ms=p_ms, err=err_d, **bnd)
    del cells, plain, cells_h, plain_h, singles
    if parent:
        summary["d' parent"] = batch_parent(parent, inputs)
    del inputs

    # ---- (g2): 1, 2, 4, 8 shards against K4 and the plain version
    err_g2, sp_times = 0.0, {}
    k4_ref = {}
    k4_f32 = [t[None].contiguous() for t in sp_args[f32][:5]] + [sp_args[f32][6]]
    k4_ref["full f32"] = pairforward.pair_forward_lp_tiled(*k4_f32)[0]
    cut64 = cut_pair(sp_args[f64], sp_args[f64][0].shape[0], pairforward.MAX_LANES[f64])
    k4_ref["4095 f64"] = pairforward.pair_forward_lp_tiled(
        *(t[None].contiguous() for t in cut64[:5]), cut64[6])[0]
    cases = {"full f32": sp_args[f32], "4095 f64": cut64, "full f64": sp_args[f64]}
    for n in (1, 2, 4, 8):
        for case, args in cases.items():
            got, ms_n = event_ms(lambda: sp_pairforward.sp_pair_forward(*args, mesh=card_mesh(n)))
            # K4 takes at most 4096 lanes in float64: the full pair in float64 is
            # held against the main path's run (8 shards)
            ref = lp_sp8 if case == "full f64" else k4_ref[case]
            dt = args[0].dtype
            e = rel_err(f"(g2) {case} {n} shards vs {'8 shards' if case == 'full f64' else 'K4'}",
                        got, ref, PAIR_RTOL[dt])
            sp_times[f"{case} {n}"] = dict(ms=ms_n, rel_err_k4=e)
            lay = sp_pairforward.LAST_LAUNCH["layouts"][0]
            print(f"(q) (g2) {case} {tuple(args[0].shape)} on {n} shards "
                  f"{sp_pairforward.LAST_LAUNCH['cols']} ({lay['strips']} strips of "
                  f"{lay['width']}): {ms_n:.3f} ms, lp_end "
                  f"{float(got):.6f}, {e:.3e} of |lp| from "
                  f"{'the 8-shard run' if case == 'full f64' else 'K4'} {name(ref.dtype)}",
                  flush=True)
    k4_ms = {dt: cuda_ms(lambda: pairforward.pair_forward_lp_tiled(
        *(t[None].contiguous() for t in a[:5]), a[6]), reps=1)
        for dt, a in ((f32, sp_args[f32]), (f64, cut64))}
    for dt, shards in ((f32, (4,)), (f64, (1, 4, 8))):
        cut = cut_pair(sp_args[dt], SP_ROWS, sp_args[dt][0].shape[1])
        for n in shards:
            got = sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(n))
            launch = dict(sp_pairforward.LAST_LAUNCH)
            plain, p_ms = host_ms(lambda: sp_pairforward.sp_pair_forward_plain(*cut, n))
            e = rel_err(f"(g2) {SP_ROWS} rows {name(dt)} {n} shards vs plain", got, plain,
                        PAIR_RTOL[dt])
            err_g2 = max(err_g2, float((got - plain).abs()))
            ms_n = cuda_ms(lambda: sp_pairforward.sp_pair_forward(*cut, mesh=card_mesh(n)))
            X1, Y1 = cut[0].shape
            bnd = bound(nbytes(*cut, got) + 2 * launch["record_bytes"],
                        PF_OPS_PER_CELL * X1 * Y1, dt)
            sp_times[f"cut {name(dt)} {n}"] = dict(ms=ms_n, plain_ms=p_ms, rel_err=e, **bnd)
            print(f"(q) (g2) {X1} x {Y1} {name(dt)} on {n} shards: {ms_n:.3f} ms, plain "
                  f"{p_ms:.1f} ms, {e:.3e} of |lp|; records {launch['record_bytes']} B; bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
            if dt == f64 and n == 8:  # the main path's shards
                out["sppairforward"] = dict(ms=ms_n, plain_ms=p_ms, **bnd)
    k3_ref = pairforward.pair_forward_lp(*head8, head64[5])
    e = rel_err("(g2) batch 2 x 4 vs K3", lp_spb, k3_ref, PAIR_RTOL[f64])
    ms_b = cuda_ms(lambda: sp_pairforward.sp_pair_forward_batch(
        *head8, torch.ones(head8[0].shape[1:], dtype=torch.bool, device=cuda), head64[5],
        mesh=card_mesh(8, ("dp", "sp"), (2, 4))))
    k3_ms = cuda_ms(lambda: pairforward.pair_forward_lp(*head8, head64[5]))
    gap = float(lp_sp8) - float(k4_ref["full f32"])
    print(f"(q) (g2) long6 f64 lp_end {float(lp_sp8):.6f}; K4 f32's {float(k4_ref['full f32']):.6f}"
          f" is {gap:.4f} nats off (float32's drift over {sp_args[f64][0].shape[0]} rows)",
          flush=True)
    sp_times["batch 2x4"] = dict(ms=ms_b, k3_ms=k3_ms, rel_err=e)
    summary["g2"] = dict(sp_times, k4_ms={name(k): v for k, v in k4_ms.items()})
    print(f"(q) (g2) sp_pair_forward_batch 8 headline pairs f64 on 2 x 4 shards: {ms_b:.3f} ms, "
          f"{e:.3e} of |lp| from K3 ({k3_ms:.3f} ms); K4 on the long6 pair f32 "
          f"{k4_ms[f32]:.3f} ms, at 4095 columns f64 {k4_ms[f64]:.3f} ms", flush=True)
    out["sppairforward"]["err"] = err_g2
    del sp_args, cut64

    # ---- (f), (g2): every strip layout, the host-memory boundary, long8x12k
    summary["strips"] = phase_strips(long12, long6)

    # ---- (g3): 2, 4, 8 stages against K3 and K4, float64
    long64 = bench.build("long", cuda, f64)
    pp_times = {}
    refs = {"headline": (head64, pairforward.pair_forward_lp(*head64),
                         cuda_ms(lambda: pairforward.pair_forward_lp(*head64))),
            "long": (long64, pairforward.pair_forward_lp_tiled(*long64),
                     cuda_ms(lambda: pairforward.pair_forward_lp_tiled(*long64), reps=1))}
    rel_err("(g3) main path headline 4 stages vs K3", lp_pp, refs["headline"][1], PAIR_RTOL[f64])
    for case, (args, ref, ref_ms) in refs.items():
        for n in (2, 4, 8):
            got = pp_pairforward.pp_pair_forward_lp(*args, mesh=card_mesh(n, ("pp",)))
            launch = dict(pp_pairforward.LAST_LAUNCH)
            e = rel_err(f"(g3) {case} {n} stages vs K3/K4", got, ref, PAIR_RTOL[f64])
            ms_n = cuda_ms(lambda: pp_pairforward.pp_pair_forward_lp(
                *args, mesh=card_mesh(n, ("pp",))), reps=3 if case == "headline" else 1)
            B, X1, Y1 = args[0].shape
            bnd = bound(nbytes(*args, got) + 2 * launch["boundary_bytes"],
                        PF_OPS_PER_CELL * B * X1 * Y1, f64)
            lay = next(iter(launch["layouts"].values()))
            pp_times[f"{case} {n}"] = dict(ms=ms_n, ref_ms=ref_ms, rel_err=e, layout=lay, **bnd)
            print(f"(q) (g3) {case} {B} x {X1 - 1} x {Y1 - 1} f64 on {n} stages ({lay['slots']} "
                  f"slots for {lay['items']} items, strips of {lay['lanes']} lanes x "
                  f"{lay['warps']} warps, clusters of {lay['cluster']}): {ms_n:.3f} ms, "
                  f"{'K3' if case == 'headline' else 'K4'} {ref_ms:.3f} ms, {e:.3e} of |lp|; "
                  f"boundaries {launch['boundary_bytes']} B; bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']})", flush=True)
    h8 = list(head8) + [head64[5]]
    got = pp_pairforward.pp_pair_forward_lp(*h8, mesh=card_mesh(4, ("pp",)))
    launch = dict(pp_pairforward.LAST_LAUNCH)
    plain, p_ms = host_ms(lambda: pp_pairforward.pp_pair_forward_lp_plain(*h8, 4))
    e = rel_err("(g3) 8 headline pairs 4 stages vs plain", got, plain, PAIR_RTOL[f64])
    ms = cuda_ms(lambda: pp_pairforward.pp_pair_forward_lp(*h8, mesh=card_mesh(4, ("pp",))))
    B, X1, Y1 = h8[0].shape
    bnd = bound(nbytes(*h8, got) + 2 * launch["boundary_bytes"],
                PF_OPS_PER_CELL * B * X1 * Y1, f64)
    pp_times["plain 8 headline 4"] = dict(ms=ms, plain_ms=p_ms, rel_err=e, **bnd)
    print(f"(q) (g3) 8 headline pairs f64 on 4 stages: {ms:.3f} ms, plain {p_ms:.1f} ms, "
          f"{e:.3e} of |lp|; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    out["pppairforward"] = dict(ms=ms, plain_ms=p_ms, err=float((got - plain).abs().max()),
                                **bnd)
    # K4's long shape and long8x12k's first pair (past the one-block
    # design's 8192 columns) on 4 stages: against the plain version on
    # their first PP_ROWS rows at every column, then at full size timed
    wide = [s for _, s in read_fasta(os.path.join(REPO, "tests", "data", "long8x12k.fa"))]
    wide_args = [t[None].contiguous() for t in pair_arrays(wide[0], wide[1], f64)]
    for case, args in (("long", long64), ("long8x12k", wide_args[:5] + [wide_args[6][0]])):
        cut = [t[:, :PP_ROWS].contiguous() if t.dim() > 1 and k in (0, 1, 3) else t
               for k, t in enumerate(args)]
        got = pp_pairforward.pp_pair_forward_lp(*cut, mesh=card_mesh(4, ("pp",)))
        plain, p_ms = host_ms(lambda: pp_pairforward.pp_pair_forward_lp_plain(*cut, 4))
        e = rel_err(f"(g3) {case} first {PP_ROWS} rows vs plain", got, plain, PAIR_RTOL[f64])
        lp, ms = event_ms(lambda: pp_pairforward.pp_pair_forward_lp(
            *args, mesh=card_mesh(4, ("pp",))))
        lay = next(iter(pp_pairforward.LAST_LAUNCH["layouts"].values()))
        if not bool((lp > -1e29).all() & (lp < 0).all()):
            raise AssertionError(f"(g3) {case} full size: lp_end {lp.tolist()}")
        P, X1, Y1 = args[0].shape
        pp_times[f"{case} full 4"] = dict(ms=ms, cut_rel_err=e, cut_plain_ms=p_ms, layout=lay,
                                          lp=lp.tolist())
        print(f"(q) (g3) {case} {P} x {X1} x {Y1} f64 on 4 stages ({lay['slots']} slots, "
              f"strips of {lay['width']}): {ms:.3f} ms ({ms * 1e3 / X1:.3f} us a row); first "
              f"{PP_ROWS} rows at all columns {e:.3e} of |lp| from the plain version "
              f"({p_ms:.1f} ms)", flush=True)
    wide_lp = float(pp_times["long8x12k full 4"]["lp"][0])
    g2_wide = summary["strips"]["long8x12k g2 float64 1"]["lp"]
    e = rel_err("(g3) long8x12k vs (g2) 1 shard", torch.tensor([wide_lp]),
                torch.tensor([g2_wide]), PAIR_RTOL[f64])
    print(f"(q) (g3) long8x12k lp_end {wide_lp:.6f}, (g2)'s {g2_wide:.6f}: {e:.3e} of |lp|; K4 "
          f"on the long shape {refs['long'][2]:.3f} ms", flush=True)
    summary["g3"] = pp_times
    del long64, wide_args

    # ---- (g2): a batch past what one launch holds, in waves
    cap = pairstrips.card_capacity("sppairforward", "f64", torch.cuda.current_device(), 4, 8, 1)
    reps = -(-(cap + 9) // head64[0].shape[0])
    big = [torch.cat([t] * reps)[:cap + 9].contiguous() for t in head64[:5]]
    ones = torch.ones(big[0].shape[1:], dtype=torch.bool, device=cuda)
    got, ms = event_ms(lambda: sp_pairforward.sp_pair_forward_batch(
        *big, ones, head64[5], mesh=card_mesh(1, ("dp", "sp"), (1, 1))))
    waves = list(sp_pairforward.LAST_LAUNCH["waves"])
    if len(waves) < 2 or sum(waves) != cap + 9:
        raise AssertionError(f"(g2) batch of {cap + 9}: waves {waves}")
    k3_lp, k3_ms = event_ms(lambda: pairforward.pair_forward_lp(*big, head64[5]))
    e = rel_err("(g2) batch past capacity vs K3", got, k3_lp, PAIR_RTOL[f64])
    plain = torch.stack([sp_pairforward.sp_pair_forward_plain(*(t[b] for t in big), ones,
                                                              head64[5], 1) for b in (0, 1)])
    e_p = rel_err("(g2) batch past capacity vs plain", got[:2], plain, PAIR_RTOL[f64])
    summary["g2 waves"] = dict(pairs=cap + 9, capacity=cap, waves=waves, ms=ms, k3_ms=k3_ms,
                               rel_err_k3=e, rel_err_plain=e_p)
    print(f"(q) (g2) sp_pair_forward_batch of {cap + 9} headline pairs f64 (one launch holds "
          f"{cap} at the widest strip): waves {waves}, {ms:.3f} ms, K3 {k3_ms:.3f} ms, "
          f"{e:.3e} of |lp| from K3, {e_p:.3e} from the plain version (first 2 pairs)",
          flush=True)
    del big
    print(json.dumps({"pairmodules": dict(summary, launches=launches)}), flush=True)
    return dict(out, launches=launches)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of historian_tpu_torch on one card.")
    ap.add_argument("--parent", help="a checkout of another version (e.g. the parent commit "
                    "unpacked under build/): time its kernels (e), (d), (a) and (d') beside "
                    "this one's in (m), (n), (o) and (q)")
    opts = ap.parse_args(argv)
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

    def elapsed(phases: str) -> None:
        print(f"(time) phases {phases} done at {time.perf_counter() - t0:.1f} s", flush=True)

    k1 = phase_k1(colforward)
    walk_planes = k1.pop("walk_planes")
    f32, f64 = torch.float32, torch.float64
    dag_err = phase_walker(tracedp, "dag", *walk_planes.pop(("dag", f64)), 3)["err"]
    for dt in (f32, f64):
        phase_walker(tracedp, "long12 best only", *walk_planes[("long12", dt)], 0)
    sampled_err = phase_walker(tracedp, "long12 in order", *walk_planes[("long12", f32)], 2)["err"]
    phase_walker(tracedp, "long12 in order", *walk_planes.pop(("long12", f32)), 10, check=False)
    walker = phase_walker(tracedp, "long12", *walk_planes.pop(("long12", f64)), 1)
    elapsed("a-d")
    launches = phase_e2e(cli, colforward, tracedp)
    k2 = phase_k2(colforward)
    guide = phase_guide(guidedp)
    launches_h = phase_guide_e2e(cli, colforward, tracedp, guidedp)
    pf = phase_pairforward(pairforward, bench, torch.device("cuda"))
    elapsed("e-i")
    with tempfile.TemporaryDirectory() as work:
        launches_j = phase_default_recon(cli, colforward, tracedp, guidedp, work)
        routes_k = phase_counts(cli, work)
        elapsed("j-k")
        launches_l = phase_careful(cli, colforward, tracedp, guidedp, work)
        elapsed("l")
        branch = phase_branch(cli, colforward, tracedp, guidedp,
                              launches_l.pop("branch_args"), launches_l.pop("matrix_args"),
                              opts.parent)
        elapsed("m")
        mcmc = phase_mcmc(cli, launches_l.pop("long6_recon"), opts.parent)
        elapsed("n")
        # (j) and (l) ran small6 from work, and (o) compares with their outputs
        small6_cpu = launches_j.pop("small6_cpu")
        dag = phase_dag(cli, work, small6_cpu, launches_l.pop("small6_careful_cpu"), opts.parent)
        elapsed("o")
        spf = phase_sp(cli, colforward, work, small6_cpu)
        elapsed("p")
    pairs = phase_pair_modules(opts.parent)
    elapsed("q")

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
    # kernel (e)'s two designs: the ring at long6's first refine fill (m),
    # the strips at long6 mcmc's full-mask Forward fill (n)
    strip = mcmc["branch_strip"]
    kernels.append(dict(
        name="branchfill", route="cuda", source="historian_tpu_torch/csrc/branchfill.cu",
        replaces="historian_tpu/ops/branchdp.py:41",
        launches=launches_l["f32"]["branch_designs"]["ring"] + mcmc["branch_launches"]["ring"],
        max_abs_err=max(branch["err"], mcmc["branch_err"]), ms=branch["ms"],
        plain_ms=branch["plain_ms"], bound_ms=branch["bound_ms"], bound_by=branch["bound_by"],
        library_ms=None))
    kernels.append(dict(
        name="branchfill_strip", route="cuda", source="historian_tpu_torch/csrc/branchfill.cu",
        replaces="historian_tpu/ops/branchdp.py:41",
        launches=launches_l["f32"]["branch_designs"]["strip"] + mcmc["branch_launches"]["strip"],
        max_abs_err=max(strip["err"], strip["plain_err"]), ms=strip["ms"],
        plain_ms=strip["plain_ms"], bound_ms=strip["bound_ms"], bound_by=strip["bound_by"],
        library_ms=None))
    kernels.append(dict(
        name="siblingfill", route="cuda", source="historian_tpu_torch/csrc/siblingfill.cu",
        replaces="historian_tpu/ops/siblingdp.py:70", launches=mcmc["launches"],
        max_abs_err=mcmc["err"], ms=mcmc["ms"], plain_ms=mcmc["plain_ms"],
        bound_ms=mcmc["bound_ms"], bound_by=mcmc["bound_by"], library_ms=None))
    kernels.append(dict(
        name="siblingplan", route="cuda", source="historian_tpu_torch/csrc/siblingfill.cu",
        replaces="historian_tpu/ops/siblingdp.py:70", launches=mcmc["plan_launches"],
        max_abs_err=0.0, ms=mcmc["plan_ms"], plain_ms=mcmc["plain_plan_ms"],
        bound_ms=mcmc["plan_bound"]["bound_ms"], bound_by=mcmc["plan_bound"]["bound_by"],
        library_ms=None))
    kernels.append(dict(
        name="dagfill", route="cuda", source="historian_tpu_torch/csrc/dagfill.cu",
        replaces="historian_tpu/ops/dagforward.py:55", launches=dag["launches"],
        max_abs_err=dag["err"], ms=dag["ms"], plain_ms=dag["plain_ms"],
        bound_ms=dag["bound_ms"], bound_by=dag["bound_by"], library_ms=None))
    kernels.append(dict(
        name="dagplan", route="cuda", source="historian_tpu_torch/csrc/dagfill.cu",
        replaces="historian_tpu/ops/devicedp.py:747", launches=dag["plan_launches"],
        max_abs_err=dag["plan_err"], ms=dag["plan_ms"], plain_ms=dag["plain_plan_ms"],
        bound_ms=dag["plan_bound"]["bound_ms"], bound_by=dag["plan_bound"]["bound_by"],
        library_ms=None))
    kernels.append(dict(
        name="spcolforward", route="cuda", source="historian_tpu_torch/csrc/spcolforward.cu",
        replaces="historian_tpu/ops/sp_colforward.py:50", launches=spf["launches"],
        max_abs_err=spf["err"], ms=spf["ms"], plain_ms=spf["plain_ms"],
        bound_ms=spf["bound_ms"], bound_by=spf["bound_by"], library_ms=None))
    for name, source, line in (
            ("tropical", "tropical.cu", "historian_tpu/ops/tropical.py:68"),
            ("siblingbatch", "siblingfill.cu", "historian_tpu/ops/siblingdp.py:215"),
            ("sppairforward", "sppairforward.cu", "historian_tpu/ops/sp_pairforward.py:76"),
            ("pppairforward", "pppairforward.cu", "historian_tpu/parallel/pp_pairforward.py:32")):
        k = pairs[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"historian_tpu_torch/csrc/{source}", replaces=line,
            launches=pairs["launches"][name], max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=None))
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
