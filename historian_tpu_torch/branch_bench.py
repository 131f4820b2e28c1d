"""Times kernel (e), the branch fill, on one fill's saved inputs, and
compares checkouts of the package on the same card.

    python -m historian_tpu_torch.branch_bench --inputs F.npz [--reps 5]
    python -m historian_tpu_torch.branch_bench --inputs F.npz --roots DIR ... [--rounds 2]

F.npz holds one fill's `match_emit` [X+1, Y+1], `ins_emit` [Y+1], `mask`
(bool [X+1, Y+1]) and `trans` [8] (chip_smoke.py --parent writes long6's
first refine fill there).  One run prints, as its last line, a JSON
object with the kernel's ms in each mode (CUDA events, median of `reps`
after a warm launch): the kernel alone (the band entry
`branchdp.branch_fill_band` on inputs already on the card where the
package has one, else its full-grid kernel on its precomputed diagonal
ranges and NEG grid) and the whole `branchdp.branch_fill` wrapper.
With --roots, each root's run in turn, parent and change alternating
(roots.compare_roots), then a `{"compare": ...}` line.
"""

from __future__ import annotations

import argparse
import json
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


def kernel_call(branchdp, args, viterbi: bool):
    """A call that launches the package's kernel alone on `args` (CUDA
    tensors), and its design."""
    if hasattr(branchdp, "branch_fill_band"):
        hull = (t.cpu().numpy() for t in branchdp.interior_hull(args[2]))
        layout = branchdp.band_layout(*hull, *args[0].shape)
        inp = branchdp.band_inputs(layout, args[0], args[2], args[1], args[3])
        return (lambda: branchdp.branch_fill_band(inp, viterbi)), layout.design()
    from historian_tpu_torch.ops import _kernels

    emit, ins, mask, trans = args
    X1, Y1 = emit.shape
    xa, xb = branchdp.diagonal_ranges(mask)
    widest = int((xb - xa + 1).clamp(min=0).max()) + 4
    threads = min(branchdp.MAX_THREADS, -(-widest // 32) * 32)
    cells = torch.full((X1, Y1, 3), branchdp.NEG, dtype=torch.float64, device=emit.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = _kernels.lib().branchfill_f64(
            emit.data_ptr(), ins.data_ptr(), mask.data_ptr(), trans.data_ptr(), xa.data_ptr(),
            xb.data_ptr(), cells.data_ptr(), X1, Y1, int(viterbi), threads, stream)
        _kernels.check(code, "branchfill")

    return launch, "diagonal rows"


def measure(path: str, reps: int) -> dict:
    from historian_tpu_torch.ops import branchdp

    if not torch.cuda.is_available():
        raise RuntimeError("branch_bench times the card: no CUDA device")
    dev = torch.device("cuda")
    with np.load(path) as f:
        args = [torch.as_tensor(f[k], device=dev)
                for k in ("match_emit", "ins_emit", "mask", "trans")]
    out = dict(shape=list(args[0].shape), in_mask=int(args[2].sum()),
               card=torch.cuda.get_device_name(0))
    for viterbi, mode in ((True, "viterbi"), (False, "forward")):
        launch, design = kernel_call(branchdp, args, viterbi)
        out[f"{mode}_ms"] = median_ms(launch, reps)
        out[f"{mode}_wrapper_ms"] = median_ms(lambda: branchdp.branch_fill(*args, viterbi), reps)
        out["design"] = design
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
                             opts.roots, opts.rounds, "branch_bench")
    print(json.dumps(measure(opts.inputs, opts.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
