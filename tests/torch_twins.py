"""The two packages side by side, for the port's tests.

`JAX` and `PORT` hold the same host modules of historian_tpu and of
historian_tpu_torch under the same names, so that a test builds its
objects from each package's own classes on the same inputs and compares
the results, and never hands an object of one package to the other."""

import contextlib
import importlib
import io
import os
from types import SimpleNamespace

DATA = os.path.join(os.path.dirname(__file__), "data")
MODULES = {
    "seqs": "core.seqs", "alignpath": "core.alignpath", "tree": "core.tree",
    "diagenv": "engine.diagenv", "forward": "engine.forward", "pairhmm": "engine.pairhmm",
    "profile": "engine.profile", "presets": "models.presets", "ratemodel": "models.ratemodel",
    "rng": "utils.rng", "seqgraph": "engine.seqgraph", "sumprod": "engine.sumprod",
    "stockholm": "core.stockholm",
}


def side(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})


JAX = side("historian_tpu")
PORT = side("historian_tpu_torch")


class PortHostForwardMatrix(PORT.forward.ForwardMatrix):
    """The port's ForwardMatrix filled on the host (the native runtime),
    as the JAX package's is under HISTORIAN_DEVICE_DP=0."""

    def _fill_device(self) -> bool:
        return False


def host_forward(pkg, *args, **kw):
    """A host-filled ForwardMatrix of `pkg` (the JAX package's takes the
    host under HISTORIAN_DEVICE_DP=0)."""
    cls = PortHostForwardMatrix if pkg is PORT else pkg.forward.ForwardMatrix
    return cls(*args, **kw)


def leaves(pkg, n, cut, preset="lg"):
    """(model, profiles) of `pkg`: the first n sequences of long8 cut to
    `cut` aa; the second loses two short stretches, so that sampled
    traces disagree on the gaps."""
    model = pkg.presets.named_model(preset)
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long8.fa"))[:n]
    for s in seqs:
        s.seq = s.seq[:cut]
    seqs[1].seq = seqs[1].seq[:cut // 3] + seqs[1].seq[cut // 3 + 6: 3 * cut // 4] \
        + seqs[1].seq[3 * cut // 4 + 3:]
    profs = [pkg.profile.Profile.from_sequence(model.components, model.alphabet, s, i)
             for i, s in enumerate(seqs)]
    return model, profs


def pair_hmm(pkg, model, t_l, t_r):
    rm = pkg.ratemodel
    return pkg.pairhmm.PairHMM(rm.ProbModel(model, t_l), rm.ProbModel(model, t_r), model.ins_prob)


def count_fills(root: str, args: list) -> tuple:
    """(bands, stdout) of `recon <args>` of package `root`, run in this
    process: the band (`max_distance`, -1 without a guide) of every
    ForwardMatrix that its recon.py builds, band-doubling retries
    included, in order.  The JAX package takes its host route when
    HISTORIAN_PLATFORM=cpu and HISTORIAN_DEVICE_DP=0 are set.  On long
    inputs, give both packages one guide and tree saved by the port
    (`-saveguide g.sto`, then `-stockholm g.sto`): the JAX package's guide
    stage on 6000-aa sequences is heavy in memory on the CPU."""
    recon = importlib.import_module(f"{root}.recon")
    cli = importlib.import_module(f"{root}.cli")
    fill, bands = recon.ForwardMatrix, []

    class Counted(fill):
        def __init__(self, *a, **k):
            env = a[4] if len(a) > 4 else k.get("env")
            bands.append(env.max_distance if env is not None and env.initialized else -1)
            super().__init__(*a, **k)

    recon.ForwardMatrix = Counted
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(["recon", *args]) == 0
    finally:
        recon.ForwardMatrix = fill
    return bands, out.getvalue()


def long6_pair(x_len: int, y_len: int, dtype, t_x: float = 0.7, t_y: float = 0.4,
               offset: int = 0, pair: tuple = (0, 1)) -> tuple:
    """The port's pair-DP inputs (absorb, rootsub_x, rootsub_y, ins_x, ins_y,
    mask, trans; torch, on the CPU) of two long6 sequences cut to x_len and
    y_len residues from `offset`, preset lg: the arrays a test hands to
    both packages (the JAX package's as numpy copies)."""
    from historian_tpu_torch.ops.pairforward import chain_pair_forward_arrays

    seqs = PORT.seqs.read_fasta(os.path.join(DATA, "long6.fa"))
    x = seqs[pair[0]].seq[offset: offset + x_len]
    y = seqs[pair[1]].seq[offset: offset + y_len]
    args, _ = chain_pair_forward_arrays(PORT.presets.named_model("lg"), x, y, t_x, t_y,
                                        dtype=dtype)
    return args


def band_mask(X1: int, Y1: int, width: int):
    """A diagonal band (|i (Y1-1)/(X1-1) - j| <= width) with row 0, column 0
    and the corner in, as a bool tensor [X1, Y1]."""
    import numpy as np
    import torch

    diag = np.arange(X1)[:, None] * ((Y1 - 1) / max(X1 - 1, 1))
    band = np.abs(diag - np.arange(Y1)[None, :]) <= width
    band[0, :] = band[:, 0] = True
    band[-1, -1] = True
    return torch.from_numpy(band)
