"""Command-line interface of the port: `recon` on PyTorch and CUDA.

Same flags as historian_tpu/cli.py for the reconstruction subset, the
same `-fast` alias, plus `-platform gpu|cpu`: `gpu`, the default, needs
CUDA and fails without it; `cpu` runs the kernels' plain PyTorch
versions and is only ever chosen explicitly.  Flags of paths that are
not ported yet are accepted where the JAX CLI accepts them and raise
NotImplementedError when the run reaches them.
"""

from __future__ import annotations

import sys
from collections import deque

from historian_tpu.utils.logging import logger
from historian_tpu_torch import __version__
from historian_tpu_torch import device as devmod
from historian_tpu_torch.recon import (
    FORMAT_FASTA,
    FORMAT_JSON,
    FORMAT_NEXUS,
    FORMAT_STOCKHOLM,
    Reconstructor,
    not_ported,
)

PROG = "historian-tpu-torch"

FAST_ALIAS = ["-rndspan", "-kmatchn", "3", "-band", "10", "-profmaxstates", "1", "-jc", "-norefine"]

HELP = f"""{PROG}: historian-tpu's `recon` on PyTorch and CUDA

Usage: {PROG} recon [options] [files]

  -platform gpu|cpu  device (default gpu; cpu must be given explicitly)
  -seqs <file>       unaligned FASTA (needs -tree and -noband)
  -guide <file>      gapped FASTA guide alignment (needs -tree)
  -tree <file>       Newick tree      -reroot <node>
  -model <file>      rate-model JSON  -preset <name>  -codon  -normalize
  -insrate/-delrate/-insextprob/-delextprob/-gaprate/-gapextprob <x>
  -inslen/-dellen/-gaplen <L>  -subscale/-indelscale/-scale <x>
  -gamma <n> -shape <a>  -savemodel <file>
  -band <n> | -noband  -profmaxstates <n>  -profsamples <n>
  -output fasta|nexus|stockholm|json  -noancs  -seed <n>
  -fast  (= -rndspan -kmatchn 3 -band 10 -profmaxstates 1 -jc -norefine)
"""

#: flags of the JAX CLI whose paths are not ported yet
_NOT_PORTED = {
    "-profminpost": "sampled-profile and DAG x DAG merges",
    "-profmaxmem": "sampled-profile and DAG x DAG merges",
    "-keepgapsopen": "sampled-profile and DAG x DAG merges",
    "-nobest": "sampled-profile and DAG x DAG merges",
    "-ancseq": "counts/fit/-ancseq", "-ancprob": "counts/fit/-ancseq",
    "-refine": "MCMC/refiner", "-mcmc": "MCMC/refiner",
    "-savedot": "full-readback/BackwardMatrix",
    "-nexus": "guide stage", "-stockholm": "guide stage", "-saveguide": "guide stage",
    "-mesh": "multi-GPU", "-careful": "guide stage",
}
#: guide-stage tuning flags: accepted (the guide stage never runs here)
_GUIDE_FLAGS = {"-rndspan": 0, "-allspan": 0, "-upgma": 0, "-nj": 0, "-jc": 0,
                "-kmatchoff": 0, "-kmatchmax": 0, "-norefine": 0,
                "-kmatchn": 1, "-kmatch": 1, "-kmatchband": 1, "-kmatchmb": 1}
_MODEL_PARAMS = ("-insrate", "-delrate", "-insextprob", "-delextprob", "-inslen",
                 "-dellen", "-gaprate", "-gapextprob", "-gaplen", "-subscale",
                 "-indelscale", "-scale")
_FORMATS = {"fasta": FORMAT_FASTA, "nexus": FORMAT_NEXUS,
            "stockholm": FORMAT_STOCKHOLM, "json": FORMAT_JSON}


def _parse(recon: Reconstructor, argvec: deque) -> None:
    while argvec:
        arg = argvec.popleft()

        def take():
            if not argvec:
                raise SystemExit(f"{PROG}: option {arg!r} requires an argument")
            return argvec.popleft()

        if arg in _NOT_PORTED:
            raise not_ported(f"option {arg}", _NOT_PORTED[arg])
        if arg in _GUIDE_FLAGS:
            for _ in range(_GUIDE_FLAGS[arg]):
                take()
        elif arg == "-fast":
            argvec.extendleft(reversed(FAST_ALIAS))
        elif arg == "-model":
            recon.model_filename = take()
        elif arg == "-preset":
            recon.preset_model_name = take()
        elif arg == "-normalize":
            recon.normalize_model = True
        elif arg in _MODEL_PARAMS:
            recon.model_param[arg[1:]] = float(take())
        elif arg == "-gamma":
            recon.gamma_categories = int(take())
        elif arg == "-shape":
            recon.gamma_shape = float(take())
        elif arg == "-savemodel":
            recon.model_save_filename = take()
        elif arg == "-codon":
            recon.tokenize_codons = True
        elif arg == "-auto":
            recon.load_auto(take())
        elif arg == "-seqs":
            recon.seq_filenames.append(take())
        elif arg == "-guide":
            recon.fasta_guide_filenames.append(take())
        elif arg == "-tree":
            recon.tree_filename = take()
        elif arg in ("-root", "-reroot"):
            recon.tree_root = take()
        elif arg == "-output":
            fmt = take().lower()
            if fmt not in _FORMATS:
                raise SystemExit(f"{PROG}: unknown output format {fmt!r} "
                                 f"(expected one of: {', '.join(_FORMATS)})")
            recon.output_format = _FORMATS[fmt]
        elif arg == "-noancs":
            recon.output_leaves_only = True
        elif arg == "-band":
            recon.max_distance_from_guide = int(take())
        elif arg == "-noband":
            recon.max_distance_from_guide = -1
        elif arg == "-profsamples":
            recon.profile_samples = int(take())
        elif arg == "-profmaxstates":
            recon.profile_node_limit = int(take())
        elif arg == "-seed":
            recon.rnd_seed = int(take())
        elif not arg.startswith("-"):
            recon.load_auto(arg)
        else:
            raise SystemExit(f"{PROG}: unknown option {arg!r} (try '{PROG} help')")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    platform = "gpu"
    if "-platform" in argv:
        i = argv.index("-platform")
        if i + 1 >= len(argv):
            raise SystemExit(f"{PROG}: option '-platform' requires an argument")
        platform = argv[i + 1]
        del argv[i : i + 2]
    argv = logger.parse_args(argv)
    if not argv or argv[0] in ("help", "h", "-h", "--help"):
        sys.stderr.write(HELP)
        return 0 if argv else 1
    if argv[0] in ("version", "v", "--version", "-V"):
        print(f"{PROG} {__version__}")
        return 0
    command, rest = argv[0], argv[1:]
    if command in ("r", "recon", "reconstruct"):
        command = "recon"
    elif command in ("c", "count", "f", "fit", "m", "mcmc", "s", "sum", "g", "generate"):
        raise not_ported(f"the {command!r} command", "counts/fit/-ancseq and MCMC/refiner")
    else:
        rest = argv  # no command word: reconstruct
    devmod.select(platform)
    recon = Reconstructor()
    _parse(recon, deque(rest))
    recon.load_model()
    recon.load_seqs()
    recon.reconstruct_all()
    recon.write_recon(sys.stdout)
    return 0
