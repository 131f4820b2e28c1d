"""Command-line interface of the port: `recon` on PyTorch and CUDA.

Same flags as historian_tpu/cli.py for the reconstruction subset, the
same `-fast` alias, plus `-platform gpu|cpu`: `gpu`, the default, needs
CUDA and fails without it; `cpu` runs the kernels' plain PyTorch
versions and is only ever chosen explicitly.  The guide and tree flags
have their JAX meaning; flags of paths that are not ported yet raise
NotImplementedError naming their ROADMAP item, none is dropped silently.
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

CAREFUL_ALIAS = ["-allspan", "-kmatchoff", "-band", "40", "-profminpost", ".001",
                 "-profmaxmem", "5", "-refine"]
FAST_ALIAS = ["-rndspan", "-kmatchn", "3", "-band", "10", "-profmaxstates", "1", "-jc", "-norefine"]

HELP = f"""{PROG}: historian-tpu's `recon` on PyTorch and CUDA

Usage: {PROG} recon [options] [files]

  -platform gpu|cpu  device (default gpu; cpu must be given explicitly)
  -seqs <file>       unaligned FASTA (guide stage, unless -noband with -tree)
  -guide <file>      gapped FASTA guide alignment
  -nexus <file>      Nexus guide alignment and tree
  -stockholm <file>  Stockholm guide alignment (with its tree if it has one)
  -tree <file>       Newick tree (default: built from the guide)  -reroot <node>
  -saveguide <file>  append the guide alignment and tree to <file>
  -rndspan | -allspan  random sparse (default) or all-pairs guide graph
  -kmatch <k> -kmatchn <n> -kmatchband <w> -kmatchmb <MB> -kmatchmax -kmatchoff
                     k-mer envelope of the guide alignments
  -upgma | -nj       tree from distances by UPGMA (default) or neighbour joining
  -jc                Jukes-Cantor distances (default: ML)
  -model <file>      rate-model JSON  -preset <name>  -codon  -normalize
  -insrate/-delrate/-insextprob/-delextprob/-gaprate/-gapextprob <x>
  -inslen/-dellen/-gaplen <L>  -subscale/-indelscale/-scale <x>
  -gamma <n> -shape <a>  -savemodel <file>
  -band <n> | -noband  -profmaxstates <n>  -profsamples <n>
  -output fasta|nexus|stockholm|json  -noancs  -seed <n>
  -fast  (= -rndspan -kmatchn 3 -band 10 -profmaxstates 1 -jc -norefine)
  -careful  (= -allspan -kmatchoff -band 40 -profminpost .001 -profmaxmem 5
             -refine; not ported: -profminpost needs the BackwardMatrix)
"""

#: flags of the JAX CLI whose paths are not ported yet
_NOT_PORTED = {
    "-profminpost": "full-readback/BackwardMatrix",
    "-profmaxmem": "sampled-profile and DAG x DAG merges",
    "-keepgapsopen": "sampled-profile and DAG x DAG merges",
    "-nobest": "sampled-profile and DAG x DAG merges",
    "-ancseq": "counts/fit/-ancseq", "-ancprob": "counts/fit/-ancseq",
    "-refine": "MCMC/refiner", "-mcmc": "MCMC/refiner",
    "-profminlen": "sampled-profile and DAG x DAG merges",
    "-profmaxlen": "sampled-profile and DAG x DAG merges",
    "-savedot": "full-readback/BackwardMatrix",
    "-dotpost": "full-readback/BackwardMatrix",
    "-dotgapsopen": "full-readback/BackwardMatrix",
    "-dotsubpost": "full-readback/BackwardMatrix",
    **{flag: "counts/fit/-ancseq" for flag in (
        "-recon", "-nexusrecon", "-stockrecon", "-counts", "-mininc", "-maxiter",
        "-nolaplace", "-fixsubrates", "-fixgaprates", "-rootlen")},
    **{flag: "MCMC/refiner" for flag in (
        "-samples", "-trace", "-checkpoint", "-ckptevery", "-fixtree", "-fixalign",
        "-fixguide")},
    "-mesh": "multi-GPU",
}
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
        env = recon.diag_env_params
        if arg == "-norefine":
            pass  # -refine is not ported, so the merge never refines
        elif arg in ("-rndspan", "-allspan"):
            recon.guide_align_try_all_pairs = arg == "-allspan"
        elif arg in ("-upgma", "-nj"):
            recon.use_upgma = arg == "-upgma"
        elif arg == "-jc":
            recon.jukes_cantor_distance_matrix = True
        elif arg == "-kmatchn":
            env.kmer_threshold = int(take())
        elif arg == "-kmatch":
            env.kmer_len = int(take())
        elif arg == "-kmatchband":
            env.band_size = int(take())
        elif arg == "-kmatchmb":
            env.max_size = int(take()) << 20
            env.kmer_threshold = -1
        elif arg == "-kmatchmax":
            env.kmer_threshold = -1
        elif arg == "-kmatchoff":
            env.sparse = False
        elif arg == "-fast":
            argvec.extendleft(reversed(FAST_ALIAS))
        elif arg == "-careful":  # its -profminpost raises, naming its item
            argvec.extendleft(reversed(CAREFUL_ALIAS))
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
        elif arg == "-nexus":
            recon.nexus_guide_filenames.append(take())
        elif arg == "-stockholm":
            recon.stockholm_guide_filenames.append(take())
        elif arg == "-saveguide":
            recon.guide_save_filename = take()
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
