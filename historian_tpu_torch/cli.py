"""Command-line interface of the port: `recon`, `count`, `sum`, `fit`
and `generate` on PyTorch and CUDA.

Same flags as historian_tpu/cli.py for these commands, the same `-fast`
and `-careful` aliases, plus `-platform gpu|cpu` (or HISTORIAN_PLATFORM
when it is not given): `gpu`, the default, needs CUDA and fails without
it; `cpu` runs the kernels' plain PyTorch versions and is only ever
chosen explicitly.  The guide, tree, profile, refinement, ancestral,
count, EM, posterior-profile, `-savedot` and simulation flags have their
JAX meaning; flags of paths that are not ported yet raise
NotImplementedError naming their ROADMAP item, none is dropped silently.
As in the JAX CLI, a missing file, a bad value or an unknown name ends
the command with a one-line `historian-tpu-torch: <message>` (`-abort`
keeps the traceback), and `-profile DIR` writes a torch.profiler trace
of the command to DIR.
"""

from __future__ import annotations

import os
import sys
from collections import deque

from historian_tpu_torch.utils.logging import logger
from historian_tpu_torch import __version__
from historian_tpu_torch import device as devmod
from historian_tpu_torch.models.counts import EventCounts
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

HELP = f"""{PROG}: historian-tpu's `recon`, `count`, `sum`, `fit` and `generate` on PyTorch and CUDA

Usage: {PROG} recon|count|fit|generate [options] [files]
       {PROG} sum <counts.json>...

  recon (r)          reconstruct ancestral sequence histories [default command]
  count (c)          expected event counts on a reconstruction (JSON)
  fit (f)            fit the model's rates by EM on reconstructions (model JSON)
  sum (s)            sum event-count JSON files
  generate (g)       simulate a history down a Newick tree (Stockholm)

  -platform gpu|cpu  device (default gpu, or HISTORIAN_PLATFORM; cpu must be
                     given explicitly)
  -abort             raw tracebacks instead of one-line errors
  -profile <dir>     write a torch.profiler trace of the command to <dir>
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
  -band <n> | -noband  band around the guide alignment (default 20)
  -profsamples <n>   sampled traces kept in each internal profile (default 10)
  -profmaxstates <n> | -profmaxmem <pct>  cells a profile may keep (default:
                     from -profmaxmem's share, 5, of the host memory)
  -profminpost <p>   posterior profiles: keep the cells whose posterior
                     passes p (a later -profsamples goes back to sampling)
  -nobest            leave the best trace out of the profiles
  -keepgapsopen      keep gap states open in the profiles
  -profminlen <n> -profmaxlen <n>  accepted, unused (as in the JAX package)
  -refine | -norefine  realign each branch by Viterbi until the likelihood
                     stops rising (default -norefine)
  -output fasta|nexus|stockholm|json  -noancs  -seed <n>
  -ancseq            predict ancestral residues  -ancprob  with their posteriors
  -savedot <file> [-dotpost [p]] [-dotsubpost [p]] [-dotgapsopen]
                     the root's ancestral sequence graph in GraphViz dot
  -recon <file>      gapped FASTA reconstruction (with -tree) to count or fit on
  -nexusrecon <file> | -stockrecon <file>  Nexus or Stockholm reconstruction
  -counts <file>     prior pseudocounts  -nolaplace  no +1 pseudocounts
  -fixsubrates | -fixgaprates  leave those rates out of the fit
  -mininc <x> -maxiter <n>  EM stopping rule (defaults .001, 100)
  -checkpoint <file> snapshot the fit after each EM iteration; resume from it
  -rootlen <n>       generate: the root sequence's length (default 100)
  -fast  (= -rndspan -kmatchn 3 -band 10 -profmaxstates 1 -jc -norefine)
  -careful  (= -allspan -kmatchoff -band 40 -profminpost .001 -profmaxmem 5
             -refine)
"""

_MCMC = "item 6, MCMC"
#: flags of the JAX CLI whose paths are not ported yet, and their ROADMAP items
_NOT_PORTED = {
    **{flag: _MCMC for flag in ("-mcmc", "-samples", "-trace", "-ckptevery", "-fixtree",
                                "-fixalign", "-fixguide")},
    "-mesh": "item 7, multi-GPU",
}
#: the commands of the JAX CLI, by alias
_COMMANDS = {"r": "recon", "recon": "recon", "reconstruct": "recon", "c": "count",
             "count": "count", "f": "fit", "fit": "fit", "s": "sum", "sum": "sum",
             "m": "mcmc", "mcmc": "mcmc", "g": "generate", "generate": "generate"}
#: the commands that are not ported yet, and their ROADMAP items
_COMMAND_ITEMS = {"mcmc": _MCMC}
_MODEL_PARAMS = ("-insrate", "-delrate", "-insextprob", "-delextprob", "-inslen",
                 "-dellen", "-gaprate", "-gapextprob", "-gaplen", "-subscale",
                 "-indelscale", "-scale")
_FORMATS = {"fasta": FORMAT_FASTA, "nexus": FORMAT_NEXUS,
            "stockholm": FORMAT_STOCKHOLM, "json": FORMAT_JSON}


def _optional_value(argvec: deque, default: float) -> float:
    """The number after a flag whose value may be left out (-dotpost,
    -dotsubpost): taken when the next argument does not start with '-'."""
    if argvec and not argvec[0].startswith("-"):
        return float(argvec.popleft())
    return default


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
        if arg in ("-refine", "-norefine"):
            recon.refine_reconstruction = arg == "-refine"
        elif arg == "-profminpost":
            recon.min_post_prob = float(take())
            recon.use_posteriors_for_profile = True
        elif arg == "-savedot":
            recon.dot_save_filename = take()
        elif arg == "-dotpost":
            recon.use_posteriors_for_dot = True
            recon.min_dot_post_prob = _optional_value(argvec, recon.min_dot_post_prob)
        elif arg == "-dotsubpost":
            recon.use_separate_sub_posteriors_for_dot = True
            recon.min_dot_sub_post_prob = _optional_value(argvec, recon.min_dot_sub_post_prob)
        elif arg == "-dotgapsopen":
            recon.keep_dot_gaps_open = True
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
        elif arg == "-careful":
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
            recon.use_posteriors_for_profile = False
        elif arg == "-profmaxstates":
            recon.profile_node_limit = int(take())
        elif arg == "-profmaxmem":
            recon.max_dp_memory_fraction = float(take()) / 100.0
            recon.profile_node_limit = 0
        elif arg in ("-profminlen", "-profmaxlen"):
            # accepted and unused, as in the JAX package (ROADMAP section 3,
            # "Faults found in the reference")
            int(take())
        elif arg == "-nobest":
            recon.include_best_trace_in_profile = False
        elif arg == "-keepgapsopen":
            recon.keep_gaps_open = True
        elif arg == "-seed":
            recon.rnd_seed = int(take())
            recon.seed_generator()
        elif arg in ("-ancseq", "-ancprob"):
            recon.predict_ancestral_sequence = True
            recon.report_ancestral_sequence_probability |= arg == "-ancprob"
        elif arg == "-recon":
            recon.fasta_recon_filename = take()
        elif arg == "-nexusrecon":
            recon.nexus_recon_filenames.append(take())
        elif arg == "-stockrecon":
            recon.stockholm_recon_filenames.append(take())
        elif arg == "-counts":
            recon.count_filenames.append(take())
        elif arg == "-mininc":
            recon.min_em_improvement = float(take())
        elif arg == "-maxiter":
            recon.max_em_iterations = int(take())
        elif arg == "-nolaplace":
            recon.use_laplace_pseudocounts = False
        elif arg == "-fixsubrates":
            recon.fit_subst_rates = False
        elif arg == "-fixgaprates":
            recon.fit_indel_rates = False
        elif arg == "-checkpoint":
            recon.checkpoint_filename = take()
        elif arg == "-rootlen":
            recon.simulator_root_seq_len = int(take())
        elif not arg.startswith("-"):
            recon.load_auto(arg)
        else:
            raise SystemExit(f"{PROG}: unknown option {arg!r} (try '{PROG} help')")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    platform = os.environ.get("HISTORIAN_PLATFORM", "") or "gpu"
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
    command, rest = _COMMANDS.get(argv[0]), argv[1:]
    if command is None:
        command, rest = "recon", argv  # no command word: reconstruct
    if command in _COMMAND_ITEMS:
        raise not_ported(f"the {command!r} command", _COMMAND_ITEMS[command])
    abort = "-abort" in rest  # debugging aid: raw tracebacks (reference optparser.cpp:35)
    rest = [a for a in rest if a != "-abort"]
    trace_dir = ""
    if "-profile" in rest:
        i = rest.index("-profile")
        if i + 1 >= len(rest):
            raise SystemExit(f"{PROG}: option '-profile' requires an argument")
        trace_dir = rest[i + 1]
        del rest[i : i + 2]

    def run() -> int:
        if trace_dir:
            return _profiled(trace_dir, lambda: _dispatch(command, platform, rest))
        return _dispatch(command, platform, rest)

    if abort:
        return run()
    try:
        return run()
    except OSError as e:
        if e.filename is not None:
            raise SystemExit(f"{PROG}: {e.strerror.lower()}: {e.filename!r}")
        raise
    except ValueError as e:
        raise SystemExit(f"{PROG}: {e}")
    except LookupError as e:
        raise SystemExit(f"{PROG}: {e.args[0] if e.args else e}")


def _profiled(trace_dir: str, fn) -> int:
    """fn() under torch.profiler (host, and the card where there is one),
    its Chrome trace written to trace_dir/trace.json."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        rc = fn()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return rc


def _dispatch(command: str, platform: str, rest: list[str]) -> int:
    out = sys.stdout
    if command == "sum":
        return _sum(rest, out)
    devmod.select(platform)
    recon = Reconstructor()
    if command in ("count", "fit"):
        recon.accumulate_subst_counts = recon.accumulate_indel_counts = True
        recon.use_laplace_pseudocounts = command == "fit"
    _parse(recon, deque(rest))
    if command == "generate":
        # a bare Newick file lands in tree_filename (load_auto)
        if recon.tree_filename:
            recon.simulator_tree_filenames.append(recon.tree_filename)
        recon.load_model()
        recon.seed_generator()
        recon.simulate()
        for ds in recon.datasets:
            recon.write_tree_alignment(ds.tree, ds.gapped_recon, ds.name, out, True)
        return 0
    recon.load_model()
    recon.load_seqs()
    if command == "recon":
        recon.reconstruct_all()
        recon.predict_all_ancestors()
        recon.write_recon(out)
        return 0
    recon.load_recon()
    recon.load_counts()
    if command == "count":
        recon.count_all()
        recon.write_counts(out)
    else:
        recon.accumulate_subst_counts = recon.fit_subst_rates
        recon.accumulate_indel_counts = recon.fit_indel_rates
        recon.fit()
        recon.write_model(out)
    return 0


def _sum(args: list[str], out) -> int:
    """The count files' sum (the reducer of the count MapReduce)."""
    total = None
    for path in (a for a in args if not a.startswith("-")):
        c = EventCounts.from_file(path)
        total = c if total is None else total + c
    if total is None:
        raise SystemExit("sum: no count files given")
    total.write(out)
    return 0
