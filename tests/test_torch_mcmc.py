"""MCMC (`mcmc`, `recon -mcmc`; sampler/sampler.py) on the CPU in float64
against the JAX package's host route (JAX_PLATFORMS=cpu
HISTORIAN_PLATFORM=cpu HISTORIAN_DEVICE_DP=0 HISTORIAN_DEVICE_SIBLING=0):

- each of the five moves, proposed once from one mt19937 seed on small6's
  reconstruction (tests/data/long6.fa cut to 240-340 aa, `recon -fast`)
  in each package: the same new history (tree and rows), proposal terms,
  Jacobian and likelihood, bit for bit;
- `python -m historian_tpu_torch mcmc` against `python -m historian_tpu
  mcmc`, byte for byte, output and `-trace` files: small4 (the first four
  sequences of tests/data/long8.fa cut to 300 aa) from FASTA alone (UPGMA,
  reconstruct, then sample) with `-trace`, from a `-stockrecon`
  reconstruction, and with `-fixtree`, `-fixalign`, `-fixguide`; small6
  from its reconstruction with `-trace`;
- a run snapshotted with `-checkpoint -ckptevery 3` and one resumed from
  its last snapshot print the uninterrupted run's output."""

import contextlib
import importlib
import io
import json
import os

import pytest

from tests.test_torch_recon import write_small4
from tests.test_torch_sampled import MEMSIZE, write_small6

HOST_ENV = dict(JAX_PLATFORMS="cpu", HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="0",
                HISTORIAN_DEVICE_SIBLING="0", HISTORIAN_MEMSIZE=MEMSIZE)
BASE = ["-samples", "2", "-seed", "7"]
CLI_CASES = {
    "fasta -trace": ["{fa}", "-trace", "{dir}/trace"],
    "stockrecon": ["-stockrecon", "{sto}"],
    "-fixtree": ["-fixtree", "-stockrecon", "{sto}"],
    "-fixalign": ["-fixalign", "-stockrecon", "{sto}"],
    "-fixguide": ["-fixguide", "-stockrecon", "{sto}"],
}
MOVES = ["_branch_align_move", "_node_align_move", "_prune_regraft_move",
         "_node_height_move", "_rescale_move"]


def _cli(root: str, argv: list) -> str:
    """stdout of `mcmc argv` through the CLI of package `root`, in this
    process; the port on the CPU."""
    cli = importlib.import_module(f"{root}.cli")
    if root == "historian_tpu_torch":
        from historian_tpu_torch import device

        device.select("cpu")
        argv = ["-platform", "cpu", *argv]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["mcmc", *argv]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def host_env():
    mp = pytest.MonkeyPatch()
    for k, v in HOST_ENV.items():
        mp.setenv(k, v)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def small4(tmp_path_factory, host_env):
    """small4's FASTA, and its `recon -fast -noband` reconstruction by the
    port (CPU, float64)."""
    from historian_tpu_torch import cli, device

    d = tmp_path_factory.mktemp("mcmc4")
    fa, nh = write_small4(d)
    sto = os.path.join(d, "small4.sto")
    device.select("cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", "-fast", "-noband", "-tree", nh, fa]) == 0
    with open(sto, "w") as f:
        f.write(out.getvalue())
    return {"fa": fa, "sto": sto, "dir": str(d)}


@pytest.fixture(scope="module")
def cli_runs(small4):
    """{case: ((jax stdout, jax trace), (port stdout, port trace))}, each
    package writing its trace in a directory of its own."""
    result = {}
    for name, flags in CLI_CASES.items():
        sides = []
        for root in ("historian_tpu", "historian_tpu_torch"):
            d = os.path.join(small4["dir"], f"{root}-{name.strip('-').replace(' ', '_')}")
            os.makedirs(d, exist_ok=True)
            argv = [a.format(dir=d, fa=small4["fa"], sto=small4["sto"]) for a in flags]
            out = _cli(root, [*BASE, *argv])
            trace = os.path.join(d, "trace.1")
            sides.append((out, open(trace).read() if os.path.exists(trace) else None))
        result[name] = tuple(sides)
    return result


@pytest.mark.parametrize("name", ["fasta -trace", "stockrecon"])
def test_mcmc_matches_jax(cli_runs, name):
    (ref, ref_trace), (got, trace) = cli_runs[name]
    assert got == ref
    assert "#=GF LP" in got and "#=GF NH" in got and got.count("\n") > 7
    assert trace == ref_trace
    if name == "fasta -trace":
        # one history a step: -samples 2 on 7 nodes
        assert trace.count("# STOCKHOLM") == 14


@pytest.mark.parametrize("name", ["-fixtree", "-fixalign", "-fixguide"])
def test_mcmc_flags_match_jax(cli_runs, small4, name):
    (ref, _), (got, _) = cli_runs[name]
    assert got == ref and "#=GF LP" in got
    if name == "-fixalign":
        rows = [ln for ln in got.splitlines() if ln and not ln.startswith("#") and ln != "//"]
        with open(small4["sto"]) as f:
            start = [ln for ln in f.read().splitlines()
                     if ln and not ln.startswith("#") and ln != "//"]
        assert rows == start  # the alignment stays as it came


def test_checkpoint_resume_matches_uninterrupted(small4, tmp_path, monkeypatch):
    """Snapshots every 3 steps leave the run's output unchanged, and a run
    resumed from the last one (step 12 of 14) prints the same output, which
    is the JAX package's."""
    base = [*BASE, "-stockrecon", small4["sto"]]
    full = _cli("historian_tpu_torch", base)
    ck = str(tmp_path / "mcmc.ckpt.json")
    assert _cli("historian_tpu_torch", [*base, "-checkpoint", ck, "-ckptevery", "3"]) == full
    with open(ck) as f:
        st = json.load(f)
    assert st["command"] == "mcmc" and st["step"] == 12
    from historian_tpu_torch.utils.logging import logger

    err = io.StringIO()
    monkeypatch.setattr(logger, "stream", err)
    monkeypatch.setattr(logger, "verbosity", logger.verbosity)  # -v, undone after
    resumed = _cli("historian_tpu_torch", [*base, "-checkpoint", ck, "-ckptevery", "3", "-v"])
    assert resumed == full
    assert "Resuming MCMC" in err.getvalue()
    assert full == _cli("historian_tpu", base)


def _sampler(root: str, sto: str):
    """(sampler, history) of package `root` on the reconstruction `sto`, set
    up as its run_mcmc_on_datasets sets up a dataset's chain."""
    recon_mod = importlib.import_module(f"{root}.recon")
    sm = importlib.import_module(f"{root}.sampler.sampler")
    seqs = importlib.import_module(f"{root}.core.seqs")
    ratemodel = importlib.import_module(f"{root}.models.ratemodel")
    recon = recon_mod.Reconstructor()
    recon.stockholm_recon_filenames.append(sto)
    recon.load_model()
    recon.load_seqs()
    recon.load_recon()
    ds = recon.datasets[0]
    tree = ds.tree.copy()
    tree.assign_internal_node_names()
    gapped = [seqs.FastSeq(name=tree.seq_name(n), seq=ds.gapped_recon[n].seq)
              for n in range(tree.n_nodes())]
    sampler = sm.Sampler(ratemodel.CachingRateModel(recon.model), sm.SimpleTreePrior(),
                         ds.gapped_guide, name=ds.name)
    sampler.max_distance_from_guide = recon.max_distance_from_guide
    history = sm.History(gapped=gapped, tree=tree)
    sampler.initialize(history, ds.name)
    return sampler, history


@pytest.fixture(scope="module")
def small6(tmp_path_factory, host_env):
    """small6's `recon -fast` reconstruction by the port (CPU, float64),
    and a directory for the runs on it."""
    from historian_tpu_torch import cli, device

    d = tmp_path_factory.mktemp("mcmc6")
    fa = write_small6(d)
    sto = os.path.join(d, "small6.sto")
    device.select("cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", "-fast", fa]) == 0
    with open(sto, "w") as f:
        f.write(out.getvalue())
    return {"sto": sto, "dir": str(d)}


@pytest.fixture(scope="module")
def small6_samplers(small6):
    return _sampler("historian_tpu", small6["sto"]), _sampler("historian_tpu_torch", small6["sto"])


def test_small6_mcmc_matches_jax(small6):
    """small6 `mcmc -samples 1 -stockrecon -trace` (11 steps): the output
    and the -trace file byte for byte."""
    outs = []
    for root in ("historian_tpu", "historian_tpu_torch"):
        trace = os.path.join(small6["dir"], f"{root}-trace")
        out = _cli(root, ["-samples", "1", "-seed", "7", "-stockrecon", small6["sto"],
                          "-trace", trace])
        with open(f"{trace}.1") as f:
            outs.append((out, f.read()))
    assert outs[1] == outs[0]
    assert "#=GF LP" in outs[1][0] and outs[1][1].count("# STOCKHOLM") == 11


def _history(h) -> tuple:
    return h.tree.to_string(), [(r.name, r.seq) for r in h.gapped]


@pytest.mark.parametrize("move", MOVES)
def test_each_move_matches_jax(small6_samplers, move):
    """One proposal of the move from each of three seeds: the same new
    history and the same terms; the alignment moves change the history
    from at least one seed."""
    from historian_tpu.utils.rng import MT19937 as JaxMT
    from historian_tpu_torch.utils.rng import MT19937 as PortMT

    (jax_s, jax_h), (port_s, port_h) = small6_samplers
    assert port_s.current_lp == jax_s.current_lp
    changed = 0
    for seed in (1, 2, 3):
        ref = getattr(jax_s, move)(jax_h, jax_s.current_lp, JaxMT(seed))
        got = getattr(port_s, move)(port_h, port_s.current_lp, PortMT(seed))
        assert (got.type, got.nullified, got.comment) == (ref.type, ref.nullified, ref.comment)
        assert _history(got.new_history) == _history(ref.new_history)
        for term in ("log_forward_proposal", "log_reverse_proposal", "log_jacobian",
                     "new_log_likelihood", "log_accept_prob"):
            assert getattr(got, term) == getattr(ref, term), term
        changed += _history(got.new_history) != _history(port_h)
    assert changed > 0
