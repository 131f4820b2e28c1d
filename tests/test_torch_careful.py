"""The port's full-band paths end to end, `python -m historian_tpu_torch`
against `python -m historian_tpu`, float64 on the CPU (the JAX package on
its host route, HISTORIAN_DEVICE_DP=0), HISTORIAN_MEMSIZE set for both:

- small6 (tests/data/long6.fa cut to 240-340 aa) `recon -careful
  -norefine`: posterior profiles, all-pairs guide over every diagonal,
  band 40; also with K2 (HISTORIAN_PALLAS_FUSED=1) in the port;
- small6 `recon -profminpost 0.01 -savedot F -dotpost -dotsubpost 0.05
  -dotgapsopen`: the alignment and the dot file;
- `count` and `fit -maxiter 2` on unaligned small4 (the first 4
  sequences of tests/data/long8.fa cut to 300 aa): reconstructed with the
  counts taken while merging.

Every output byte-identical."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from tests.test_torch_recon import write_small4
from tests.test_torch_sampled import MEMSIZE, write_small6

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name: (command, flags, input, port-only environment); "{dot}" is the
#: run's own dot file
CASES = {
    "small6 -careful -norefine": ("recon", ["-careful", "-norefine"], "small6", {}),
    "small6 -careful -norefine fused": ("recon", ["-careful", "-norefine"], "small6",
                                        {"HISTORIAN_PALLAS_FUSED": "1"}),
    "small6 -profminpost -savedot": ("recon", ["-profminpost", "0.01", "-savedot", "{dot}",
                                               "-dotpost", "-dotsubpost", "0.05",
                                               "-dotgapsopen"], "small6", {}),
    "small4 count": ("count", [], "small4", {}),
    "small4 fit -maxiter 2": ("fit", ["-maxiter", "2"], "small4", {}),
}


def _run(pkg, argv, env, dot):
    e = dict(os.environ, HISTORIAN_MEMSIZE=MEMSIZE, **env)
    out = subprocess.run([sys.executable, "-m", pkg, *argv], capture_output=True, text=True,
                         timeout=300, env=e, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    text = ""
    if dot:
        with open(dot) as f:
            text = f.read()
    return out.stdout, text


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: ((jax stdout, dot), (port stdout, dot))}, four runs at a time."""
    d = tmp_path_factory.mktemp("careful")
    inputs = {"small6": write_small6(d), "small4": write_small4(d)[0]}
    envs = {"historian_tpu": dict(JAX_PLATFORMS="cpu", HISTORIAN_PLATFORM="cpu",
                                  HISTORIAN_DEVICE_DP="0"),
            "historian_tpu_torch": dict(HISTORIAN_DEVICE_DTYPE="f64",
                                        HISTORIAN_PALLAS_FUSED="0")}
    jobs = {}
    for k, (name, (command, flags, inp, port_env)) in enumerate(CASES.items()):
        for pkg, env in envs.items():
            dot = os.path.join(d, f"{k}_{pkg}.dot") if "{dot}" in flags else ""
            argv = [command, *(f.replace("{dot}", dot) for f in flags), inputs[inp]]
            if pkg == "historian_tpu_torch":
                argv[1:1] = ["-platform", "cpu"]
                env = dict(env, **port_env)
            jobs[(name, pkg)] = (pkg, argv, env, dot)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(_run, *job) for k, job in jobs.items()}
        outs = {k: f.result() for k, f in futures.items()}
    return {name: (outs[(name, "historian_tpu")], outs[(name, "historian_tpu_torch")])
            for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_fullband_paths_match_jax(runs, name):
    (ref, ref_dot), (got, got_dot) = runs[name]
    assert got == ref
    assert got_dot == ref_dot
    if CASES[name][0] == "recon":
        assert "#=GF LP" in got and got.count("\n") > 11
    if "{dot}" in CASES[name][1]:
        assert got_dot.startswith("digraph profile {") and "->" in got_dot


def test_careful_routes(tmp_path, monkeypatch):
    """small6 `-careful -norefine`: every merge wants its BackwardMatrix
    but the root's, so the leaf merges (a chain x) take the full-band
    route, merges of a posterior profile x the host, and none stays
    resident; each full-band merge reads its band back once."""
    from historian_tpu_torch import cli, device, recon
    from historian_tpu_torch.ops import readback

    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")
    before, n_read = dict(recon.MERGES), len(readback.READBACKS)
    fa = write_small6(tmp_path)
    assert cli.main(["recon", "-platform", "cpu", "-careful", "-norefine", fa]) == 0
    merges = {k: recon.MERGES[k] - before[k] for k in recon.MERGES}
    assert merges == dict(device=0, fullband=3, host=2, oversized=0)  # 3 leaf pairs, 2 above them
    reads = readback.READBACKS[n_read:]
    assert len(reads) == merges["fullband"] and all(r["kind"] == "merge" for r in reads)
    assert all(r["bytes"] == r["cells"] * 5 * 8 for r in reads)
