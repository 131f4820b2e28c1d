"""The refiner (`recon -careful`, `-refine`) end to end on the CPU in
float64, `python -m historian_tpu_torch` against `python -m
historian_tpu` (its host route, HISTORIAN_DEVICE_DP=0), HISTORIAN_MEMSIZE
set for both:

- small6 (tests/data/long6.fa cut to 240-340 aa) `recon -careful`: the
  JAX package gives `#=GF LP -2692.972875` against -2713.652736 without
  the refiner;
- small4 (the first 4 sequences of tests/data/long8.fa cut to 300 aa)
  `recon -refine -tree`, sampled profiles then the refiner.

Every output byte-identical.  In process: the refiner's steps and its
fills' routes, and the device route forced on the CPU."""

import contextlib
import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from tests.test_torch_recon import rows_and_lp, write_small4
from tests.test_torch_sampled import MEMSIZE, write_small6

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "small6 -careful": (["-careful"], "small6"),
    "small4 -refine -tree": (["-refine", "-tree", "{tree}"], "small4"),
}
JAX_ENV = dict(JAX_PLATFORMS="cpu", HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="0")
PORT_ENV = dict(HISTORIAN_DEVICE_DTYPE="f64")


def _run(pkg, argv, env):
    e = dict(os.environ, HISTORIAN_MEMSIZE=MEMSIZE, **env)
    out = subprocess.run([sys.executable, "-m", pkg, "recon", *argv], capture_output=True,
                         text=True, timeout=300, env=e, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("refine")
    fa4, nh4 = write_small4(d)
    return {"small6": write_small6(d), "small4": fa4, "tree": nh4}


@pytest.fixture(scope="module")
def runs(inputs):
    """{name: (jax stdout, port stdout)}, all runs at once."""
    jobs = {}
    for name, (flags, inp) in CASES.items():
        argv = [f.replace("{tree}", inputs["tree"]) for f in flags] + [inputs[inp]]
        jobs[(name, "jax")] = ("historian_tpu", argv, JAX_ENV)
        jobs[(name, "port")] = ("historian_tpu_torch", ["-platform", "cpu", *argv], PORT_ENV)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(_run, *job) for k, job in jobs.items()}
        outs = {k: f.result() for k, f in futures.items()}
    return {name: (outs[(name, "jax")], outs[(name, "port")]) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_refine_matches_jax(runs, name):
    ref, got = runs[name]
    assert got == ref
    assert "#=GF LP" in got and got.count("\n") > 7
    if name == "small6 -careful":
        assert "#=GF LP -2692.972875" in got


def _port_recon(argv) -> str:
    from historian_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", *argv]) == 0
    return out.getvalue()


def test_refiner_steps_and_routes(inputs, monkeypatch):
    """small4 `-refine -tree` on the CPU: every fill on the host (fill.cpp),
    at least one full cycle of the 6 branches, the LP of the output the
    refiner's last, and no lower than before it."""
    from historian_tpu_torch import device
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.sampler import refiner

    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    device.select("cpu")
    fills = dict(branchmatrix.FILLS)
    out = _port_recon(["-refine", "-tree", inputs["tree"], inputs["small4"]])
    last = refiner.LAST
    assert last["steps"] >= 6 and last["steps"] == branchmatrix.FILLS["host"] - fills["host"]
    assert branchmatrix.FILLS["device"] == fills["device"]
    assert last["lp_after"] >= last["lp_before"]
    assert f"#=GF LP {last['lp_after']:.6f}" in out
    assert set(last["seconds"]) == {"pwms", "matrix", "traceback", "loglik", "total"}


def test_forced_device_route_refines(inputs, monkeypatch):
    """HISTORIAN_DEVICE_BRANCH=1 on the CPU sends every refine step's fill
    through branchdp (the plain version) and its band readback; the
    refiner still only ever raises the likelihood."""
    from historian_tpu_torch import device
    from historian_tpu_torch.engine import branchmatrix
    from historian_tpu_torch.ops import branchdp, readback
    from historian_tpu_torch.sampler import refiner

    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    monkeypatch.setenv("HISTORIAN_DEVICE_BRANCH", "1")
    device.select("cpu")
    fills, n_read = dict(branchmatrix.FILLS), len(readback.READBACKS)
    out = _port_recon(["-refine", "-tree", inputs["tree"], inputs["small4"]])
    steps = refiner.LAST["steps"]
    assert branchmatrix.FILLS == dict(fills, device=fills["device"] + steps)
    assert sum(r["kind"] == "branch" for r in readback.READBACKS[n_read:]) == steps
    assert branchdp.LAUNCHES == 0  # the plain version launches nothing
    _, lp = rows_and_lp(out)
    assert lp >= refiner.LAST["lp_before"] - 1e-6
