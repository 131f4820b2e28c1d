"""The port's multi-process paths: two processes of
`python -m historian_tpu_torch ... -platform cpu` in one gloo group
(parallel/dist.py, HISTORIAN_COORDINATOR on a free localhost port,
HISTORIAN_NUM_PROCESSES=2, HISTORIAN_PROCESS_ID 0 and 1), each with its
own timeout, on small4's reconstruction (the first 4 sequences of
tests/data/long8.fa cut to 300 aa, reconstructed by the port) and a copy
of it with one residue changed:

- `count` on the two datasets: each process counts one and the partials
  are summed over the group; both ranks print the single-process counts;
- `count -mesh 8` on one dataset with 4 virtual devices a process: the
  collective E-step over a mesh that spans both processes, against the
  single-process run and the JAX package's two-process run in the same
  environment (as tests/test_dist2proc.py starts it);
- `mcmc -samples 1 -trace` on the two datasets: each rank's dataset
  equals a single-process run given that dataset alone, both ranks print
  both, and the trace files are numbered by the global dataset index;
- `fit -checkpoint` writes `<file>.p1` on rank 1;
- a mesh holding one process's devices only is refused by both ranks."""

import contextlib
import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from historian_tpu_torch import cli, device
from historian_tpu_torch.models.counts import _parse_lenient_json as parse
from tests.test_torch_recon import write_small4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(pkg: str, args: list, env_extra: dict, cwd: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return subprocess.Popen([sys.executable, "-m", pkg, *args], env=env, cwd=cwd, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def two_processes(pkg: str, args: list, cwd: str, **env) -> list:
    """stdout of rank 0 and rank 1 of `args` in one process group."""
    common = dict(env, HISTORIAN_COORDINATOR=f"127.0.0.1:{free_port()}",
                  HISTORIAN_NUM_PROCESSES="2")
    procs = [spawn(pkg, args, dict(common, HISTORIAN_PROCESS_ID=str(r)), cwd) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def in_process(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([argv[0], "-platform", "cpu", *argv[1:]]) == 0
    return out.getvalue()


def counts_of(text: str) -> dict:
    """The count JSON's numbers (after anything a library printed first)."""
    obj = parse(text[text.index("{"):])

    def flat(x, path=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{path}/{k}")
        elif isinstance(x, list):
            for k, v in enumerate(x):
                yield from flat(v, f"{path}[{k}]")
        else:
            yield path, x

    return dict(flat(obj))


def assert_counts_close(got: str, want: str, rtol: float) -> None:
    g, w = counts_of(got), counts_of(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], (int, float)):
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (k, g[k], w[k])
        else:
            assert g[k] == w[k], k


@pytest.fixture(scope="module")
def recons(tmp_path_factory):
    """(dir, a.sto, b.sto): small4's reconstruction, and a copy with its
    first residue 'g' of a leaf turned into 'a'."""
    d = str(tmp_path_factory.mktemp("dist"))
    fa, nh = write_small4(d)
    device.select("cpu")
    text = in_process("recon", "-fast", "-noband", "-tree", nh, fa)
    a, b = os.path.join(d, "a.sto"), os.path.join(d, "b.sto")
    with open(a, "w") as f:
        f.write(text)
    lines = text.splitlines(keepends=True)
    k = next(i for i, ln in enumerate(lines) if ln.startswith("t1 "))
    name, row = lines[k].split(None, 1)
    lines[k] = lines[k][: len(lines[k]) - len(row)] + row.replace("g", "a", 1)
    with open(b, "w") as f:
        f.write("".join(lines))
    assert open(a).read() != open(b).read()
    return d, a, b


def test_two_process_count_matches_single(recons):
    d, a, b = recons
    args = ["count", "-platform", "cpu", "-stockrecon", a, "-stockrecon", b]
    out0, out1 = two_processes("historian_tpu_torch", args, d)
    assert out0 == out1
    single = in_process("count", "-stockrecon", a, "-stockrecon", b)
    assert_counts_close(out0, single, 1e-12)
    assert counts_of(single) != counts_of(in_process("count", "-stockrecon", a, "-stockrecon", a))


def test_collective_mesh_count_matches_single_and_jax(recons):
    """-mesh 8 over 2 processes of 4 devices: every rank counts the
    dataset collectively (an all-reduce, once)."""
    d, a, _ = recons
    args = ["count", "-stockrecon", a, "-mesh", "8"]
    flags = "--xla_force_host_platform_device_count=4"
    out0, out1 = two_processes("historian_tpu_torch", [args[0], "-platform", "cpu", *args[1:]],
                               d, XLA_FLAGS=flags)
    assert out0 == out1
    single = in_process(*args)  # 8 devices in this process (tests/conftest.py)
    assert_counts_close(out0, single, 1e-9)
    assert_counts_close(out0, in_process("count", "-stockrecon", a), 1e-9)
    j0, j1 = two_processes("historian_tpu", args, d, XLA_FLAGS=flags, HISTORIAN_PLATFORM="cpu")
    assert counts_of(j0) == counts_of(j1)
    assert_counts_close(out0, j0, 1e-9)


def test_mesh_without_a_process_raises(recons):
    """-mesh 4 in a group of two processes of 4 devices holds only rank 0's
    devices: both ranks refuse it before any collective."""
    d, a, _ = recons
    common = dict(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                  HISTORIAN_COORDINATOR=f"127.0.0.1:{free_port()}", HISTORIAN_NUM_PROCESSES="2")
    args = ["count", "-platform", "cpu", "-stockrecon", a, "-mesh", "4"]
    procs = [spawn("historian_tpu_torch", args, dict(common, HISTORIAN_PROCESS_ID=str(r)), d)
             for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode != 0
            assert "-mesh 4 holds devices of 1 of the 2 processes" in err, err[-2000:]
    finally:
        for p in procs:
            p.kill()


def test_two_process_mcmc_round_robin(recons):
    d, a, b = recons
    base = ["mcmc", "-samples", "1", "-seed", "7"]
    singles = []
    for name, path in (("a", a), ("b", b)):
        singles.append(in_process(*base, "-trace", os.path.join(d, f"single_{name}"),
                                  "-stockrecon", path))
    trace = os.path.join(d, "both")
    out0, out1 = two_processes(
        "historian_tpu_torch",
        [base[0], "-platform", "cpu", *base[1:], "-trace", trace, "-stockrecon", a,
         "-stockrecon", b], d)
    assert out0 == out1 == singles[0] + singles[1]
    for k, name in ((1, "a"), (2, "b")):  # numbered by the global dataset index
        with open(f"{trace}.{k}") as got, open(os.path.join(d, f"single_{name}.1")) as want:
            assert got.read() == want.read()
    assert not os.path.exists(f"{trace}.3")


def test_fit_checkpoint_per_rank(recons):
    d, a, b = recons
    ck = os.path.join(d, "fit_ck.json")
    args = ["fit", "-platform", "cpu", "-maxiter", "1", "-checkpoint", ck,
            "-stockrecon", a, "-stockrecon", b]
    out0, out1 = two_processes("historian_tpu_torch", args, d)
    assert out0 == out1
    assert os.path.exists(ck) and os.path.exists(ck + ".p1") and not os.path.exists(ck + ".p0")
    single = in_process("fit", "-maxiter", "1", "-stockrecon", a, "-stockrecon", b)
    nums = [np.array([float(x) for x in re.findall(r"-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?", t)])
            for t in (out0, single)]
    assert len(nums[0]) > 400
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-9)
