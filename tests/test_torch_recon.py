"""`python -m historian_tpu_torch recon -fast -noband` against
`python -m historian_tpu recon -fast -noband` on small4 (the first four
sequences of tests/data/long8.fa cut to 300 aa).

The JAX package runs its device route on the CPU in float64
(HISTORIAN_DEVICE_DP=1, HISTORIAN_DEVICE_TRACE=1): the alignment rows
must be byte-identical and `#=GF LP` within 1e-6.  The port in float32
must stay within tests/test_f32_drift.py's bound of 50 nats.  Without
CUDA, `-platform gpu` (the default) fails instead of falling back."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL4_TREE = "((t1:0.12,t2:0.12):0.1,(t3:0.12,t4:0.12):0.1)root;\n"


def write_small4(d) -> tuple:
    """small4 into directory d: returns (fasta path, tree path)."""
    from historian_tpu_torch.core.seqs import read_fasta

    seqs = read_fasta(os.path.join(REPO, "tests", "data", "long8.fa"))[:4]
    fa, nh = os.path.join(d, "small4.fa"), os.path.join(d, "small4.nh")
    with open(fa, "w") as f:
        for k, s in enumerate(seqs):
            f.write(f">t{k + 1}\n{s.seq[:300]}\n")
    with open(nh, "w") as f:
        f.write(SMALL4_TREE)
    return fa, nh


def run(pkg, args, **env):
    e = dict(os.environ)
    e.update(env)
    return subprocess.run([sys.executable, "-m", pkg, "recon", *args],
                          capture_output=True, text=True, timeout=300, env=e, cwd=REPO)


def rows_and_lp(text):
    rows = [ln for ln in text.splitlines() if ln and not ln.startswith("#") and ln != "//"]
    lp = [float(ln.split()[2]) for ln in text.splitlines() if ln.startswith("#=GF LP")]
    assert len(lp) == 1, text[-500:]
    return rows, lp[0]


@pytest.fixture(scope="module")
def small4(tmp_path_factory):
    d = tmp_path_factory.mktemp("small4")
    fa, nh = write_small4(d)
    args = ["-fast", "-noband", "-tree", nh, fa]
    ref = run("historian_tpu", args, HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="1",
              HISTORIAN_DEVICE_TRACE="1", HISTORIAN_DEVICE_DTYPE="f64")
    assert ref.returncode == 0, ref.stderr[-2000:]
    return args, rows_and_lp(ref.stdout)


@pytest.mark.parametrize("dtype,lp_tol", [("f64", 1e-6), ("f32", 50.0)])
def test_port_recon_matches_jax(small4, dtype, lp_tol):
    args, (ref_rows, ref_lp) = small4
    out = run("historian_tpu_torch", ["-platform", "cpu", *args], HISTORIAN_DEVICE_DTYPE=dtype)
    assert out.returncode == 0, out.stderr[-2000:]
    rows, lp = rows_and_lp(out.stdout)
    assert len(rows) == 7  # 4 leaves + 3 ancestors
    if dtype == "f64":
        assert rows == ref_rows
    assert abs(lp - ref_lp) < lp_tol


def test_platform_gpu_without_cuda_fails(small4):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: -platform gpu is valid here")
    args, _ = small4
    out = run("historian_tpu_torch", args)  # no -platform: gpu
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "#=GF" not in out.stdout
    from historian_tpu_torch import device

    with pytest.raises(RuntimeError, match="CUDA"):
        device.select("gpu")


def test_band_doubling_ladder_matches_jax(tmp_path, monkeypatch):
    """small4 `-fast -band 2`: a merge with no path inside the band is
    filled again with the band doubled; the port (CPU, float64) builds
    the same fills with the same bands as the JAX package's host route,
    and prints the same rows and `#=GF LP`."""
    from historian_tpu_torch import device
    from tests.torch_twins import count_fills

    fa, nh = write_small4(tmp_path)
    args = ["-fast", "-band", "2", "-tree", nh, fa]
    for k, v in (("HISTORIAN_PLATFORM", "cpu"), ("HISTORIAN_DEVICE_DP", "0"),
                 ("HISTORIAN_DEVICE_DTYPE", "f64")):
        monkeypatch.setenv(k, v)
    ref_bands, ref = count_fills("historian_tpu", args)
    device.select("cpu")
    bands, got = count_fills("historian_tpu_torch", ["-platform", "cpu", *args])
    assert bands == ref_bands == [2, 2, 2, 4, 8]
    ref_rows, ref_lp = rows_and_lp(ref)
    rows, lp = rows_and_lp(got)
    assert rows == ref_rows and abs(lp - ref_lp) < 1e-6


def cli_output(argv: list) -> str:
    """stdout of the port's CLI on `argv`, run in this process."""
    import contextlib
    import io

    from historian_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


#: `recon` and `mcmc` (one sample a node) on small4, with these flags after
#: the command's inputs
MESH_COMMANDS = (("recon",), ("mcmc", "-samples", "1"))


@pytest.fixture(scope="module")
def plain_outputs(small4):
    """stdout of MESH_COMMANDS' plain runs (float64) by command."""
    args, _ = small4
    old = os.environ.get("HISTORIAN_DEVICE_DTYPE")
    os.environ["HISTORIAN_DEVICE_DTYPE"] = "f64"
    try:
        return {command: cli_output([command, "-platform", "cpu", *args, *flags])
                for command, *flags in MESH_COMMANDS}
    finally:
        if old is None:
            del os.environ["HISTORIAN_DEVICE_DTYPE"]
        else:
            os.environ["HISTORIAN_DEVICE_DTYPE"] = old


def test_unported_paths_raise(small4, plain_outputs, monkeypatch):
    """-mesh 1 (ROADMAP item 7, ported): `recon` and `mcmc` on a mesh of one
    device equal the plain run, and the mesh ends with the command.  (Until
    item 7 was ported, -mesh raised; the test keeps its name.)"""
    from historian_tpu_torch.parallel import pcounts

    args, (ref_rows, _) = small4
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    meshes = []
    set_mesh = pcounts.set_mesh
    monkeypatch.setattr(pcounts, "set_mesh", lambda spec: meshes.append(set_mesh(spec)) or
                        meshes[-1])
    for command, *flags in MESH_COMMANDS:
        plain = plain_outputs[command]
        assert cli_output([command, "-platform", "cpu", *args, *flags, "-mesh", "1"]) == plain
        assert pcounts.active_mesh() is None
    assert rows_and_lp(plain)[0] != [] and len(meshes) == 2
    assert all(m.shape == {"dp": 1} for m in meshes)
    assert rows_and_lp(cli_output(["recon", "-platform", "cpu", *args, "-mesh", "1"]))[0] \
        == ref_rows


def group_run(argv: list, env: dict, ranks: int = 1, loopback: str | None = None) -> list:
    """(stdout, the group each rank reports) of `python -m
    historian_tpu_torch <argv>` in `ranks` processes (rank k with
    HISTORIAN_PROCESS_ID=k where `env` gives none), each reporting after
    the command whether a group is up, its size, its rank and backend.
    `loopback` (host:port) takes the place of the forced group's fixed
    rendezvous, dist.LOOPBACK, in the subprocesses."""
    script = ("import sys\n"
              "import torch.distributed as td\n"
              "from historian_tpu_torch import cli\n"
              "from historian_tpu_torch.parallel import dist\n"
              + (f"dist.LOOPBACK = {loopback!r}\n" if loopback else "")
              + "rc = cli.main(sys.argv[1:])\n"
              "print('GROUP', dist.is_initialized(), td.get_world_size(), td.get_rank(),\n"
              "      td.get_backend(), file=sys.stderr)\n"
              "sys.exit(rc)\n")
    e = dict(os.environ)
    for name in ("HISTORIAN_MESH", "HISTORIAN_DIST", "HISTORIAN_COORDINATOR",
                 "HISTORIAN_NUM_PROCESSES", "HISTORIAN_PROCESS_ID"):
        e.pop(name, None)
    e.update(env, HISTORIAN_DEVICE_DTYPE="f64")
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv], cwd=REPO, text=True,
                              env={"HISTORIAN_PROCESS_ID": str(k), **e},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k in range(ranks)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            group = [ln.split()[1:] for ln in err.splitlines() if ln.startswith("GROUP ")]
            outs.append((out, group[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def free_port() -> str:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


@pytest.mark.parametrize("name,value", [("HISTORIAN_MESH", "2"), ("HISTORIAN_DIST", "1"),
                                        ("HISTORIAN_COORDINATOR", "127.0.0.1:12321"),
                                        ("HISTORIAN_NUM_PROCESSES", "2"),
                                        ("HISTORIAN_PROCESS_ID", "0")])
def test_unported_mesh_environment_raises(small4, plain_outputs, monkeypatch, name, value):
    """Each variable with which the JAX CLI engages a mesh or a process
    group has its meaning in the port (ROADMAP item 7, ported; until then
    each raised, and the test keeps its name), and `recon` and `mcmc` print
    what the plain run prints:

    - HISTORIAN_MESH=2: a mesh of 2 of the CPU's 8 devices, in this process;
    - HISTORIAN_DIST=1: a loopback gloo group of one, whose rendezvous is
      127.0.0.1:12321 (checked in process, the group not started), then
      run in a subprocess with a free port in its place;
    - HISTORIAN_COORDINATOR: the group of one that it describes with
      HISTORIAN_NUM_PROCESSES=1 and HISTORIAN_PROCESS_ID=0, on a free port
      of the value's host;
    - HISTORIAN_NUM_PROCESSES=2: a group of two processes (ranks 0 and 1
      on a free port), each printing the plain run's output;
    - HISTORIAN_PROCESS_ID=0: rank 0 of a group of one on a free port.
    The process-group cases run in subprocesses, and none of them binds a
    fixed port, so that two runs of the tests on one machine never meet."""
    from historian_tpu_torch.parallel import dist, pcounts

    args, _ = small4
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    if name == "HISTORIAN_DIST":
        import torch.distributed as tdist

        class Stop(Exception):
            pass

        seen = []

        def init_process_group(backend, **kw):
            seen.append((backend, kw))
            raise Stop

        with monkeypatch.context() as m:
            for other in ("HISTORIAN_COORDINATOR", "HISTORIAN_NUM_PROCESSES",
                          "HISTORIAN_PROCESS_ID"):
                m.delenv(other, raising=False)
            m.setenv(name, value)
            m.setattr(tdist, "init_process_group", init_process_group)
            with pytest.raises(Stop):
                dist.init_from_env("cpu")
        assert seen == [("gloo", dict(init_method="tcp://127.0.0.1:12321", world_size=1,
                                      rank=0))]
        assert not dist.is_initialized()
    for command, *flags in MESH_COMMANDS:
        argv = [command, "-platform", "cpu", *args, *flags]
        plain = plain_outputs[command]
        if name == "HISTORIAN_MESH":
            meshes = []
            set_mesh = pcounts.set_mesh
            monkeypatch.setattr(pcounts, "set_mesh",
                                lambda spec: meshes.append(set_mesh(spec)) or meshes[-1])
            monkeypatch.setenv(name, value)
            assert cli_output(argv) == plain
            monkeypatch.delenv(name)
            monkeypatch.setattr(pcounts, "set_mesh", set_mesh)
            assert [m.shape for m in meshes] == [{"dp": 2}]
            assert len(meshes[0].local_devices()) == 2
            continue
        env, ranks, loopback = {name: value}, 1, None
        if name == "HISTORIAN_DIST":
            loopback = free_port()
        elif name == "HISTORIAN_COORDINATOR":
            # a free port of the value's host, in place of its fixed one
            env.update(HISTORIAN_COORDINATOR=free_port(), HISTORIAN_NUM_PROCESSES="1",
                       HISTORIAN_PROCESS_ID="0")
        elif name == "HISTORIAN_NUM_PROCESSES":
            env.update(HISTORIAN_COORDINATOR=free_port())
            ranks = 2
        elif name == "HISTORIAN_PROCESS_ID":
            env.update(HISTORIAN_COORDINATOR=free_port(), HISTORIAN_NUM_PROCESSES="1")
        runs = group_run(argv, env, ranks, loopback)
        for rank, (out, group) in enumerate(runs):
            assert out == plain
            assert group == ["True", str(ranks), str(rank), "gloo"]


def test_unused_mesh_environment_runs(small4, monkeypatch):
    """HISTORIAN_DIST other than "1", empty process-group variables and
    HISTORIAN_SP without a mesh start nothing in the JAX package either:
    the port runs on."""
    import contextlib
    import io

    from historian_tpu_torch import cli

    args, (ref_rows, _) = small4
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    for name, value in (("HISTORIAN_DIST", "0"), ("HISTORIAN_COORDINATOR", ""),
                        ("HISTORIAN_MESH", ""), ("HISTORIAN_SP", "1")):
        monkeypatch.setenv(name, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", *args]) == 0
    assert rows_and_lp(out.getvalue())[0] == ref_rows


@pytest.mark.parametrize("command", [["recon", "-mcmc"], ["mcmc"], ["m"]],
                         ids=["recon -mcmc", "mcmc", "m"])
def test_mcmc_commands_take_the_flags(small4, tmp_path, command):
    """`recon -mcmc`, `mcmc` and its alias `m` sample small4 on the CPU and
    take every MCMC flag: one sample a node (7 steps, a -trace history
    each, a snapshot after every 3), the tree, the alignment and the guide
    fixed.  With every move's rate 0 the move drawn is the last, Rescale,
    as in the JAX package, so the alignment stays the reconstruction's
    and the tree keeps its shape."""
    import contextlib
    import io

    from historian_tpu_torch import cli

    args, (ref_rows, _) = small4
    trace, ck = str(tmp_path / "trace"), str(tmp_path / "ck.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*command, "-platform", "cpu", *args, "-samples", "1", "-trace", trace,
                         "-checkpoint", ck, "-ckptevery", "3", "-fixtree", "-fixalign",
                         "-fixguide", "-seed", "5"]) == 0
    rows, lp = rows_and_lp(out.getvalue())
    assert rows == ref_rows and lp < 0
    assert re.search(r"#=GF NH \(\(t1:[0-9.]+,t2:[0-9.]+\)node3:[0-9.]+,"
                     r"\(t3:[0-9.]+,t4:[0-9.]+\)node6:[0-9.]+\)root;", out.getvalue())
    with open(f"{trace}.1") as f:
        assert f.read().count("# STOCKHOLM") == 7
    assert os.path.exists(ck)


@pytest.fixture(scope="module")
def small4_counts(tmp_path_factory):
    """The port's small4 reconstruction (`recon -fast -noband -tree`) and
    its `count` JSON, through `python -m historian_tpu_torch`."""
    d = tmp_path_factory.mktemp("small4_counts")
    fa, nh = write_small4(d)
    paths = {}
    for name, argv in (("recon", ["recon", "-fast", "-noband", "-tree", nh, fa]),
                       ("counts", ["count", "-stockrecon", os.path.join(d, "recon.sto")])):
        out = subprocess.run([sys.executable, "-m", "historian_tpu_torch", "-platform", "cpu",
                              *argv], capture_output=True, text=True, timeout=300, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        paths[name] = os.path.join(d, f"{name}.{'sto' if name == 'recon' else 'json'}")
        with open(paths[name], "w") as f:
            f.write(out.stdout)
    return paths


@pytest.mark.parametrize("command", ["count", "sum", "fit"])
def test_ported_commands_run_on_cpu(small4_counts, command):
    """`count`, `sum` and `fit -maxiter 2` through the CLI entry on small4's
    reconstruction: counts of every kind, a sum of two files that doubles
    each count, a model whose fitted rates moved."""
    from historian_tpu_torch.models.counts import EventCounts
    from historian_tpu_torch.models.presets import named_model
    from historian_tpu_torch.models.ratemodel import RateModel

    argv = {"count": ["count", "-stockrecon", small4_counts["recon"]],
            "sum": ["sum", small4_counts["counts"], small4_counts["counts"]],
            "fit": ["fit", "-stockrecon", small4_counts["recon"], "-maxiter", "2"]}[command]
    out = subprocess.run([sys.executable, "-m", "historian_tpu_torch", "-platform", "cpu", *argv],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    if command == "fit":
        fitted, lg = RateModel.from_json_string(out.stdout), named_model("lg")
        assert fitted.ins_rate != lg.ins_rate and fitted.del_rate != lg.del_rate
        assert not np.array_equal(fitted.sub_rate, lg.sub_rate)
        return
    got = EventCounts.from_json_string(out.stdout)
    one = EventCounts.from_file(small4_counts["counts"])
    scale = 2.0 if command == "sum" else 1.0
    assert one.indel.ins > 0 and one.indel.del_ > 0 and one.root_count.sum() > 250
    assert got.indel.ins == scale * one.indel.ins
    np.testing.assert_allclose(got.sub_count, scale * one.sub_count, rtol=1e-5)
