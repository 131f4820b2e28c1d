"""`python -m historian_tpu_torch recon -fast -noband` against
`python -m historian_tpu recon -fast -noband` on small4 (the first four
sequences of tests/data/long8.fa cut to 300 aa).

The JAX package runs its device route on the CPU in float64
(HISTORIAN_DEVICE_DP=1, HISTORIAN_DEVICE_TRACE=1): the alignment rows
must be byte-identical and `#=GF LP` within 1e-6.  The port in float32
must stay within tests/test_f32_drift.py's bound of 50 nats.  Without
CUDA, `-platform gpu` (the default) fails instead of falling back."""

import os
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


def test_unported_paths_raise(small4):
    """-mcmc names its ROADMAP item."""
    from historian_tpu_torch import cli

    args, _ = small4
    with pytest.raises(NotImplementedError, match="item 6, MCMC"):
        cli.main(["recon", "-platform", "cpu", *args, "-mcmc"])


@pytest.mark.parametrize("command,item", [("mcmc", "item 6")])
def test_unported_commands_name_their_item(command, item):
    """Each command that is not ported raises naming its own ROADMAP item."""
    from historian_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=f"'{command}' command .*{item},"):
        cli.main([command, "-platform", "cpu"])


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
