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

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL4_TREE = "((t1:0.12,t2:0.12):0.1,(t3:0.12,t4:0.12):0.1)root;\n"


def write_small4(d) -> tuple:
    """small4 into directory d: returns (fasta path, tree path)."""
    from historian_tpu.core.seqs import read_fasta

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


def test_unported_paths_raise(small4):
    from historian_tpu_torch import cli

    args, _ = small4
    for argv, item in ((args + ["-profmaxstates", "5"], "sampled-profile"),
                       (args + ["-ancseq"], "ancseq"),
                       (["-careful", *args[1:]], "BackwardMatrix")):
        with pytest.raises(NotImplementedError, match=item):
            cli.main(["recon", "-platform", "cpu", *argv])
