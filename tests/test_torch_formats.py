"""The port's writers against the JAX package's on small4 (`recon -fast
-noband`, CPU, float64): FASTA, Nexus and JSON output byte-identical."""

import contextlib
import io

import pytest

from historian_tpu_torch import cli
from tests.test_torch_recon import run, write_small4


@pytest.mark.parametrize("fmt", ["fasta", "nexus", "json"])
def test_output_format_matches_jax(tmp_path, monkeypatch, fmt):
    fa, nh = write_small4(tmp_path)
    args = ["-fast", "-noband", "-output", fmt, "-tree", nh, fa]
    ref = run("historian_tpu", args, HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="1",
              HISTORIAN_DEVICE_TRACE="1", HISTORIAN_DEVICE_DTYPE="f64")
    assert ref.returncode == 0, ref.stderr[-2000:]
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["recon", "-platform", "cpu", *args]) == 0
    assert buf.getvalue() == ref.stdout
