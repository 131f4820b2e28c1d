"""`generate` in the port against the JAX package's, both CLIs run in
this process on the CPU: a Newick tree and a `-seed`, with and without
`-rootlen`, on lg, on a gamma mixture of lg and on the codon preset
ECMrest (with and without `-codon`).  The Stockholm output, `#=GF LP`
included, byte-identical."""

import contextlib
import io

import pytest

from historian_tpu import cli as jax_cli
from historian_tpu_torch import cli

TREE = "((t1:0.12,t2:0.3):0.1,(t3:0.12,(t4:0.2,t5:0.05):0.08):0.1)root;\n"
CASES = {
    "lg": ["-seed", "7"],
    "lg -rootlen": ["-seed", "7", "-rootlen", "40"],
    "lg -rootlen 0": ["-seed", "5", "-rootlen", "0"],
    "lg -gamma": ["-seed", "11", "-gamma", "3"],
    "ECMrest": ["-seed", "3", "-preset", "ECMrest", "-rootlen", "30"],
    "ECMrest -codon": ["-seed", "3", "-preset", "ECMrest", "-codon", "-rootlen", "30"],
}


def _generate(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["generate", "-platform", "cpu", *argv]) == 0
    return out.getvalue()


@pytest.mark.parametrize("name", list(CASES))
def test_generate_matches_jax(name, tmp_path):
    nh = tmp_path / "t5.nh"
    nh.write_text(TREE)
    argv = [*CASES[name], str(nh)]
    ref = _generate(jax_cli.main, argv)
    got = _generate(cli.main, argv)
    assert got == ref
    assert got.startswith("# STOCKHOLM 1.0") and "#=GF LP" in got and "#=GF NH" in got
    assert sum(1 for ln in got.splitlines() if ln and not ln.startswith(("#", "//"))) == 9
