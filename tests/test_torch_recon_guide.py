"""`recon -fast small6.fa` with no `-tree` and no `-noband`: the guide
stage, the distance tree and the banded merges, the port on the CPU
(`-platform cpu`) against the JAX package on the CPU, both in float64.
small6 is the 6 sequences of tests/data/long6.fa cut to 240-340 aa.

Every line but `#=GF LP` must be byte-identical (the rows and `#=GF NH`
among them), and `#=GF LP` within 1e-6; so too with `-nj`, `-allspan` and
a supplied `-tree`.  `-saveguide` writes the same guide file in FASTA
output.  In Stockholm output the JAX package raises: it scores the guide's
leaf rows as if they were a reconstruction, and a test pins that fault of
the reference.  The port writes the leaf rows and the tree with no
`#=GF LP` line, and that file, read back as `-stockholm` input,
reconstructs the same in both.  The fused route (HISTORIAN_PALLAS_FUSED=1,
kernel K2's plain version on the CPU) gives the default route's output
byte for byte.

Both CLIs run in this process, so the JAX package compiles its programs
once for the whole file; the port's default run also saves the Stockholm
guide that the input test reads."""

import contextlib
import io
import os

import pytest

from historian_tpu import cli as jax_cli
from historian_tpu_torch import cli as port_cli
from tests.test_torch_recon import rows_and_lp
from tests.test_torch_span import DATA, write_small6

JAX_ENV = dict(HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="1", HISTORIAN_DEVICE_TRACE="1",
               HISTORIAN_DEVICE_DTYPE="f64")


@contextlib.contextmanager
def _env(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(main, argv, **env) -> str:
    buf = io.StringIO()
    with _env(**env), contextlib.redirect_stdout(buf):
        rc = main(["recon", *argv])
    assert rc == 0
    return buf.getvalue()


def jax_recon(*args) -> str:
    return _run(jax_cli.main, list(args), **JAX_ENV)


def port_recon(*args, **env) -> str:
    return _run(port_cli.main, ["-platform", "cpu", *args], HISTORIAN_DEVICE_DTYPE="f64", **env)


def assert_same_recon(got: str, ref: str) -> None:
    rows, lp = rows_and_lp(got)
    ref_rows, ref_lp = rows_and_lp(ref)
    assert len(rows) == 11  # 6 leaves + 5 ancestors
    assert [ln for ln in got.splitlines() if not ln.startswith("#=GF LP")] == \
        [ln for ln in ref.splitlines() if not ln.startswith("#=GF LP")]
    assert abs(lp - ref_lp) < 1e-6


@pytest.fixture(scope="module")
def small6(tmp_path_factory):
    return write_small6(tmp_path_factory.mktemp("small6"))


@pytest.fixture(scope="module")
def default_run(small6):
    """The port's `recon -fast small6.fa` and the Stockholm guide it saved."""
    guide = os.path.join(os.path.dirname(small6), "guide.sto")
    return port_recon("-fast", "-saveguide", guide, small6), guide


@pytest.mark.parametrize("flags", [[], ["-nj"], ["-allspan"], ["-tree", f"{DATA}/long6.nh"]],
                         ids=["default", "nj", "allspan", "tree"])
def test_recon_matches_jax(small6, default_run, flags):
    got = port_recon("-fast", *flags, small6) if flags else default_run[0]
    assert "#=GF NH" in got
    assert_same_recon(got, jax_recon("-fast", *flags, small6))


def test_saveguide_matches_jax(small6, tmp_path):
    jax_guide, port_guide = tmp_path / "jax.fa", tmp_path / "port.fa"
    ref = jax_recon("-fast", "-output", "fasta", "-saveguide", str(jax_guide), small6)
    got = port_recon("-fast", "-output", "fasta", "-saveguide", str(port_guide), small6)
    assert got == ref
    assert port_guide.read_text() == jax_guide.read_text()
    assert port_guide.read_text().count(">") == 6


def test_jax_stockholm_saveguide_raises(small6, tmp_path):
    """The reference's fault that the port departs from: the JAX package
    scores a Stockholm guide's leaf rows (historian_tpu/recon.py
    write_tree_alignment) and fails on the missing root row."""
    with pytest.raises(SystemExit, match="list index out of range"):
        jax_recon("-fast", "-saveguide", str(tmp_path / "guide.sto"), small6)


def test_stockholm_guide_input(default_run):
    guide = default_run[1]
    with open(guide) as f:
        text = f.read()
    assert text.startswith("# STOCKHOLM") and "#=GF NH" in text and "#=GF LP" not in text
    assert len(rows_and_lp(text + "#=GF LP 0\n")[0]) == 6  # the leaf rows
    assert_same_recon(port_recon("-fast", "-stockholm", guide),
                      jax_recon("-fast", "-stockholm", guide))


def test_fused_route_matches_default(small6, default_run):
    assert port_recon("-fast", small6, HISTORIAN_PALLAS_FUSED="1") == default_run[0]
