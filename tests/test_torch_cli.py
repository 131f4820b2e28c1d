"""The port's CLI errors and switches against the JAX CLI's, both run in
this process on the CPU: a missing file, an unknown preset and a bad
number end either command in one line, `<prog>: <message>`, with the
same message; `-abort` keeps the raw exception; `-profile DIR` writes a
torch.profiler trace there; HISTORIAN_PLATFORM picks the platform when
`-platform` is not given."""

import json
import os

import pytest

from historian_tpu import cli as jax_cli
from historian_tpu_torch import cli

TREE = "((a:0.1,b:0.2):0.1,c:0.3)r;\n"


@pytest.fixture
def files(tmp_path):
    nh = tmp_path / "t.nh"
    nh.write_text(TREE)
    fa = tmp_path / "s.fa"
    fa.write_text(">a\nACDEFGHIK\n>b\nACDEFGHK\n")
    return {"tree": str(nh), "fasta": str(fa), "missing": str(tmp_path / "nosuch.fa")}


BAD = {
    "missing file": ["recon", "{missing}"],
    "missing count file": ["sum", "{missing}"],
    "unknown preset": ["recon", "-preset", "nosuch", "{fasta}"],
    "bad number": ["recon", "-band", "abc", "{fasta}"],
    "bad rootlen": ["generate", "-rootlen", "x", "{tree}"],
}


def _message(main, prog, argv) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    text = str(e.value.code)
    assert text.startswith(f"{prog}: ") and "\n" not in text
    return text[len(prog) + 2:]


@pytest.mark.parametrize("name", list(BAD))
def test_error_messages_match_jax(name, files):
    argv = [a.format(**files) for a in BAD[name]]
    argv[1:1] = ["-platform", "cpu"]
    ref = _message(jax_cli.main, jax_cli.PROG, argv)
    got = _message(cli.main, cli.PROG, argv)
    assert got == ref


def test_abort_keeps_the_exception(files):
    with pytest.raises(FileNotFoundError):
        cli.main(["recon", "-platform", "cpu", "-abort", files["missing"]])
    with pytest.raises(KeyError):
        cli.main(["recon", "-platform", "cpu", "-preset", "nosuch", "-abort", files["fasta"]])


def test_profile_writes_a_trace(files, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert cli.main(["generate", "-platform", "cpu", "-profile", str(trace), files["tree"]]) == 0
    assert "#=GF LP" in capsys.readouterr().out
    with open(os.path.join(trace, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_platform_from_environment(files, monkeypatch, capsys):
    from historian_tpu_torch import device

    monkeypatch.setenv("HISTORIAN_PLATFORM", "cpu")
    assert cli.main(["generate", files["tree"]]) == 0
    assert device.current().type == "cpu" and "#=GF LP" in capsys.readouterr().out
    monkeypatch.setenv("HISTORIAN_PLATFORM", "tpu")
    assert _message(cli.main, cli.PROG, ["generate", files["tree"]]) == (
        "unknown platform 'tpu' (expected gpu or cpu)")
    device.select("cpu")
