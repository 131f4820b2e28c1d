"""`count`, `sum`, `fit` and `recon -ancseq -ancprob` of the port
(historian_tpu_torch/cli.py) against the JAX package's CLI, float64 on
the CPU, both run in this process on the same files.

The reconstructions are the port's: small4 (`recon -fast -noband -tree`,
the first 4 sequences of tests/data/long8.fa cut to 300 aa) and small6
(the default `recon` of tests/data/long6.fa cut to 240-340 aa, with its
guide and tree saved).  The count, sum and model JSON and the ancestral
Stockholm and JSON are byte-identical.  A synthetic reconstruction of at
least 512 columns, made from a seed, takes the torch contraction in the
port and the device contraction in the JAX package: their in-memory
counts agree within rtol 1e-9."""

import contextlib
import importlib
import io
import json
import os

import numpy as np
import pytest

from historian_tpu_torch import device
from historian_tpu_torch.engine import sumprod
from historian_tpu_torch.models.counts import _parse_lenient_json as parse
from tests.test_torch_felsenstein import model_of
from tests.test_torch_recon import write_small4
from tests.test_torch_span import write_small6
from tests.torch_twins import PORT

JAX_ROOT, PORT_ROOT = "historian_tpu", "historian_tpu_torch"


def run(root, *argv) -> str:
    """stdout of `<command> argv` through the CLI of package `root`, in this
    process; the port on the CPU."""
    cli = importlib.import_module(f"{root}.cli")
    argv = list(argv)
    if root == PORT_ROOT:
        argv[1:1] = ["-platform", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def recons(tmp_path_factory):
    """{name: (reconstruction, guide args)} of small4 and small6, written by
    the port."""
    d = tmp_path_factory.mktemp("recons")
    fa4, nh4 = write_small4(d)
    fa6 = write_small6(d)
    guide6 = os.path.join(d, "small6_guide.sto")
    inputs = {"small4": ["-fast", "-noband", "-tree", nh4, fa4],
              "small6": ["-saveguide", guide6, fa6]}
    out = {}
    for name, args in inputs.items():
        path = os.path.join(d, f"{name}.sto")
        with open(path, "w") as f:
            f.write(run(PORT_ROOT, "recon", *args))
        out[name] = (path, inputs[name] if name == "small4" else ["-stockholm", guide6])
    return out


@pytest.mark.parametrize("name", ["small4", "small6"])
def test_count_identical(recons, name):
    got = run(PORT_ROOT, "count", "-stockrecon", recons[name][0])
    assert got == run(JAX_ROOT, "count", "-stockrecon", recons[name][0])
    counts = parse(got)  # the reference's count JSON lacks a comma after insTime
    assert counts["indel"]["ins"] > 0 and counts["sub"]["root"]["w"] > 0


def test_sum_identical(recons, tmp_path):
    paths = []
    for name in ("small4", "small6"):
        paths.append(str(tmp_path / f"{name}.json"))
        with open(paths[-1], "w") as f:
            f.write(run(PORT_ROOT, "count", "-stockrecon", recons[name][0]))
    got = run(PORT_ROOT, "sum", *paths)
    assert got == run(JAX_ROOT, "sum", *paths)
    total = parse(got)["indel"]
    parts = [parse(open(p).read())["indel"] for p in paths]
    assert total["ins"] == sum(p["ins"] for p in parts)


@pytest.mark.parametrize("name", ["small4", "small6"])
def test_fit_identical(recons, name):
    args = ("fit", "-stockrecon", recons[name][0], "-maxiter", "2")
    got = run(PORT_ROOT, *args)
    assert got == run(JAX_ROOT, *args)
    assert parse(got)["insrate"] != PORT.presets.named_model("lg").ins_rate


@pytest.mark.parametrize("source", ["fasta", "nexus", "prior"])
def test_other_reconstruction_inputs_identical(recons, tmp_path, source):
    """`count -recon <gapped FASTA> -tree`, `count -nexusrecon`, and `fit`
    from pseudocounts alone (`-counts`, no data)."""
    if source == "prior":
        counts = str(tmp_path / "counts.json")
        with open(counts, "w") as f:
            f.write(run(PORT_ROOT, "count", "-stockrecon", recons["small4"][0]))
        args = ("fit", "-counts", counts)
    else:
        path = str(tmp_path / f"small4.{source}")
        with open(path, "w") as f:
            f.write(run(PORT_ROOT, "recon", "-output", source, *recons["small4"][1]))
        tree = recons["small4"][1][3]  # -fast -noband -tree <tree> <fasta>
        args = ("count", "-recon", path, "-tree", tree) if source == "fasta" else \
            ("count", "-nexusrecon", path)
    got = run(PORT_ROOT, *args)
    assert got == run(JAX_ROOT, *args)
    if source != "prior":
        assert got == run(PORT_ROOT, "count", "-stockrecon", recons["small4"][0])


@pytest.mark.parametrize("name,fmt", [("small6", "stockholm"), ("small6", "json")])
def test_ancseq_ancprob_identical(recons, name, fmt, monkeypatch):
    """`recon -ancseq -ancprob` from the reconstruction's guide and tree;
    the JAX package on its host route, whose sampled profiles the port's
    equal."""
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    args = ("recon", "-ancseq", "-ancprob", "-output", fmt, *recons[name][1])
    got = run(PORT_ROOT, *args)
    assert got == run(JAX_ROOT, *args)
    if fmt == "stockholm":
        rows = [ln.split() for ln in got.splitlines() if ln and not ln.startswith(("#", "//"))]
        assert len(rows) == {"small4": 7, "small6": 11}[name]
        assert all("x" not in r[1] and "*" not in r[1] for r in rows)
        assert "#=GS node" in got and " PP " in got
    else:
        assert any(isinstance(v, list) for v in parse(got)["rowData"].values())


def synthetic_recon(model, tree, L, seed) -> list:
    """(name, row) of a reconstruction with one root a column: the column's
    root is the tree's root (60 %) or another node; a node under an
    ungapped parent is gapped at 15 %, and so is everything under a gap.
    Leaves take random residues, internal nodes `*`.  Columns are ordered
    by their root's depth, deepest first, so that no branch has a deletion
    followed by an insertion (a transition of probability 0)."""
    rng = np.random.default_rng(seed)
    n = tree.n_nodes()
    syms = np.array([model.alphabet.symbol(i) for i in range(model.alphabet.size)])
    rows = np.full((n, L), "-", dtype=object)
    depth = np.zeros(L, dtype=int)
    for col in range(L):
        top = tree.root() if rng.random() < 0.6 else int(rng.integers(0, n - 1))
        node = top
        while tree.parent(node) >= 0:
            node, depth[col] = tree.parent(node), depth[col] + 1
        for node in reversed(range(n)):  # preorder
            p = tree.parent(node)
            open_ = node == top or (p >= 0 and rows[p, col] != "-" and rng.random() >= 0.15)
            if open_:
                rows[node, col] = syms[rng.integers(0, len(syms))] if tree.is_leaf(node) else "*"
    rows = rows[:, np.argsort(-depth, kind="stable")]
    return [(tree.seq_name(node), "".join(rows[node])) for node in range(n)]


def counted(root, model_path, recon_path):
    rc = importlib.import_module(f"{root}.recon").Reconstructor()
    rc.accumulate_subst_counts = rc.accumulate_indel_counts = True
    rc.use_laplace_pseudocounts = False
    rc.model_filename = model_path
    rc.stockholm_recon_filenames.append(recon_path)
    rc.load_model()
    rc.load_recon()
    rc.load_counts()
    rc.count_all()
    c = rc.data_counts
    return dict(root=c.root_count, sub=c.sub_count,
                indel=np.array([getattr(c.indel, k) for k in
                                ("ins", "del_", "ins_ext", "del_ext", "ins_time", "del_time", "lp")]))


@pytest.mark.parametrize("name,fill", [("lg", "torch"), ("complex", "native")])
def test_wide_reconstruction_counts_agree(tmp_path, monkeypatch, name, fill):
    """600 columns: the port's torch contraction (real for lg, complex128
    for the complex spectrum) against the JAX package's device
    contraction, on the native fill or (`torch`) the port's torch fill
    against the JAX package's XLA fill."""
    device.select("cpu")
    if fill == "torch":
        monkeypatch.setenv("HISTORIAN_DEVICE_SUMPROD", "1")
        monkeypatch.setattr(sumprod.SumProductEngine, "NATIVE_FILL_MAX_CELLS", 0)
    model = model_of(PORT, name)
    model_path = str(tmp_path / "model.json")
    with open(model_path, "w") as f:
        model.write(f)
    tree = PORT.tree.Tree("(((a:0.3,b:0.05):0.2,c:0.7):0.1,(d:0.01,(e:0.4,f:0.2):0.15):0.25)r;")
    rows = synthetic_recon(model, tree, 600, seed=21)
    recon_path = str(tmp_path / "wide.sto")
    with open(recon_path, "w") as f:
        f.write("# STOCKHOLM 1.0\n#=GF NH " + tree.to_string() + "\n")
        f.writelines(f"{n} {r}\n" for n, r in rows)
        f.write("//\n")
    sumprod.ROUTES.clear()
    got = counted(PORT_ROOT, model_path, recon_path)
    kind = "real" if name == "lg" else "complex"
    assert sumprod.ROUTES == {f"fill:{'native' if fill == 'native' else 'cpu'}": 1,
                              f"counts:cpu:{kind}": 1, **({"down:cpu": 1} if fill == "torch" else {})}
    want = counted(JAX_ROOT, model_path, recon_path)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert got["sub"].sum() > 100 and got["indel"][:4].sum() > 50


def test_fit_checkpoint_resumes(recons, tmp_path):
    """`fit -checkpoint` stopped after one EM iteration resumes where it
    stopped: run again with -maxiter 1 it does nothing more, and with
    -maxiter 3 it equals an uninterrupted run."""
    base = ("fit", "-stockrecon", recons["small4"][0], "-checkpoint", str(tmp_path / "ck.json"))
    first = run(PORT_ROOT, *base, "-maxiter", "1")
    with open(tmp_path / "ck.json") as f:
        assert json.load(f)["iteration"] == 0
    assert run(PORT_ROOT, *base, "-maxiter", "1") == first
    resumed = run(PORT_ROOT, *base, "-maxiter", "3")
    fresh = run(PORT_ROOT, "fit", "-stockrecon", recons["small4"][0], "-maxiter", "3")
    assert resumed == fresh != first


@pytest.mark.parametrize("command", ["count", "fit"])
def test_unaligned_input_raises(tmp_path, command, monkeypatch):
    """`count` and `fit` on input that is not a reconstruction no longer
    raise: like the JAX package, they reconstruct it (`-fast`) and count
    while merging, through the root's BackwardMatrix; the output is the
    JAX package's (its host route), byte for byte."""
    from tests.test_torch_sampled import MEMSIZE

    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    fa, _ = write_small4(tmp_path)
    argv = [command, "-fast", *(["-maxiter", "2"] if command == "fit" else []), fa]
    got = run(PORT_ROOT, *argv)
    assert got == run(JAX_ROOT, *argv)
    assert '"insrate"' in got if command == "fit" else parse(got)["indel"]["ins"] > 0
