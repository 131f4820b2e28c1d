"""The port's sum-product engine (historian_tpu_torch/engine/sumprod.py)
against the JAX package's (historian_tpu/engine/sumprod.py), float64 on
the CPU, each package on its own model and tree.

Where both take one formulation the results are identical: the native
fill (the same csrc/fill.cpp), and the numpy count formulation below 512
columns on it.  Where they do not, within rtol 1e-9: the port's torch
fill against the JAX package's XLA fill (HISTORIAN_DEVICE_SUMPROD=1 in
the environment makes the JAX engine take it), the torch node
posteriors against XLA's, and the torch eigencount contraction (512
columns and more) against the JAX package's device contraction."""

import numpy as np
import pytest
import torch

from historian_tpu.engine import sumprod as jsp
from historian_tpu_torch import device
from historian_tpu_torch.engine import sumprod
from tests.test_torch_felsenstein import model_of
from tests.torch_twins import JAX, PORT

TREE = "((a:0.3,b:0.2):0.1,((c:0.4,d:0.15):0.05,e:0.3):0.25)r;"
NAMES = ("F", "logF", "E", "logE", "G", "logG", "cpt_ll", "col_ll")
RTOL = 1e-9


def random_rows(model, tree, L, seed):
    """Leaves: residues with 15 % gaps; internal rows `*`, so each column
    has one root."""
    rng = np.random.default_rng(seed)
    syms = np.array([model.alphabet.symbol(i) for i in range(model.alphabet.size)])
    rows = []
    for n in range(tree.n_nodes()):
        if tree.is_leaf(n):
            row = syms[rng.integers(0, len(syms), L)]
            rows.append("".join(np.where(rng.random(L) < 0.15, "-", row)))
        else:
            rows.append("*" * L)
    return rows


def engines(name="lg"):
    device.select("cpu")
    jm, pm = model_of(JAX, name), model_of(PORT, name)
    return (jsp.SumProductEngine(jm, JAX.tree.Tree(TREE)),
            sumprod.SumProductEngine(pm, PORT.tree.Tree(TREE)))


@pytest.fixture
def xla_route(monkeypatch):
    """The JAX engine's XLA fill and the port's torch fill, at any size."""
    monkeypatch.setenv("HISTORIAN_DEVICE_SUMPROD", "1")
    monkeypatch.setattr(sumprod.SumProductEngine, "NATIVE_FILL_MAX_CELLS", 0)


def test_native_fill_identical():
    jeng, peng = engines()
    rows = random_rows(peng.model, peng.tree, 150, seed=1)
    sumprod.ROUTES.clear()
    got, ref = peng.fill(rows), jeng.fill(rows)
    assert sumprod.ROUTES == {"fill:native": 1}
    for name in NAMES:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


def test_torch_fill_matches_xla_fill(xla_route):
    jeng, peng = engines()
    rows = random_rows(peng.model, peng.tree, 150, seed=2)
    sumprod.ROUTES.clear()
    got, ref = peng.fill(rows), jeng.fill(rows)
    assert isinstance(got.tensor("F"), torch.Tensor)
    for name in NAMES:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=RTOL,
                                   atol=1e-12, err_msg=name)
    assert sumprod.ROUTES == {"fill:cpu": 1, "down:cpu": 1}


@pytest.mark.parametrize("route", ["native", "torch"])
def test_ancestral_rows_and_posteriors(route, request):
    if route == "torch":
        request.getfixturevalue("xla_route")
    jeng, peng = engines()
    rows = random_rows(peng.model, peng.tree, 120, seed=3)
    got, ref = peng.fill(rows), jeng.fill(rows)
    np.testing.assert_allclose(got.log_node_post_prob_all(), ref.log_node_post_prob_all(),
                               rtol=RTOL, atol=1e-12)
    anc = got.ancestral_gapped_rows(rows)
    assert anc == ref.ancestral_gapped_rows(rows) and "*" not in "".join(anc)
    assert got.max_post_state(7, 6) == ref.max_post_state(7, 6)
    pp, want = got.ancestral_post_probs(rows), ref.ancestral_post_probs(rows)
    assert sorted(pp) == sorted(want) == [2, 5, 7, 8]  # the internal nodes
    for row in want:
        assert pp[row].keys() == want[row].keys()
        for col in want[row]:
            assert pp[row][col].keys() == want[row][col].keys()
            np.testing.assert_allclose(list(pp[row][col].values()),
                                       list(want[row][col].values()), rtol=RTOL)


def test_per_column_eigen_counts_identical():
    jeng, peng = engines()
    rows = random_rows(peng.model, peng.tree, 90, seed=4)
    got, ref = peng.fill(rows).per_column_eigen_counts(), jeng.fill(rows).per_column_eigen_counts()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert np.abs(got[1]).max() > 0


def test_fill_column_identical():
    jeng, peng = engines()
    col = {0: "a", 1: "-", 2: "*", 3: "w", 4: "x", 5: "*", 6: "k", 7: "*", 8: "*"}
    got, ref = peng.fill_column(col), jeng.fill_column(col)
    assert got.n_columns == 1
    for name in NAMES:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    c, a = peng.model.components, peng.model.alphabet_size
    out = [(np.zeros((c, a)), np.zeros((c, a, a), complex)) for _ in range(2)]
    got.accumulate_eigen_counts(*out[0])
    ref.accumulate_eigen_counts(*out[1])
    for g, r in zip(*out):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name,L,route", [("lg", 300, "counts:numpy"),
                                          ("lg", 700, "counts:cpu:real"),
                                          ("complex", 300, "counts:numpy"),
                                          ("complex", 700, "counts:cpu:complex")])
def test_eigen_counts_both_sides_of_512_columns(name, L, route):
    """Below 512 columns both engines take the numpy formulation on the
    native fill: identical.  From 512 on, the port's torch contraction
    (real, or complex128 for the complex spectrum) against the JAX
    package's device contraction: rtol 1e-9.  Column weights random."""
    jeng, peng = engines(name)
    rows = random_rows(peng.model, peng.tree, L, seed=6)
    w = np.random.default_rng(7).random(L)
    c, a = peng.model.components, peng.model.alphabet_size
    out = [(np.zeros((c, a)), np.zeros((c, a, a), complex)) for _ in range(2)]
    sumprod.ROUTES.clear()
    peng.fill(rows).accumulate_eigen_counts(*out[0], w)
    jeng.fill(rows).accumulate_eigen_counts(*out[1], w)
    assert sumprod.ROUTES == {"fill:native": 1, route: 1}
    assert (np.abs(out[0][1].imag).max() > 0) == (name == "complex")
    for g, r in zip(*out):
        if L < 512:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-12 * np.abs(r).max())


def test_column_log_likelihood_memo():
    jeng, peng = engines()
    rows = random_rows(peng.model, peng.tree, 60, seed=8)
    ref = jeng.column_log_likelihoods(rows)
    np.testing.assert_array_equal(peng.column_log_likelihoods(rows), ref)
    np.testing.assert_array_equal(peng.column_log_likelihoods_cached(rows), ref)
    np.testing.assert_array_equal(peng.column_log_likelihoods_cached(rows), ref)  # warm
    assert peng.log_likelihood_cached(rows) == peng.log_likelihood(rows) == jeng.log_likelihood(rows)


def test_engine_cache_keys_exact_lengths_and_device():
    device.select("cpu")
    model = PORT.presets.named_model("lg")
    a = PORT.tree.Tree("((a:0.1,b:0.2):0.3,c:0.4)r;")
    b = PORT.tree.Tree("((a:0.1000000001,b:0.2):0.3,c:0.4)r;")  # the same text at 6 digits
    assert a.to_string() == b.to_string()
    e = sumprod.get_engine(model, a)
    assert sumprod.get_engine(model, a) is e and sumprod.get_engine(model, b) is not e
    assert e.device == torch.device("cpu")


def test_native_fill_unavailable_raises(monkeypatch):
    from historian_tpu_torch import native

    _, peng = engines()
    monkeypatch.setattr(native, "get_native", lambda: None)
    with pytest.raises(RuntimeError, match="native host fill"):
        peng.fill(random_rows(peng.model, peng.tree, 10, seed=9))
