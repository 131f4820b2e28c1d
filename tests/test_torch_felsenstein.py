"""The port's Felsenstein passes (historian_tpu_torch/ops/felsenstein.py)
against the JAX package's (historian_tpu/ops/felsenstein.py), each
function called directly on the same inputs, float64 on the CPU: rtol
1e-12 (atol 1e-12 for entries that are zero in one of the two).

Inputs are made with numpy from a seed: an 11-node tree, leaves with
residues, wildcards and gaps, internal rows `*` or gapped, so that a
gapped internal node cuts its column into sub-forests.  Models: `lg`
(an exactly-real eigensystem) and `complex`, ECMunrest's codon rates
plus a seeded cyclic non-reversible term, whose spectrum is complex (no
preset's is: numpy's eig gives every preset, ECMunrest included, a real
one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from historian_tpu.engine.sumprod import SumProductEngine as JaxEngine
from historian_tpu.ops import felsenstein as jf
from historian_tpu_torch import device
from historian_tpu_torch.engine.sumprod import SumProductEngine
from historian_tpu_torch.ops import felsenstein as pf
from tests.torch_twins import JAX, PORT

TREE = "(((a:0.3,b:0.05):0.2,c:0.7):0.1,(d:0.01,(e:0.4,f:0.2):0.15):0.25)r;"
RTOL = ATOL = 1e-12


def complex_model(pkg, seed=11):
    """ECMunrest's codon model with a cyclic term added to its rates: codon
    i -> i + 1 (mod A) at a seeded rate, which makes the rate matrix
    non-reversible and its spectrum complex."""
    model = pkg.presets.named_model("ECMunrest")
    rng = np.random.default_rng(seed)
    rate = model.sub_rate.copy()
    a = rate.shape[1]
    idx = np.arange(a)
    rate[0, idx, (idx + 1) % a] += 2.0 + rng.random(a)
    np.fill_diagonal(rate[0], 0.0)
    np.fill_diagonal(rate[0], -rate[0].sum(axis=1))
    model.sub_rate = rate
    return model


def model_of(pkg, name):
    return complex_model(pkg) if name == "complex" else pkg.presets.named_model(name)


def random_tokens(tree, A, L, seed):
    """[N, L] tokens: leaves a residue (82 %), a wildcard (3 %) or a gap;
    internal nodes a wildcard or, one time in four, a gap."""
    rng = np.random.default_rng(seed)
    n = tree.n_nodes()
    tok = np.full((n, L), pf.WILD_TOK, dtype=np.int32)
    for node in range(n):
        u = rng.random(L)
        if tree.is_leaf(node):
            tok[node] = np.where(u < 0.82, rng.integers(0, A, L),
                                 np.where(u < 0.85, pf.WILD_TOK, pf.GAP_TOK))
        else:
            tok[node] = np.where(u < 0.25, pf.GAP_TOK, pf.WILD_TOK)
    return tok


@pytest.fixture(scope="module", params=["lg", "complex"])
def case(request):
    """Both packages' engines on one model and tree, the tokens, and the
    JAX package's up and down passes on them (the inputs of the later
    functions), as numpy arrays."""
    device.select("cpu")
    jmodel, pmodel = model_of(JAX, request.param), model_of(PORT, request.param)
    jeng = JaxEngine(jmodel, JAX.tree.Tree(TREE))
    peng = SumProductEngine(pmodel, PORT.tree.Tree(TREE), torch.device("cpu"))
    np.testing.assert_array_equal(peng.branch_sub, jeng.branch_sub)
    assert peng.count_device_ok == (request.param == "lg") == jeng.count_device_ok
    tokens = random_tokens(peng.tree, pmodel.alphabet_size, 192, seed=5)
    arr = jeng.arrays
    sub, ins, lw = (jnp.asarray(a) for a in (jeng.branch_sub, jeng.ins_prob, jeng.log_cpt_weight))
    up, is_gap = jf._fill_up_batch_tokens(
        jnp.asarray(tokens), jnp.asarray(arr.parent), jnp.asarray(arr.left),
        jnp.asarray(arr.right), sub, ins, lw, arr.n_nodes, pmodel.alphabet_size)
    down = jf._fill_down_batch(up[2], up[3], is_gap, jnp.asarray(arr.parent),
                               jnp.asarray(arr.sibling), sub, ins, arr.n_nodes)
    ref = dict(zip(("F", "logF", "E", "logE", "cpt_ll", "col_ll", "G", "logG"),
                   (np.asarray(a) for a in (*up, *down))))
    ref["is_gap"] = np.asarray(is_gap)
    return request.param, jeng, peng, tokens, ref


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_tree_arrays_match(case):
    _, jeng, peng, _, _ = case
    for name in ("parent", "left", "right", "sibling"):
        np.testing.assert_array_equal(getattr(peng.arrays, name), getattr(jeng.arrays, name))


def test_fill_up_matches_jax(case):
    _, _, peng, tokens, ref = case
    got = pf.fill_up(tokens, peng.arrays, *peng.tensors())
    gap, parent = ref["is_gap"], peng.arrays.parent
    roots = (~gap & np.where(parent >= 0, gap[:, np.maximum(parent, 0)], True)).sum(axis=1)
    assert (roots > 1).sum() > 20 and np.isfinite(ref["col_ll"]).all()  # sub-forests
    for name, g in zip(("F", "logF", "E", "logE", "cpt_ll", "col_ll"), got):
        close(g, ref[name])
    # the rescore's column likelihoods are fill_up's, bit for bit
    assert torch.equal(pf.column_log_likelihoods(tokens, peng.arrays, *peng.tensors()), got[5])


def test_fill_down_matches_jax(case):
    _, _, peng, _, ref = case
    sub, ins, _ = peng.tensors()
    G, logG = pf.fill_down(t(ref["E"]), t(ref["logE"]), t(ref["is_gap"]), peng.arrays, sub, ins)
    close(G, ref["G"])
    close(logG, ref["logG"])


def test_node_post_prob_matches_jax(case):
    _, jeng, _, _, ref = case
    args = [ref[k] for k in ("F", "logF", "G", "logG", "col_ll")]
    want = jf._node_post_prob_batch(*(jnp.asarray(a) for a in args),
                                     jnp.asarray(jeng.log_cpt_weight), jeng.arrays.n_nodes)
    got = pf.node_post_prob(*(t(a) for a in args), t(jeng.log_cpt_weight))
    close(got, want)
    # in a column with one root, every ungapped node's posterior sums to 1
    gap, parent = ref["is_gap"], jeng.arrays.parent
    one = (~gap & np.where(parent >= 0, gap[:, np.maximum(parent, 0)], True)).sum(axis=1) == 1
    total = np.exp(got.numpy()).sum(axis=2)[one][~gap[one]]
    np.testing.assert_allclose(total, 1.0, rtol=1e-9)


def _count_inputs(jeng, ref, seed=9):
    arr = jeng.arrays
    parent_safe = np.maximum(arr.parent, 0)
    sib_safe = np.maximum(arr.sibling, 0)
    gap = ref["is_gap"]
    mask = (~gap) & (arr.parent >= 0)[None, :] & ~gap[:, parent_safe]
    w_col = np.random.default_rng(seed).random(gap.shape[0])
    names = ("F", "logF", "E", "logE", "G", "logG", "col_ll")
    return [ref[k] for k in names] + [parent_safe, sib_safe, mask, w_col, jeng.log_cpt_weight]


def test_eigen_counts_match_jax(case):
    name, jeng, _, _, ref = case
    args = _count_inputs(jeng, ref)
    e, j = jeng.eigen, jeng.branch_eigen_sub_count
    parts = [np.ascontiguousarray(x) for x in (e.evec.real, e.evec.imag, e.evec_inv.real,
                                               e.evec_inv.imag, j.real, j.imag)]
    want_r, want_i = jf._eigen_counts_batch_cplx(*(jnp.asarray(a) for a in args + parts),
                                                 chunk=64)
    want = np.asarray(want_r) + 1j * np.asarray(want_i)
    got = pf.eigen_counts_cplx(*(t(a) for a in args), t(e.evec), t(e.evec_inv), t(j), chunk=50)
    assert got.dtype == torch.complex128
    close(got, want)
    if name == "lg":  # the real contraction, for an exactly-real eigensystem
        want = jf._eigen_counts_batch(*(jnp.asarray(a) for a in args + parts[::2]))
        got = pf.eigen_counts(*(t(a) for a in args + parts[::2]), chunk=50)
        assert got.dtype == torch.float64
        close(got, want)
    else:
        assert np.abs(want.imag).max() > 1e-6 * np.abs(want).max()
        with pytest.raises(TypeError):
            pf.eigen_counts(*(t(a) for a in args), t(e.evec), t(e.evec_inv), t(j))


def test_root_counts_match_jax(case):
    _, jeng, _, _, ref = case
    arr = jeng.arrays
    gap = ref["is_gap"]
    parent_gap = np.where(arr.parent[None, :] >= 0, gap[:, np.maximum(arr.parent, 0)], True)
    is_root = ~gap & parent_gap
    cols = np.nonzero(is_root.any(axis=1))[0]
    roots = np.argmax(is_root, axis=1)[cols]  # each column's first sub-forest root
    w = np.random.default_rng(3).random(len(cols))
    args = (ref["F"][cols, roots], ref["logF"][cols, roots], ref["col_ll"][cols], w,
            jeng.log_cpt_weight, jeng.ins_prob)
    close(pf.root_counts(*(t(a) for a in args)),
          jf._root_counts_batch(*(jnp.asarray(a) for a in args)))
