"""The refiner's branch machinery on the CPU in float64, each package on
its own objects: small6's `recon -careful -norefine` reconstruction
(tests/data/long6.fa cut to 240-340 aa, written by the port, which
equals the JAX package's byte for byte, tests/test_torch_careful.py),
cut at every branch as `Refiner.refine_node` cuts it.

- the treealign helpers (`branch_path`, `clade_path`,
  `get_guide_seq_pos`: exactly; `get_conditional_pwms`, `pre_multiply`,
  `calc_ins_probs`: to 1e-12);
- `BranchMatrix` (Viterbi and Forward) against the JAX package's: the
  cells and lp_end exactly (both fill on the host, fill.cpp), `best`
  exactly, `sample` from one mt19937 seed exactly, `log_path_prob` and
  `log_post_prob` exactly;
- the hull of each row that the port's device route takes from the
  envelope (`envelope_hull`) against the mask's (`branchdp.interior_hull`);
- the port's device route forced on the CPU (HISTORIAN_DEVICE_BRANCH=1:
  the band entry's plain version and the band readback) against its host
  route:
  lp_end to 1e-9, and a best path that scores, under the host's matrix,
  within 1e-9 of the host's best.  The paths themselves may differ at an
  exact tie: the plain version's Delete scan rounds otherwise than
  fill.cpp (at small6's branch 6 the two paths score the same to the
  last bit under the host's cells), which is why the CUDA kernel keeps
  fill.cpp's order of operations."""

import contextlib
import io

import numpy as np
import pytest
import torch

from historian_tpu.engine import branchmatrix as jax_bm
from historian_tpu.engine import treealign as jax_ta
from historian_tpu_torch.engine import branchmatrix as port_bm
from historian_tpu_torch.engine import treealign as port_ta
from historian_tpu_torch.ops import branchdp
from tests.test_torch_sampled import MEMSIZE, write_small6
from tests.torch_twins import JAX, PORT

N_BRANCHES = 10  # small6: 11 nodes
SIDES = {"jax": (JAX, jax_ta, jax_bm), "port": (PORT, port_ta, port_bm)}


@pytest.fixture(scope="module")
def small6_recon(tmp_path_factory):
    """The Stockholm text of small6 `recon -careful -norefine` (port, CPU,
    float64)."""
    from historian_tpu_torch import cli, device

    fa = write_small6(tmp_path_factory.mktemp("bm"))
    mp = pytest.MonkeyPatch()
    mp.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    mp.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    out = io.StringIO()
    try:
        device.select("cpu")
        with contextlib.redirect_stdout(out):
            assert cli.main(["recon", "-platform", "cpu", "-careful", "-norefine", fa]) == 0
    finally:
        mp.undo()
    return out.getvalue()


def history(pkg, text):
    """(model, tree, gapped rows in node order) of `pkg` from the text."""
    stock = pkg.stockholm.Stockholm.parse(text)
    tree = stock.get_tree()
    return pkg.presets.named_model("lg"), tree, tree.reorder_seqs(stock.gapped)


def branch(side, text, node, viterbi=True):
    """Everything refine_node builds for `node`'s branch, in package `side`."""
    pkg, ta, bm = SIDES[side]
    model, tree, gapped = history(pkg, text)
    parent = tree.parent(node)
    path = pkg.alignpath.Alignment.from_gapped(gapped).path
    bpath = ta.branch_path(path, tree, node)
    env = pkg.alignpath.GuideAlignmentEnvelope(bpath, parent, node, 20)
    out = dict(
        parent=parent, bpath=bpath, env=env,
        p_clade=ta.clade_path(path, tree, parent, node),
        n_clade=ta.clade_path(path, tree, node, parent),
        p_pos=ta.get_guide_seq_pos(path, parent, parent),
        n_pos=ta.get_guide_seq_pos(path, node, node),
    )
    out["pwms"] = ta.get_conditional_pwms(model, tree, gapped, {node: parent, parent: node})
    out["matrix"] = bm.BranchMatrix(
        model, out["pwms"][parent], out["pwms"][node], tree.branch_length_between(parent, node),
        env, out["p_pos"], out["n_pos"], parent, node, viterbi=viterbi)
    out["model"] = model
    return out


def same_path(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module", params=range(N_BRANCHES))
def both(request, small6_recon):
    node = request.param
    return node, branch("jax", small6_recon, node), branch("port", small6_recon, node)


def test_treealign_helpers(both):
    node, ref, got = both
    assert got["parent"] == ref["parent"]
    for k in ("bpath", "p_clade", "n_clade"):
        assert same_path(got[k], ref[k]), k
    for k in ("p_pos", "n_pos"):
        assert np.array_equal(got[k], ref[k]), k
    for n in (node, got["parent"]):
        r, g = ref["pwms"][n], got["pwms"][n]
        assert g.shape == r.shape and len(g) > 0
        assert np.allclose(g, r, rtol=1e-12, atol=1e-12)
    model = got["model"]
    lsub = np.log(model.sub_prob_matrix(0.3))
    pwm = got["pwms"][node]
    assert np.allclose(port_ta.pre_multiply(pwm, lsub), jax_ta.pre_multiply(pwm, lsub),
                       rtol=1e-12, atol=1e-12)
    lins, lw = np.log(model.ins_prob), np.log(model.cpt_weight)
    assert np.allclose(port_ta.calc_ins_probs(pwm, lins, lw),
                       jax_ta.calc_ins_probs(pwm, lins, lw), rtol=1e-12, atol=1e-12)


def test_viterbi_best_and_scores(both):
    node, ref, got = both
    rm, gm = ref["matrix"], got["matrix"]
    assert np.array_equal(gm.cells, rm.cells) and np.array_equal(gm.mask, rm.mask)
    assert gm.lp_end == rm.lp_end
    best = gm.best()
    assert same_path(best, rm.best())
    for path in (best, got["bpath"]):
        assert gm.log_path_prob(path) == rm.log_path_prob(path)
        assert gm.log_post_prob(path) == rm.log_post_prob(path)


def test_forward_sample_and_scores(both, small6_recon):
    node = both[0]
    ref = branch("jax", small6_recon, node, viterbi=False)["matrix"]
    got = branch("port", small6_recon, node, viterbi=False)["matrix"]
    assert got.lp_end == ref.lp_end
    r_rng, g_rng = JAX.rng.MT19937(node + 11), PORT.rng.MT19937(node + 11)
    for _ in range(3):
        path = got.sample(g_rng)
        assert same_path(path, ref.sample(r_rng))
        assert got.log_path_prob(path) == ref.log_path_prob(path)
        assert got.log_post_prob(path) == ref.log_post_prob(path)
    assert g_rng.next_u32() == r_rng.next_u32()


def test_envelope_hull_equals_the_mask_hull(both):
    """The device route's band: each interior row's hull found by binary
    search on the envelope's cumulative matches equals the span of the
    row's in-mask interior columns, and an uninitialised envelope leaves
    the hull to the mask."""
    node, _, got = both
    m = got["matrix"]
    hull = port_bm.envelope_hull(got["env"], got["p_pos"], got["n_pos"], m.x_size, m.y_size)
    lo, hi = branchdp.interior_hull(torch.from_numpy(m.mask))
    assert hull is not None and (hi[1:-1] > 0).any()
    assert np.array_equal(hull[0], lo.numpy()) and np.array_equal(hull[1], hi.numpy())
    blank = PORT.alignpath.GuideAlignmentEnvelope()
    assert port_bm.envelope_hull(blank, got["p_pos"], got["n_pos"], m.x_size, m.y_size) is None


def test_forced_device_route_on_cpu(both, small6_recon, monkeypatch):
    """HISTORIAN_DEVICE_BRANCH=1 sends the fill through branchdp (the plain
    version on the CPU) and reads its band back; the host traceback
    finds a best path of the host's best score."""
    node, _, host = both
    monkeypatch.setenv("HISTORIAN_DEVICE_BRANCH", "1")
    fills = dict(port_bm.FILLS)
    dev = branch("port", small6_recon, node)
    assert port_bm.FILLS == dict(fills, device=fills["device"] + 1)
    hm, dm = host["matrix"], dev["matrix"]
    tol = 1e-9 * abs(hm.lp_end)
    assert abs(dm.lp_end - hm.lp_end) <= tol
    best, host_best = dm.best(), hm.best()
    assert abs(hm.log_path_prob(best) - hm.log_path_prob(host_best)) <= tol
    assert abs(dm.log_path_prob(best) - hm.log_path_prob(best)) <= tol
