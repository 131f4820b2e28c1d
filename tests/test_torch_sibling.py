"""`SiblingMatrix` (sampler/sibling.py) against the JAX package's, each
package's built from its own classes (tests/torch_twins.py) on the same
seeded synthetic profiles, under a guide envelope and under an
uninitialised one (the full mask of a prune-and-regraft move):

- the emissions, the mask and the transitions exactly; the packed
  transitions (`pack_sibling_transitions`) exactly;
- both on their host route (csrc/fill.cpp in each package): the cells
  and lp_end exactly, `sample` from one mt19937 seed, `log_post_prob` and
  `parent_seq` exactly; the Python fill bit-identical to fill.cpp;
- the port's device route forced on the CPU (HISTORIAN_DEVICE_SIBLING=1:
  the band entry's plain version and the band readback) against its host
  route: the same -inf pattern, the cells, lp_end and the path scores
  within 1e-9; `FILLS` counts each route."""

import numpy as np
import pytest
import torch

from historian_tpu.ops import siblingdp as jax_sibdp
from historian_tpu.sampler import sibling as jax_sib
from historian_tpu_torch.ops import siblingdp as port_sibdp
from historian_tpu_torch.sampler import sibling as port_sib
from tests.torch_twins import JAX, PORT

L, R = 57, 66
SIDES = {"jax": (JAX, jax_sib), "port": (PORT, port_sib)}


def random_pwm(rng, n: int, c: int, a: int) -> np.ndarray:
    z = rng.normal(0, 2, (n, c, a))
    return z - np.log(np.exp(z).sum(axis=(1, 2), keepdims=True))


def pair_path(rng) -> dict:
    """A random 2-row path of L and R residues: rows 1 (left), 2 (right)."""
    cols = []
    x = y = 0
    while x < L or y < R:
        move = rng.integers(0, 3)
        if (move == 0 and x < L and y < R) or (x < L and y == R):
            move = 0 if y < R else 1
        if move == 0:
            cols.append((True, True)); x += 1; y += 1
        elif (move == 1 and x < L) or y == R:
            cols.append((True, False)); x += 1
        else:
            cols.append((False, True)); y += 1
    arr = np.array(cols, dtype=bool)
    return {1: arr[:, 0], 2: arr[:, 1]}


def build(side: str, banded: bool, **kw):
    pkg, mod = SIDES[side]
    rng = np.random.default_rng(11)
    model = pkg.presets.named_model("lg")
    c, a = model.components, model.alphabet_size
    l_pwm, r_pwm = random_pwm(rng, L, c, a), random_pwm(rng, R, c, a)
    env = (pkg.alignpath.GuideAlignmentEnvelope(pair_path(rng), 1, 2, 8) if banded
           else pkg.alignpath.GuideAlignmentEnvelope())
    return mod.SiblingMatrix(model, l_pwm, r_pwm, 0.21, 0.34, env, np.arange(L + 1),
                             np.arange(R + 1), 1, 2, 0, **kw)


def grid(cells, shape) -> np.ndarray:
    return np.array([[cells[x, y] for y in range(shape[1])] for x in range(shape[0])])


@pytest.fixture(params=["banded", "full"])
def pair(request, monkeypatch):
    from historian_tpu_torch import device

    device.select("cpu")
    monkeypatch.setenv("HISTORIAN_DEVICE_SIBLING", "0")
    banded = request.param == "banded"
    return build("jax", banded), build("port", banded), banded


def test_inputs_and_host_fill_match_jax(pair):
    ref, got, banded = pair
    for name in ("l_emit", "r_emit", "match_emit", "mask", "l_sub", "r_sub"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    assert got.mask.all() != banded
    assert got.t == ref.t
    assert np.array_equal(port_sibdp.pack_sibling_transitions(got),
                          jax_sibdp.pack_sibling_transitions(ref))
    assert np.array_equal(got.cells, ref.cells)
    assert got.lp_end == ref.lp_end and np.isfinite(got.lp_end)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sample_and_scores_match_jax(pair, seed):
    ref, got, _ = pair
    p_ref = ref.sample(JAX.rng.MT19937(seed))
    p_got = got.sample(PORT.rng.MT19937(seed))
    assert set(p_got) == set(p_ref) == {0, 1, 2}
    for k in p_ref:
        assert np.array_equal(p_got[k], p_ref[k])
    assert got.log_post_prob(p_got) == ref.log_post_prob(p_ref)
    assert np.array_equal(got.parent_seq(p_got), ref.parent_seq(p_ref))


def test_python_fill_equals_fill_cpp(pair):
    _, got, banded = pair
    py = build("port", banded, defer_fill=True)
    py._fill_host()
    assert np.array_equal(py.cells, got.cells) and py.lp_end == got.lp_end


def test_forced_device_route_on_cpu(pair, monkeypatch):
    """The band entry's plain version through the band readback: cells and
    scores within 1e-9 of the host route, counted as a device fill."""
    _, host, banded = pair
    monkeypatch.setenv("HISTORIAN_DEVICE_SIBLING", "1")
    before = dict(port_sib.FILLS)
    dev = build("port", banded)
    assert port_sib.FILLS["device"] == before["device"] + 1
    assert port_sib.FILLS["host"] == before["host"]
    shape = (dev.x_size, dev.y_size)
    g = grid(dev.cells, shape)
    assert np.array_equal(g == -np.inf, host.cells == -np.inf)
    live = np.isfinite(host.cells)
    assert np.abs(g[live] - host.cells[live]).max() < 1e-9
    assert abs(dev.lp_end - host.lp_end) < 1e-9 * abs(host.lp_end)
    path = host.sample(PORT.rng.MT19937(5))
    assert abs(dev.log_post_prob(path) - host.log_post_prob(path)) < 1e-9


def test_routes_on_cpu(monkeypatch):
    """Under -platform cpu every fill takes the host, whatever its size,
    unless HISTORIAN_DEVICE_SIBLING forces the device route."""
    from historian_tpu_torch import device

    device.select("cpu")
    monkeypatch.delenv("HISTORIAN_DEVICE_SIBLING", raising=False)
    m = build("port", False, defer_fill=True)
    m.mask = np.ones((500, 500), bool)  # past DEVICE_MIN_CELLS
    assert not m._want_device()
    monkeypatch.setenv("HISTORIAN_DEVICE_SIBLING", "1")
    assert m._want_device()
    monkeypatch.setenv("HISTORIAN_DEVICE_SIBLING", "0")
    assert not m._want_device()


def test_route_rule_counts_the_mask(monkeypatch):
    """On the card the rule counts the in-mask state-cells: a banded grid
    past DEVICE_MIN_CELLS whose mask is under it stays on the host, the
    full mask of the same grid takes kernel (d)."""
    monkeypatch.delenv("HISTORIAN_DEVICE_SIBLING", raising=False)
    monkeypatch.setattr(port_sib.devmod, "current", lambda: torch.device("cuda"))
    m = build("port", True, defer_fill=True)
    side = 500
    assert side * side * port_sib.N_STATES > port_sib.DEVICE_MIN_CELLS
    diag = np.abs(np.arange(side)[:, None] - np.arange(side)[None, :])
    m.mask = diag <= 20
    assert np.count_nonzero(m.mask) * port_sib.N_STATES < port_sib.DEVICE_MIN_CELLS
    assert not m._want_device()
    m.mask = np.ones((side, side), bool)
    assert m._want_device()
