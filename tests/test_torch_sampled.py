"""Sampled-profile merges, the default `recon`: the port against the JAX
package's host route (HISTORIAN_DEVICE_DP=0) in float64.

The JAX package's host route is the reference's semantics: the host fill,
then each sampled trace walked with one mt19937 `uniform(0, ptot)` a step.
The port's device route (on the CPU, the kernels' plain versions) draws
the same uniforms ahead in bulk, walks the sampled traces in order over
them, and moves the generator past the draws of the walks the host loop
would have made.  So every merge must give the same paths, the same
profile and leave the generator in the same state; end to end, the rows
must be byte-identical and `#=GF LP` within 1e-6."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from historian_tpu_torch import device
from historian_tpu_torch.ops import tracedp
from tests.test_torch_recon import REPO, rows_and_lp, write_small4
from tests.torch_twins import DATA, JAX, PORT, host_forward, leaves, pair_hmm

#: the memory both packages size max_profile_states() from (16 GiB)
MEMSIZE = str(16 << 30)


@pytest.fixture
def cpu64(monkeypatch):
    monkeypatch.setenv("HISTORIAN_DEVICE_DP", "0")
    monkeypatch.setenv("HISTORIAN_DEVICE_DTYPE", "f64")
    device.select("cpu")


class ListDraws:
    """A generator of given uniforms, with the host's `uniform` and the
    port's `uniforms_ahead` / `advance_uniforms` over the same list."""

    def __init__(self, values):
        self.values, self.pos = list(values), 0

    def uniform(self, a=0.0, b=1.0):
        u = self.values[self.pos % len(self.values)]
        self.pos += 1
        return a + u * (b - a)

    def uniforms_ahead(self, n):
        return np.array([self.values[(self.pos + k) % len(self.values)] for k in range(n)])

    def advance_uniforms(self, n):
        self.pos += n


# ------------------------------------------------------------ the generator
@pytest.mark.parametrize("seed,skip,n", [(5489, 0, 3000), (7, 5, 1000), (2024, 623, 700)])
def test_uniforms_ahead_are_uniform_calls(seed, skip, n):
    """uniforms_ahead(n) equals n uniform() calls bit for bit and does not
    move the generator; advance_uniforms(n) leaves it where they do."""
    g, h = PORT.rng.MT19937(seed), PORT.rng.MT19937(seed)
    for _ in range(skip):
        g.next_u32(), h.next_u32()
    ahead = g.uniforms_ahead(n)
    assert g.mti == h.mti and g.mt == h.mt
    calls = np.array([h.uniform() for _ in range(n)])
    assert np.array_equal(ahead.view(np.int64), calls.view(np.int64))
    g.advance_uniforms(n)
    assert g.mt == h.mt and g.mti == h.mti and g.next_u32() == h.next_u32()


def test_sampled_pick_is_the_host_rule():
    """tracedp.sampled_index against the JAX package's DPMatrix.sample_cell
    on weights 0 and 1 and draws k/8, so that p = u * ptot lands exactly
    on 0 after a subtraction: the first candidate of positive weight with
    p <= 0 wins, and at u > 0 a zero weight never does."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        w = (rng.random(rng.integers(2, 12)) < 0.6).astype(np.float64)
        w[rng.integers(len(w))] = 1.0
        lp = {(0, k, 0): (0.0 if x else -np.inf) for k, x in enumerate(w)}
        for u in np.arange(1, 8) / 8:
            host = JAX.forward.DPMatrix.sample_cell(None, lp, ListDraws([u]))
            assert tracedp.sampled_index(w, u) == host[1]
    # u = 0: the first candidate of positive weight, never a zero weight
    assert tracedp.sampled_index(np.array([0.0, 0.0, 1.0, 1.0]), 0.0) == 2


# ------------------------------------------------------------- the walks
def _chain_merge(pkg):
    model, profs = leaves(pkg, 2, 150)
    return profs[0], profs[1], pair_hmm(pkg, model, 0.4, 0.3)


def _dag_y_merge(pkg):
    """A chain x against a sampled-profile DAG y (in-degree up to 5): y from
    two distant sequences of long8 cut to 120 aa, by `pkg`'s host fill and
    its mt19937 sampler; x a third with two 3-aa deletions, so that the
    sampled traces disagree."""
    model = pkg.presets.named_model("lg")
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long8.fa"))
    s = seqs[2].seq[:120]
    rows = [seqs[0].seq[:120], seqs[3].seq[:120], s[:40] + s[43:90] + s[93:]]
    a, b, c = (pkg.profile.Profile.from_sequence(
        model.components, model.alphabet, pkg.seqs.FastSeq(name=f"s{i}", seq=r), i)
        for i, r in enumerate(rows))
    y = host_forward(pkg, a, b, pair_hmm(pkg, model, 0.6, 0.6), 3).sample_profile(
        pkg.rng.MT19937(5489), 10, 0)
    return c, y, pair_hmm(pkg, model, 0.5, 0.4)


def _pair(build, node=4):
    """(JAX host ForwardMatrix, port device-route ForwardMatrix)."""
    host = JAX.forward.ForwardMatrix(*build(JAX), node)
    port = PORT.forward.ForwardMatrix(*build(PORT), node, defer_cells=True)
    assert host._trace_handle is None and port._trace_handle is not None
    return host, port


DRAWS = {
    "mt19937": lambda pkg: pkg.rng.MT19937(5489),
    # dyadic draws, 0 among them: p = u * ptot is exact.  (Near 1, the
    # reference's serial subtraction can leave p above 0 after the last
    # candidate, and its sample_cell fails.)
    "dyadic": lambda pkg: ListDraws([0.5, 0.25, 0.0, 0.75, 0.125, 0.875]),
}


@pytest.mark.parametrize("draws", sorted(DRAWS))
@pytest.mark.parametrize("merge", ["chain y", "DAG y"])
def test_sampled_walks_are_the_host_walks(cpu64, merge, draws):
    """The plain walker's sampled traces, on the generator's draws taken
    ahead, equal the JAX package's host sample_trace on the same
    generator, walk for walk; moved past their draws, both generators then
    stand at the same place."""
    host, port = _pair(_chain_merge if merge == "chain y" else _dag_y_merge)
    if merge == "DAG y":
        assert port._trace_handle.walk["y_src"].shape[1] > 1  # KY > 1
    g_host, g_port = DRAWS[draws](JAX), DRAWS[draws](PORT)
    paths = port._device_traces(6, False, g_port)
    ref = [host.sample_trace(g_host) for _ in range(6)]
    assert paths == ref
    assert len({tuple(p) for p in paths}) > 1
    g_port.advance_uniforms(sum(len(p) - 1 for p in paths))
    if draws == "mt19937":
        assert g_port.next_u32() == g_host.next_u32()
    else:
        assert g_port.pos == g_host.pos


PROFILE_CASES = {
    # name: (profile_samples, max_cells, strategy flags, min_len, max_len)
    "default": (10, 0, ("COLLAPSE_CHAINS", "INCLUDE_BEST_TRACE"), 0, 1 << 62),
    "max_cells stops early": (10, 145, ("COLLAPSE_CHAINS", "INCLUDE_BEST_TRACE"), 0, 1 << 62),
    "no best trace": (10, 0, ("COLLAPSE_CHAINS",), 0, 1 << 62),
    "gaps open": (4, 0, ("COLLAPSE_CHAINS", "INCLUDE_BEST_TRACE", "KEEP_GAPS_OPEN"), 0, 1 << 62),
    # a sampled trace longer than max_len is walked (its draws taken), and
    # the loop stops there
    "a trace too long": (10, 0, ("COLLAPSE_CHAINS", "INCLUDE_BEST_TRACE"), 0, 120),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_sample_profile_matches_host(cpu64, case):
    """sample_profile on the device route gives the JAX host route's
    profile and leaves the generator where the host loop leaves it: the
    max_cells early stop and the length break included."""
    n, max_cells, flags, lo, hi = PROFILE_CASES[case]
    host, port = _pair(_dag_y_merge)
    profs, gens = [], []
    for pkg, fwd in ((JAX, host), (PORT, port)):
        strategy = sum(getattr(pkg.forward, f) for f in flags)
        gen = pkg.rng.MT19937(99)
        draws = PORT.forward.SAMPLED["draws"]
        profs.append(fwd.sample_profile(gen, n, max_cells, strategy, lo, hi).to_json())
        gens.append((gen.mt, gen.mti))
    assert profs[1] == profs[0]
    assert gens[1] == gens[0]
    # the port's draws: the walks the host loop made, and no more
    taken = PORT.forward.SAMPLED["draws"] - draws
    all_walks = sum(len(p) - 1 for p in port._device_traces(n, False, PORT.rng.MT19937(99)))
    if case in ("max_cells stops early", "a trace too long"):
        assert 0 < taken < all_walks
    else:
        assert taken == all_walks


def test_dag_x_merge_takes_the_host_fill(cpu64):
    """A sampled-profile x: the port fills with csrc/fill.cpp, counts the
    fill on the host route, and gives the JAX host route's cells (1e-9),
    lp_end and sampled profile, generator state included."""
    def build(pkg):
        model, (a, b, c) = leaves(pkg, 3, 90)
        hmm = pair_hmm(pkg, model, 0.3, 0.2)
        x = host_forward(pkg, a, b, hmm, 3).sample_profile(pkg.rng.MT19937(5489), 10, 0)
        assert x.as_chain() is None
        return x, c, hmm

    host = JAX.forward.ForwardMatrix(*build(JAX), 4)
    args = build(PORT)
    fills = dict(PORT.forward.FILLS)
    port = PORT.forward.ForwardMatrix(*args, 4, defer_cells=True)
    assert port._trace_handle is None
    assert PORT.forward.FILLS == dict(fills, host=fills["host"] + 1)
    assert abs(port.lp_end - host.lp_end) < 1e-9
    hc = np.where(np.isfinite(host.cells), host.cells, -1e99)
    pc = np.where(np.isfinite(port.cells), port.cells, -1e99)
    np.testing.assert_allclose(pc, hc, rtol=1e-9, atol=1e-9)
    out = []
    for pkg, fwd in ((JAX, host), (PORT, port)):
        gen = pkg.rng.MT19937(31)
        out.append((fwd.sample_profile(gen, 10, 0, pkg.forward.COLLAPSE_CHAINS
                                       | pkg.forward.INCLUDE_BEST_TRACE).to_json(),
                    gen.next_u32()))
    assert out[1] == out[0]


# ------------------------------------------------------------ end to end
def write_small6(d) -> str:
    """small6: the 6 sequences of tests/data/long6.fa cut to 240-340 aa."""
    from historian_tpu_torch.core.seqs import read_fasta

    fa = os.path.join(d, "small6.fa")
    with open(fa, "w") as f:
        for s, n in zip(read_fasta(os.path.join(REPO, "tests", "data", "long6.fa")),
                        (240, 260, 280, 300, 320, 340)):
            f.write(f">{s.name}\n{s.seq[:n]}\n")
    return fa


#: name: (input, flags, port-only environment); the JAX package runs the
#: same input and flags once each
E2E_CASES = {
    "small6": ("small6", [], {}),
    "small4 -tree": ("small4", [], {}),
    "small4 -profsamples 3 -profmaxstates 400": ("small4", ["-profsamples", "3",
                                                            "-profmaxstates", "400"], {}),
    "small4 -nobest": ("small4", ["-nobest"], {}),
    "small4 -keepgapsopen": ("small4", ["-keepgapsopen"], {}),
    "small4 fused": ("small4", [], {"HISTORIAN_PALLAS_FUSED": "1"}),
}


def _run(pkg, args, env):
    e = dict(os.environ, HISTORIAN_MEMSIZE=MEMSIZE, **env)
    out = subprocess.run([sys.executable, "-m", pkg, "recon", *args], capture_output=True,
                         text=True, timeout=300, env=e, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Every case's two runs, four at a time: {name: (jax, port) stdout}."""
    d = tmp_path_factory.mktemp("sampled")
    fa4, nh4 = write_small4(d)
    inputs = {"small6": [write_small6(d)], "small4": ["-tree", nh4, fa4]}
    jax_env = dict(JAX_PLATFORMS="cpu", HISTORIAN_PLATFORM="cpu", HISTORIAN_DEVICE_DP="0")
    port_env = dict(HISTORIAN_DEVICE_DTYPE="f64", HISTORIAN_PALLAS_FUSED="0")
    jobs = {}
    for name, (inp, flags, env) in E2E_CASES.items():
        key = (inp, tuple(flags))
        jobs.setdefault(("jax", key), ("historian_tpu", [*flags, *inputs[inp]], jax_env))
        jobs[("port", name)] = ("historian_tpu_torch",
                                ["-platform", "cpu", *flags, *inputs[inp]],
                                dict(port_env, **env))
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(_run, *job) for k, job in jobs.items()}
        outs = {k: f.result() for k, f in futures.items()}
    return {name: (outs[("jax", (inp, tuple(flags)))], outs[("port", name)])
            for name, (inp, flags, _) in E2E_CASES.items()}


@pytest.mark.parametrize("name", list(E2E_CASES))
def test_default_recon_matches_jax(e2e, name):
    """`python -m historian_tpu_torch recon -platform cpu` in float64
    against `python -m historian_tpu recon` on the CPU's host route: rows
    byte-identical, `#=GF LP` within 1e-6."""
    ref, got = e2e[name]
    ref_rows, ref_lp = rows_and_lp(ref)
    rows, lp = rows_and_lp(got)
    assert len(rows) == (11 if name == "small6" else 7)
    assert rows == ref_rows
    assert abs(lp - ref_lp) < 1e-6


def test_default_recon_routes(cpu64, tmp_path, monkeypatch, capsys):
    """small6 with no flags: the chain-x merges on the device route, the
    merges of a sampled x on the host, sampled walks on both."""
    from historian_tpu_torch import cli, recon
    from historian_tpu_torch.engine import forward

    monkeypatch.setenv("HISTORIAN_MEMSIZE", MEMSIZE)
    before = (dict(recon.MERGES), dict(forward.FILLS), dict(forward.SAMPLED),
              tracedp.LAUNCHES)
    assert cli.main(["recon", "-platform", "cpu", write_small6(tmp_path)]) == 0
    merges = {k: recon.MERGES[k] - before[0][k] for k in recon.MERGES}
    fills = {k: forward.FILLS[k] - before[1][k] for k in forward.FILLS}
    walks = {k: forward.SAMPLED[k] - before[2][k] for k in forward.SAMPLED}
    assert sum(merges.values()) == 5 and merges["device"] > 0 and merges["host"] > 0
    assert fills == merges  # no band-doubling retry on small6
    assert walks["device_walks"] > 0 and walks["host_walks"] > 0 and walks["draws"] > 0
    assert tracedp.LAUNCHES == before[3]  # the plain walker launches nothing
    assert "#=GF LP" in capsys.readouterr().out
