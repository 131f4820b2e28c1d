"""The port's mesh paths (historian_tpu_torch/parallel/, ops/sp_colforward.py)
against the JAX package's, in this process, float64 on the CPU, on the 8
virtual CPU devices of tests/conftest.py: the JAX package's CPU platform
has 8 devices, and so has the port's (device.local_devices reads the same
XLA_FLAGS), whose shards run in turn.

- the sharded E-step (pcounts.sharded_alignment_eigen_counts) at 1, 2, 3
  and 8 devices against the port's host oracle and the JAX package's on
  the same mesh (1e-9 relative), and on DxE meshes with a two-component
  mixture built from a preset against the dp-only mesh;
- psum_counts and the counts' tensor round trip;
- the plain SP fill (sp_col_forward_planes_plain) at 1, 2, 3 and 8 shards
  against the JAX sp_col_forward_cells and K1's plain version, on a
  chain-x x sampled-y merge of long12 and on seeded inputs whose x does
  not divide into the shards;
- sp_merge_wins against the JAX router at its thresholds;
- `recon -fast` of small6 under `-mesh 4` with HISTORIAN_SP=1: every merge
  on the SP route, the output the JAX package's with the same settings.
Inputs come from in-repo files or a numpy seed."""

import contextlib
import io
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from historian_tpu.ops.sp_colforward import sp_col_forward_cells as jax_sp_cells
from historian_tpu.parallel import pcounts as jax_pcounts
from historian_tpu.parallel import spmerge as jax_spmerge
from historian_tpu_torch import convert, device
from historian_tpu_torch.engine import forward
from historian_tpu_torch.ops import colforward, devicedp, sp_colforward
from historian_tpu_torch.parallel import mesh as port_mesh
from historian_tpu_torch.parallel import pcounts, spmerge
from tests.test_torch_colforward import _inputs, _k1_args
from tests.test_torch_counts import synthetic_recon
from tests.test_torch_span import write_small6
from tests.torch_twins import DATA, JAX, PORT, count_fills, host_forward, pair_hmm

RTOL = 1e-9
TREE = "(((a:0.3,b:0.05):0.2,c:0.7):0.1,(d:0.01,(e:0.4,f:0.2):0.15):0.25)r;"


@pytest.fixture(autouse=True)
def no_mesh():
    """Every test starts and ends with no mesh in either package."""
    device.select("cpu")
    pcounts.clear_mesh()
    jax_pcounts.clear_mesh()
    yield
    pcounts.clear_mesh()
    jax_pcounts.clear_mesh()


def mixture(pkg):
    """lg as a two-component mixture: the second component's rates scaled
    by 2.5, weights 0.6 / 0.4, each component with lg's root frequencies."""
    lg = pkg.presets.named_model("lg")
    return pkg.ratemodel.RateModel(
        lg.alphabet.symbols, ins_rate=lg.ins_rate, del_rate=lg.del_rate,
        ins_ext_prob=lg.ins_ext_prob, del_ext_prob=lg.del_ext_prob,
        cpt_weight=np.array([0.6, 0.4]), ins_prob=np.concatenate([lg.ins_prob] * 2),
        sub_rate=np.concatenate([lg.sub_rate, 2.5 * lg.sub_rate]),
    )


def close(got, want, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def assert_counts(got, want):
    close(got.root_count, want.root_count, "root")
    close(got.eigen_count, want.eigen_count, "eigen")
    assert abs(got.indel.lp - want.indel.lp) <= RTOL * abs(want.indel.lp)


@pytest.fixture(scope="module")
def alignment():
    """(port model, JAX model, port tree, JAX tree, rows): 700 columns of a
    synthetic reconstruction (every column one root, gaps under gaps)."""
    model = PORT.presets.named_model("lg")
    tree = PORT.tree.Tree(TREE)
    rows = [r for _, r in synthetic_recon(model, tree, 700, seed=5)]
    return model, JAX.presets.named_model("lg"), tree, JAX.tree.Tree(TREE), rows


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_counts_match_oracle_and_jax(alignment, n):
    model, jmodel, tree, jtree, rows = alignment
    mesh = pcounts.set_mesh(n)
    assert mesh.shape == {"dp": n} and len(mesh.local_devices()) == n
    got = pcounts.sharded_alignment_eigen_counts(model, tree, rows, mesh)
    assert_counts(got, pcounts.column_sharded_eigen_counts(model, tree, rows, n))
    assert_counts(got, pcounts.column_sharded_eigen_counts(model, tree, rows, 1))
    want = jax_pcounts.sharded_alignment_eigen_counts(jmodel, jtree, rows,
                                                      jax_pcounts.set_mesh(n))
    assert_counts(got, want)


@pytest.mark.parametrize("spec", ["2x2", "4x2"])
def test_dxe_mesh_matches_dp_mesh_and_jax(alignment, spec):
    """Components over ep: the same counts as the dp-only mesh of the
    same dp, and as the JAX package's DxE mesh."""
    _, _, tree, jtree, rows = alignment
    model, jmodel = mixture(PORT), mixture(JAX)
    dp = int(spec.split("x")[0])
    mesh = pcounts.set_mesh(spec)
    assert mesh.shape == {"dp": dp, "ep": 2}
    got = pcounts.sharded_alignment_eigen_counts(model, tree, rows, mesh)
    assert got.root_count.shape == (2, 20)
    assert_counts(got, pcounts.sharded_alignment_eigen_counts(model, tree, rows,
                                                              pcounts.set_mesh(dp)))
    assert_counts(got, pcounts.column_sharded_eigen_counts(model, tree, rows, 1))
    assert_counts(got, jax_pcounts.sharded_alignment_eigen_counts(
        jmodel, jtree, rows, jax_pcounts.set_mesh(spec)))


def test_component_count_must_divide(alignment):
    model, _, tree, _, rows = alignment  # one component
    with pytest.raises(ValueError, match=r"-mesh ep=2 requires the model's component count \(1\)"):
        pcounts.sharded_alignment_eigen_counts(model, tree, rows, pcounts.set_mesh("2x2"))


def test_mesh_larger_than_visible_raises():
    with pytest.raises(ValueError) as port_err:
        pcounts.set_mesh(9)
    with pytest.raises(ValueError) as jax_err:
        jax_pcounts.set_mesh(9)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value) == "-mesh 9 requests 9 devices but only 8 are visible"
    assert len(port_mesh.global_devices()) == len(jax.devices()) == 8


def test_meshes_match_jax():
    """set_mesh's dp and DxE meshes and the global dp mesh: the JAX
    package's shapes and device order over the 8 devices, and its error
    past them."""
    from historian_tpu.parallel import dist as jax_dist
    from historian_tpu_torch.parallel import dist

    for spec in (8, "4x2", "2x3", "1x4", 3):
        got, want = pcounts.set_mesh(spec), jax_pcounts.set_mesh(spec)
        assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
        assert [d.index for d in got.devices.flat] == [d.id for d in want.devices.flat]
    assert dist.global_mesh(3).shape == dict(jax_dist.global_mesh(3).shape) == {"dp": 3}
    assert dist.global_mesh().size == 8 and not dist.is_initialized()
    with pytest.raises(ValueError, match="9 devices requested, 8 visible globally"):
        dist.global_mesh(9)


def test_psum_counts_and_round_trip():
    alphabet = PORT.presets.named_model("lg").alphabet
    rng = np.random.default_rng(3)
    shards = []
    for _ in range(5):
        c = pcounts.EventCounts(alphabet, 2)
        c.root_count = rng.random((2, 20))
        c.sub_count = rng.random((2, 20, 20))
        c.indel.ins, c.indel.del_, c.indel.lp = rng.random(3)
        shards.append(c)
    back = pcounts.arrays_to_counts(pcounts.counts_to_arrays(shards[0]), alphabet)
    np.testing.assert_array_equal(back.root_count, shards[0].root_count)
    np.testing.assert_array_equal(back.sub_count, shards[0].sub_count)
    assert (back.indel.ins, back.indel.del_, back.indel.lp) == \
        (shards[0].indel.ins, shards[0].indel.del_, shards[0].indel.lp)
    host = pcounts.psum_counts(shards, alphabet)
    for n in (3, 8):  # fewer devices than shards folds them, more pads with zeros
        on_mesh = pcounts.psum_counts(shards, alphabet, pcounts.set_mesh(n))
        np.testing.assert_allclose(on_mesh.root_count, host.root_count, rtol=1e-14)
        np.testing.assert_allclose(on_mesh.sub_count, host.sub_count, rtol=1e-14)
        assert on_mesh.indel.lp == pytest.approx(host.indel.lp, rel=1e-14)


def _long12_merge(pkg):
    """A chain x against a sampled-profile y from long12's first three
    sequences cut to 90 aa, the second with two short stretches cut out (as
    torch_twins.leaves does), built by `pkg`'s host fill and its mt19937."""
    model = pkg.presets.named_model("lg")
    seqs = pkg.seqs.read_fasta(os.path.join(DATA, "long12.fa"))[:3]
    for s in seqs:
        s.seq = s.seq[:90]
    seqs[1].seq = seqs[1].seq[:30] + seqs[1].seq[36:67] + seqs[1].seq[70:]
    a, b, c = (pkg.profile.Profile.from_sequence(model.components, model.alphabet, s, i)
               for i, s in enumerate(seqs))
    y = host_forward(pkg, a, b, pair_hmm(pkg, model, 0.3, 0.2), 3).sample_profile(
        pkg.rng.MT19937(5489), 10, 0)
    assert y.as_chain() is None
    return c, y, pair_hmm(pkg, model, 0.25, 0.15)


def _merge_args():
    """K1's arguments (float64, CPU) at the long12 merge, as the bridge
    builds them."""
    dp = host_forward(PORT, *_long12_merge(PORT), 4)
    t = convert.fill_tensors(devicedp.fill_arrays(dp), "cpu", torch.float64)
    absorb, maskg, _ = devicedp.emission_and_lanes(t)
    return t["y_src"], t["y_lp"], t["y_flags"], absorb, maskg, t["xvec"], t["trans"]


@pytest.fixture(scope="module", params=["long12 merge", "padded"])
def sp_case(request):
    """(K1 arguments as tensors, the JAX kernel's arguments as numpy)."""
    if request.param == "padded":
        a = _inputs(37, 40, 3, 4, 7, np.float64)  # 37 lanes: no shard count divides them
        args = tuple(torch.as_tensor(x) for x in _k1_args(a))
    else:
        args = _merge_args()
    y_src, y_lp, y_flags, absorb, maskg, xvec, trans = (x.numpy() for x in args)
    jargs = (absorb, xvec[0], xvec[1], y_flags[:, 2], y_flags[:, 3], maskg == 0, trans,
             xvec[2] == 0, xvec[3] == 0, y_src, y_lp, y_flags[:, 0] > 0.5, y_flags[:, 1] > 0.5)
    return args, jargs


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_plain_sp_fill_matches_jax_and_k1(sp_case, n):
    args, jargs = sp_case
    got = sp_colforward.sp_col_forward_planes(*args, devices=["cpu"] * n)
    assert sp_colforward.LAUNCHES == 0
    k1 = colforward.col_forward_planes_plain(*args)
    if n == 1:
        assert torch.equal(got, k1)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    want = np.moveaxis(np.asarray(jax_sp_cells(*(jnp.asarray(a) for a in jargs), mesh=mesh)),
                       -1, 0)
    for ref in (k1.numpy(), want):
        live = ref > -1e25
        assert np.array_equal(got.numpy() > -1e25, live)
        np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=RTOL, atol=RTOL)


def test_shard_bounds_are_whole_strips():
    assert sp_colforward.shard_bounds(6085, 8)[:2] == [(0, 768), (768, 1536)]
    assert sp_colforward.shard_bounds(6085, 8)[-1] == (5376, 6085)
    assert sp_colforward.shard_bounds(200, 8) == [(0, 128), (128, 200)]
    assert sp_colforward.shard_bounds(300, 3) == [(0, 128), (128, 256), (256, 300)]


def test_sp_strip_layout_of_shards():
    """Kernel (g1)'s blocks (a fake capacity): each shard a chain of whole
    128-lane strips (its last shorter only in the last shard), in clusters
    of up to 8 strips; its table's shard boundaries are the exchange
    records given, its edges between clusters records of their own, and
    with `cluster_records` (a y DAG past the ring) every edge has one."""
    from historian_tpu_torch.ops import pairstrips as ps

    cuts = [(a, b - a) for a, b in sp_colforward.shard_bounds(6085, 3)]
    plan = sp_colforward.strip_layout(cuts, 132, lambda m, w, c: 1024)
    assert (plan.lanes, plan.warps, plan.cluster, plan.width) == (1, 4, 8, 128)
    assert plan.strips == 48 and plan.blocks % 8 == 0
    for j, (a, n) in enumerate(cuts):
        k = np.flatnonzero(plan.chain == j)
        assert plan.c0[k[0]] == a and plan.nc[k].sum() == n
        assert np.all(plan.nc[k[:-1]] == 128)
    ends = {}
    bufs = [sp_colforward._record_buffer("device", torch.device("cpu"), 20, torch.float64)
            for _ in range(2)]
    for d in range(3):
        if d > 0:
            ends[(d, "left")] = bufs[d - 1]
        if d < 2:
            ends[(d, "right")] = bufs[d]
    for deep in (False, True):
        table, records = ps.strip_table(plan, 20, torch.float64, torch.device("cpu"), ends,
                                        cluster_records=deep)
        live = plan.chain >= 0
        edges = int(np.count_nonzero(plan.right[live] != ps.NONE))
        assert len(records) == (edges if deep else int(np.count_nonzero(plan.right == ps.RECORD)))
        for d in (1, 2):
            first = np.flatnonzero(plan.chain == d)[0]
            assert table[first, 3] == ps.RECORD and table[first, 5] == bufs[d - 1][0].data_ptr()
            assert table[first - 1, 4] == ps.RECORD and table[first - 1, 7] == table[first, 5]
        inner = np.flatnonzero(live & (plan.left == ps.CLUSTER_EDGE))
        assert np.all((table[inner, 5] != 0) == deep)
    with pytest.raises(ValueError):
        sp_colforward.strip_layout(cuts, 132, lambda m, w, c: 40)


def test_sp_deep_edges():
    """An in-edge more than HALO columns back makes the y DAG deep."""
    chain = torch.clamp(torch.arange(50, dtype=torch.int32) - 1, min=0)[:, None]
    assert not sp_colforward.deep_edges(chain)
    far = torch.cat([chain, torch.clamp(chain - sp_colforward.HALO, min=0)], dim=1)
    assert sp_colforward.deep_edges(far)
    pad = torch.cat([chain, torch.full_like(chain, 50)], dim=1)  # no in-edge: src >= j
    assert not sp_colforward.deep_edges(pad)


@pytest.mark.parametrize("sp", ["auto", "0", "1"])
def test_sp_merge_wins_matches_jax(monkeypatch, sp):
    monkeypatch.setenv("HISTORIAN_SP", sp)
    assert spmerge.SP_MIN_SX == jax_spmerge.SP_MIN_SX == 8192

    def dp(nx, chain=True, empty=False):
        x = SimpleNamespace(as_chain=lambda: np.zeros(nx + 1) if chain else None)
        return SimpleNamespace(x=x, x_size=nx + 1, x_empty=empty, y_empty=False)

    for nx in (100, 8191, 8192, 9362, 9363, 16383, 16384, 16385):
        for n_dev in (2, 4, 8):
            for case in (dp(nx), dp(nx, chain=False), dp(nx, empty=True)):
                assert spmerge.sp_merge_wins(case, n_dev) == jax_spmerge.sp_merge_wins(
                    case, n_dev), (nx, n_dev)
    assert spmerge.sp_merge_wins(dp(16384), 2)
    assert spmerge.sp_merge_wins(dp(100), 8) == (sp == "1")


def test_sp_mesh_needs_two_devices(monkeypatch):
    assert spmerge.sp_mesh() is None and spmerge.dp_placement_devices() is None
    pcounts.set_mesh(1)
    assert spmerge.sp_mesh() is None and spmerge.dp_placement_devices() is None
    pcounts.set_mesh(4)
    assert spmerge.sp_mesh() == [torch.device("cpu")] * 4
    assert spmerge.dp_placement_devices() == [torch.device("cpu")] * 4
    monkeypatch.setenv("HISTORIAN_SP", "0")
    assert spmerge.sp_mesh() is None


def test_recon_fast_mesh_sp_matches_jax(tmp_path, monkeypatch):
    """small6 `recon -fast -mesh 4` with HISTORIAN_SP=1: every merge of the
    port (chain x against chain y under -fast) takes the SP route, and the
    rows and `#=GF LP` are the JAX package's, whose merges take its SP
    kernel on 4 of its 8 CPU devices."""
    fa = write_small6(tmp_path)
    for k, v in (("HISTORIAN_PLATFORM", "cpu"), ("HISTORIAN_DEVICE_DP", "0"),
                 ("HISTORIAN_DEVICE_DTYPE", "f64"), ("HISTORIAN_SP", "1")):
        monkeypatch.setenv(k, v)
    args = ["-fast", "-mesh", "4", fa]
    _, want = count_fills("historian_tpu", args)
    before = dict(forward.FILLS)
    _, got = count_fills("historian_tpu_torch", ["-platform", "cpu", *args])
    fills = {k: forward.FILLS[k] - before[k] for k in before}
    assert fills["sp"] >= 5 and sum(fills.values()) == fills["sp"], fills
    assert pcounts.active_mesh() is None  # the command's mesh ended with it

    def rows_lp(text):
        rows = [ln for ln in text.splitlines() if ln and not ln.startswith("#") and ln != "//"]
        lp = [float(ln.split()[2]) for ln in text.splitlines() if ln.startswith("#=GF LP")]
        return rows, lp

    (rows, lp), (ref_rows, ref_lp) = rows_lp(got), rows_lp(want)
    assert rows == ref_rows and len(lp) == 1 and abs(lp[0] - ref_lp[0]) < 1e-6
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # and the plain run's
        from historian_tpu_torch import cli

        assert cli.main(["recon", "-platform", "cpu", "-fast", fa]) == 0
    assert rows_lp(out.getvalue())[0] == rows
