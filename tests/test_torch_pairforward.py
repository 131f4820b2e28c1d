"""The port's pair-Forward (historian_tpu_torch/ops/pairforward.py and the
bench path historian_tpu_torch/bench.py) against the JAX package's
ops/pairforward.py and ops/pallas_pairforward.py on the CPU.

Inputs are in the repo: presets lg and ECMrest, sequences of
tests/data/long*.fa cut short, codon sequences drawn from numpy seeds.

- `chain_pair_forward_arrays`: the same arrays.  In float64 within 2 ulps
  rather than bit for bit: XLA's CPU exp and log are not torch's (each
  within an ulp of the true value, they round differently on a share of
  arguments), and the emission takes exp of the root weights and log of
  every product.  The one-hot selections (ins_x,
  ins_y) and the transitions are bit-equal.  In float32 within 3e-7
  relative (f32 rounding).
- The plain `pair_forward` (cells and lp_end) against the JAX `lax.scan`
  kernel, float64, within 1e-9.
- `pair_forward_lp_plain` (K3's and K4's plain version) against
  `pallas_pair_forward_lp` and `pallas_pair_forward_lp_tiled` in
  interpret mode: 1e-9 relative in float64, 1e-6 relative in float32
  (tests/test_pallas.py's 1e-3 at an lp near 1e3).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from historian_tpu.ops import pairforward as jax_pf
from historian_tpu_torch import bench
from historian_tpu_torch.roots import compare_roots
from historian_tpu_torch.ops import pairforward as pf
from tests.torch_twins import DATA, JAX, PORT

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
TOL = {"f64": 1e-9, "f32": 1e-6}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _seqs(name="long12.fa"):
    return [s.seq for s in PORT.seqs.read_fasta(os.path.join(DATA, name))]


def _codon_pair(x_len, y_len, seed=11):
    syms = PORT.presets.named_model("ECMrest").alphabet.symbols
    rng = np.random.RandomState(seed)
    return tuple("".join(syms[i] for i in rng.randint(0, len(syms), n)) for n in (x_len, y_len))


def _both(preset, x, y, dt, t=(0.4, 0.6)):
    """(JAX arrays as numpy, port tensors) of one pair."""
    npdt, tdt = DTYPES[dt]
    ja, _ = jax_pf.chain_pair_forward_arrays(JAX.presets.named_model(preset), x, y, *t, dtype=npdt)
    ta, _ = pf.chain_pair_forward_arrays(PORT.presets.named_model(preset), x, y, *t, dtype=tdt)
    return [np.asarray(a) for a in ja], list(ta)


def _batch(preset, pairs, dt, t=(0.4, 0.6)):
    """B pairs of one shape: JAX inputs (numpy) and the port's tensors."""
    both = [_both(preset, x, y, dt, t) for x, y in pairs]
    jax_in = [np.stack([j[k] for j, _ in both]) for k in range(5)] + [both[0][0][6]]
    port_in = [torch.stack([p[k] for _, p in both]) for k in range(5)] + [both[0][1][6]]
    return jax_in, port_in


def _close(got, ref, dt):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(ref).all()
    np.testing.assert_array_less(np.abs(got - ref), TOL[dt] * np.abs(ref))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("preset", ["lg", "ECMrest"])
def test_arrays_match_jax(preset, dt):
    x, y = (_seqs("long6.fa")[0][:50], _seqs("long6.fa")[1][:64]) if preset == "lg" \
        else _codon_pair(20, 26)
    ja, ta = _both(preset, x, y, dt)
    rtol = 4.5e-16 if dt == "f64" else 3e-7
    names = ("absorb", "rsx", "rsy", "ix", "iy", "mask", "trans")
    for name, ref, got in zip(names, ja, ta):
        got = got.numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if name in ("ix", "iy", "mask", "trans"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        fin = np.isfinite(ref)
        assert np.array_equal(np.isfinite(got), fin) and fin.any(), name
        np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("case", ["lg", "lg-banded", "ECMrest"])
def test_scan_matches_jax(case):
    if case == "ECMrest":
        x, y = _codon_pair(24, 18, seed=5)
    else:
        x, y = _seqs("long8.fa")[2][:60], _seqs("long8.fa")[3][:75]
    ja, ta = _both(case.split("-")[0], x, y, "f64")
    if case.endswith("banded"):
        i, j = np.ogrid[: len(x) + 1, : len(y) + 1]
        mask = (np.abs(i * len(y) - j * len(x)) <= 8 * len(x)) | (i == 0) | (j == 0)
        ja[5], ta[5] = mask, torch.as_tensor(mask)
        assert not mask.all()
    cells, lp = jax_pf.pair_forward(*ja)
    got_cells, got_lp = pf.pair_forward(*ta)
    cells, got_cells = np.asarray(cells), got_cells.numpy()
    assert got_cells.shape == cells.shape == (len(x) + 1, len(y) + 1, 5)
    live = cells > -1e25
    assert np.array_equal(got_cells > -1e25, live) and live.any()
    np.testing.assert_allclose(got_cells[live], cells[live], rtol=1e-9, atol=1e-9)
    assert abs(float(got_lp) - float(lp)) < 1e-9 * abs(float(lp))


def _long12_pairs(B, x_len, y_len):
    """B distinct pairs of long12's sequences cut to one shape."""
    s = _seqs()
    return [(s[k][:x_len], s[k + 1][:y_len]) for k in range(B)]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("B", [5, 8])
def test_lp_plain_matches_pallas(interpret_pallas, B, dt):
    """B = 5 is not a multiple of the TPU kernel's group of 8 pairs."""
    from historian_tpu.ops.pallas_pairforward import pallas_pair_forward_lp

    jax_in, port_in = _batch("lg", _long12_pairs(B, 40, 56), dt)
    ref = np.asarray(pallas_pair_forward_lp(*jax_in))
    got = pf.pair_forward_lp_plain(*port_in)
    assert got.shape == (B,) and got.dtype == DTYPES[dt][1]
    _close(got, ref, dt)
    assert len(set(ref.tolist())) == B  # the pairs differ


def test_lp_plain_is_the_scan_lp():
    """The corner read (IMM, IMD, IIW) equals the scan's five-state end
    gather: IDM and IMI are gated off on the last row."""
    jax_in, port_in = _batch("lg", _long12_pairs(3, 33, 47), "f64")
    got = pf.pair_forward_lp_plain(*port_in)
    mask = torch.ones(34, 48, dtype=torch.bool)
    for b in range(3):
        _, lp = pf.pair_forward(*(t[b] for t in port_in[:5]), mask, port_in[5])
        _, jlp = jax_pf.pair_forward(*(a[b] for a in jax_in[:5]), mask.numpy(), jax_in[5])
        _close([got[b], lp], [float(jlp)] * 2, "f64")


@pytest.mark.parametrize("case", ["x_tile16", "one_partial_tile"])
def test_tiled_matches_pallas(interpret_pallas, case):
    """x_tile = 16 with X + 1 = 41: several tiles and padded rows; and X + 1
    below one tile (tests/test_pallas.py's 9 x 23 case), where the
    padded rows run after the lp capture."""
    from historian_tpu.ops.pallas_pairforward import pallas_pair_forward_lp_tiled

    x_len, y_len, x_tile = (40, 56, 16) if case == "x_tile16" else (9, 23, 64)
    jax_in, port_in = _batch("lg", _long12_pairs(3, x_len, y_len), "f32", t=(0.6, 0.4))
    ref = np.asarray(pallas_pair_forward_lp_tiled(*jax_in, x_tile=x_tile))
    before = pf.TILED_LAUNCHES
    got = pf.pair_forward_lp_tiled(*port_in, x_tile=x_tile)
    assert pf.TILED_LAUNCHES == before  # the CPU takes the plain version
    _close(got, ref, "f32")
    jax_in, port_in = _batch("lg", _long12_pairs(3, x_len, y_len), "f64", t=(0.6, 0.4))
    _close(pf.pair_forward_lp_tiled(*port_in, x_tile=x_tile),
            np.asarray(pallas_pair_forward_lp_tiled(*jax_in, x_tile=x_tile)), "f64")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_codon_pair(interpret_pallas, dt):
    """A codon pair (ECMrest, 61 tokens): K3's plain version against the
    Pallas kernel and the JAX scan."""
    from historian_tpu.ops.pallas_pairforward import pallas_pair_forward_lp

    jax_in, port_in = _batch("ECMrest", [_codon_pair(30, 22, seed=9)], dt)
    ref = np.asarray(pallas_pair_forward_lp(*jax_in))
    got = pf.pair_forward_lp(*port_in)
    _close(got, ref, dt)
    mask = np.ones((31, 23), bool)
    _, lp = jax_pf.pair_forward(*(a[0] for a in jax_in[:5]), mask, jax_in[5])
    _close(got, [float(lp)], dt)


def test_wrappers_take_plain_on_cpu_and_raise_on_bad_inputs():
    _, args = _batch("lg", _long12_pairs(2, 12, 15), "f32")
    k3, k4 = pf.LAUNCHES, pf.TILED_LAUNCHES
    ref = pf.pair_forward_lp_plain(*args)
    assert torch.equal(pf.pair_forward_lp(*args), ref)
    assert torch.equal(pf.pair_forward_lp_tiled(*args, x_tile=4), ref)
    assert (pf.LAUNCHES, pf.TILED_LAUNCHES) == (k3, k4)
    absorb, rsx, rsy, ix, iy, trans = args
    bad = {
        "dtype": (TypeError, (absorb.half(), rsx, rsy, ix, iy, trans)),
        "mixed dtype": (TypeError, (absorb, rsx.double(), rsy, ix, iy, trans)),
        "shape": (ValueError, (absorb, rsx[:, :-1], rsy, ix, iy, trans)),
        "trans": (ValueError, (absorb, rsx, rsy, ix, iy, trans[:22])),
        "contiguity": (ValueError, (absorb.transpose(1, 2).contiguous().transpose(1, 2),
                                    rsx, rsy, ix, iy, trans)),
        "device": (ValueError, (absorb, rsx.to("meta"), rsy, ix, iy, trans)),
    }
    for what, (err, a) in bad.items():
        for fn in (pf.pair_forward_lp, pf.pair_forward_lp_tiled):
            with pytest.raises(err):
                fn(*a)
    meta = [t.to("meta") for t in args]
    for fn in (pf.pair_forward_lp, pf.pair_forward_lp_tiled):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*meta)
    with pytest.raises(ValueError, match="x_tile"):
        pf.pair_forward_lp_tiled(*args, x_tile=0)
    wide = torch.zeros(1, 1, pf.MAX_LANES[torch.float32] + 1)
    with pytest.raises(ValueError, match="lanes"):
        pf.pair_forward_lp(wide, wide[:, :, 0], wide[0], wide[:, :, 0], wide[0], trans)


def test_k4_rows_fit_shared_memory():
    smem = 232448  # an H100 block's opt-in shared memory
    assert pf.k4_rows(385, 4, 512, smem) == (smem - pf.K4_STATIC_SMEM) // (2 * 385 * 4)
    assert pf.k4_rows(3001, 4, 512, smem) == 9
    assert pf.k4_rows(3001, 4, 4, smem) == 4
    with pytest.raises(ValueError, match="does not fit"):
        pf.k4_rows(30000, 8, 512, smem)


def _bench_device_arrays(preset, seed, n_pairs, length, batch):
    """The arrays bench.py's `bench_device` (lg) and `bench_codon`
    (ECMrest) build with the JAX package, tiled to the batch."""
    model = JAX.presets.named_model(preset)
    rng = np.random.RandomState(seed)
    syms = [model.alphabet.symbol(i) for i in range(model.alphabet.size)]

    def random_seq(n):
        return "".join(syms[i] for i in rng.randint(0, len(syms), size=n))

    arrs = [jax_pf.chain_pair_forward_arrays(model, random_seq(length), random_seq(length),
                                             0.5, 0.5, dtype=np.float32)[0]
            for _ in range(n_pairs)]
    tile = batch // n_pairs
    return [np.tile(np.stack([np.asarray(a[k]) for a in arrs]), (tile, 1, 1) if k == 0 else (tile, 1))
            for k in range(5)] + [np.asarray(arrs[0][6])]


@pytest.mark.parametrize("name,preset,seed,n_pairs,length,batch", [
    ("headline", "lg", 42, 8, 384, 128), ("codon", "ECMrest", 11, 4, 192, 32)])
def test_bench_builds_as_bench_py(name, preset, seed, n_pairs, length, batch):
    ref = _bench_device_arrays(preset, seed, n_pairs, length, batch)
    got = bench.build(name, "cpu", torch.float32)
    assert got[0].shape == (batch, length + 1, length + 1)
    for r, g in zip(ref, got):
        g = g.numpy()
        assert g.shape == r.shape
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], r[fin], rtol=3e-7, atol=0)


def test_bench_run_on_cpu():
    k3 = pf.LAUNCHES
    out = bench.run("codon", torch.device("cpu"), reps=1)
    assert out["device"] == "cpu" and out["kernel"] == "k3" and pf.LAUNCHES == k3
    assert out["state_cells_per_s"] > 0 and -1e4 < out["lp_mean"] < 0
    w = bench.WORKLOADS["long"]
    assert (w.batch, w.x_len, w.y_len, w.kernel) == (6, 3000, 3000, "k4")


# The order in which csrc/pairforward.cu's warp step associates the row
# scans, as torch: each thread composes its M lanes in order, a 32-thread
# Hillis-Steele scan combines the thread aggregates of a warp, and the
# carry passes from warp to warp in order, applied as lse(u_local, c + w)
# a lane.  Dead lanes past Y1 are (NEG, NEG), as the kernels make them.

def _lse2(a, b):
    return torch.logaddexp(a, b)


def _kernel_order_scan(a, b, m, warps):
    """u[l] = lse(a[l], u[l-1] + b[l]) along the last axis of [B, Y1], in
    the warp step's order, at m lanes a thread and `warps` warps."""
    B, Y1 = a.shape
    n = warps * 32 * m
    pad = a.new_full((B, n - Y1), NEG_F)
    v = torch.cat([a, pad], 1).reshape(B, warps, 32, m)
    w = torch.cat([b, pad], 1).reshape(B, warps, 32, m)
    v, w = list(v.unbind(-1)), list(w.unbind(-1))
    for k in range(1, m):  # each thread's lanes in order
        v[k] = _lse2(v[k], v[k - 1] + w[k])
        w[k] = torch.clamp_min(w[k - 1] + w[k], NEG_F)
    av, aw = v[-1], w[-1]  # [B, warps, 32]
    t = torch.arange(32)
    for d in (1, 2, 4, 8, 16):  # across the threads of a warp
        ov, ow = pf._shift(av, d, 0.0), pf._shift(aw, d, 0.0)
        av, aw = (torch.where(t >= d, _lse2(av, ov + aw), av),
                  torch.where(t >= d, torch.clamp_min(aw + ow, NEG_F), aw))
    ev, ew = pf._shift(av, 1, 0.0), pf._shift(aw, 1, 0.0)
    carry, out = a.new_full((B,), NEG_F), []
    for q in range(warps):  # warp to warp, in order
        cin = torch.where(t == 0, carry[:, None], _lse2(ev[:, q], carry[:, None] + ew[:, q]))
        u = torch.stack([_lse2(v[k][:, q], cin + w[k][:, q]) for k in range(m)], -1)
        out.append(u.reshape(B, 32 * m))
        carry = out[-1][:, -1]
    return torch.cat(out, 1)[:, :Y1]


NEG_F = pf.NEG


def _kernel_order_lp(absorb, rsx, rsy, ix, iy, trans, m, warps):
    """A copy of pair_forward_lp_plain's row loop in the kernels' order, at
    m lanes a thread and `warps` warps a block:
    in float64 IMD, IIW and the IMM source in linear space scaled by each
    lane's largest state (float32 keeps the plain version's pairwise
    log-sum-exps), the IDM source as one three-term log-sum-exp, and the
    row scans as `_kernel_order_scan`."""
    tr = trans.tolist()
    et = torch.exp(trans)
    B, X1, Y1 = absorb.shape
    cols = torch.arange(Y1)
    neg_row = absorb.new_full((B, Y1), NEG_F)
    rsx_c, ix_c = torch.clamp_min(rsx, NEG_F), torch.clamp_min(ix, NEG_F)

    def scans(so, io):
        idm = _kernel_order_scan(pf._shift(so, 1, NEG_F) + rsy, tr[12] + rsy, m, warps)
        imi = _kernel_order_scan(pf._shift(io, 1, NEG_F) + iy, tr[16] + iy, m, warps)
        return idm, imi

    def lse3(a, b, c):
        mx = torch.maximum(torch.maximum(a, b), c)
        return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx) + torch.exp(c - mx))

    imm = torch.where(cols == 0, 0.0, neg_row)
    imd = iiw = neg_row
    idm, imi = scans(imm + tr[2], imm + tr[3])
    lse = pf._lse
    for i in range(1, X1):
        if absorb.dtype == torch.float32:
            imd_n = lse(lse(imm + tr[1], imd + tr[7]), lse(idm + tr[11], imi + tr[15]))
            iiw_n = lse(lse(imm + tr[4], imi + tr[17]), iiw + tr[21])
            src = lse(lse(lse(imm + tr[0], imd + tr[6]), lse(idm + tr[10], imi + tr[14])),
                      iiw + tr[19])
        else:
            r = torch.stack([imm, imd, idm, imi, iiw]).amax(0)
            em, ed, ei, en, ew = (torch.exp(p - r) for p in (imm, imd, idm, imi, iiw))
            imd_n = r + torch.log(em * et[1] + ed * et[7] + ei * et[11] + en * et[15])
            iiw_n = r + torch.log(em * et[4] + en * et[17] + ew * et[21])
            src = r + torch.log(em * et[0] + ed * et[6] + ei * et[10] + en * et[14] + ew * et[19])
        imd_n = imd_n + rsx_c[:, i, None]
        iiw_n = iiw_n + ix_c[:, i, None]
        imd = torch.where(cols < Y1 - 1, imd_n, NEG_F)
        iiw = torch.where(cols < Y1 - 1, iiw_n, NEG_F)
        imm = pf._shift(src, 1, NEG_F) + absorb[:, i]
        idm, imi = scans(lse3(imm + tr[2], imd + tr[8], iiw + tr[20]), imm + tr[3])
    return pf._lse(pf._lse(imm[:, -1] + tr[5], imd[:, -1] + tr[9]), iiw[:, -1] + tr[22])


def _pf_numpy_args(B, X1, Y1, dt, seed=8):
    """Random emissions with the boundary row and column at -inf, as the
    float32 arrays of chain_pair_forward_arrays have them."""
    rng = np.random.default_rng(seed)
    absorb = rng.normal(-5, 1, (B, X1, Y1))
    absorb[:, 0, :] = absorb[:, :, 0] = -np.inf
    vx = rng.normal(-3, 1, (2, B, X1))
    vy = rng.normal(-3, 1, (2, B, Y1))
    vx[:, :, 0] = vy[:, :, 0] = -np.inf
    tr = rng.normal(-1, 0.5, 23)
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=DTYPES[dt][1])
            for a in (absorb, vx[0], vy[0], vx[1], vy[1], tr)]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("y1,m,warps", [
    (385, 1, 13), (1500, 2, 24), (1500, 4, 12), (3001, 3, 32), (3001, 4, 24), (3001, 6, 16)])
def test_kernel_scan_order_one_row(y1, m, warps, dt):
    """The warp step's scan order against affine_scan on one row, at m
    lanes a thread and `warps` warps (the launcher's shapes among them:
    385 lanes take 13 warps, not 16)."""
    _, _, rsy, _, iy, tr = _pf_numpy_args(2, 2, y1, dt, seed=y1)
    a = torch.as_tensor(np.random.default_rng(1).normal(-8, 3, (2, y1)), dtype=rsy.dtype)
    a[:, 0] = NEG_F
    b = tr[12] + rsy
    got = _kernel_order_scan(a, b, m, warps)
    ref = pf.affine_scan(a, b, NEG_F)
    assert torch.isfinite(ref).all()
    assert bool(((got - ref).abs() <= TOL[dt] * ref.abs()).all())


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("y1,m,warps", [
    (385, 1, 13), (1500, 2, 24), (1500, 4, 12), (3001, 3, 32), (3001, 4, 24), (3001, 6, 16)])
def test_kernel_scan_order_lp(y1, m, warps, dt):
    """lp_end with the rows scanned in the kernels' order, at m lanes a
    thread and `warps` warps (the launcher's shapes among them: 4 lanes a
    thread at 3001 lanes in float32, 6 in float64), against
    pair_forward_lp_plain: the new association rounds within the
    kernels' tolerance (1e-6 of |lp| in float32, 1e-9 in float64)."""
    args = _pf_numpy_args(2, 24, y1, dt)
    ref = pf.pair_forward_lp_plain(*args)
    got = _kernel_order_lp(*args, m, warps)
    _close(got.numpy(), ref.numpy(), dt)


def test_bench_f64_and_cases():
    """The bench path in float64 (the plain version here) agrees with the
    float32 run, and `--roots` times the headline, codon and long
    workloads in float32 and the headline in float64."""
    f64 = bench.run("codon", torch.device("cpu"), reps=1, dtype=torch.float64)
    f32 = bench.run("codon", torch.device("cpu"), reps=1)
    assert (f64["dtype"], f32["dtype"]) == ("float64", "float32")
    assert abs(f64["lp_mean"] - f32["lp_mean"]) < 1e-4 * abs(f64["lp_mean"])
    assert [(n, str(d)) for n, d in bench.CASES] == [
        ("headline", "torch.float32"), ("codon", "torch.float32"), ("long", "torch.float32"),
        ("wide", "torch.float32"), ("headline", "torch.float64"), ("long", "torch.float64")]


def test_compare_roots_order(tmp_path, capsys):
    """`--roots` runs the script from each root in turn, P C C P, with the
    child's arguments, and keeps what `keep` picks in the compare line;
    a failed run raises."""
    script = tmp_path / "child.py"
    script.write_text("import json, os, sys\n"
                      "print('noise')\n"
                      "print(json.dumps({'cwd': os.path.basename(os.getcwd()), "
                      "'argv': sys.argv[1:]}))\n")
    roots = [tmp_path / "P", tmp_path / "C"]
    for r in roots:
        r.mkdir()
    assert compare_roots(str(script), ["--cases"], roots, 2, "t",
                         keep=lambda rec: rec["cwd"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["cwd"], r["round"], r["argv"]) for r in lines[:-1]] == [
        ("P", 0, ["--cases"]), ("C", 0, ["--cases"]), ("C", 1, ["--cases"]),
        ("P", 1, ["--cases"])]
    assert lines[-1] == {"compare": {str(roots[0]): ["P", "P"], str(roots[1]): ["C", "C"]}}
    script.write_text("raise SystemExit(3)\n")
    with pytest.raises(RuntimeError, match="the run in"):
        compare_roots(str(script), [], roots, 1, "t")
