"""The port's `recon` slice never imports jax or the JAX package: with
every import of `jax`, `jaxlib` and `historian_tpu` refused (by the
top-level name, so `historian_tpu_torch` still loads), the CLI still
reconstructs small4 on the CPU (also with the refiner, `mcmc` and `generate`)
with a supplied tree, also on a mesh in a process group (parallel/), and small6 through the guide stage and the distance
tree: neighbour joining on Jukes-Cantor distances, the fused route (K2's
plain version), and ML distances (`-fast` without its `-jc`).

The imports are refused by a meta-path finder rather than by setting
sys.modules["jax"] = None: scipy's array-API helpers look the name up in
sys.modules and fail on a None entry, whoever imports them."""

import os
import subprocess
import sys

import pytest

from tests.test_torch_recon import REPO, rows_and_lp, write_small4
from tests.test_torch_span import write_small6

BLOCKED = """
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "historian_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
from historian_tpu_torch.cli import main
rc = main(sys.argv[1:])
assert not any(m.split(".")[0] in ("jax", "jaxlib", "historian_tpu") for m in sys.modules)
sys.exit(rc)
"""


def test_recon_without_jax(tmp_path):
    fa, nh = write_small4(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED, "recon", "-platform", "cpu",
         "-fast", "-noband", "-tree", nh, fa],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rows, lp = rows_and_lp(out.stdout)
    assert len(rows) == 7 and lp < 0


@pytest.mark.parametrize("flags, env", [
    (["-fast", "-nj"], {}),
    (["-fast"], {"HISTORIAN_PALLAS_FUSED": "1"}),
    (["-rndspan", "-kmatchn", "3", "-band", "10", "-profmaxstates", "1", "-norefine"], {}),
], ids=["nj", "fused", "ml"])
def test_guide_recon_without_jax(tmp_path, flags, env):
    fa = write_small6(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED, "recon", "-platform", "cpu", *flags, fa],
        capture_output=True, text=True, timeout=300, cwd=REPO, env={**os.environ, **env},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rows, lp = rows_and_lp(out.stdout)
    assert len(rows) == 11 and lp < 0 and "#=GF NH" in out.stdout


def test_ancseq_count_fit_without_jax(tmp_path):
    """`recon -ancseq -ancprob` on small4, then `count` and `fit` on that
    reconstruction, with jax refused: the sum-product engine, the counts,
    the EM fit and the checkpoint module stand alone too."""
    fa, nh = write_small4(tmp_path)
    recon = tmp_path / "small4.sto"
    outs = {}
    for name, argv in (("recon", ["recon", "-ancseq", "-ancprob", "-fast", "-noband",
                                  "-tree", nh, fa]),
                       ("count", ["count", "-stockrecon", str(recon)]),
                       ("fit", ["fit", "-stockrecon", str(recon), "-maxiter", "1",
                                "-checkpoint", str(tmp_path / "ck.json")])):
        out = subprocess.run([sys.executable, "-c", BLOCKED, argv[0], "-platform", "cpu",
                              *argv[1:]], capture_output=True, text=True, timeout=300, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        outs[name] = out.stdout
        if name == "recon":
            recon.write_text(out.stdout)
    rows, lp = rows_and_lp(outs["recon"])
    assert len(rows) == 7 and lp < 0 and "#=GS node3 PP" in outs["recon"]
    assert '"alphabet": "arndcqeghilkmfpstwyv"' in outs["count"]
    assert '"insrate"' in outs["fit"] and (tmp_path / "ck.json").exists()


@pytest.mark.parametrize("command", ["refine", "generate"])
def test_refine_and_generate_without_jax(tmp_path, command):
    """`recon -refine -tree` on small4 (the refiner, the branch fill and
    its treealign helpers) and `generate` (the simulator), with jax
    refused."""
    fa, nh = write_small4(tmp_path)
    argv = (["recon", "-platform", "cpu", "-refine", "-tree", nh, fa] if command == "refine"
            else ["generate", "-platform", "cpu", "-seed", "3", "-rootlen", "50", nh])
    out = subprocess.run([sys.executable, "-c", BLOCKED, *argv], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rows, lp = rows_and_lp(out.stdout)
    assert len(rows) == 7 and lp < 0


def test_mcmc_without_jax(tmp_path):
    """`mcmc` on small4 (the sampler's five moves, the sibling fill and the
    branch fill in Forward mode, the checkpoint) with jax refused."""
    fa, nh = write_small4(tmp_path)
    out = subprocess.run([sys.executable, "-c", BLOCKED, "mcmc", "-platform", "cpu",
                          "-samples", "2", "-seed", "3", "-checkpoint", str(tmp_path / "ck.json"),
                          "-ckptevery", "5", "-fast", "-noband", "-tree", nh, fa],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rows, lp = rows_and_lp(out.stdout)
    assert len(rows) == 7 and lp < 0 and (tmp_path / "ck.json").exists()


def test_mesh_and_group_without_jax(tmp_path):
    """`recon -mesh 4` with HISTORIAN_SP=1 (the SP fill's plain version
    over 4 of 8 CPU devices), then `count -mesh 2x1` on its output, in a
    gloo group of one (HISTORIAN_DIST=1 with a coordinator on a free
    port), with jax refused: parallel/ and ops/sp_colforward.py stand
    alone."""
    import socket

    fa, nh = write_small4(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    env = {**os.environ, "HISTORIAN_SP": "1", "HISTORIAN_DIST": "1",
           "HISTORIAN_COORDINATOR": f"127.0.0.1:{s.getsockname()[1]}",
           "HISTORIAN_NUM_PROCESSES": "1", "HISTORIAN_PROCESS_ID": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    s.close()
    recon = tmp_path / "small4.sto"
    for argv in (["recon", "-platform", "cpu", "-mesh", "4", "-fast", "-noband", "-tree", nh, fa],
                 ["count", "-platform", "cpu", "-mesh", "2x1", "-stockrecon", str(recon)]):
        out = subprocess.run([sys.executable, "-c", BLOCKED, *argv], capture_output=True,
                             text=True, timeout=300, cwd=REPO, env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        if argv[0] == "recon":
            recon.write_text(out.stdout)
            rows, lp = rows_and_lp(out.stdout)
            assert len(rows) == 7 and lp < 0
    assert '"alphabet": "arndcqeghilkmfpstwyv"' in out.stdout


PAIR_MODULES = """
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "historian_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
import numpy as np
import torch
from historian_tpu_torch import device
from historian_tpu_torch.ops import pairforward, siblingdp, sp_pairforward, tropical
from historian_tpu_torch.parallel import mesh, pp_pairforward
from historian_tpu_torch.sampler.sibling import SiblingMatrix

device.select("cpu")
rng = np.random.default_rng(5)
absorb = torch.from_numpy(rng.normal(-5, 1, (2, 9, 11)))
rsx, ix = (torch.from_numpy(rng.normal(-3, 1, (2, 9))) for _ in range(2))
rsy, iy = (torch.from_numpy(rng.normal(-3, 1, (2, 11))) for _ in range(2))
trans = torch.from_numpy(rng.normal(-1, 0.5, 23))
mask = torch.ones((9, 11), dtype=torch.bool)
one = (absorb[0], rsx[0], rsy[0], ix[0], iy[0], mask, trans)
lp = float(pairforward.pair_forward(*one)[1])
cells, best = tropical.tropical_pair_forward(*one)
assert cells.shape == (9, 11, 5) and float(best) <= lp
devs = mesh.global_devices()
sp = sp_pairforward.sp_pair_forward(*one, mesh=mesh.Mesh(devs[:3], ("sp",)))
assert abs(float(sp) - lp) < 1e-9
batch = sp_pairforward.sp_pair_forward_batch(absorb, rsx, rsy, ix, iy, mask, trans,
                                             mesh=mesh.Mesh(np.array(devs[:4], dtype=object)
                                                            .reshape(2, 2), ("dp", "sp")))
pp = pp_pairforward.pp_pair_forward_lp(absorb, rsx, rsy, ix, iy, trans,
                                       mesh=mesh.Mesh(devs[:3], ("pp",)))
assert torch.allclose(batch, pp, rtol=0, atol=1e-9) and abs(float(pp[0]) - lp) < 1e-9
tmat = np.full((12, 12), -np.inf)
for a, b in siblingdp._KEYS:
    tmat[siblingdp._INDEX[a], siblingdp._INDEX[b]] = np.log(rng.uniform(0.05, 0.9))
c, l = siblingdp.sibling_forward_batch(
    torch.from_numpy(rng.uniform(-4, -1, (1, 6))), torch.from_numpy(rng.uniform(-4, -1, (1, 5))),
    torch.from_numpy(rng.uniform(-8, -2, (1, 7, 6))), torch.ones((1, 7, 6), dtype=torch.bool),
    torch.from_numpy(siblingdp.pack_table(tmat))[None], torch.tensor([[6, 5]]))
assert np.isfinite(float(l[0])) and SiblingMatrix.fill_batch([])
assert not any(m.split(".")[0] in ("jax", "jaxlib", "historian_tpu") for m in sys.modules)
"""


def test_pair_modules_without_jax():
    """The last four modules (ops/tropical.py, ops/sp_pairforward.py,
    parallel/pp_pairforward.py, siblingdp.sibling_forward_batch and
    SiblingMatrix.fill_batch), which no CLI command reaches, run their plain
    versions on seeded inputs and CPU meshes with jax refused."""
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run([sys.executable, "-c", PAIR_MODULES], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
