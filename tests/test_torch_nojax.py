"""The port's `recon` slice never imports jax or the JAX package: with
every import of `jax`, `jaxlib` and `historian_tpu` refused (by the
top-level name, so `historian_tpu_torch` still loads), the CLI still
reconstructs small4 on the CPU (also with the refiner, and `generate`)
with a supplied tree, and small6 through the guide stage and the distance
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
