"""The port's `recon` slice never imports jax: with every import of
`jax` and `jaxlib` refused, the CLI still reconstructs small4 on the CPU.

The imports are refused by a meta-path finder rather than by setting
sys.modules["jax"] = None: scipy's array-API helpers look the name up in
sys.modules and fail on a None entry, whoever imports them."""

import subprocess
import sys

from tests.test_torch_recon import REPO, rows_and_lp, write_small4

BLOCKED = """
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
from historian_tpu_torch.cli import main
rc = main(sys.argv[1:])
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
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
