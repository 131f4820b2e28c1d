"""The sibling fill's drift from csrc/fill.cpp with length: the JAX
package's row scan (`historian_tpu.ops.siblingdp.sibling_forward`, XLA on
the CPU) and the port's plain version (its copy in PyTorch) against
fill.cpp's per-cell order, which kernel (d) keeps, on the seeded banded
grids of tests/test_torch_siblingdp.py (X x (X + 13), band 20):

    JAX_PLATFORMS=cpu python -m tests.sibling_drift 300 1200 2400

prints one JSON line a length (a 2400 grid takes ~30 s on one CPU)."""

import json
import sys

from tests.test_torch_siblingdp import drift


def main(argv: list) -> None:
    for x in argv or ["300", "1200"]:
        print(json.dumps(dict(x=int(x), band=20, **drift(int(x), 20, seed=int(x)))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
