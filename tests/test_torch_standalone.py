"""The port stands alone: no module of historian_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package (historian_tpu),
read from each file's syntax tree; and the port's own copy of the preset
models gives the same arrays as the JAX package's, directly and through
`convert.rate_model`."""

import ast
import glob
import os

import numpy as np
import pytest

from historian_tpu_torch import convert
from tests.torch_twins import JAX, PORT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "historian_tpu")
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "historian_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
PRESETS = sorted(
    os.path.basename(p)[:-5]
    for p in glob.glob(os.path.join(REPO, "historian_tpu_torch", "models", "presets_data", "*.json"))
)


def imported_roots(path: str) -> set:
    """Top-level names of every absolute import in a source file."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_found():
    assert "historian_tpu_torch/engine/forward.py" in SOURCES and len(SOURCES) > 30
    assert "historian_tpu_torch/ops/dagforward.py" in SOURCES
    assert {f"historian_tpu_torch/parallel/{m}.py" for m in ("dist", "mesh", "pcounts", "spmerge")} \
        <= set(SOURCES)
    assert "historian_tpu_torch/ops/sp_colforward.py" in SOURCES
    assert {"historian_tpu_torch/ops/tropical.py", "historian_tpu_torch/ops/sp_pairforward.py",
            "historian_tpu_torch/parallel/pp_pairforward.py"} <= set(SOURCES)
    assert "lg" in PRESETS and "ECMrest" in PRESETS


@pytest.mark.parametrize("path", SOURCES)
def test_imports_nothing_of_jax(path):
    bad = imported_roots(path) & set(REFUSED)
    assert not bad, f"{path} imports {sorted(bad)}"


def _arrays(model) -> dict:
    return dict(sub_rate=model.sub_rate, ins_prob=model.ins_prob, cpt_weight=model.cpt_weight,
                indel=np.array([model.ins_rate, model.del_rate, model.ins_ext_prob,
                                model.del_ext_prob]))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_models_identical(preset):
    ref = JAX.presets.named_model(preset)
    for got in (PORT.presets.named_model(preset), convert.rate_model(ref)):
        assert type(got) is PORT.ratemodel.RateModel
        assert got.alphabet.symbols == ref.alphabet.symbols
        assert got.alphabet.wildcard == ref.alphabet.wildcard
        for name, a in _arrays(ref).items():
            b = _arrays(got)[name]
            assert b.dtype == a.dtype and b.shape == a.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
