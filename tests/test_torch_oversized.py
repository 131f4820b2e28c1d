"""A chain-x merge that does not fit the card fills on the host, as the
JAX package's does past its device budget (historian_tpu/ops/devicedp.py
col_forward_device returns None).  On the CPU the two checks of
`devicedp.merge_fits` are monkeypatched: the memory budget
(`_fits_budget`) and the strips (`_strips_fit`).  small4 `recon -fast
-noband -tree` then takes the "oversized" route for its 3 merges, logs
each at level 1 and prints what the default route prints; and
`colforward.strip_width` gives 0 past the card's strips and raises on a
CUDA error, with a fake capacity."""

import contextlib
import io
from types import SimpleNamespace

import pytest

from historian_tpu_torch import cli, device, recon
from historian_tpu_torch.engine import forward
from historian_tpu_torch.ops import colforward, devicedp
from tests.test_torch_recon import write_small4


def _recon(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["recon", "-platform", "cpu", *argv]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def small4(tmp_path_factory):
    fa, nh = write_small4(tmp_path_factory.mktemp("oversized"))
    device.select("cpu")
    args = ["-fast", "-noband", "-tree", nh, fa]
    return args, _recon(args)


@pytest.mark.parametrize("check", ["_fits_budget", "_strips_fit"])
def test_oversized_merges_fill_on_the_host(small4, check, monkeypatch):
    from historian_tpu_torch.utils.logging import logger

    args, ref = small4
    monkeypatch.setattr(devicedp, check, lambda *a: False)
    monkeypatch.setattr(logger, "verbosity", logger.verbosity)
    log = io.StringIO()
    monkeypatch.setattr(logger, "stream", log)
    merges, fills = dict(recon.MERGES), dict(forward.FILLS)
    got = _recon(["-v", *args])
    assert got == ref
    assert {k: recon.MERGES[k] - merges[k] for k in merges} == dict(
        device=0, fullband=0, host=0, oversized=3)
    assert forward.FILLS == dict(fills, oversized=fills["oversized"] + 3)
    assert log.getvalue().count("does not fit cpu: filled on the host") == 3


def test_strip_width(monkeypatch):
    dev = SimpleNamespace(index=0)
    caps = {}
    monkeypatch.setattr(colforward, "_capacity", lambda name, dtype, ns, ca, index: caps[ns])
    caps[128] = 4
    assert colforward.strip_width("colforward", 4 * 128, None, dev) == 128
    assert colforward.strip_width("colforward", 4 * 128 + 1, None, dev) == 0
    caps[128] = -2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        colforward.strip_width("colforward", 10, None, dev)
    caps[64] = 10  # K2 takes the narrow strips where the wide slice does not fit
    assert colforward.strip_width("colforward_fused", 640, None, dev, 300) == 64
    assert colforward.strip_width("colforward_fused", 641, None, dev, 300) == 0
    caps[64] = -1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        colforward.strip_width("colforward_fused", 10, None, dev, 300)
