"""Named substitution-model presets.

Counterpart of the reference's presets layer (reference src/presets.cpp:13-34).
Preset matrices are generated from the published PAML data files by
tools/convert_paml.py (Dayhoff; JTT; WAG; LG; Kosiol-Holmes-Goldman ECM
codon models; Jukes-Cantor) and stored as JSON under presets_data/.
"""

from __future__ import annotations

import os

from historian_tpu_torch.models.ratemodel import RateModel

DEFAULT_AMINO_MODEL = "lg"
DEFAULT_CODON_MODEL = "ECMunrest"

_DATA_DIR = os.path.join(os.path.dirname(__file__), "presets_data")

_ALIASES = {
    "jtt": "jones",
    "ecmrest": "ECMrest",
    "ecmunrest": "ECMunrest",
}

_KNOWN = ["jc", "jcrna", "dayhoff", "jones", "wag", "lg", "ECMrest", "ECMunrest"]


def preset_names() -> list[str]:
    return list(_KNOWN) + ["jtt"]


def named_model(name: str) -> RateModel:
    key = name.lower()
    key = _ALIASES.get(key, key)
    for known in _KNOWN:
        if known.lower() == key.lower():
            return RateModel.from_file(os.path.join(_DATA_DIR, known + ".json"))
    raise KeyError(f"unknown model: {name}")
