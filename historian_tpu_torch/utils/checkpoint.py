"""Mid-run checkpoint and resume for the EM fit (`fit -checkpoint`).

Copy of historian_tpu/utils/checkpoint.py.  The reference's only restart
story is its final outputs (-savemodel, count JSON); a killed EM run
loses everything since launch.  `-checkpoint <file>` snapshots the
optimizer's state after each EM iteration -- atomically, via a temp-file
rename, so a crash mid-write never corrupts the previous snapshot -- and
the same command line resumes from the snapshot if it exists.  Snapshots
capture the mt19937 generator state, so a resumed run continues the
exact trajectory the uninterrupted run would have taken (pinned by
tests/test_torch_counts.py).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Iterable

import numpy as np

from historian_tpu_torch.utils.rng import MT19937

#: bumped when the snapshot layout changes; mismatched files are ignored
#: (a stale snapshot must never silently poison a new run)
FORMAT = 1


def save_atomic(path: str, state: dict) -> None:
    state = {"format": FORMAT, **state}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str, command: str, fingerprint: str | None = None) -> dict | None:
    """Snapshot dict, or None when absent / unreadable / wrong command
    or format (all treated as 'start fresh').  With `fingerprint`, a
    snapshot written for DIFFERENT inputs (a leftover file from another
    run sharing the -checkpoint path) is likewise ignored, with a
    warning -- silently resuming it would emit output for the old data."""
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    if state.get("format") != FORMAT or state.get("command") != command:
        return None
    if fingerprint is not None and state.get("fingerprint") != fingerprint:
        from historian_tpu_torch.utils.logging import log_this_at

        log_this_at(
            0,
            f"Checkpoint {path} was written for different inputs; starting fresh",
        )
        return None
    return state


def input_fingerprint(parts: Iterable[str]) -> str:
    """Order-sensitive digest of the run's inputs (dataset rows, trees,
    model identity), stored in snapshots so a resume can detect that the
    checkpoint file belongs to a different run."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def model_state(model) -> dict:
    """Exact (repr-float) RateModel snapshot.  The user-facing model
    JSON writer keeps the reference's %g formatting; a resume must not
    lose those bits or the continued EM trajectory drifts."""
    return {
        "alphabet": model.alphabet.symbols,
        "wildcard": model.alphabet.wildcard,
        "insrate": float(model.ins_rate),
        "delrate": float(model.del_rate),
        "insextprob": float(model.ins_ext_prob),
        "delextprob": float(model.del_ext_prob),
        "cpt_weight": np.asarray(model.cpt_weight, dtype=float).tolist(),
        "ins_prob": np.asarray(model.ins_prob, dtype=float).tolist(),
        "sub_rate": np.asarray(model.sub_rate, dtype=float).tolist(),
    }


def restore_model(state: dict):
    from historian_tpu_torch.core.alphabet import Alphabet
    from historian_tpu_torch.models.ratemodel import RateModel

    return RateModel(
        alphabet=Alphabet(state["alphabet"], state["wildcard"]),
        ins_rate=state["insrate"],
        del_rate=state["delrate"],
        ins_ext_prob=state["insextprob"],
        del_ext_prob=state["delextprob"],
        cpt_weight=np.asarray(state["cpt_weight"]),
        ins_prob=np.asarray(state["ins_prob"]),
        sub_rate=np.asarray(state["sub_rate"]),
    )


def exact_newick(tree) -> str:
    """Newick with full-precision (repr) branch lengths.

    Tree.to_string uses the reference's %g (6 sig figs) -- right for
    user-facing output, but a lossy round-trip would make a resumed MCMC
    trajectory drift from the uninterrupted one."""

    def desc(n: int) -> str:
        ch = tree.children(n)
        s = ""
        if ch:
            parts = []
            for c in ch:
                d = tree.branch_length(c)
                parts.append(desc(c) + (f":{d!r}" if d >= 0 else ""))
            s = "(" + ",".join(parts) + ")"
        return s + tree.node_name(n)

    return desc(tree.root()) + ";"


def rng_state(rng: MT19937) -> dict[str, Any]:
    return {"mt": list(rng.mt), "mti": rng.mti}


def restore_rng(rng: MT19937, state: dict[str, Any]) -> None:
    rng.mt = [int(v) for v in state["mt"]]
    rng.mti = int(state["mti"])
