"""Timing checkouts in turn on one card: the `--roots` mode of bench.py
and walk_bench.py.

Each root is a directory holding a `historian_tpu_torch` package, e.g. a
`git archive` of another commit unpacked under build/.  The benches
import this module only in their `--roots` mode, in the process that
drives the runs, so the roots themselves need not have it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def compare_roots(script: str, child_argv: list, roots: list, rounds: int, what: str,
                  keep=lambda rec: rec) -> int:
    """Runs `script` with `child_argv` in a fresh process from each root:
    round by round, the roots in the order given, reversed every other
    round (P C C P for two roots and two rounds).  The process starts in
    the root, so it imports that root's package and this checkout's
    `script`.  Its last line of output is a JSON object: printed tagged
    with its root and round, and `keep(object)` kept for one final
    `{"compare": {root: [kept, ...]}}` line, in run order."""
    script = os.path.abspath(script)
    code = (f"import runpy, sys; sys.argv[0] = {script!r}; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    order = [os.path.abspath(r) for r in roots]
    table = {root: [] for root in order}
    for k in range(rounds):
        for root in order if k % 2 == 0 else order[::-1]:
            proc = subprocess.run([sys.executable, "-c", code, *child_argv], cwd=root,
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{what}: the run in {root} failed")
            rec = json.loads(proc.stdout.splitlines()[-1])
            print(json.dumps(dict(root=root, round=k, **rec)), flush=True)
            table[root].append(keep(rec))
    print(json.dumps({"compare": table}), flush=True)
    return 0
