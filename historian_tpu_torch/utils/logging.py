"""Leveled logging with per-tag filters and progress/ETA reporting.

TPU-native equivalent of the reference's Logger/ProgressLogger
(reference src/logger.h:18-93): verbosity levels -v..-v9, per-tag
enablement, ANSI color by level, and percent+ETA progress lines for long
loops.  Kept host-side and stateless with respect to device code.
"""

from __future__ import annotations

import sys
import time

_ANSI_COLORS = [91, 93, 92, 96, 94, 95, 90, 37, 97]


class Logger:
    def __init__(self) -> None:
        self.verbosity = 0
        self.tags: set[str] = set()
        self.use_color = sys.stderr.isatty()
        self.stream = sys.stderr

    def enabled(self, level: int, tag: str | None = None) -> bool:
        return self.verbosity >= level or (tag is not None and tag in self.tags)

    def log(self, level: int, msg: str, tag: str | None = None) -> None:
        if not self.enabled(level, tag):
            return
        if self.use_color:
            color = _ANSI_COLORS[min(level, len(_ANSI_COLORS)) - 1]
            self.stream.write(f"\x1b[{color}m{msg}\x1b[0m\n")
        else:
            self.stream.write(msg + "\n")

    def parse_args(self, argv: list[str]) -> list[str]:
        """Consume -v/-vN/-log <tag>/-nocolor flags; return the rest."""
        rest: list[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-v" or a == "-verbose" or a == "--verbose":
                self.verbosity = max(self.verbosity, 1)
            elif len(a) > 2 and a.startswith("-v") and set(a[1:]) == {"v"}:
                # -vv, -vvv, ... (reference logger.cpp:59-61)
                self.verbosity = max(self.verbosity, len(a) - 1)
            elif len(a) > 2 and a.startswith("-v") and a[2:].isdigit():
                self.verbosity = max(self.verbosity, int(a[2:]))
            elif a in ("-log", "--log") and i + 1 < len(argv):
                self.tags.add(argv[i + 1])
                i += 1
            elif a == "-nocolor" or a == "--nocolour":
                self.use_color = False
            else:
                rest.append(a)
            i += 1
        return rest


logger = Logger()


def log_this_at(level: int, msg: str, tag: str | None = None) -> None:
    logger.log(level, msg, tag)


class ProgressLogger:
    """Prints percent-complete + ETA at geometrically spaced intervals."""

    def __init__(self, desc: str, level: int = 4, min_interval: float = 2.0):
        self.desc = desc
        self.level = level
        self.min_interval = min_interval
        self.start = time.monotonic()
        self.last_report = self.start

    def update(self, frac: float, detail: str = "") -> None:
        now = time.monotonic()
        if now - self.last_report < self.min_interval or frac <= 0:
            return
        self.last_report = now
        elapsed = now - self.start
        eta = elapsed * (1 - frac) / frac
        logger.log(
            self.level,
            f"{self.desc}: {100 * frac:.1f}% (ETA {eta:.0f}s) {detail}",
        )
