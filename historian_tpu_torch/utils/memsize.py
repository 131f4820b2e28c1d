"""Physical memory detection.

Counterpart of the reference's memsize component
(reference src/memsize.cpp:30-99, per-OS sysctl/sysconf probing):
used to size the profile-DP cell budget (-profmaxmem) and the k-mer
diagonal-envelope auto-fit.  HISTORIAN_MEMSIZE (bytes) overrides the
probe -- handy for reproducing runs across machines.
"""

from __future__ import annotations

import os

_FALLBACK = 1 << 30  # 1 GiB when probing fails


def physical_memory_bytes() -> int:
    override = os.environ.get("HISTORIAN_MEMSIZE")
    if override:
        return int(override)
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        pages = os.sysconf("SC_PHYS_PAGES")
        if page > 0 and pages > 0:
            return page * pages
    except (ValueError, OSError, AttributeError):
        pass
    return _FALLBACK
