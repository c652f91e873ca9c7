"""Process-level runtime knobs (a copy of exllama_tpu/globals.py): CPU
affinity pinning through ``os.sched_setaffinity``, for the host thread that
tokenizes and launches the kernels on a busy machine."""

from __future__ import annotations

import os

affinity_mask: "set[int] | None" = None


def set_affinity_mask(mask: "set[int] | None" = None):
    global affinity_mask
    affinity_mask = set(mask) if mask else None
    if affinity_mask and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, affinity_mask)


def set_affinity_str(affinity_str: "str | None"):
    """Comma-separated core list, e.g. '0,1,2,3'."""
    if not affinity_str:
        return
    set_affinity_mask({int(x) for x in affinity_str.split(",")})
