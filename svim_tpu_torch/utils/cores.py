"""Affinity-aware CPU core counting for worker-pool sizing.

Every native thread pool (BGZF inflate, scan sessions, edit-distance and
POA batches) sizes itself from the host's core count.  `os.cpu_count()`
reports the MACHINE's cores, not the cores this process may run on — under
taskset/sched_setaffinity pinning (core-pinned multi-host ranks,
containerized deployments with cpuset limits) that oversubscribes the
pinned set and the ranks contend instead of scaling.  The reference has no
equivalent concern (single-threaded by design, README.rst:73).
"""

from __future__ import annotations

import os


def available_cores() -> int:
    """Cores this PROCESS may run on: the scheduling-affinity set where the
    platform exposes it (Linux), the machine core count otherwise."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1
