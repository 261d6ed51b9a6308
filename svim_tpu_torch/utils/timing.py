"""Per-stage timing.

Counterpart of svim_tpu/utils/timing.py without its profiler-trace branch:
timing (--profile) is plain untraced wall clock; the port has no
--profile_trace yet.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict


class StageTimer:
    """Wall-clock accounting per pipeline stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a stage."""
        start = time.perf_counter()
        yield
        self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - start

    def report(self):
        if not self.enabled or not self.durations:
            return
        total = sum(self.durations.values())
        logging.info("Stage timings (total %.2fs):", total)
        for name, duration in self.durations.items():
            logging.info("  %-10s %8.2fs  (%.1f%%)", name, duration,
                         100.0 * duration / total if total else 0.0)
