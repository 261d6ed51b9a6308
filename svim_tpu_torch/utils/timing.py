"""Per-stage timing and optional torch.profiler traces.

Counterpart of svim_tpu/utils/timing.py.  Timing (--profile) is plain
untraced wall clock; the profiler trace under <working_dir>/traces is
opt-in via --profile_trace because its instrumentation of the host threads
inflates host-bound stage wall times: a traced run's logged timings are for
timeline inspection, not for wall-clock decisions.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Wall-clock accounting per pipeline stage."""

    def __init__(self, enabled: bool = True, trace_dir: Optional[str] = None):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, trace: bool = False):
        """Time a stage; `trace=True` additionally records a torch.profiler
        trace of it (host ops, and the card's kernels and copies when torch
        sees a card) into <trace_dir>/<name>.json, a Chrome trace.  The
        scan session's native threads are not Python threads and do not
        appear; a stage that never touches the card still writes its trace."""
        start = time.perf_counter()
        if trace and self.enabled and self.trace_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            with profile(activities=activities) as profiler:
                yield
            profiler.export_chrome_trace(
                os.path.join(self.trace_dir, name + ".json"))
        else:
            yield
        self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - start

    def report(self):
        if not self.enabled or not self.durations:
            return
        total = sum(self.durations.values())
        if self.trace_dir:
            logging.info("Stage timings below include the profiler's "
                         "overhead (host-bound stages inflate); rerun with "
                         "--profile alone for accurate wall clock.")
        logging.info("Stage timings (total %.2fs):", total)
        for name, duration in self.durations.items():
            logging.info("  %-10s %8.2fs  (%.1f%%)", name, duration,
                         100.0 * duration / total if total else 0.0)
