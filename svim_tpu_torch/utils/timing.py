"""Per-stage timing, spans inside the stages, and torch.profiler traces.

Counterpart of svim_tpu/utils/timing.py.  Timing (--profile) is plain
untraced wall clock; the profiler trace under <working_dir>/traces is
opt-in via --profile_trace because its instrumentation of the host threads
inflates host-bound stage wall times: a traced run's logged timings are for
timeline inspection, not for wall-clock decisions.

While `run_pipeline` runs, its StageTimer is the process's current job
(`StageTimer.job`).  `span(name)` times a piece of work inside the running
stage as `<stage>.<name>`, on the job's thread or on a worker thread (the
streaming reader, the consensus pool); `count(name, n)` adds to a per-job
count.  A span opened with `part=True` is a part of the span around it on
its thread (a cluster's POA seed inside the cluster's consensus) and stays
in that span's self time too.  Whenever a torch profiler records, stages
and spans also enter
`torch.profiler.record_function`: `stage:<stage>` and `stage:<stage>.<name>`
on the job's thread, `worker:<stage>.<name>` on other threads, so a gap in
the device trace is put down to what the job's thread was doing there.
With the timer disabled and no profiler recording, `span` returns one
shared no-op context: no clock read, no range.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import resource
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the StageTimer of the job that runs (a module global, not a contextvar:
# ThreadPoolExecutor.map carries no context into its workers)
_JOB: Optional["StageTimer"] = None
# each thread's open spans, innermost last, for self time
_LOCAL = threading.local()


def _recording() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of a job that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One timed piece of work; `seconds` is its wall once it ends.  The
    job records its self time: the spans opened inside it on the same
    thread are taken off, so the job-thread spans of a stage never sum past
    the stage; a `part` is not taken off the span around it."""

    __slots__ = ("job", "key", "label", "part", "range", "start", "nested",
                 "seconds")

    def __init__(self, job, key, label, part=False):
        self.job = job
        self.key = key
        self.label = label
        self.part = part
        self.range = None
        self.nested = 0.0
        self.seconds = 0.0

    def __enter__(self):
        if self.label is not None:
            self.range = torch.profiler.record_function(self.label)
            self.range.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        stack = _LOCAL.stack
        stack.pop()
        if stack and not self.part:
            stack[-1].nested += self.seconds
        if self.job is not None and self.job.enabled:
            self.job._add_span(self.key, self.seconds - self.nested)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, mark: Optional[str] = None, measured: bool = False,
         part: bool = False):
    """A context that times `name` inside the current job's running stage
    (recorded as `<stage>.<name>`, summed over the job) and, while a torch
    profiler records, marks it as a range (`mark` replaces the range's
    name).  `measured=True` reads the clock even when nothing records, for
    a caller that logs the span's `seconds` itself; otherwise, with the
    job's timer disabled and no profiler recording, the shared no-op.
    `part=True`: the span's time stays in the self time of the span around
    it on this thread as well."""
    job = _JOB
    recording = _recording()
    if not (recording or measured or (job is not None and job.enabled)):
        return _OFF
    key = name if job is None or job.current is None else (
        job.current + "." + name)
    label = None
    if recording:
        owner = job.thread if job is not None else threading.main_thread().ident
        label = mark or ("stage:" if threading.get_ident() == owner
                         else "worker:") + key
    return _Span(job, key, label, part)


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(function):
        @functools.wraps(function)
        def call(*args, **kwargs):
            with span(name):
                return function(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Add `n` to the current job's count `name` (nothing when the job's
    timer is disabled)."""
    job = _JOB
    if job is not None and job.enabled:
        with job.lock:
            job.counts[name] = job.counts.get(name, 0) + n


def counting() -> bool:
    """Whether `count` records: for a caller whose count costs work."""
    job = _JOB
    return job is not None and job.enabled


class StageTimer:
    """Wall-clock accounting per pipeline stage, with the spans and counts
    of the job inside them."""

    def __init__(self, enabled: bool = True, trace_dir: Optional[str] = None):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.durations: Dict[str, float] = {}
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.current: Optional[str] = None
        self.thread = threading.get_ident()
        self.lock = threading.Lock()
        self.usage = None

    @contextlib.contextmanager
    def job(self):
        """This timer as the process's current job while the block runs,
        on the calling thread; the process's resource usage at its start,
        for the record's `host.cpu_ms`."""
        global _JOB
        previous = _JOB
        _JOB = self
        self.thread = threading.get_ident()
        if self.enabled:
            self.usage = resource.getrusage(resource.RUSAGE_SELF)
        try:
            yield self
        finally:
            _JOB = previous

    def _add_span(self, key: str, seconds: float):
        with self.lock:
            self.spans[key] = self.spans.get(key, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str, trace: bool = False):
        """Time a stage; `trace=True` additionally records a torch.profiler
        trace of it (host ops of every Python thread, and the card's
        kernels and copies when torch sees a card) into
        <trace_dir>/<name>.json, a Chrome trace.  The scan session's native
        threads are not Python threads and do not appear; a stage that
        never touches the card still writes its trace."""
        start = time.perf_counter()
        outer = self.current
        self.current = name
        try:
            if trace and self.enabled and self.trace_dir:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                os.makedirs(self.trace_dir, exist_ok=True)
                with profile(activities=activities,
                             experimental_config=_all_threads()) as profiler:
                    with self._mark(name):
                        yield
                profiler.export_chrome_trace(
                    os.path.join(self.trace_dir, name + ".json"))
            else:
                with self._mark(name):
                    yield
        finally:
            self.current = outer
        self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - start

    @staticmethod
    def _mark(name):
        if _recording():
            return torch.profiler.record_function("stage:" + name)
        return contextlib.nullcontext()

    def record(self):
        """The job's record as --profile logs it: the stage seconds, then
        `spans` ({"<stage>.<name>": seconds}) and `counts`, with the CPU
        milliseconds the process's threads spent since the job began
        (`host.cpu_ms`): the same work in more wall time and more CPU is
        a slower host, not more work."""
        counts = dict(self.counts)
        if self.usage is not None:
            now = resource.getrusage(resource.RUSAGE_SELF)
            counts["host.cpu_ms"] = round(1e3 * (
                now.ru_utime + now.ru_stime
                - self.usage.ru_utime - self.usage.ru_stime))
        return dict(self.durations, spans=dict(self.spans), counts=counts)

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


def _all_threads():
    """The profiler's setting that records the ranges of every Python
    thread (the reader thread, the consensus pool), not only the one that
    started it."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)
