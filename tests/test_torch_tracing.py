"""The port's spans and per-job counts (svim_tpu_torch/utils/timing.py):
spans sum under `<stage>.<name>` as self time, worker threads' spans under
their own names, nothing is recorded or read when tracing is off, and a
torch.profiler trace of the golden job names the job thread's work
`stage:<stage>.<name>` inside its stage and the workers' `worker:` and
`consensus:cluster`; the logged `Stage seconds` record keeps its six stage
keys beside `spans` and `counts`, and --profile changes no byte of the
VCF."""

import json
import logging
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from svim_tpu_torch import cli, workloads
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.utils import timing

CPU = torch.device("cpu")
torch.set_num_threads(1)
STAGES = ("collect", "cluster", "combine", "genotype", "output", "plots")
# spans made on threads other than the job's on the golden job's path
WORKER_SPANS = ("collect.read", "combine.consensus_cluster", "combine.poa",
                "combine.polish", "combine.realign")


class _StageSeconds(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = []

    def emit(self, record):
        if record.msg == "Stage seconds: %s":
            self.seen.append(json.loads(record.args[0]))


def _job(directory, name, bam, genome, *extra):
    """One whole job of the CLI's pipeline: (exit code, VCF lines without
    the ##fileDate line, the logged Stage seconds records)."""
    root = logging.getLogger()
    handler = _StageSeconds()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        workdir = directory / name
        options = parse_arguments(arguments=[
            "alignment", str(workdir), bam, genome, "--stream_input", *extra])
        code = cli.run_pipeline(options, CPU)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    with open(workdir / "variants.vcf") as vcf:
        lines = [line for line in vcf if not line.startswith("##fileDate")]
    return code, lines, handler.seen


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden workload streamed three times: with --profile, without,
    and without under a torch.profiler that records every thread."""
    directory = tmp_path_factory.mktemp("tracing")
    bam, genome = workloads.golden_workload(str(directory))
    profiled = _job(directory, "profiled", bam, genome, "--profile")
    plain = _job(directory, "plain", bam, genome)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=timing._all_threads()) as profiler:
        traced = _job(directory, "traced", bam, genome)
    path = directory / "trace.json"
    profiler.export_chrome_trace(str(path))
    events = [event for event in json.loads(path.read_text())["traceEvents"]
              if event.get("ph") == "X"
              and event.get("cat") == "user_annotation"]
    return {"profiled": profiled, "plain": plain, "traced": traced,
            "events": events}


def test_spans_sum_under_the_stage_as_self_time():
    timer = timing.StageTimer()
    with timer.job():
        with timer.stage("collect"):
            for _ in range(3):
                with timing.span("emit"):
                    with timing.span("fetch") as fetch:
                        pass
            timing.count("fetches", 2)
            timing.count("fetches")
        with timer.stage("combine"):
            with timing.span("emit"):
                pass
    assert set(timer.spans) == {"collect.emit", "collect.fetch",
                                "combine.emit"}
    assert fetch.seconds > 0
    assert timer.counts == {"fetches": 3}
    assert timer.spans["collect.emit"] + timer.spans["collect.fetch"] \
        <= timer.durations["collect"]
    assert timer.current is None
    record = timer.record()
    assert record["spans"] == timer.spans
    assert [key for key in record if key not in ("spans", "counts")] \
        == ["collect", "combine"]


def test_worker_spans_sum_under_their_own_names_without_a_lost_update():
    """More threads than cores, a short switch interval: every worker
    span and count lands (a lost update under the job's lock would not)."""
    timer = timing.StageTimer()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.job(), timer.stage("combine"):
            def work(_):
                for _ in range(200):
                    with timing.span("consensus_cluster"):
                        timing.count("consensus.clusters")
                return threading.get_ident()

            with timing.span("consensus"), ThreadPoolExecutor(16) as pool:
                threads = set(pool.map(work, range(64), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert threading.get_ident() not in threads
    assert timer.counts == {"consensus.clusters": 64 * 200}
    assert set(timer.spans) == {"combine.consensus",
                                "combine.consensus_cluster"}


def test_a_part_stays_in_the_self_time_of_the_span_around_it():
    timer = timing.StageTimer()
    with timer.job(), timer.stage("combine"):
        with timing.span("consensus_cluster") as whole:
            with timing.span("poa", part=True) as part:
                with timing.span("inner"):
                    pass
            with timing.span("other") as other:
                pass
    spans = timer.spans
    assert set(spans) == {"combine.consensus_cluster", "combine.poa",
                          "combine.inner", "combine.other"}
    # the part is not taken off the cluster's span; a plain span is, and
    # a span inside the part is taken off the part
    assert spans["combine.consensus_cluster"] == pytest.approx(
        whole.seconds - other.seconds)
    assert spans["combine.poa"] == pytest.approx(
        part.seconds - spans["combine.inner"])
    assert spans["combine.consensus_cluster"] >= part.seconds


def test_off_returns_the_shared_no_op_and_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    timer = timing.StageTimer(enabled=False)
    assert timing.span("emit") is timing._OFF   # no job at all
    with timer.job(), timer.stage("collect"):
        with timing.span("emit") as off:
            timing.count("fetches")
        assert off is timing._OFF
        assert not timing.counting()
        # a caller that logs a span's seconds itself still reads its clock
        with timing.span("scan", measured=True) as scan:
            pass
    assert scan.seconds > 0
    assert timer.spans == {} and timer.counts == {}
    assert set(timer.durations) == {"collect"}


def test_the_record_keeps_six_stage_keys_and_adds_spans_and_counts(golden):
    code, _lines, seen = golden["profiled"]
    assert code == 0 and len(seen) == 1
    record = seen[0]
    assert list(record) == list(STAGES) + ["spans", "counts"]
    assert all(isinstance(record[stage], float) for stage in STAGES)
    spans, counts = record["spans"], record["counts"]
    for name in ("collect.input_wait", "collect.read", "collect.upload",
                 "collect.split_reads", "collect.fetch", "collect.emit",
                 "collect.finalize", "cluster.partition", "cluster.dispatch",
                 "cluster.fetch", "cluster.finish", "cluster.consolidate",
                 "combine.prepare", "combine.consensus",
                 "combine.consensus_cluster", "combine.candidate_round",
                 "genotype.fetch"):
        assert spans[name] > 0, name
    assert counts["collect.batches"] >= 1
    assert counts["fetches"] >= 3 and counts["fetch_bytes"] > 0
    assert counts["consensus.clusters"] >= counts["consensus.workers"] >= 1
    assert "collect.reruns" not in counts


def test_each_stage_job_thread_spans_sum_within_the_stage(golden):
    record = golden["profiled"][2][0]
    for stage in STAGES:
        job_thread = sum(seconds for name, seconds in record["spans"].items()
                         if name.split(".")[0] == stage
                         and name not in WORKER_SPANS)
        assert job_thread <= record[stage], stage


def test_the_vcf_is_byte_equal_with_and_without_profile(golden):
    assert golden["profiled"][0] == golden["plain"][0] \
        == golden["traced"][0] == 0
    assert golden["profiled"][1] == golden["plain"][1] == golden["traced"][1]
    # without --profile nothing is logged
    assert golden["plain"][2] == [] and golden["traced"][2] == []


def test_the_trace_names_spans_inside_their_stage(golden):
    events = golden["events"]
    stages = {event["name"]: event for event in events
              if event["name"] in ("stage:" + s for s in STAGES)}
    assert set(stages) >= {"stage:collect", "stage:combine"}
    job = stages["stage:collect"]["tid"]
    for name in ("stage:collect.input_wait", "stage:collect.emit",
                 "stage:combine.consensus"):
        stage = stages[name.split(".")[0]]
        inside = [event for event in events if event["name"] == name]
        assert inside, name
        for event in inside:
            assert event["tid"] == job
            assert stage["ts"] <= event["ts"]
            assert event["ts"] + event["dur"] <= stage["ts"] + stage["dur"]


def test_worker_ranges_are_not_stage_named(golden):
    events = golden["events"]
    job = next(event["tid"] for event in events
               if event["name"] == "stage:collect")
    assert {event["tid"] for event in events
            if event["name"].startswith("stage:")} == {job}
    workers = [event for event in events if event["tid"] != job]
    names = {event["name"] for event in workers}
    assert {"worker:collect.read", "consensus:cluster"} <= names
    assert not any(name.startswith("stage:") for name in names)
