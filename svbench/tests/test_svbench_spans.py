"""The readers of the program's spans, on synthetic traces: each gives
its value averaged over the jobs, and nothing where a job's record lacks
its span (the record of a program without spans)."""

import pytest

from svbench import run


def _job(**spans):
    workers = spans.pop("workers", None)
    job = {"collect": 4.0, "cluster": 1.0, "combine": 13.0, "genotype": 0.1,
           "output": 0.1, "plots": 0.0,
           "spans": {name.replace("__", "."): value
                     for name, value in spans.items()},
           "counts": {}}
    if workers is not None:
        job["counts"]["consensus.workers"] = workers
    return job


FULL = [_job(collect__input_wait=1.0, collect__emit=2.0, collect__fetch=0.01,
             cluster__fetch=0.02, genotype__fetch=0.03, combine__consensus=10.0,
             combine__consensus_cluster=60.0, workers=8),
        _job(collect__input_wait=3.0, collect__emit=4.0, collect__fetch=0.03,
             combine__consensus=12.0, combine__consensus_cluster=48.0,
             workers=8)]
WANT = {"collect_input_wait_s": 2.0, "collect_emit_s": 3.0,
        "device_wait_s": 0.045, "consensus_s": 11.0,
        # (60 / 80 + 48 / 96) / 2
        "consensus_occupancy": 62.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_its_value(name):
    reader = run.metric_reader(name)
    assert reader.UNIT == ("%" if name == "consensus_occupancy" else "s/job")
    assert reader.read({"stages": FULL}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_nothing_where_the_span_is_missing(name):
    reader = run.metric_reader(name)
    # the parent's records: the six stages alone
    bare = [{key: value for key, value in job.items()
             if key not in ("spans", "counts")} for job in FULL]
    assert reader.read({"stages": bare}) is None
    assert reader.read({"stages": []}) is None
    # one job of two without the reader's spans
    assert reader.read({"stages": [FULL[0], _job(workers=8)]}) is None
