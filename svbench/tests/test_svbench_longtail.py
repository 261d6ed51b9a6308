"""The long-tail cell's pieces: its entries in BENCHMARK.json, its
configuration and traffic files, the readers of its three per-layer
metrics on recorded traces, and the frozen wavefront bound against
chip_smoke.py's on the same inputs."""

import json
import os

import numpy as np
import pytest

import chip_smoke
from svbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "wavefront-longtail30x"
NEW = ("ins_pairs_s", "ins_distance_s", "wavefront_roofline")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        return json.load(handle)


def test_the_cell_its_configuration_and_its_metrics(bench):
    cell, config, traffic, end_to_end, per_layer = run.load_cell(CELL)
    assert cell == {"name": CELL, "config": "svim-wavefront-chr20",
                    "traffic": "longtail30x", "chips": 1,
                    "why": cell["why"]}
    assert config["arguments"] == ["--edit_backend", "wavefront"]
    assert set(config["reduced"]) == {"chromosomes", "genome_sequence",
                                      "base_qualities"}
    defaults = [c for c in bench["configs"] if c["name"] == "svim-defaults-chr20"][0]
    ours = [c for c in bench["configs"] if c["name"] == "svim-wavefront-chr20"][0]
    # SVIM's defaults again, but the long tail's own sources: a new deployment
    assert ours["source"] == config["source"] != defaults["source"]
    assert ours["source"].startswith(defaults["source"].split(";")[0] + ";")
    assert ours["reduced"] == defaults["reduced"]
    assert traffic["knobs"] == {
        "plan_seed": 1, "contig_length": 64444167, "partner_length": 46709983,
        "depth": 30, "loci": None, "ins_sizes": [50, 3000],
        "split_loci": None, "pileup": 1000, "long_ins": 8}
    assert {m["name"] for m in end_to_end} == {"reads_per_s", "peak_rss_gib",
                                                "setup_s"}
    names = [m["name"] for m in per_layer]
    assert set(NEW) <= set(names)
    assert "poa_cell_ns" not in names
    for metric in bench["per_layer"]:
        if metric["name"] in NEW:
            assert metric["workloads"] == [CELL]
    # the defaults cell reads none of the new metrics
    assert not set(NEW) & {m["name"] for m in run.load_cell(
        "defaults-classes30x")[4]}


def _job(**spans):
    return {"collect": 4.0, "cluster": 6.0, "combine": 7.0, "genotype": 0.2,
            "output": 0.1, "plots": 0.0,
            "spans": {name.replace("__", "."): value
                      for name, value in spans.items()},
            "counts": {}}


@pytest.mark.parametrize("name,span", [("ins_pairs_s", "cluster.ins_pairs"),
                                       ("ins_distance_s",
                                        "cluster.ins_distances")])
def test_the_span_readers(name, span):
    reader = run.metric_reader(name)
    assert reader.UNIT == "s/job"
    stages = [_job(**{span.replace(".", "__"): 3.0}),
              _job(**{span.replace(".", "__"): 5.0})]
    assert reader.read({"stages": stages}) == pytest.approx(4.0)
    # the parent's records, without the span
    assert reader.read({"stages": [_job(), _job()]}) is None
    assert reader.read({"stages": [stages[0], _job()]}) is None
    assert reader.read({"stages": []}) is None


def test_the_roofline_reader_on_recorded_calls():
    reader = run.metric_reader("wavefront_roofline")
    assert reader.UNIT == "%"
    assert reader.TIMED == {"svim_tpu_torch.ops.wavefront_kernel":
                            ("banded_distance",)}
    # (device ms, bound ms) of each launch
    calls = [(2.0, 0.1), (6.0, 0.7)]
    assert reader.read({"calls": {"wavefront_roofline": calls}}) == \
        pytest.approx(10.0)
    assert reader.read({"calls": {}}) is None
    assert reader.read({"calls": {"wavefront_roofline": []}}) is None


def test_keep_and_bound_read_a_launch():
    import torch

    reader = run.metric_reader("wavefront_roofline")
    a_lens = torch.tensor([300, 500], dtype=torch.int32)
    b_lens = torch.tensor([310, 480], dtype=torch.int32)
    result = torch.tensor([12, 40], dtype=torch.int32)
    kept = reader.keep("banded_distance",
                       {"a_codes": torch.zeros((2, 512), dtype=torch.uint8),
                        "a_lens": a_lens, "b_codes": None, "b_lens": b_lens,
                        "band": 64}, result)
    a_lens[0] = 1   # the launch's buffers may be reused after the call
    assert reader.bound_ms(kept) == chip_smoke.wavefront_bound_ms(
        np.array([300, 500]), np.array([310, 480]), np.array([12, 40]),
        512, 64)[0]


@pytest.mark.parametrize("seed", range(6))
def test_the_frozen_bound_equals_chip_smoke(seed):
    reader = run.metric_reader("wavefront_roofline")
    rng = np.random.default_rng(seed)
    length = int(rng.choice([512, 1024, 4096]))
    batch = 64
    a_lens = rng.integers(1, length + 1, batch)
    b_lens = np.clip(a_lens + rng.integers(-300, 300, batch), 1, length)
    band = int(rng.choice([64, 256, 1024, 4096]))
    values = rng.integers(0, 2 * band, batch)
    assert reader.wavefront_bound_ms(a_lens, b_lens, values, length, band) \
        == chip_smoke.wavefront_bound_ms(a_lens, b_lens, values, length, band)
    widths = rng.integers(-1, length + 2, batch)
    assert (reader.band_cells(a_lens, b_lens, widths)
            == chip_smoke._band_cells(a_lens, b_lens, widths)).all()
