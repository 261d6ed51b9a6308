"""BENCHMARK.json against the benchmark's contract: names, units, keys and
the files that the harness finds by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        return json.load(handle)


def test_the_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "svbench/run.py"]
    assert bench["paths"] == ["svbench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for config in bench["configs"]:
        assert all(NAME.match(key) for key in config["reduced"])
        assert set(config) == {"name", "source", "file", "reduced", "why"}


def test_every_cell_metric_and_file_is_found(bench):
    configs = {config["name"]: config for config in bench["configs"]}
    used = set()
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1
        assert len(cell["why"]) <= 200
        used.add(cell["config"])
        assert os.path.exists(os.path.join(ROOT, "svbench", "traffic",
                                           cell["traffic"] + ".json"))
    assert used == set(configs)
    for config in configs.values():
        with open(os.path.join(ROOT, config["file"])) as handle:
            content = json.load(handle)
        assert content["source"] == config["source"]
        assert all(key in content for key in config["reduced"])
    for metric in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "svbench", "metrics",
                                           metric["name"] + ".py"))
        assert metric["moves"] == "reads_per_s"
    assert {m["name"] for m in bench["end_to_end"]} == {
        "reads_per_s", "peak_rss_gib", "setup_s"}
    for metric in bench["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
