"""The benchmark's arithmetic on hand cases: the rate, the union of device
intervals, the idle gaps, the agglomeration bound and its reader."""

import pytest

from svbench import run, yardstick


def test_the_rate_is_every_read_of_every_job_over_the_whole_window():
    # three jobs of 1,000 reads, the last finished at 40 s of a 30 s window
    assert run.reads_per_second(1000, 3, 40.0) == pytest.approx(75.0)


def test_the_union_counts_overlaps_once():
    assert yardstick.union_seconds([]) == 0.0
    assert yardstick.union_seconds([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert yardstick.union_seconds([(0, 100), (10, 20), (30, 40)]) == pytest.approx(100e-6)
    assert yardstick.union_seconds([(5, 6), (0, 1)]) == pytest.approx(2e-6)


def test_idle_gaps_are_named_by_the_innermost_stage():
    intervals = [(0, 10, "a"), (50, 60, "b"), (62, 70, "c")]
    marks = [(0, 100, "stage:collect"), (20, 45, "stage:inner")]
    gaps = yardstick.idle_gaps(intervals, marks)
    assert gaps[0] == ["stage:inner", pytest.approx(40e-6)]
    assert gaps[1] == ["stage:collect", pytest.approx(2e-6)]


def test_device_intervals_take_kernels_copies_and_memsets_only():
    events = [{"ph": "X", "cat": "kernel", "ts": 1, "dur": 2, "name": "k"},
              {"ph": "X", "cat": "gpu_memcpy", "ts": 5, "dur": 1, "name": "m"},
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 99, "name": "op"},
              {"ph": "i", "cat": "kernel", "ts": 0, "name": "mark"}]
    assert yardstick.device_intervals(events) == [(1, 3, "k"), (5, 6, "m")]


def test_the_roofline_reader_sums_bounds_over_device_time():
    reader = run.metric_reader("agglomerate_roofline")
    assert reader.read({"calls": {}}) is None
    calls = {"agglomerate_roofline": [(2.0, 0.5), (6.0, 0.5)]}
    assert reader.read({"calls": calls}) == pytest.approx(12.5)


def test_the_agglomeration_bound_on_hand_counts():
    # matrix entry, two partitions of 3 and 1 valid slots at P = 32
    ms, by = yardstick.agglomerate_bound_ms([3, 1], 32, fused=False)
    moved = 2 * (12 * 31 + 4) + 2 * (4 * 32 * 32 + 32)
    assert by == "bytes"
    assert ms == pytest.approx(moved / yardstick.HBM_BYTES_PER_SECOND * 1e3)
    # fused entry, one full partition of 128: the matrix's build bounds it
    ms, by = yardstick.agglomerate_bound_ms([128], 128, fused=True)
    loads_ms = 3 * (128 * 129 // 2 - 1) / yardstick.SHARED_LOADS_PER_SECOND * 1e3
    build_ms = (yardstick.AGGLOMERATE_BUILD_OPS_PER_CELL * 128 * 127 // 2
                / yardstick.LANE_INSTRUCTIONS_PER_SECOND * 1e3)
    assert by == "operations"
    assert ms == pytest.approx(max(loads_ms, build_ms))
