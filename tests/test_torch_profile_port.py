"""The device-busy count of scripts/profile_port.py, on the CPU.

The script's numbers come from a card, but what it counts is decided here:
only the device's own events (kernels, copies, memsets; no CPU-op row, whose
self device time is that of the kernels it launched, and no user
annotation), and busy time as the union of their intervals, so that a copy
beside a kernel counts once.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "profile_port.py")


@pytest.fixture(scope="module")
def profile_port():
    spec = importlib.util.spec_from_file_location("profile_port", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("intervals,seconds", [
    ([], 0.0),
    ([(0, 10)], 10e-6),
    ([(0, 10), (20, 25)], 15e-6),
    ([(0, 10), (5, 12)], 12e-6),            # a copy beside a kernel
    ([(5, 12), (0, 10), (1, 2), (12, 14)], 14e-6),
])
def test_busy_is_the_union_of_the_intervals(profile_port, intervals, seconds):
    assert profile_port._union_seconds(intervals) == pytest.approx(seconds)


def test_only_device_rows_count(profile_port):
    def row(device_type, annotation=False):
        return SimpleNamespace(device_type=device_type,
                               is_user_annotation=annotation)

    assert profile_port._on_device(row(DeviceType.CUDA))
    assert not profile_port._on_device(row(DeviceType.CPU))
    assert not profile_port._on_device(row(DeviceType.CUDA, True))
    # a torch without the annotation flag: a CUDA row is a device row
    assert profile_port._on_device(SimpleNamespace(
        device_type=DeviceType.CUDA))


def test_trace_intervals_are_kernels_copies_and_memsets(profile_port,
                                                        tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "agglomerate", "ts": 100.0,
         "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 103.0,
         "dur": 4.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 120.0,
         "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 90.0,
         "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 95.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "cluster",
         "ts": 99.0, "dur": 30.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    intervals = profile_port.device_intervals(str(path))
    assert sorted(intervals) == [(100.0, 105.0), (103.0, 107.0),
                                 (120.0, 121.0)]
    assert profile_port._union_seconds(intervals) == pytest.approx(8e-6)


def test_a_profiler_trace_without_a_card_has_no_device_interval(
        profile_port, tmp_path):
    """The trace torch.profiler writes parses, and a CPU-only run puts
    nothing on the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as trace:
        torch.ones(64).cumsum(0)
    path = str(tmp_path / "trace.json")
    trace.export_chrome_trace(path)
    assert profile_port.device_intervals(path) == []
    assert not any(profile_port._on_device(event)
                   for event in trace.key_averages())


def test_collect_pass_overlap_counts_the_host_waiting_beside_it(
        profile_port, tmp_path):
    """Of the COLLECT kernels' device time, the part during which the host
    sat in a runtime call that waits for the device; other kernels, launch
    calls and CPU ops do not count."""
    events = [
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 10.0,
         "name": "(anonymous namespace)::scan_rows(int const*, int)"},
        {"ph": "X", "cat": "kernel", "ts": 120.0, "dur": 4.0,
         "name": "(anonymous namespace)::write_events(int const*)"},
        {"ph": "X", "cat": "kernel", "ts": 200.0, "dur": 6.0,
         "name": "(anonymous namespace)::classify_groups(int const*)"},
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 50.0,
         "name": "agglomerate_fused"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 104.0, "dur": 18.0,
         "name": "cudaStreamSynchronize"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 108.0, "dur": 4.0,
         "name": "cudaMemcpy"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 200.0, "dur": 6.0,
         "name": "cudaLaunchKernel"},
        {"ph": "X", "cat": "cpu_op", "ts": 90.0, "dur": 200.0,
         "name": "aten::copy_"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    total, waited = profile_port.collect_pass_overlap(str(path))
    assert total == pytest.approx(20e-6)
    # scan_rows 104-110, write_events 120-122; classify ran beside no wait
    assert waited == pytest.approx(8e-6)


def test_collect_kernel_counts_name_both_scan_designs(profile_port,
                                                      tmp_path):
    """The one kernel of the scan's present design and the three of its
    first design count as scan kernels, both classify routes as classify
    kernels; launch calls and other kernels do not count."""
    events = [
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 3.0,
         "name": "(anonymous namespace)::scan_and_compact(Params)"},
        {"ph": "X", "cat": "kernel", "ts": 110.0, "dur": 3.0,
         "name": "(anonymous namespace)::scan_and_compact(Params)"},
        {"ph": "X", "cat": "kernel", "ts": 120.0, "dur": 2.0,
         "name": "(anonymous namespace)::classify_groups_warp(Columns)"},
        {"ph": "X", "cat": "kernel", "ts": 130.0, "dur": 2.0,
         "name": "(anonymous namespace)::classify_groups(Columns)"},
        {"ph": "X", "cat": "kernel", "ts": 140.0, "dur": 9.0,
         "name": "agglomerate_fused"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 99.0, "dur": 1.0,
         "name": "cudaLaunchCooperativeKernel"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profile_port.collect_kernel_counts(str(path)) == {
        "scan": 2, "classify": 2}
    total, waited = profile_port.collect_pass_overlap(str(path))
    assert total == pytest.approx(10e-6) and waited == 0
    old = [dict(event, name=name) for event, name in zip(events, (
        "scan_rows(int const*)", "scan_offsets(int const*)",
        "write_events(int const*)"))]
    path.write_text(json.dumps({"traceEvents": old}))
    assert profile_port.collect_kernel_counts(str(path)) == {
        "scan": 3, "classify": 0}
