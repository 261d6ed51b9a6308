"""The port's workload generators write the same inputs as the ones the JAX
package is tested and benchmarked on: the golden SimConfig of
tests/test_golden_vcf.py, and bench.make_workload's BAM and genome."""

import importlib.util
import os

from svim_tpu_torch import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name, path, **environment):
    previous = {key: os.environ.get(key) for key in environment}
    os.environ.update(environment)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for key, value in previous.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    return module


def test_golden_sim_is_the_golden_fixtures():
    golden = _module("_golden_vcf", os.path.join(REPO, "tests",
                                                 "test_golden_vcf.py"))
    assert workloads.GOLDEN_SIM == golden._SIM


def test_bench_workload_equals_bench_make_workload(tmp_path):
    bench = _module("_bench_256", os.path.join(REPO, "bench.py"),
                    SVIM_BENCH_READS="256")
    want_dir = tmp_path / "bench"
    got_dir = tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    want_bam, want_genome, _header, _records = bench.make_workload(
        str(want_dir))
    got_bam, got_genome = workloads.bench_workload(str(got_dir), reads=256)
    with open(got_bam, "rb") as got, open(want_bam, "rb") as want:
        assert got.read() == want.read()
    with open(got_genome, "rb") as got, open(want_genome, "rb") as want:
        assert got.read() == want.read()
