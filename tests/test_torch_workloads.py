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


def _fields(record):
    return (record.query_name, record.flag, record.reference_id,
            record.reference_start, record.mapping_quality,
            record.cigartuples, record.query_sequence,
            record.tags.get("SA", (None,))[0])


def test_rewrites_keep_the_records(tmp_path):
    """The level-0 copy inflates to the same stream; SAM text parses back to
    the same records; the queryname BAM holds every record, grouped by name,
    plus one supplementary record per SA-tag entry."""
    import gzip

    from svim_tpu.io.sam import AlignmentFile

    bam, _genome = workloads.golden_workload(str(tmp_path))
    stored = workloads.reblock_stored(bam, str(tmp_path / "stored.bam"))
    with open(bam, "rb") as original, open(stored, "rb") as copy:
        inflated = gzip.decompress(original.read())
        assert gzip.decompress(copy.read()) == inflated
    assert os.path.getsize(stored) > len(inflated)

    records = list(AlignmentFile(bam).fetch(until_eof=True))
    sam = AlignmentFile(workloads.sam_text(bam, str(tmp_path / "reads.sam")))
    assert sam.header.sort_order == "coordinate"
    assert sam.references == AlignmentFile(bam).references
    assert [_fields(r) for r in sam.fetch(until_eof=True)] \
        == [_fields(r) for r in records]

    grouped = AlignmentFile(workloads.queryname_bam(
        bam, str(tmp_path / "reads.qname.bam")))
    assert grouped.header.sort_order == "queryname"
    grouped_records = list(grouped.fetch(until_eof=True))
    names = [r.query_name for r in grouped_records]
    assert names == sorted(names)
    supplementary = [r for r in grouped_records if r.is_supplementary]
    assert len(supplementary) == sum(
        len([e for e in r.get_tag("SA").split(";") if e])
        for r in records if r.has_tag("SA")) > 0
    assert sorted(map(_fields, (r for r in grouped_records
                                if not r.is_supplementary))) \
        == sorted(map(_fields, records))


def test_smoke_pins_svim_tpus_vcfs_of_the_other_inputs(tmp_path, monkeypatch):
    """chip_smoke.SAM_VCF_SHA256 and QUERYNAME_VCF_SHA256 are svim_tpu's own
    CPU results (with mid-scan clustering off, as the port runs) on the
    golden workload as SAM text and as a queryname-sorted BAM; the port
    gives the same bytes."""
    import hashlib

    from svim_tpu.cli import main as jax_main
    from svim_tpu_torch.cli import main as port_main

    smoke = _module("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    bam, genome = workloads.golden_workload(str(tmp_path))

    def digest(working_dir):
        with open(os.path.join(working_dir, "variants.vcf")) as handle:
            return hashlib.sha256("".join(
                line for line in handle
                if not line.startswith("##fileDate")).encode()).hexdigest()

    for writer, name, expected in (
            (workloads.sam_text, "reads.sam", smoke.SAM_VCF_SHA256),
            (workloads.queryname_bam, "reads.qname.bam",
             smoke.QUERYNAME_VCF_SHA256)):
        path = writer(bam, str(tmp_path / name))
        arguments = [path, genome, "--edit_backend", "wavefront"]
        jax_wd = str(tmp_path / ("jax_" + name))
        port_wd = str(tmp_path / ("port_" + name))
        assert jax_main(["alignment", jax_wd] + arguments
                        + ["--incremental_cluster", "off"]) == 0
        assert port_main(["alignment", port_wd] + arguments) == 0
        assert digest(jax_wd) == digest(port_wd) == expected, name
