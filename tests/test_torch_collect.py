"""Parity of the port's COLLECT (svim_tpu_torch.ops.cigar_kernel,
ops.segments_kernel, collect.packed) with the JAX package's on the same
inputs: equal integers from both kernels, events in (row, op) order, and
equal signature tables from a whole BAM."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from svim_tpu.collect import packed as jax_packed
from svim_tpu.config import parse_arguments
from svim_tpu.io.bamscan import scan_bam
from svim_tpu.io.packing import PackedAlignments
from svim_tpu.ops import cigar_kernel as jax_cigar
from svim_tpu.sigtable import SIG_TYPES
from svim_tpu_torch.collect import packed as torch_packed
from svim_tpu_torch.ops import cigar_kernel as torch_cigar
from svim_tpu_torch.state import packed_to_torch, to_host

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_packed(seed, n=96, k=48):
    """Random BAM words including clips, zero lengths and the synthetic
    compaction ops 9 (reference advance) and 10 (read advance)."""
    rng = np.random.default_rng(seed)
    ops = rng.choice([0, 0, 0, 1, 2, 3, 4, 5, 7, 8, 9, 10], size=(n, k))
    lens = rng.integers(0, 120, size=(n, k))
    lens[rng.random((n, k)) < 0.05] = 0
    words = ((lens << 4) | ops).astype(np.int32)
    words[:, -4:] = 0   # padding
    return PackedAlignments(
        n=n, ref_id=rng.integers(0, 3, size=n).astype(np.int32),
        ref_start=rng.integers(0, 10_000_000, size=n).astype(np.int32),
        ref_end=None, mapq=np.full(n, 60, np.int32),
        flag=(rng.random(n) < 0.5).astype(np.int32) * 16, qa_start=None,
        qa_end=None, read_len=None, cigar_words=words, names=None,
        sequences=None)


@pytest.mark.parametrize("seed,min_sv_size", [(1, 40), (2, 100), (3, 1)])
def test_collect_scan_equals_jax(seed, min_sv_size):
    packed = _random_packed(seed)
    columns = packed_to_torch(packed, CPU)
    got = to_host(torch_cigar.collect_scan(columns["cigar_words"],
                                           columns["ref_start"], min_sv_size))
    max_events = 1
    while max_events < packed.cigar_words.size:
        max_events *= 2
    want = jax.device_get(jax_cigar.collect_scan(
        packed.cigar_words, packed.ref_start, np.int32(min_sv_size),
        max_events))
    count = int(want[-1])
    assert int(got[-1]) == count > 0
    for got_column, want_column in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(got_column, want_column)
        assert got_column.dtype == want_column.dtype
    for got_column, want_column in zip(got[5:10], want[5:10]):
        np.testing.assert_array_equal(got_column, want_column[:count])
    rows = got[5]
    assert (np.diff(rows) >= 0).all()   # (row, op) order


def _classes_bam(tmp_path):
    import sys

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_all_classes_e2e import _build_sam

    return _build_sam(tmp_path)


def _options(working_dir, bam, genome, *extra):
    return parse_arguments(arguments=["alignment", str(working_dir), bam,
                                      genome, *extra])


def test_collect_and_classify_equal_jax_on_a_bam(tmp_path):
    """Both device passes of one packed batch, fed the same scan."""
    bam, genome = _classes_bam(tmp_path)
    options = _options(tmp_path, bam, genome, "--all_bnds")
    header, packed, sa_tags = scan_bam(bam, options.min_mapq,
                                       options.min_sv_size)
    jax_stage = jax_packed.stage_signatures_soa(packed, sa_tags, header,
                                                options)
    jax_collect, jax_classify = jax.device_get(jax_stage.device_tree())

    port_batch = PackedAlignments(
        n=packed.n, ref_id=packed.ref_id, ref_start=packed.ref_start,
        ref_end=None, mapq=packed.mapq, flag=packed.flag, qa_start=None,
        qa_end=None, read_len=None, cigar_words=packed.cigar_words,
        names=packed.names, sequences=packed.sequences)
    port_stage = torch_packed.stage_signatures_soa(port_batch, sa_tags,
                                                   header, options, CPU)
    port_collect, port_classify = to_host(port_stage.device_tree())

    count = int(jax_collect[-1])
    assert int(port_collect[-1]) == count
    for got, want in zip(port_collect[:5], jax_collect[:5]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_collect[5:10], jax_collect[5:10]):
        np.testing.assert_array_equal(got, want[:count])
    assert port_stage.group_rows == jax_stage.group_rows
    assert len(port_stage.group_rows) >= 20
    assert len(port_classify) == len(jax_classify) == 12
    for got, want in zip(port_classify, jax_classify):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert (port_classify[0] != 0).any()


def _signature_fields(signature):
    names = [name for cls in type(signature).__mro__
             for name in getattr(cls, "__slots__", ())]
    return (type(signature).__name__,) + tuple(
        getattr(signature, name, None) for name in names)


def _assert_same_collect(got, want):
    got_header, got_table, got_soa, got_twins = got
    want_header, want_table, want_soa, want_twins = want
    assert got_header.references == want_header.references
    for column in ("ref_id", "ref_start", "ref_end", "mapq"):
        np.testing.assert_array_equal(getattr(got_table, column),
                                      getattr(want_table, column))
    assert list(got_table.names) == list(want_table.names)
    total = 0
    for sig_type in SIG_TYPES:
        got_t = got_soa.tables.get(sig_type)
        want_t = want_soa.tables.get(sig_type)
        assert (got_t is None) == (want_t is None)
        if got_t is None:
            continue
        assert got_t.n == want_t.n
        total += got_t.n
        assert ([_signature_fields(s) for s in got_t.materialize_list(
            range(got_t.n))]
            == [_signature_fields(s) for s in want_t.materialize_list(
                range(want_t.n))])
    assert total > 0
    assert ([_signature_fields(s) for s in got_twins]
            == [_signature_fields(s) for s in want_twins])


@pytest.mark.parametrize("all_bnds", [False, True])
def test_soa_tables_equal_jax_on_split_read_classes(tmp_path, all_bnds):
    bam, genome = _classes_bam(tmp_path)
    extra = ("--all_bnds",) if all_bnds else ()
    options = _options(tmp_path, bam, genome, *extra)
    _assert_same_collect(
        torch_packed.collect_soa_from_bam(bam, options, CPU),
        jax_packed.collect_soa_from_bam(bam, options))


def _bench_module(reads):
    """bench.py loaded privately with SVIM_BENCH_READS=reads (it sizes the
    workload when imported)."""
    previous = os.environ.get("SVIM_BENCH_READS")
    os.environ["SVIM_BENCH_READS"] = str(reads)
    try:
        spec = importlib.util.spec_from_file_location(
            "_bench_{0}".format(reads), os.path.join(REPO, "bench.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if previous is None:
            del os.environ["SVIM_BENCH_READS"]
        else:
            os.environ["SVIM_BENCH_READS"] = previous
    return module


def test_soa_tables_equal_jax_on_bench_workload(tmp_path):
    bench = _bench_module(256)
    bam, genome, _header, _records = bench.make_workload(str(tmp_path))
    options = _options(tmp_path, bam, genome, "--batch_reads", "64")
    _assert_same_collect(
        torch_packed.collect_soa_from_bam(bam, options, CPU),
        jax_packed.collect_soa_from_bam(bam, options))


def _tree_state(directory):
    return {name: (os.path.getsize(os.path.join(directory, name)),
                   os.path.getmtime(os.path.join(directory, name)))
            for name in sorted(os.listdir(directory))}


def test_host_library_builds_svim_tpu_native_sources(tmp_path, monkeypatch):
    """The port's native library is built from the port's own sources (which
    include <string>, as g++ 13 needs) into the port's build directory, and
    nothing under svim_tpu/native is created or changed."""
    import svim_tpu.native as jax_native
    from svim_tpu_torch import native

    jax_dir = os.path.dirname(jax_native.__file__)
    before = _tree_state(jax_dir)
    with open(native._SOURCE) as handle:
        assert "#include <string>" in handle.read()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    library = native.get_library()
    assert os.path.dirname(library._name) == str(tmp_path / "_build")
    assert library._name == native.library_path()
    assert library.myers_distance(b"ACGTT", 5, b"AGTT", 4) == 1
    assert _tree_state(jax_dir) == before
    # the build the package itself uses lies in its git-ignored directory
    monkeypatch.undo()
    package_dir = os.path.dirname(os.path.dirname(native.__file__))
    assert os.path.dirname(native.library_path()) == os.path.join(
        package_dir, "_build")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No Python stand-in: a failing g++ raises instead of returning None."""
    from svim_tpu_torch import native

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_SOURCE", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_library()


def test_streaming_sizes_are_not_ported(tmp_path):
    """--stream_input routes collect_soa_from_bam through the port's
    streaming scanner (as it routes svim_tpu's), with equal tables."""
    from svim_tpu_torch.io import bamstream

    bam, genome = _classes_bam(tmp_path)
    options = _options(tmp_path, bam, genome, "--stream_input", "--all_bnds",
                       "--batch_reads", "7")
    before = bamstream.BATCHES
    got = torch_packed.collect_soa_from_bam(bam, options, CPU)
    assert bamstream.BATCHES > before + 1
    _assert_same_collect(got, jax_packed.collect_soa_from_bam(bam, options))
