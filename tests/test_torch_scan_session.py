"""The port's incremental scan session (svim_tpu_torch.native: its own copy
of svimnative.cpp) against svim_tpu's on the same inputs: the twin of
tests/test_scan_session.py, the native engine under the one-shot and the
pipelined COLLECT.

The session's columns must equal the port's one-shot scanner's and
svim_tpu's, column for column across batch boundaries, with the inflated
stream byte-equal (the pooled-buffer contract: a buffer's capacity never
leaks into the walk length); a stream that is not BGZF or is cut in half is
refused; the port's pipelined and streaming COLLECT must give the
signatures of svim_tpu's classic scan-then-extract path and of its
pipelined COLLECT (the port keeps no classic scanner).  A
second dataset, the sample workload at a small size (3,001-op CIGARs,
split reads), crosses the same checks at the widths the sample runs."""

import numpy as np
import pytest

from svim_tpu import native as jax_native
from svim_tpu_torch import native, workloads
from svim_tpu_torch.io.packing import bucket_size

pytestmark = pytest.mark.skipif(native.get_library() is None,
                                reason="native library unavailable")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from svim_tpu_torch.sim import SimConfig, simulate

    out = tmp_path_factory.mktemp("scansession")
    genome, bam, _ = simulate(str(out), SimConfig(
        seed=31, genome_length=500_000, second_contig_length=200_000,
        coverage=6, n_del=3, n_ins=3, n_inv=2, n_tan=2, n_dup_int=1,
        n_bnd=2, n_background=60))
    return str(out), bam, genome


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    out = tmp_path_factory.mktemp("sample")
    bam, genome = workloads.sample_workload(
        str(out), 3, contig_length=1_000_000, partner_length=500_000,
        depth=4, ins_sizes=(50, 300))
    return str(out), bam, genome


def _oracle_columns(module, compressed, min_mapq, min_sv_size):
    data, counted = module.bam_scan_fused(compressed, min_mapq, min_sv_size)
    result = module.bamscan_native(data, min_mapq, bucket_size, min_sv_size,
                                   counted=counted)
    return bytes(data), result


@pytest.mark.parametrize("which", ["dataset", "sample"])
def test_session_matches_oneshot_scanner(which, request):
    _out, bam, _genome = request.getfixturevalue(which)
    with open(bam, "rb") as handle:
        compressed = handle.read()
    oracle_data, oracle = _oracle_columns(native, compressed, 20, 40)
    jax_data, jax_oracle = _oracle_columns(jax_native, compressed, 20, 40)
    assert oracle_data == jax_data
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(oracle[3:], jax_oracle[3:]))
    (_t, _r, _l, cw0, rid0, pos0, mq0, fl0, no0, nl0, so0, sl0, sao0,
     sal0) = oracle

    for batch in (64, 1000, 1 << 20):   # many boundaries ... single batch
        session = native.BamScanSession(compressed, 20, 40)
        total = 0
        while True:
            row_start, n, max_ops, _body, done = session.next_rows(batch)
            if n:
                k = bucket_size(max(1, max_ops))
                columns = session.fill(row_start, n, k)
                rows = slice(row_start, row_start + n)
                cw = columns[0]
                for got, want in zip(columns[1:], (rid0, pos0, mq0, fl0, no0,
                                                   nl0, so0, sl0, sao0,
                                                   sal0)):
                    assert np.array_equal(got, want[rows])
                kk = min(k, cw0.shape[1])
                assert np.array_equal(cw[:, :kk], cw0[rows][:, :kk])
                if k < cw0.shape[1]:
                    assert not cw0[rows][:, kk:].any()
                total += n
            if done:
                break
        assert bytes(session.data) == oracle_data
        assert total == len(rid0)
        session.close()


def test_session_rejects_non_bgzf():
    with pytest.raises(ValueError):
        native.BamScanSession(b"not a bam at all", 0, 0)


def test_session_truncated_stream_raises(dataset):
    _out, bam, _genome = dataset
    with open(bam, "rb") as handle:
        compressed = handle.read()
    session = None
    truncated = compressed[:len(compressed) // 2]
    try:
        session = native.BamScanSession(truncated, 20, 40)
    except ValueError:
        return   # rejected at block scan: fine
    with pytest.raises(ValueError):
        while True:
            _rs, n, _mo, _b, done = session.next_rows(1 << 20)
            if done:
                break
    session.close()


def _signature_strings(soa, twins, sig_types):
    return ({sig_type: [s.as_string() for s in soa.tables[sig_type]
                        .materialize_list(range(soa.tables[sig_type].n))]
             for sig_type in sig_types},
            [twin.as_string() for twin in twins])


@pytest.mark.parametrize("which", ["dataset", "sample"])
def test_pipelined_and_streaming_collect_match_svim_tpu(which, request,
                                                        monkeypatch):
    """The port's collect_soa_pipelined (the session) and collect_streaming
    (windows of 64 KiB here, so that records cross window ends) give,
    signature for signature and row name for row name, what svim_tpu's
    classic scan_bam + signatures_from_packed_soa and its
    collect_soa_pipelined give, across multiple batches."""
    import torch
    from svim_tpu.collect.packed import (
        collect_soa_pipelined as jax_pipelined,
        signatures_from_packed_soa as jax_signatures,
    )
    from svim_tpu.config import parse_arguments as jax_arguments
    from svim_tpu.io.bamscan import scan_bam as jax_scan_bam

    from svim_tpu_torch.collect.packed import collect_soa_pipelined
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.io import bamstream
    from svim_tpu_torch.sigtable import SIG_TYPES

    out, bam, genome = request.getfixturevalue(which)
    arguments = ["alignment", out, bam, genome, "--batch_reads", "64"]
    jax_options = jax_arguments(arguments=arguments)
    header, packed, sa_tags = jax_scan_bam(bam, jax_options.min_mapq,
                                           jax_options.min_sv_size)
    expected = _signature_strings(*jax_signatures(packed, sa_tags, header,
                                                  jax_options), SIG_TYPES)
    assert sum(map(len, expected[0].values())) > 0
    _jh, jax_table, jax_soa, jax_twins = jax_pipelined(bam, jax_options)
    assert _signature_strings(jax_soa, jax_twins, SIG_TYPES) == expected
    names = list(jax_table.names)
    assert len(names) == packed.n

    options = parse_arguments(arguments=arguments)
    device = torch.device("cpu")
    _h, table, soa, twins = collect_soa_pipelined(bam, options, device)
    assert _signature_strings(soa, twins, SIG_TYPES) == expected
    assert list(table.names) == names
    monkeypatch.setattr(bamstream, "WINDOW_UNCOMPRESSED", 1 << 16)
    monkeypatch.setattr(bamstream, "WINDOWS", 0)
    _h, table, soa, twins = bamstream.collect_streaming(bam, options, device)
    assert _signature_strings(soa, twins, SIG_TYPES) == expected
    assert list(table.names) == names
    assert bamstream.WINDOWS > 1
