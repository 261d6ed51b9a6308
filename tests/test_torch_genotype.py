"""Parity of the port's GENOTYPE (svim_tpu_torch.ops.genotype_kernel and
genotype.genotype_packed_multi) with the JAX package's: equal counts from
the interval-join kernel, equal genotypes on the test_genotype_packed.py
cases."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from svim_tpu.genotype import genotype_packed_multi as jax_genotype_multi
from svim_tpu.io.bamscan import scan_bam
from svim_tpu.ops import genotype_kernel as jax_kernel
from svim_tpu_torch.genotype import genotype_packed_multi
from svim_tpu_torch.ops import genotype_kernel as torch_kernel

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def test_genotype_support_batched_equals_jax():
    rng = np.random.default_rng(3)
    rows, slice_len, candidates, support = 3000, 256, 40, 16
    starts = np.sort(rng.integers(0, 400_000, size=rows))
    ends = starts + rng.integers(500, 8000, size=rows)
    ids = rng.integers(0, 900, size=rows)
    starts2 = np.concatenate([starts * 2, np.full(slice_len,
                                                  torch_kernel.INT_MAX)])
    ends2 = np.concatenate([ends * 2, np.full(slice_len,
                                              torch_kernel.INT_MIN)])
    ids = np.concatenate([ids, np.full(slice_len, torch_kernel.INT_MAX)])
    table = [x.astype(np.int32) for x in (starts2, ends2, ids)]

    lo = rng.integers(0, rows - slice_len, size=candidates)
    width = rng.integers(1, slice_len + 1, size=candidates)
    start = starts[lo + width // 2] + rng.integers(-500, 500, size=candidates)
    end = start + rng.integers(0, 3000, size=candidates)
    window_start = np.maximum(0, start - 1000)
    type_class = rng.integers(0, 2, size=candidates)
    end = np.where(type_class == 1, start, end)
    support_sorted = np.full((candidates, support), torch_kernel.INT_MAX,
                             dtype=np.int64)
    for row in range(candidates):
        chosen = np.unique(rng.choice(ids[lo[row]:lo[row] + width[row]],
                                      size=4))
        support_sorted[row, :len(chosen)] = chosen
    params = [x.astype(np.int32) for x in (
        lo, width, 2 * window_start, 2 * start, 2 * end,
        np.minimum(end - start, 4000), type_class, support_sorted)]

    want = np.asarray(jax_kernel.genotype_support_batched(
        *params, *table, slice_len))
    got = torch_kernel.genotype_support_batched(
        *(torch.from_numpy(x) for x in params),
        *(torch.from_numpy(x) for x in table), slice_len).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got > 0).any()


@pytest.mark.parametrize("n_background", [700, 120])
def test_genotype_packed_multi_equals_jax(tmp_path, default_options,
                                          n_background):
    """The test_genotype_packed.py inputs, including the 500-alignment cap
    (700 background reads) and a shallow table."""
    from test_genotype_packed import _make_inputs

    bam_path, del_candidates, ins_candidate = _make_inputs(
        tmp_path, n_background=n_background)
    header, packed, _sa_tags = scan_bam(bam_path, default_options.min_mapq)
    from svim_tpu.collect.packed import _run_collect_scan
    _run_collect_scan(packed, default_options)  # fills ref_end geometry

    def groups(dels, ins):
        return [(dels, "DEL", "deletions"), ([ins], "INS", "insertions")]

    port_dels = copy.deepcopy(del_candidates)
    port_ins = copy.deepcopy(ins_candidate)
    jax_genotype_multi(groups(del_candidates, ins_candidate), packed, header,
                       default_options)
    genotype_packed_multi(groups(port_dels, port_ins), packed, header,
                          default_options, CPU)
    for got, want in zip(port_dels + [port_ins],
                         del_candidates + [ins_candidate]):
        assert got.genotype == want.genotype
        assert got.ref_reads == want.ref_reads
        assert got.alt_reads == want.alt_reads
        assert got.support_fraction == want.support_fraction
    assert any(candidate.ref_reads for candidate in port_dels)

    # --device_backend host: the numpy join alone, same genotypes
    host_dels = copy.deepcopy(port_dels)
    host_ins = copy.deepcopy(port_ins)
    for candidate in host_dels + [host_ins]:
        candidate.genotype = candidate.ref_reads = None

    def no_kernel(*args, **kwargs):
        raise AssertionError("--device_backend host ran the device join")

    original = torch_kernel.genotype_ref_support_device
    torch_kernel.genotype_ref_support_device = no_kernel
    try:
        genotype_packed_multi(groups(host_dels, host_ins), packed, header,
                              default_options.replace(device_backend="host"),
                              CPU)
    finally:
        torch_kernel.genotype_ref_support_device = original
    for got, want in zip(host_dels + [host_ins], port_dels + [port_ins]):
        assert (got.genotype, got.ref_reads, got.alt_reads) \
            == (want.genotype, want.ref_reads, want.alt_reads)


def test_genotype_ref_support_guards_giant_contigs():
    """Doubled positions are int32: contigs past 2^30 bp go to the host
    join (None), as in the JAX package."""
    per_tid = {0: (np.asarray([10]), np.asarray([5000]), np.asarray([0]),
                   4990)}
    jobs = [(0, 100, 200, 0, [], 2**30 + 1)]
    assert torch_kernel.genotype_ref_support_device(jobs, per_tid, CPU) \
        == jax_kernel.genotype_ref_support_device(jobs, per_tid, None) \
        == [None]
