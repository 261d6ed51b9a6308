"""Parity of the port's GENOTYPE (svim_tpu_torch.ops.genotype_kernel and
genotype.genotype_packed_multi) with the JAX package's: equal counts from
the interval join's plain version on chip_smoke.py's seeded edge cases
(genotype_cases: the cap at 499, 500 and 501, width 0, 1 and 8192, S past
the kernel's shared-memory stage, INT_MAX and INT_MIN ids, wrapping
margins, C = 1 and 4096), a numpy model of the CUDA kernel's algorithm
(csrc/genotype_support.cu: a warp a candidate, steps of rows in
coordinate order, a row's rank and list slot from ballots, the stop at the
500th qualifying row, the list of at most 512 ids, its warp sort and the
boundary count) held to JAX at several step sizes, the dispatcher (CPU tensors take the plain version
without a build; a CUDA tensor reaches the kernel or raises; any other
device raises), and equal genotypes on the test_genotype_packed.py cases.
Everything is integers: the tolerance is exact equality."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from svim_tpu.genotype import genotype_packed as jax_genotype_packed
from svim_tpu.genotype import genotype_packed_multi as jax_genotype_multi
from svim_tpu.io.bamscan import scan_bam
from svim_tpu.ops import genotype_kernel as jax_kernel
from svim_tpu_torch.genotype import genotype_packed_multi
from svim_tpu_torch.ops import _build
from svim_tpu_torch.ops import genotype_kernel as torch_kernel

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_collect_kernel import SMOKE, _OnCard  # noqa: E402


# the seed of chip_smoke.py's phase 16
CASES = list(SMOKE.genotype_cases(np.random.default_rng(20261023)))


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


def _jax_counts(args):
    return np.asarray(jax_kernel.genotype_support_batched(*args[:-1],
                                                          args[-1]))


def _tensors(args):
    return [torch.from_numpy(value) for value in args[:-1]] + [args[-1]]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[label for label, _ in CASES])
def test_plain_version_equals_jax_on_the_smoke_cases(case):
    label, args = CASES[case]
    want = _jax_counts(args)
    got = torch_kernel.genotype_support_batched(*_tensors(args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=label)


def test_the_smoke_cases_reach_their_edges():
    """The cap cases count 499, 500, 500 (501 qualifying rows), 0 for
    supporters after the 500th qualifying row, 250 around it, 500 past
    excluded and out-of-window rows, 150 distinct of 600 supporters; the
    sentinel cases 200 (INT_MAX ids use the cap against a full support
    row), 300 (they match the padding), 5 (INT_MIN never counted)."""
    counts = dict((label, _jax_counts(args)) for label, args in CASES)
    cap = counts["the cap at 499, 500, 501 and around it"]
    np.testing.assert_array_equal(cap, [499, 500, 500, 0, 250, 500, 500,
                                        150] * 2)
    np.testing.assert_array_equal(counts["INT_MAX and INT_MIN ids"],
                                  [200, 300, 5, 0] * 2)
    np.testing.assert_array_equal(counts["width 0, 1 and 8192"][:3],
                                  [0, 1, 1])
    assert counts["width 0, 1 and 8192"][3] > 0
    for label, args in CASES:
        assert set(args[6].tolist()) == {0, 1} or len(args[6]) == 1, label
    assert any(args[7].shape[1] > 4096 for _, args in CASES)


def _numpy_bound_work(args):
    """chip_smoke.genotype_bound_work candidate by candidate in numpy: the
    rows walked to the 500th qualifying one, the set of table rows they
    touch, and the operations of the walk."""
    (lo, width, window_start2, _start2, _end2, _overlap2, type_class,
     support, _starts2, ends2, ids, slice_len) = args
    table_rows = len(ends2)
    steps = max(support.shape[1] - 1, 0).bit_length()
    touched = set()
    operations = 0
    for c in range(len(lo)):
        first = min(max(int(lo[c]), 0), max(table_rows - slice_len, 0))
        qualified = 0
        for row in range(first, first + min(max(int(width[c]), 0),
                                            slice_len)):
            touched.add(row)
            operations += 3
            if ends2[row] <= window_start2[c]:
                continue
            operations += steps + 2
            if ids[row] in support[c]:
                continue
            operations += 10 if type_class[c] == 0 else 6
            qualified += 1
            if qualified == torch_kernel.ALIGNMENT_CAP:
                break
    return len(touched), operations


@pytest.mark.parametrize("shape,same_window", [
    ((24, 256, 8), False), ((16, 2048, 64), False), ((16, 2048, 64), True)],
    ids=["under the cap", "the cap reached", "one window for all"])
def test_the_genotype_bound_counts_a_table_row_once(shape, same_window):
    """The smoke's bound of the join counts the distinct table rows the
    walks touch (overlapping windows once) and the operations of the walks,
    each stopped at its 500th qualifying row, as a plain loop does."""
    args = SMOKE.genotype_timed_inputs(np.random.default_rng(7), *shape)
    if same_window:
        args[0] = np.full_like(args[0], args[0][0])
    touched, operations = SMOKE.genotype_bound_work(_tensors(args))
    assert (touched, operations) == _numpy_bound_work(args)
    candidates, slice_len, _ = shape
    if same_window:
        assert touched <= slice_len
    ms, bound_by = SMOKE.genotype_bound_ms(_tensors(args))
    moved = 12 * touched + candidates * (28 + 4 * shape[2] + 4)
    assert ms == max(moved / SMOKE.HBM_BYTES_PER_SECOND,
                     operations / SMOKE.INT32_OPS_PER_SECOND) * 1e3
    assert bound_by in ("bytes", "operations")


def _wrap(value):
    return (int(value) + 2**31) % 2**32 - 2**31


def _register_sort(values):
    """The kernel's sort of a warp's listed ids (csrc/genotype_support.cu's
    distinct_ids): the bitonic network over a power-of-two size >= 32 in
    registers, entry x = lane * E + e in value e of lane `lane` (E = size /
    32); a stage whose partner bit j is below E compares values e and e | j
    of a lane, the others exchange value e with lane ^ (j / E) by a
    shuffle, a lane keeping the minimum where its entry is the lower of the
    pair in an ascending block.  Returns the entries in x order."""
    size = len(values)
    per_lane = size // 32
    value = np.asarray(values).reshape(32, per_lane).copy()
    x = np.arange(size).reshape(32, per_lane)
    k = 2
    while k <= size:
        j = k // 2
        while j > 0:
            if j >= per_lane:
                other = value[np.arange(32) ^ (j // per_lane)]
                keep_min = ((x & j) == 0) == ((x & k) == 0)
                value = np.where(keep_min, np.minimum(value, other),
                                 np.maximum(value, other))
            else:
                for e in range(per_lane):
                    if e & j:
                        continue
                    ascending = (x[:, e] & k) == 0
                    low = np.minimum(value[:, e], value[:, e | j])
                    high = np.maximum(value[:, e], value[:, e | j])
                    value[:, e] = np.where(ascending, low, high)
                    value[:, e | j] = np.where(ascending, high, low)
            j //= 2
        k *= 2
    return value.reshape(size)


def _lower_bound(row, value):
    """The kernel's branch-free lower bound: ceil(log2 S) halvings."""
    at, n = 0, len(row)
    while n > 1:
        half = n >> 1
        if row[at + half] < value:
            at += half
        n -= half
    return at + int(row[at] < value)


def _model_genotype_support(args, rows_a_lane):
    """numpy model of csrc/genotype_support.cu, a warp a candidate: the
    window walked in coordinate order `rows_a_lane` x 32 rows a step, lane
    l at rows base + r * 32 + l; a step none of whose rows ends past the
    window's start is skipped; for each r in order the ballot of qualifying
    lanes gives a row its rank (rows qualified so far + qualifying lanes
    below + 1), the ballot of supporting lanes (spanning, rank <= 500) a
    supporting row its slot; the walk stopped once 500 rows qualified; the
    listed ids sorted by the register network over the smallest power of
    two >= 32 that holds them, and the boundaries counted with a first
    previous of INT_MIN.  Returns (counts, rows walked)."""
    (lo, width, window_start2, start2, end2, min_overlap2, type_class,
     support, starts2, ends2, ids, slice_len) = args
    int_max, int_min = torch_kernel.INT_MAX, torch_kernel.INT_MIN
    cap = torch_kernel.ALIGNMENT_CAP
    lanes = np.arange(32)
    counts = np.zeros(len(lo), dtype=np.int32)
    walked = np.zeros(len(lo), dtype=np.int64)
    for c in range(len(lo)):
        rows = min(max(int(width[c]), 0), slice_len)
        first = min(max(int(lo[c]), 0), len(starts2) - slice_len)
        row_ids = support[c]
        bounds = (_wrap(int(end2[c]) - int(min_overlap2[c])),
                  _wrap(int(end2[c]) + 200), _wrap(int(start2[c]) - 200),
                  _wrap(int(start2[c]) + int(min_overlap2[c])))
        listed_ids = np.full(512, int_max, dtype=np.int64)
        qualified = listed = 0
        for base in range(0, rows, 32 * rows_a_lane):
            if qualified >= cap:
                break
            walked[c] += min(32 * rows_a_lane, rows - base)
            k = base + np.arange(rows_a_lane)[:, None] * 32 + lanes[None, :]
            inside = k < rows
            row = first + np.where(inside, k, 0)
            end = np.where(inside, ends2[row], int_min)
            in_window = inside & (end > window_start2[c])
            if not in_window.any():
                continue
            for r in range(rows_a_lane):
                start, row_id = starts2[row[r]], ids[row[r]]
                member = np.array([
                    row_ids[min(_lower_bound(row_ids, value),
                                len(row_ids) - 1)] == value
                    for value in row_id])
                qualifying = in_window[r] & ~member
                if type_class[c] == 0:
                    spans = (((start < bounds[0]) & (end[r] > bounds[1]))
                             | ((start < bounds[2]) & (end[r] > bounds[3])))
                else:
                    spans = (start < bounds[2]) & (end[r] > bounds[1])
                rank = qualified + np.cumsum(qualifying) - qualifying + 1
                supports = qualifying & spans & (rank <= cap)
                slots = listed + np.cumsum(supports) - supports
                listed_ids[slots[supports]] = row_id[supports]
                listed += int(supports.sum())
                qualified += int(qualifying.sum())
                if qualified >= cap:
                    break
        size = 32
        while size < listed:
            size *= 2
        ordered = _register_sort(listed_ids[:size])
        assert np.all(ordered[:-1] <= ordered[1:])
        previous = np.concatenate([[int_min], ordered[:-1]])
        counts[c] = np.sum((ordered != int_max) & (ordered != previous))
    return counts, walked


def test_the_kernels_sorts_and_search_order_as_numpy_does():
    """The register sort network sorts any ids (INT_MIN and INT_MAX among
    them) at every size it takes, and the branch-free search is the lower
    bound of a sorted row."""
    rng = np.random.default_rng(9)
    extremes = [torch_kernel.INT_MIN, torch_kernel.INT_MAX]
    for size in (32, 64, 128, 256, 512):
        values = rng.integers(-5, 40, size=size)
        values[:3] = extremes + [7]
        np.testing.assert_array_equal(_register_sort(values),
                                      np.sort(values))
    for s in (1, 2, 3, 8, 37, 64, 4096):
        row = np.sort(rng.integers(0, 60, size=s))
        for value in (-1, 0, 17, 59, 60, torch_kernel.INT_MAX):
            assert _lower_bound(row, value) == np.searchsorted(row, value)


@pytest.mark.parametrize("tile", [32, 64, 128, 256, 1024])
def test_the_genotype_kernel_model_at_several_tiles(tile):
    """The kernel's algorithm (a warp a candidate) equals JAX on every
    seeded case whatever the rows a step, `tile` = 32 x the rows a lane
    loads (the kernel's: 128), and its stop at the 500th qualifying row
    leaves rows of the long windows unread."""
    for label, args in CASES:
        if label == "C=4096":
            args = [value[:512] if index < 8 else value
                    for index, value in enumerate(args)]
        got, walked = _model_genotype_support(args, tile // 32)
        np.testing.assert_array_equal(got, _jax_counts(args),
                                      err_msg=label)
        if label.startswith("the cap"):
            rows = np.minimum(args[1], args[-1])
            assert (walked < rows).any() or tile > 600, label


def test_dispatch_takes_the_plain_version_on_the_cpu_and_never_falls_back(
        monkeypatch):
    """CPU tensors take genotype_support_batched_plain without a build; a
    tensor on a card goes to the kernel, and a failing build reaches the
    caller; a tensor on any other device raises."""
    def broken(name):
        raise RuntimeError("nvcc failed for {0}.cu".format(name))

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(torch_kernel, "_library", None)
    label, args = CASES[0]
    got = torch_kernel.genotype_support_batched(*_tensors(args))
    np.testing.assert_array_equal(got.numpy(), _jax_counts(args))

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(torch_kernel, "genotype_support_batched_plain",
                        no_plain)
    launches = torch_kernel.LAUNCHES
    on_card = [_OnCard(value) if isinstance(value, torch.Tensor) else value
               for value in _tensors(args)]
    with pytest.raises(RuntimeError,
                       match="nvcc failed for genotype_support.cu"):
        torch_kernel.genotype_support_batched(*on_card)
    assert torch_kernel.LAUNCHES == launches
    meta = [value.to("meta") if isinstance(value, torch.Tensor) else value
            for value in _tensors(args)]
    with pytest.raises(ValueError, match="no genotype_support kernel"):
        torch_kernel.genotype_support_batched(*meta)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch_kernel.genotype_support_batched_cuda(*_tensors(args))




def test_one_call_a_shard_and_the_plain_blocks(monkeypatch):
    """genotype_ref_support_device makes one call of the dispatcher a shard
    with every candidate of the shard (the kernel keeps no (C, slice_len)
    temporary); the plain version's blocks of MAX_GATHER_CELLS cells give
    the same counts as one block."""
    label, args = CASES[-1]
    want = _jax_counts(args)
    monkeypatch.setattr(torch_kernel, "MAX_GATHER_CELLS", 1000)
    got = torch_kernel.genotype_support_batched_plain(*_tensors(args))
    np.testing.assert_array_equal(got.numpy(), want)

    rng = np.random.default_rng(9)
    starts = np.sort(rng.integers(0, 200_000, size=4000))
    per_tid = {0: (starts, starts + rng.integers(500, 8000, size=4000),
                   rng.integers(0, 900, size=4000), 8000)}
    jobs = []
    for _ in range(64):
        start = int(rng.integers(2000, 190_000))
        tc = int(rng.integers(0, 2))
        end = start if tc else start + int(rng.integers(50, 3000))
        jobs.append((0, start, end, tc, list(rng.integers(0, 900, size=3)),
                     250_000))
    calls = []
    original = torch_kernel.genotype_support_batched

    def counted(*args):
        calls.append(args[0].shape[0])
        return original(*args)

    monkeypatch.setattr(torch_kernel, "genotype_support_batched", counted)
    for shards in (1, 8):
        del calls[:]
        counts = torch_kernel.genotype_ref_support_device(jobs, per_tid, CPU,
                                                          shards)
        assert calls == [64 // shards] * shards
        assert counts == jax_kernel.genotype_ref_support_device(
            jobs, per_tid, None)


def test_genotype_packed_filters_unfiltered_table_equals_jax(
        tmp_path, default_options):
    """Twin of test_genotype_packed.py::
    test_genotype_packed_filters_unfiltered_table: a table scanned at
    min_mapq 0 genotypes as svim_tpu's does."""
    from svim_tpu.collect.packed import _run_collect_scan
    from test_genotype_packed import _make_inputs

    bam_path, del_candidates, ins_candidate = _make_inputs(tmp_path)
    header, packed, _sa_tags = scan_bam(bam_path, 0)
    _run_collect_scan(packed, default_options)
    assert (packed.mapq < default_options.min_mapq).any()
    port_dels = copy.deepcopy(del_candidates)
    port_ins = copy.deepcopy(ins_candidate)
    jax_genotype_packed(del_candidates, packed, header, "DEL",
                        default_options)
    jax_genotype_packed([ins_candidate], packed, header, "INS",
                        default_options)
    genotype_packed_multi([(port_dels, "DEL", None), ([port_ins], "INS",
                                                      None)],
                          packed, header, default_options, CPU)
    for got, want in zip(port_dels + [port_ins],
                         del_candidates + [ins_candidate]):
        assert (got.genotype, got.ref_reads, got.alt_reads,
                got.support_fraction) == (want.genotype, want.ref_reads,
                                          want.alt_reads,
                                          want.support_fraction)
    assert any(candidate.ref_reads for candidate in port_dels)


def test_genotype_packed_multi_single_call_matches_per_type_equals_jax(
        tmp_path, default_options):
    """Twin of test_genotype_packed.py::
    test_genotype_packed_multi_single_call_matches_per_type: DEL and INS
    jobs interleaved in one join give svim_tpu's per-type genotypes."""
    from svim_tpu.collect.packed import _run_collect_scan
    from test_genotype_packed import _make_inputs

    bam_path, del_candidates, ins_candidate = _make_inputs(tmp_path)
    header, packed, _sa_tags = scan_bam(bam_path, default_options.min_mapq)
    _run_collect_scan(packed, default_options)
    port_dels = copy.deepcopy(del_candidates)
    port_ins = copy.deepcopy(ins_candidate)
    jax_genotype_packed(del_candidates, packed, header, "DEL",
                        default_options)
    jax_genotype_packed([ins_candidate], packed, header, "INS",
                        default_options)
    # the port's one call, its jobs interleaved: DEL, INS, DEL, ...
    groups = []
    for index, candidate in enumerate(port_dels):
        groups.append(([candidate], "DEL", None))
        if index == 0:
            groups.append(([port_ins], "INS", None))
    joins = []
    original = torch_kernel.genotype_ref_support_device

    def counted(jobs, *args):
        joins.append([job[3] for job in jobs])
        return original(jobs, *args)

    torch_kernel.genotype_ref_support_device = counted
    try:
        genotype_packed_multi(groups, packed, header, default_options, CPU)
    finally:
        torch_kernel.genotype_ref_support_device = original
    assert len(joins) == 1 and 0 in joins[0] and 1 in joins[0]
    for got, want in zip(port_dels + [port_ins],
                         del_candidates + [ins_candidate]):
        assert (got.genotype, got.ref_reads, got.alt_reads,
                got.support_fraction) == (want.genotype, want.ref_reads,
                                          want.alt_reads,
                                          want.support_fraction)
