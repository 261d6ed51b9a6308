"""COLLECT's two device passes in svim_tpu_torch against svim_tpu's, on the
CPU: the event-bounded CIGAR scan (collect_scan_plain at svim_tpu's
max_events, the dispatch's re-run on overflow, the 8-shard merge), the
split-read classify (classify_groups_fused_plain), numpy models of the two
CUDA kernels' algorithms (csrc/collect_scan.cu: 32-op chunks of a warp,
ballots of the non-clip ops and the events, a scan of the row counts;
csrc/classify_segments.cu: the rank sort), and the dispatchers (CPU
tensors never build; a failing build raises, nothing falls back).

Everything is integers: the tolerance is exact equality.  The seeded cases
of chip_smoke.py's phase 15 (collect_cases, classify_inputs) are the ones
held here, so the card checks the kernels on inputs whose plain results
equal svim_tpu's.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from svim_tpu.collect import packed as jax_packed
from svim_tpu.config import parse_arguments as jax_parse_arguments
from svim_tpu.io.packing import pack_alignments as jax_pack_alignments
from svim_tpu.io.sam import AlignmentFile as JaxAlignmentFile
from svim_tpu.ops import cigar_kernel as jax_cigar
from svim_tpu.ops import segments_kernel as jax_segments
from svim_tpu_torch.collect import packed as torch_packed
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.io.packing import pack_alignments
from svim_tpu_torch.io.sam import AlignmentFile
from svim_tpu_torch.ops import _build, cigar_kernel, segments_kernel
from svim_tpu_torch.parallel import mesh
from svim_tpu_torch.state import to_host

CPU = torch.device("cpu")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_collect", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def _words(seed, n, k):
    """Clip rows, then random rows of every op 0-10 with zero lengths."""
    rng = np.random.default_rng(seed)
    return np.concatenate([SMOKE._rows_of_ops(k, SMOKE.CLIP_ROWS),
                           SMOKE._random_cigar_rows(rng, n, k)]), rng


def _assert_scan_equals_jax(words, starts, threshold, max_events):
    got = to_host(cigar_kernel.collect_scan(_t(words), _t(starts), threshold,
                                            max_events))
    want = jax.device_get(jax_cigar.collect_scan(
        words, starts, np.int32(threshold), max_events))
    count = int(want[10])
    kept = min(count, max_events)
    assert int(got[10]) == count
    for got_column, want_column in zip(got[:5], want[:5]):
        assert got_column.dtype == want_column.dtype
        np.testing.assert_array_equal(got_column, want_column)
    for got_column, want_column in zip(got[5:10], want[5:10]):
        assert got_column.shape == want_column.shape == (max_events,)
        assert got_column.dtype == want_column.dtype
        np.testing.assert_array_equal(got_column[:kept], want_column[:kept])
    assert (got[5][kept:] == -1).all()
    for column in got[6:10]:
        assert not column[kept:].any()
    return count


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("threshold", [1, 40, 100])
def test_collect_scan_plain_equals_jax_at_its_bound(k, threshold):
    words, rng = _words(k + threshold, 48, k)
    starts = rng.integers(-1000, 200_000_000, size=len(words)).astype(
        np.int32)
    count = _assert_scan_equals_jax(words, starts, threshold, 1024)
    assert count > 0
    # a bound the events overflow: the same prefix and the true count
    small = 1 << max(0, (count - 1).bit_length() - 1)
    assert small < count
    assert _assert_scan_equals_jax(words, starts, threshold, small) == count


def _model_collect_scan(words, starts, threshold, max_events):
    """numpy model of csrc/collect_scan.cu: pass 1 a row's 32-op chunks
    (sums, a ballot of the non-clip ops whose first and last bound the
    leading and trailing soft clips, the event count), pass 2 an exclusive
    scan of the row counts, pass 3 the events at their row's place plus the
    events before them in the row, then the fill.  uint32 sums."""
    n, k = words.shape
    u32 = np.uint32
    geometry = np.zeros((4, n), dtype=u32)
    hard_any = np.zeros(n, dtype=bool)
    row_events = np.zeros(n, dtype=np.int64)
    for row in range(n):
        ref_sum = query_sum = hard_sum = u32(0)
        leading = trailing = u32(0)
        seen = False
        for base in range(0, k, 32):
            lane = np.arange(32)
            inside = base + lane < k
            word = np.where(inside, words[row, np.minimum(base + lane, k - 1)],
                            0).astype(np.int32)
            op = word & 0xF
            length = word >> 4
            ulen = length.astype(u32)
            match = (op == 0) | (op == 7) | (op == 8)
            ref_c = inside & (match | (op == 2) | (op == 3) | (op == 9))
            query_c = inside & (match | (op == 1) | (op == 4) | (op == 10))
            soft = inside & (op == 4) & (length > 0)
            hard = inside & (op == 5) & (length > 0)
            nonclip = inside & ~(soft | (op == 5) | (length == 0))
            event = inside & ((op == 1) | (op == 2)) & (length >= threshold)
            ref_sum += ulen[ref_c].sum(dtype=u32)
            query_sum += ulen[query_c].sum(dtype=u32)
            hard_sum += ulen[hard].sum(dtype=u32)
            hard_any[row] |= hard.any()
            row_events[row] += event.sum()
            lanes = np.flatnonzero(nonclip)
            if lanes.size == 0:
                if seen:
                    trailing += ulen[soft].sum(dtype=u32)
                else:
                    leading += ulen[soft].sum(dtype=u32)
            else:
                if not seen:
                    leading += ulen[soft & (lane < lanes[0])].sum(dtype=u32)
                trailing = ulen[soft & (lane > lanes[-1])].sum(dtype=u32)
                seen = True
        geometry[:, row] = (u32(starts[row]) + ref_sum, query_sum + hard_sum,
                            leading, query_sum - trailing)
    offsets = np.concatenate([[0], np.cumsum(row_events)[:-1]])
    count = int(row_events.sum())
    table = [np.full(max_events, -1, np.int32)] + [
        np.zeros(max_events, np.int32) for _ in range(3)] + [
        np.zeros(max_events, bool)]
    for row in range(n):
        place = int(offsets[row])
        ref_before = read_before = u32(0)
        for base in range(0, k, 32):
            if place >= max_events:
                break
            lane = np.arange(32)
            inside = base + lane < k
            word = np.where(inside, words[row, np.minimum(base + lane, k - 1)],
                            0).astype(np.int32)
            op = word & 0xF
            length = word >> 4
            ulen = length.astype(u32)
            match = (op == 0) | (op == 7) | (op == 8)
            ref_advance = np.where(inside & (match | (op == 2) | (op == 9)),
                                   ulen, u32(0))
            read_advance = np.where(
                inside & (match | (op == 1) | (op == 4) | (op == 10)), ulen,
                u32(0))
            ref_at = ref_before + np.cumsum(ref_advance, dtype=u32) \
                - ref_advance
            read_at = read_before + np.cumsum(read_advance, dtype=u32) \
                - read_advance
            event = inside & ((op == 1) | (op == 2)) & (length >= threshold)
            for offset, at_lane in enumerate(np.flatnonzero(event)):
                at = place + offset
                if at < max_events:
                    table[0][at] = row
                    table[1][at] = ref_at[at_lane].astype(np.int32)
                    table[2][at] = read_at[at_lane].astype(np.int32)
                    table[3][at] = length[at_lane]
                    table[4][at] = op[at_lane] == 1
            place += int(event.sum())
            ref_before += ref_advance.sum(dtype=u32)
            read_before += read_advance.sum(dtype=u32)
    return (tuple(geometry.astype(np.int32)) + (hard_any,) + tuple(table)
            + (np.int32(count),))


def test_the_collect_kernel_model_equals_the_plain_version():
    """Every seeded case of the smoke's phase 15 through the numpy model of
    the kernel and through collect_scan_plain; those with K <= 128 also
    through svim_tpu's jit program."""
    rng = np.random.default_rng(20261021)
    seen = []
    for label, words, starts, threshold, max_events, _shards in \
            SMOKE.collect_cases(rng):
        if words.shape[1] >= 2048:
            # the model walks a row's chunks in Python: keep the case's
            # first rows (the clip rows) and a few random ones
            words, starts = words[:14], starts[:14]
        want = to_host(cigar_kernel.collect_scan_plain(
            _t(words), _t(starts), threshold, max_events))
        got = _model_collect_scan(words, starts, threshold, max_events)
        for index, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg="{0}, output {1}"
                                          .format(label, index))
        if words.shape[1] <= 128:
            _assert_scan_equals_jax(words, starts, threshold, max_events)
        seen.append((label, int(want[10]) > max_events))
    assert ("overflowing table", True) in seen
    assert ("8 shards, shard 3 overflowing", True) in seen


def test_the_collect_cases_cover_the_clip_rules():
    """The smoke's clip rows reach every branch of _geometry: qa_start from
    leading soft clips, qa_end from trailing ones, clip-only rows (all soft
    clips leading), hard clips counted in read_len."""
    words = SMOKE._rows_of_ops(128, SMOKE.CLIP_ROWS)
    ref_end, read_len, qa_start, qa_end, hard = to_host(
        cigar_kernel.collect_scan_plain(
            _t(words), _t(np.zeros(len(words), np.int32)), 40, 1024))[:5]
    assert (qa_start[:3] == (20, 40, 0)).all()
    assert (qa_end[:3] == (20, 150, 100)).all()   # clip-only: nothing trails
    assert hard[0] and hard[1] and not hard[2]
    assert read_len[1] == 30 + 40 + 100 + 10 + 25 + 5
    assert ref_end[4] == 1000 + 500 + 60 + 7


def _overflowing_sam(tmp_path, rows=64, events=20):
    """A coordinate-sorted SAM whose reads carry `events` deletions each:
    64 x 20 events overflow the dispatch's first bound of 1024."""
    body = "".join("100M{0}D".format(50 + e) for e in range(events))
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chr1\tLN:5000000"]
    for row in range(rows):
        lines.append("r{0}\t0\tchr1\t{1}\t60\t{2}100M\t*\t0\t0\t*\t*".format(
            row, 1000 + 500 * row, body))
    path = tmp_path / "overflow.sam"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_dispatch_reruns_an_overflowing_bound_as_svim_tpu_does(tmp_path):
    sam = _overflowing_sam(tmp_path)
    arguments = ["alignment", str(tmp_path), sam, "g.fa"]
    jax_records = list(JaxAlignmentFile(sam).fetch(until_eof=True))
    jax_batch = jax_pack_alignments(jax_records, min_sv_size=40)
    jax_options = jax_parse_arguments(arguments=arguments)
    want = jax_packed.finish_collect_scan(
        jax_batch, jax_packed.dispatch_collect_scan(jax_batch, jax_options),
        jax_options)

    records = list(AlignmentFile(sam).fetch(until_eof=True))
    packed = pack_alignments(records, min_sv_size=40)
    options = parse_arguments(arguments=arguments)
    rerun, result, max_events = torch_packed.dispatch_collect_scan(
        packed, options, CPU)
    assert max_events == 1024 and int(result[10]) == 64 * 20 > max_events
    bounds = []

    def counted(bound):
        bounds.append(bound)
        return rerun(bound)

    got = torch_packed._consume_collect(packed, counted, max_events,
                                        to_host(result))
    assert bounds == [2048]
    assert len(got[0]) == 64 * 20
    for got_column, want_column in zip(got, want):
        np.testing.assert_array_equal(got_column, want_column)
    for column in ("ref_end", "read_len", "qa_start", "qa_end",
                   "has_hard_clip"):
        np.testing.assert_array_equal(getattr(packed, column),
                                      getattr(jax_batch, column))


@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("overflowing", [False, True])
def test_sharded_scan_merges_to_the_unsharded_scan(shards, overflowing):
    """The merge of per-shard tables by their counts equals the whole
    batch's scan, also when one shard alone overflows the bound."""
    rng = np.random.default_rng(shards)
    words = SMOKE._random_cigar_rows(rng, 256, 64)
    if overflowing:
        # every op of the rows of shard 1 (of 8) an event: 32 x 64 = 2048
        words[32:64] = np.where(np.arange(64) % 2 == 0, (100 << 4) | 2,
                                (60 << 4) | 1).astype(np.int32)[None, :]
    starts = rng.integers(0, 1_000_000, size=256).astype(np.int32)
    bound = 1024
    want = cigar_kernel.collect_scan(_t(words), _t(starts), 40, bound)
    got = mesh.collect_scan_sharded(shards, CPU, _t(words), _t(starts), 40,
                                    bound)
    assert (int(want[10]) > bound) == overflowing
    if overflowing and shards == 8:
        assert int(cigar_kernel.collect_scan(
            _t(words[32:64]), _t(starts[32:64]), 40, bound)[10]) > bound
    assert len(got) == len(want) == 11
    for index, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), index


def _jax_classify(inputs):
    arrays = [np.asarray(value) for value in inputs[:17]]
    scalars = [np.int32(value) for value in inputs[17:21]]
    return jax.device_get(jax_segments.classify_groups_fused(
        *arrays, *scalars, max_segments=inputs[21]))


@pytest.mark.parametrize("groups,slots", [(256, 2), (64, 64), (32, 128)])
def test_classify_plain_equals_jax(groups, slots):
    """Key ties, invalid slots in the middle, gated and padding groups,
    slots from packed rows; over 64 slots the first 64 sorted are kept."""
    inputs = SMOKE.classify_inputs(np.random.default_rng(slots), groups,
                                   slots)
    args, kwargs = SMOKE._classify_call(inputs)
    got = to_host(segments_kernel.classify_groups_fused(
        *[_t(value) if isinstance(value, np.ndarray) else value
          for value in args], **kwargs))
    want = _jax_classify(inputs)
    assert len(got) == len(want) == 12
    for index, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (groups, slots - 1), index
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(index))
    # padding groups give zeros; gated groups give no event
    assert not got[0][-2:].any() and not got[5][-2:].any()
    gated = (inputs[8] >= 0) & inputs[16][np.maximum(inputs[8], 0)]
    assert gated.any() and not got[0][gated].any()


def test_the_classify_cases_reach_every_code():
    """The seeded classify cases of the smoke's phase 15 reach every event
    code, twins and cross-contig pairs, and their ties are exact."""
    codes = set()
    twins = cross = ties = 0
    for _label, inputs in SMOKE.classify_cases(np.random.default_rng(3)):
        args, kwargs = SMOKE._classify_call(inputs)
        got = segments_kernel.classify_groups_fused(
            *[_t(value) if isinstance(value, np.ndarray) else value
              for value in args], **kwargs)
        codes |= set(got[0].unique().tolist())
        twins += int(got[6].sum())
        cross += int(((got[0] == 5) & (got[4] != got[11])).sum())
        q_start, q_end, valid = inputs[1], inputs[2], inputs[7]
        for g in range(len(valid)):
            keys = list(zip(q_start[g][valid[g]], q_end[g][valid[g]]))
            ties += len(keys) - len(set(keys))
    assert codes == {0, 1, 2, 3, 4, 5}
    assert twins and cross and ties


def _rank_sort(start, end, valid):
    """numpy model of the kernel's sort: slot i goes to the number of slots
    whose key (q_start, q_end) is smaller, or equal at a lower index, with
    invalid slots keyed INT32_MAX in both."""
    big = np.int32(2**31 - 1)
    key_start = np.where(valid, start, big).astype(np.int64)
    key_end = np.where(valid, end, big).astype(np.int64)
    index = np.arange(len(start))
    before = ((key_start[None, :] < key_start[:, None])
              | ((key_start[None, :] == key_start[:, None])
                 & ((key_end[None, :] < key_end[:, None])
                    | ((key_end[None, :] == key_end[:, None])
                       & (index[None, :] < index[:, None])))))
    rank = before.sum(axis=1)
    order = np.empty_like(rank)
    order[rank] = index
    return order


@pytest.mark.parametrize("slots", [2, 7, 64, 128, 300])
def test_rank_sort_equals_two_stable_argsorts(slots):
    """The kernel's rank sort is the permutation of the plain version's two
    stable argsorts (q_end first, then q_start), ties and invalid slots
    included, and of svim_tpu's jnp.argsort pair."""
    rng = np.random.default_rng(slots)
    for _ in range(20):
        start = rng.integers(0, 6, slots).astype(np.int32) * 100
        end = start + rng.integers(0, 4, slots).astype(np.int32) * 100
        valid = rng.random(slots) < 0.8
        big = np.int32(2**31 - 1)
        first = np.argsort(np.where(valid, end, big), kind="stable")
        second = np.argsort(np.where(valid, start, big)[first],
                            kind="stable")
        torch_perm1 = torch.argsort(_t(np.where(valid, end, big)),
                                    stable=True)
        torch_perm2 = torch.argsort(_t(np.where(valid, start, big))[
            torch_perm1], stable=True)
        model = _rank_sort(start, end, valid)
        np.testing.assert_array_equal(model, first[second])
        np.testing.assert_array_equal(model, torch_perm1[torch_perm2].numpy())


class _OnCard:
    """What the wrappers read of a tensor before they launch, for a tensor
    that claims to lie on a card (there is none here)."""

    def __init__(self, tensor):
        self.device = torch.device("cuda", 0)
        self.dtype = tensor.dtype
        self.shape = tensor.shape

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def to(self, dtype):
        cast = _OnCard(self)
        cast.dtype = dtype
        return cast


def test_cpu_tensors_never_build_and_a_failed_build_raises(monkeypatch):
    """The dispatchers take the plain versions for CPU tensors without
    touching the build; for CUDA tensors they go to the kernels, and a
    failing build reaches the caller without a plain fallback."""
    def broken(name):
        raise RuntimeError("nvcc failed for {0}.cu".format(name))

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(cigar_kernel, "_library", None)
    monkeypatch.setattr(segments_kernel, "_library", None)
    words, rng = _words(5, 8, 32)
    starts = np.zeros(len(words), np.int32)
    scan = cigar_kernel.collect_scan(_t(words), _t(starts), 40, 1024)
    inputs = SMOKE.classify_inputs(rng, 16, 4)
    args, kwargs = SMOKE._classify_call(inputs)
    args = [_t(value) if isinstance(value, np.ndarray) else value
            for value in args]
    segments_kernel.classify_groups_fused(*args, **kwargs)
    assert int(scan[10]) > 0

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(cigar_kernel, "collect_scan_plain", no_plain)
    monkeypatch.setattr(segments_kernel, "classify_groups_fused_plain",
                        no_plain)
    launches = (cigar_kernel.LAUNCHES, segments_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed for collect_scan.cu"):
        cigar_kernel.collect_scan(_OnCard(_t(words)), _OnCard(_t(starts)),
                                  40, 1024)
    with pytest.raises(RuntimeError,
                       match="nvcc failed for classify_segments.cu"):
        segments_kernel.classify_groups_fused(
            *[_OnCard(value) if isinstance(value, torch.Tensor) else value
              for value in args], **kwargs)
    assert (cigar_kernel.LAUNCHES, segments_kernel.LAUNCHES) == launches
    meta = torch.empty((2, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no collect_scan kernel"):
        cigar_kernel.collect_scan(meta, meta[:, 0], 40, 1024)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cigar_kernel.collect_scan_cuda(_t(words), _t(starts), 40, 1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_the_plain_versions(cuda_device):
    """The smoke's seeded cases through both kernels on the card: bit-equal
    to the plain versions there (chip_smoke.py phase 15 runs these and the
    main path's own calls)."""
    rng = np.random.default_rng(20261021)
    for label, words, starts, threshold, max_events, _shards in \
            SMOKE.collect_cases(rng):
        tensors = (_t(words).to(cuda_device), _t(starts).to(cuda_device))
        got = cigar_kernel.collect_scan_cuda(*tensors, threshold, max_events)
        want = cigar_kernel.collect_scan_plain(*tensors, threshold,
                                               max_events)
        for a, b in zip(got, want):
            assert torch.equal(a, b), label
    for label, inputs in SMOKE.classify_cases(rng):
        args, kwargs = SMOKE._classify_call(inputs)
        args = [_t(value).to(cuda_device) if isinstance(value, np.ndarray)
                else value for value in args]
        got = segments_kernel.classify_groups_fused_cuda(*args, **kwargs)
        want = segments_kernel.classify_groups_fused_plain(*args, **kwargs)
        for a, b in zip(got, want):
            assert torch.equal(a, b), label
