"""COLLECT's two device passes in svim_tpu_torch against svim_tpu's, on the
CPU: the event-bounded CIGAR scan (collect_scan_plain at svim_tpu's
max_events, the dispatch's re-run on overflow, the 8-shard merge), the
split-read classify (classify_groups_fused_plain), numpy models of the two
CUDA kernels' algorithms (csrc/collect_scan.cu: a grid of CTAs over blocks
of rows, staged or re-read, a team a row over runs of consecutive ops (a
warp up to 1024 ops, 128 threads to 4096, 256 above), CTA totals summed
after the barrier, the fill cut across the CTAs;
csrc/classify_segments.cu: the rank sort of the CTA route and the
segmented warp route), and the dispatchers (CPU tensors never build; a
failing build raises, nothing falls back).

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


U32 = np.uint32
THREADS = 1024          # csrc/collect_scan.cu kThreads: rows a chunk
STAGE_WORDS = 51200     # kStageBytes / 4, the padding included


def _team_size(k):
    """Threads a row (csrc/collect_scan.cu team_size): a warp up to K =
    1024 (kWarpK), 128 up to 4096 (kMidK), 256 above."""
    return 32 if k <= 1024 else 128 if k <= 4096 else 256


def _decoded(words, threshold):
    """What each word adds (csrc/collect_scan.cu `decode`), as uint32 and
    bool arrays of the words' shape; a padding word 0 adds nothing."""
    words = np.asarray(words, dtype=np.int32)
    op = words & 0xF
    length = words >> 4
    ulen = length.astype(U32)
    zero = U32(0)
    match = (op == 0) | (op == 7) | (op == 8)
    soft = (op == 4) & (length > 0)
    hard = (op == 5) & (length > 0)
    ref_advance = np.where(match | (op == 2) | (op == 9), ulen, zero)
    return {
        "ref": ref_advance + np.where(op == 3, ulen, zero),
        "ref_advance": ref_advance,
        "query": np.where(match | (op == 1) | (op == 4) | (op == 10), ulen,
                          zero),
        "hard": np.where(hard, ulen, zero), "hard_clip": hard,
        "soft": np.where(soft, ulen, zero), "length": length,
        "nonclip": ~(soft | (op == 5) | (length == 0)),
        "event": ((op == 1) | (op == 2)) & (length >= threshold),
        "insertion": op == 1}


def _runs(row_words, team):
    """The row cut into `team` runs of consecutive ops, padded with 0:
    (team, length) words, and the run length."""
    k = len(row_words)
    length = -(-k // team)
    padded = np.zeros(team * length, np.int32)
    padded[:k] = row_words
    return padded.reshape(team, length), length


def _team_row_counts(row_words, threshold, team):
    """A team a row: a thread's sums over its run, team sums, the first and
    last non-clip op as a min and a max over the runs, then the soft clips
    of the runs before (after) the run that holds it plus those before
    (after) it in that run.  Returns (ref sum, query sum, hard sum, leading
    soft, trailing soft, any hard, events)."""
    runs, length = _runs(row_words, team)
    w = _decoded(runs, threshold)
    nonclip = w["nonclip"]
    has = nonclip.any(axis=1)
    first = np.where(has, np.argmax(nonclip, axis=1), 0) \
        + np.arange(team) * length
    last = np.where(has, runs.shape[1] - 1 - np.argmax(nonclip[:, ::-1],
                                                       axis=1), 0) \
        + np.arange(team) * length
    k = len(row_words)
    row_first = first[has].min() if has.any() else k
    row_last = last[has].max() if has.any() else -1
    soft = w["soft"]
    before = np.where(np.cumsum(nonclip, axis=1) == 0, soft, U32(0)).sum(
        axis=1, dtype=U32)
    after = np.where(np.cumsum(nonclip[:, ::-1], axis=1)[:, ::-1] == 0, soft,
                     U32(0)).sum(axis=1, dtype=U32)
    total = soft.sum(axis=1, dtype=U32)
    rank = np.arange(team)
    first_run = team if row_first == k else row_first // length
    last_run = team if row_last < 0 else row_last // length
    leading = np.where(rank < first_run, total,
                       np.where(rank == first_run, before, U32(0))).sum(
        dtype=U32)
    trailing = np.where(rank > last_run, total,
                        np.where(rank == last_run, after, U32(0))).sum(
        dtype=U32)
    return (w["ref"].sum(dtype=U32), w["query"].sum(dtype=U32),
            w["hard"].sum(dtype=U32), leading, trailing,
            bool(w["hard_clip"].any()), int(w["event"].sum()))


def _team_row_events(row_words, threshold, place, max_events, team):
    """A team a row: a team exclusive scan of the runs' event counts; each
    thread walks its run from its place.  Yields (table index, op index)."""
    runs, length = _runs(row_words, team)
    events = _decoded(runs, threshold)["event"]
    counts = events.sum(axis=1)
    starts = place + np.concatenate([[0], np.cumsum(counts)[:-1]])
    for thread in np.flatnonzero(counts):
        at = int(starts[thread])
        for column in np.flatnonzero(events[thread]):
            if at >= max_events:
                break
            yield at, thread * length + column
            at += 1


def _places(counts, carry):
    """A chunk's rows' places: `carry` plus their exclusive prefix, None for
    a row without events."""
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return [None if count == 0 else carry + int(offset)
            for count, offset in zip(counts, offsets)]


def _model_collect_scan(words, starts, threshold, max_events, ctas=132,
                        stage_words=STAGE_WORDS, chunk_rows=THREADS,
                        trace=None):
    """numpy model of csrc/collect_scan.cu: `ctas` CTAs, each a contiguous
    block of rows whose first rows are staged when a warp takes a row (32
    words of every 36 of `stage_words`; wider teams copy each row when they
    take it, which gives the same words); phase A a team a row
    (_team_size) over runs of
    consecutive ops, the first `chunk_rows`
    rows' places relative to the CTA worked out before the barrier and the
    later rows' counts kept in scratch, each CTA's total; after the barrier
    a CTA's first place is the sum of the totals before it; phase B the
    later rows' counts scanned in chunks of `chunk_rows`, the events written
    a team a row; the fill cut across the CTAs.  Every table entry must be
    written exactly once.  `trace`, a dict, receives the rows staged and
    re-read.  uint32 sums."""
    n, k = words.shape
    ctas = min(ctas, n) if n else 0
    team = _team_size(k)
    geometry = np.zeros((4, n), dtype=U32)
    hard_any = np.zeros(n, dtype=bool)
    row_events = np.zeros(n, dtype=np.int64)
    blocks = [(b * n // ctas, (b + 1) * n // ctas) for b in range(ctas)]
    staged = np.zeros(n, dtype=bool)
    totals, first_places = [], []
    for first, end in blocks:   # phase A
        rows = end - first
        capacity = stage_words // 36 * 32   # only warps stage rows
        staged[first:first + (min(rows, capacity // k)
                              if k and team == 32 else 0)] = True
        for row in range(first, end):
            ref, query, hard, leading, trailing, any_hard, events = \
                _team_row_counts(words[row], threshold, team)
            geometry[:, row] = (U32(starts[row]) + ref, query + hard,
                                leading, query - trailing)
            hard_any[row] = any_hard
            row_events[row] = events
        # the first chunk's places relative to the CTA's first
        first_places.append(_places(
            row_events[first:min(end, first + chunk_rows)], 0))
        totals.append(int(row_events[first:end].sum()))
    count = sum(totals)   # the barrier: every total is written
    kept = min(count, max_events)
    table = [np.full(max_events, -1, np.int32)] + [
        np.zeros(max_events, np.int32) for _ in range(3)] + [
        np.zeros(max_events, bool)]
    written = np.zeros(max_events, dtype=np.int64)
    for b, (first, end) in enumerate(blocks):   # phase B
        carry = sum(totals[:b])
        for i in range(kept + b * THREADS, max_events, ctas * THREADS):
            written[i:i + THREADS] += 1   # the fill (the table starts so)
        for chunk in range(first, end, chunk_rows):
            if carry >= max_events:
                break
            counts = row_events[chunk:min(end, chunk + chunk_rows)]
            places = [None if place is None else carry + place
                      for place in first_places[b]] if chunk == first \
                else _places(counts, carry)
            for row, place in zip(range(chunk, end), places):
                if place is None or place >= max_events:
                    continue
                w = _decoded(words[row], threshold)
                ref_at = np.cumsum(w["ref_advance"], dtype=U32) \
                    - w["ref_advance"]
                read_at = np.cumsum(w["query"], dtype=U32) - w["query"]
                for at, op_index in _team_row_events(
                        words[row], threshold, place, max_events, team):
                    written[at] += 1
                    table[0][at] = row
                    table[1][at] = ref_at[op_index].astype(np.int32)
                    table[2][at] = read_at[op_index].astype(np.int32)
                    table[3][at] = w["length"][op_index]
                    table[4][at] = w["insertion"][op_index]
            carry += int(counts.sum())
    assert (written == 1).all(), "table entries written {0} times".format(
        sorted(set(written.tolist())))
    if trace is not None:
        trace["staged"] = int(staged.sum())
        trace["re-read"] = int((~staged).sum())
    return (tuple(geometry.astype(np.int32)) + (hard_any,) + tuple(table)
            + (np.int32(count),))


def _model_sized(words, starts):
    """A seeded case cut to what the model walks in Python in a moment: its
    first 14 rows (the clip rows and a few random ones) at K >= 2048, its
    first 600 rows of a batch larger than 4,096."""
    if words.shape[1] >= 2048:
        return words[:14], starts[:14]
    if words.shape[0] > 4096:
        return words[:600], starts[:600]
    return words, starts


def test_the_collect_kernel_model_equals_the_plain_version():
    """Every seeded case of the smoke's phase 15 through the numpy model of
    the kernel and through collect_scan_plain; those with K <= 128 also
    through svim_tpu's jit program."""
    rng = np.random.default_rng(20261021)
    seen = []
    for label, words, starts, threshold, max_events, _shards in \
            SMOKE.collect_cases(rng):
        words, starts = _model_sized(words, starts)
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


GRIDS = {"1 CTA": (1, STAGE_WORDS, THREADS),
         "1 CTA, chunks of 64 rows": (1, STAGE_WORDS, 64),
         "7 CTAs": (7, STAGE_WORDS, THREADS),
         "132 CTAs": (132, STAGE_WORDS, THREADS),
         "a CTA a row": (None, STAGE_WORDS, THREADS),
         "7 CTAs, 512 words staged": (7, 512, THREADS)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_the_collect_kernel_model_at_several_grids(grid):
    """The kernel's model at several grid sizes, staging budgets and chunk
    sizes (a CTA a row: as many CTAs as rows; chunks of 64 rows: the rows
    past a CTA's first chunk placed after the barrier) on the smoke's seeded
    cases, bit for bit against collect_scan_plain and, at K <= 128,
    svim_tpu's jit program; the small budget re-reads rows at every team
    size."""
    ctas, stage_words, chunk_rows = GRIDS[grid]
    rng = np.random.default_rng(20261021)
    trace, re_read = {}, []
    for label, words, starts, threshold, max_events, _shards in \
            SMOKE.collect_cases(rng):
        words, starts = _model_sized(words, starts)
        want = to_host(cigar_kernel.collect_scan_plain(
            _t(words), _t(starts), threshold, max_events))
        got = _model_collect_scan(words, starts, threshold, max_events,
                                  ctas=ctas or len(words),
                                  stage_words=stage_words,
                                  chunk_rows=chunk_rows, trace=trace)
        for index, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg="{0}, output {1}"
                                          .format(label, index))
        if words.shape[1] <= 128:
            _assert_scan_equals_jax(words, starts, threshold, max_events)
        if trace["re-read"]:
            re_read.append(words.shape[1])
    if stage_words == 512:
        assert {_team_size(k) for k in re_read} == {32, 128, 256}


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


@pytest.mark.parametrize("groups,slots", [(256, 2), (64, 64), (32, 128),
                                          (512, 8), (97, 7), (128, 32)])
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


def _warp_rank_sort(start, end, valid):
    """numpy model of the classify kernel's warp route (S <= 32): a warp of
    32 lanes takes 32 // S groups, lane = segment * S + slot; a lane's rank
    is counted over S shuffles of its segment's keys (invalid slots keyed
    INT32_MAX, ties to the lower slot); the lane at sorted place i takes
    the slot whose rank is i (S more shuffles); the lane of pair i takes
    its next segment from lane + 1.  Lanes past the warp's last whole
    segment and those of groups past G run every shuffle and write nothing.
    Returns ((G, S) slot at each sorted place, (G, S - 1) slot of each
    pair's next segment)."""
    groups, slots = start.shape
    per_warp = 32 // slots
    big = np.int64(2**31 - 1)
    order = np.full((groups, slots), -1)
    following = np.full((groups, slots - 1), -1)
    lane = np.arange(32)
    segment = lane // slots
    slot = lane - segment * slots
    first_lane = segment * slots
    for warp in range(-(-groups // per_warp)):
        group = warp * per_warp + segment
        active = (segment < per_warp) & (group < groups)
        row = np.where(active, group, 0)
        mine = active & valid[row, slot]
        key_start = np.where(mine, start[row, slot], big)
        key_end = np.where(mine, end[row, slot], big)
        rank = np.zeros(32, dtype=np.int64)
        for j in range(slots):
            source = (first_lane + j) % 32   # __shfl_sync wraps the lane
            other_start, other_end = key_start[source], key_end[source]
            rank += ((other_start < key_start)
                     | ((other_start == key_start)
                        & ((other_end < key_end)
                           | ((other_end == key_end) & (j < slot)))))
        held = np.zeros(32, dtype=np.int64)
        for j in range(slots):
            held = np.where(rank[(first_lane + j) % 32] == slot, j, held)
        after = held[(lane + 1) % 32]
        for at in np.flatnonzero(active):
            order[group[at], slot[at]] = held[at]
            if slot[at] < slots - 1:
                following[group[at], slot[at]] = after[at]
    return order, following


@pytest.mark.parametrize("slots", [2, 3, 4, 5, 7, 8, 16, 32])
def test_warp_route_sort_equals_two_stable_argsorts(slots):
    """The warp route's segmented rank sort gives each group the
    permutation of the two stable argsorts (ties on a 100-base grid,
    invalid slots in the middle, padding groups with no valid slot, G no
    multiple of the groups a warp), and each pair the next sorted slot."""
    rng = np.random.default_rng(100 + slots)
    groups = 3 * (32 // slots) + 5
    start = rng.integers(0, 6, (groups, slots)).astype(np.int32) * 100
    end = start + rng.integers(0, 4, (groups, slots)).astype(np.int32) * 100
    valid = rng.random((groups, slots)) < 0.8
    valid[-2:] = False
    order, following = _warp_rank_sort(start, end, valid)
    big = np.int32(2**31 - 1)
    for g in range(groups):
        first = np.argsort(np.where(valid[g], end[g], big), kind="stable")
        second = np.argsort(np.where(valid[g], start[g], big)[first],
                            kind="stable")
        np.testing.assert_array_equal(order[g], first[second])
        np.testing.assert_array_equal(order[g], _rank_sort(
            start[g], end[g], valid[g]))
        np.testing.assert_array_equal(following[g], order[g][1:])
    assert not (order < 0).any()


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
