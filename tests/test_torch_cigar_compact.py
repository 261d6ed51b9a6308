"""Twin of tests/test_cigar_compact.py for the port's
io/packing.py::compact_cigar_row: on the same seeded CIGARs it returns
svim_tpu's words (or None where svim_tpu's does), the port's native batch
compaction gives the Python rows, and the port's COLLECT scan
(ops.cigar_kernel.collect_scan: the plain version on the CPU) gives the
same geometry and events, in order, over raw and compacted encodings, and
svim_tpu's jit program's outputs on the raw ones.  The kernel itself on
such rows is held by tests/test_torch_collect_kernel.py and chip_smoke.py
phase 15.  Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from svim_tpu.io.packing import compact_cigar_row as jax_compact_cigar_row
from svim_tpu_torch import native
from svim_tpu_torch.io.packing import bucket_size, compact_cigar_row
from svim_tpu_torch.ops.cigar_kernel import collect_scan
from tests.test_cigar_compact import (
    THRESHOLD,
    _batch,
    _random_cigar,
    _run_kernels,
    _words,
)


def _scan(words_batch, ref_start):
    outputs = collect_scan(torch.from_numpy(words_batch),
                           torch.from_numpy(ref_start), THRESHOLD, 1024)
    return [np.asarray(part) for part in outputs]


def _same_outputs(got, want):
    """Geometry columns equal; events equal in count, rows, positions,
    lengths, kinds and order."""
    for got_column, want_column in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(got_column, want_column)
    count = int(want[10])
    assert int(got[10]) == count
    for got_column, want_column in zip(got[5:10], want[5:10]):
        np.testing.assert_array_equal(got_column[:count],
                                      want_column[:count])


def test_rows_equal_svim_tpu_and_scan_outputs_on_a_compacted_batch():
    rng = random.Random(1234)
    raw_rows = [_words(_random_cigar(rng)) for _ in range(200)]
    compact_rows = []
    shrunk = 0
    for row in raw_rows:
        compacted = compact_cigar_row(row, THRESHOLD)
        assert compacted == jax_compact_cigar_row(row, THRESHOLD)
        if compacted is not None:
            shrunk += 1
        compact_rows.append(row if compacted is None else compacted)
    assert shrunk > 100

    ref_start = np.arange(200, dtype=np.int32) * 1000
    raw = _scan(_batch(raw_rows), ref_start)
    _same_outputs(_scan(_batch(compact_rows), ref_start), raw)
    _same_outputs(raw, _run_kernels(_batch(raw_rows), ref_start))


def test_native_matches_python_reference():
    rng = random.Random(99)
    rows, offsets, counts, flat = [], [], [], []
    position = 0
    for _ in range(500):
        row = _words(_random_cigar(rng))
        rows.append(row)
        offsets.append(position * 4)
        counts.append(len(row))
        flat.extend(row)
        position += len(row)
    buffer = np.asarray(flat, dtype=np.uint32).tobytes()
    batch = native.cigar_compact_rows(buffer, offsets, counts, THRESHOLD,
                                      bucket_size)
    assert batch is not None
    for index, row in enumerate(rows):
        compacted = compact_cigar_row(row, THRESHOLD)
        expected = [word for word in (row if compacted is None
                                      else compacted) if word != 0]
        assert [int(word) for word in batch[index] if word != 0] \
            == expected, index


def test_a_long_read_compacts_to_its_events():
    """tests/test_cigar_compact.py's 2,048-op read with two SV events,
    through compact_cigar_row: the events stay, the noise folds away."""
    row = []
    for _ in range(1000):
        row.append((0, 30))
        row.append((2, 5))
    row.insert(500, (2, 500))
    row.insert(1500, (1, 200))
    words = _words(row)
    compacted = compact_cigar_row(words, THRESHOLD)
    assert compacted == jax_compact_cigar_row(words, THRESHOLD)
    assert bucket_size(len(compacted)) == 32
    ops = [word & 0xF for word in compacted]
    assert ops.count(2) == 1 and ops.count(1) == 1
    ref_start = np.zeros(1, dtype=np.int32)
    _same_outputs(_scan(_batch([compacted]), ref_start),
                  _scan(_batch([words]), ref_start))


@pytest.mark.parametrize("words", [
    _words([(4, 10), (6, 5), (0, 100), (0, 0), (4, 7), (2, 80), (3, 30),
            (0, 50), (4, 20)])], ids=["zero_and_padding_ops"])
def test_zero_and_padding_ops_preserved(words):
    compacted = compact_cigar_row(words, THRESHOLD)
    assert compacted == jax_compact_cigar_row(words, THRESHOLD)
    ref_start = np.zeros(1, dtype=np.int32)
    raw = _scan(_batch([words]), ref_start)
    _same_outputs(_scan(_batch([words if compacted is None else compacted]),
                        ref_start), raw)
    _same_outputs(raw, _run_kernels(_batch([words]), ref_start))
