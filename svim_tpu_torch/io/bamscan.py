"""Packed batches for the port's device passes.

Counterpart of svim_tpu/io/bamscan.py: the lazy name and sequence columns
over a scanned buffer (LazyStrings, LazySequences) and build_packed, the
same PackedAlignments batch, but nothing is copied to a device here.  The
device columns (int32 CIGAR words in BAM encoding, alignment starts,
contig ids, strands) are uploaded by the first pass that needs them
(collect.packed._device_columns), on the thread that runs the kernels: the
streaming scanner builds batches on a prefetch thread.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from svim_tpu_torch.io.packing import PackedAlignments

_SEQ_CODES = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
# 256 -> two decoded bases per packed byte
_NIBBLE_HI = _SEQ_CODES[np.arange(256) >> 4]
_NIBBLE_LO = _SEQ_CODES[np.arange(256) & 0xF]


class LazySequences:
    """Per-row on-demand decoding of 4-bit packed BAM sequences."""

    def __init__(self, data: bytes, seq_offsets: np.ndarray, seq_lengths: np.ndarray):
        self._data = data
        self._offsets = seq_offsets
        self._lengths = seq_lengths

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, row: int) -> Optional[str]:
        length = int(self._lengths[row])
        if length == 0:
            return None
        return self.slice(row, 0, length)

    def slice(self, row: int, start: int, end: int) -> str:
        """Decode only bases [start, end) of a row — insertion events touch a
        tiny window of a long read, so whole-read decoding is wasted work."""
        length = int(self._lengths[row])
        start = max(0, min(start, length))
        end = max(start, min(end, length))
        if start >= end:
            return ""
        offset = int(self._offsets[row])
        first_byte = start // 2
        last_byte = (end + 1) // 2
        packed = np.frombuffer(self._data, dtype=np.uint8,
                               count=last_byte - first_byte,
                               offset=offset + first_byte)
        out = np.empty(2 * len(packed), dtype=np.uint8)
        out[0::2] = _NIBBLE_HI[packed]
        out[1::2] = _NIBBLE_LO[packed]
        return out[start - 2 * first_byte:end - 2 * first_byte].tobytes().decode()

    def slice_batch(self, rows, starts, ends):
        """Decode many windows in one vectorized pass (ragged gather + one
        nibble expansion); per-call numpy overhead dominates tiny per-event
        decodes, so batching is ~20x cheaper than repeated slice()."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return []
        lengths = np.asarray(self._lengths, dtype=np.int64)[rows]
        starts = np.clip(np.asarray(starts, dtype=np.int64), 0, lengths)
        ends = np.clip(np.asarray(ends, dtype=np.int64), starts, lengths)
        offsets = np.asarray(self._offsets, dtype=np.int64)[rows]
        first_byte = starts >> 1
        nbytes = ((ends + 1) >> 1) - first_byte
        out_off = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(nbytes, out=out_off[1:])
        total = int(out_off[-1])
        if total == 0:
            return [""] * len(rows)
        gather = (np.arange(total, dtype=np.int64)
                  - np.repeat(out_off[:-1], nbytes)
                  + np.repeat(offsets + first_byte, nbytes))
        packed = np.frombuffer(self._data, dtype=np.uint8)[gather]
        chars = np.empty(2 * total, dtype=np.uint8)
        chars[0::2] = _NIBBLE_HI[packed]
        chars[1::2] = _NIBBLE_LO[packed]
        decoded = chars.tobytes().decode()
        char_start = (2 * out_off[:-1] + (starts - 2 * first_byte)).tolist()
        spans = (ends - starts).tolist()
        return [decoded[o:o + n] for o, n in zip(char_start, spans)]


class LazyStrings:
    """Per-row on-demand decoding of byte ranges (read names, SA tags)."""

    def __init__(self, data: bytes, offsets, lengths, none_when_negative=False):
        self._data = data
        self._offsets = offsets
        self._lengths = lengths
        self._none_when_negative = none_when_negative

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, row: int):
        offset = int(self._offsets[row])
        if self._none_when_negative and offset < 0:
            return None
        return self._data[offset:offset + int(self._lengths[row])].decode()

    def present_rows(self):
        """Rows with a value (negative offset = absent) — lets consumers skip
        the per-row lookup over mostly-empty columns like SA tags."""
        return np.nonzero(np.asarray(self._offsets) >= 0)[0]

    def take(self, rows):
        """Decode many rows in one vectorized pass (ragged gather + a single
        bytes decode) — much cheaper than per-row __getitem__ for hot loops
        touching thousands of read names."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return []
        offsets = np.asarray(self._offsets, dtype=np.int64)[rows]
        lengths = np.asarray(self._lengths, dtype=np.int64)[rows]
        if self._none_when_negative and (offsets < 0).any():
            # mixed presence: fall back to scalar decodes for clarity
            return [self[int(row)] for row in rows.tolist()]
        out_off = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lengths, out=out_off[1:])
        total = int(out_off[-1])
        if total == 0:
            return [""] * len(rows)
        gather = (np.arange(total, dtype=np.int64)
                  - np.repeat(out_off[:-1], lengths)
                  + np.repeat(offsets, lengths))
        decoded = np.frombuffer(self._data, dtype=np.uint8)[gather].tobytes().decode()
        bounds = out_off.tolist()
        return [decoded[bounds[k]:bounds[k + 1]] for k in range(len(rows))]


def build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                 sequences) -> PackedAlignments:
    """Assemble a PackedAlignments batch.  Geometry columns (ref_end, qa
    bounds, ...) are filled by the fused COLLECT pass on first use."""
    return PackedAlignments(
        n=len(names), ref_id=ref_id, ref_start=ref_start, ref_end=None,
        mapq=mapq, flag=flag, qa_start=None, qa_end=None,
        read_len=None, cigar_words=cigar_words,
        names=names, sequences=sequences, records=None)
