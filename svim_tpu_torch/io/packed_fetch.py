"""Region queries over a PackedAlignments batch.

Gives the genotyper (svim_tpu_torch.genotype) the same fetch surface as an
AlignmentFile without re-parsing the BAM: per-contig coordinate indexes are
built once from the packed columns, and fetches yield lightweight row views.
Replaces pysam's .bai-backed random access (reference: SVIM_genotyping.py:49).
"""

from __future__ import annotations

import numpy as np

FSECONDARY = 0x100
FUNMAP = 0x4


class _RowView:
    """The slice of an alignment row the genotyper consumes."""

    __slots__ = ("query_name", "mapping_quality", "reference_start", "reference_end")
    is_unmapped = False   # packed batches contain mapped, non-secondary rows only
    is_secondary = False

    def __init__(self, query_name, mapping_quality, reference_start, reference_end):
        self.query_name = query_name
        self.mapping_quality = mapping_quality
        self.reference_start = reference_start
        self.reference_end = reference_end


class PackedAlignmentIndex:
    """Coordinate index over packed rows, fetch-compatible with the
    genotyper."""

    def __init__(self, packed, header):
        self.packed = packed
        self.header = header
        self._by_tid = {}
        self._names_cache = {}
        ref_id = np.asarray(packed.ref_id)
        starts = np.asarray(packed.ref_start, dtype=np.int64)
        ends = np.asarray(packed.ref_end, dtype=np.int64)
        for tid in np.unique(ref_id):
            if tid < 0:
                continue
            rows = np.nonzero(ref_id == tid)[0]
            order = np.lexsort((rows, starts[rows]))
            rows = rows[order]
            self._by_tid[int(tid)] = (starts[rows], ends[rows], rows)

    @property
    def references(self):
        return self.header.references

    @property
    def lengths(self):
        return self.header.lengths

    def get_reference_length(self, contig):
        tid = self.header.get_tid(contig)
        if tid < 0:
            raise KeyError(contig)
        return self.header.lengths[tid]

    def _name(self, row):
        name = self._names_cache.get(row)
        if name is None:
            name = self.packed.names[row]
            self._names_cache[row] = name
        return name

    def fetch(self, contig=None, start=None, stop=None):
        tid = self.header.get_tid(contig)
        entry = self._by_tid.get(tid)
        if entry is None:
            return iter(())
        starts, ends, rows = entry
        start = 0 if start is None else start
        stop = np.iinfo(np.int64).max if stop is None else stop
        hi = np.searchsorted(starts, stop, side="left")
        mapq = self.packed.mapq

        def row_iter():
            for position in range(hi):
                if ends[position] > start:
                    row = int(rows[position])
                    yield _RowView(self._name(row), int(mapq[row]),
                                   int(starts[position]), int(ends[position]))
        return row_iter()
