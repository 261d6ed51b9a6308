"""SAM/BAM alignment records and file access.

From-scratch replacement for the pysam surface the reference consumes
(pysam.AlignmentFile / AlignedSegment; see SVIM_COLLECT.py, SVIM_genotyping.py).
SAM is parsed as text; BAM is decoded from BGZF via svim_tpu_torch.io.bam (with an
optional native C++ fast path).  Region fetches are served from an in-memory
coordinate table, so no .bai index is required.
"""

from __future__ import annotations

import gzip
import logging
from typing import Dict, Iterator, List, Optional, Tuple

from svim_tpu_torch.io import cigar as _cigar

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800


class AlignmentHeader:
    """Minimal SAM header model: HD fields + reference dictionary."""

    def __init__(self, hd: Dict[str, str], references: List[str], lengths: List[int],
                 text: str = ""):
        self.hd = hd
        self.references = tuple(references)
        self.lengths = tuple(lengths)
        self.text = text
        self._tid = {name: i for i, name in enumerate(references)}

    def __getitem__(self, key):
        if key == "HD":
            if not self.hd:
                raise KeyError("HD")
            return self.hd
        raise KeyError(key)

    def get_tid(self, name: str) -> int:
        return self._tid.get(name, -1)

    def get_reference_name(self, tid: int) -> Optional[str]:
        if 0 <= tid < len(self.references):
            return self.references[tid]
        return None

    @property
    def sort_order(self) -> Optional[str]:
        return self.hd.get("SO")

    @classmethod
    def from_text(cls, text: str) -> "AlignmentHeader":
        hd: Dict[str, str] = {}
        references: List[str] = []
        lengths: List[int] = []
        for line in text.splitlines():
            if line.startswith("@HD"):
                for field in line.split("\t")[1:]:
                    if ":" in field:
                        key, _, value = field.partition(":")
                        hd[key] = value
            elif line.startswith("@SQ"):
                name, length = None, None
                for field in line.split("\t")[1:]:
                    if field.startswith("SN:"):
                        name = field[3:]
                    elif field.startswith("LN:"):
                        length = int(field[3:])
                if name is not None:
                    references.append(name)
                    lengths.append(length if length is not None else 0)
        return cls(hd, references, lengths, text)


class AlignmentRecord:
    """One alignment, with the pysam.AlignedSegment accessor surface the
    pipeline uses (coordinates 0-based, like BAM in memory)."""

    __slots__ = ("query_name", "flag", "reference_id", "reference_start",
                 "mapping_quality", "_cigartuples", "_derived",
                 "query_sequence",
                 "query_qualities", "next_reference_id", "next_reference_start",
                 "template_length", "tags")

    def __init__(self, query_name="", flag=0, reference_id=-1, reference_start=-1,
                 mapping_quality=0, cigartuples=None, query_sequence=None,
                 query_qualities=None, next_reference_id=-1, next_reference_start=-1,
                 template_length=0, tags=None):
        self.query_name = query_name
        self.flag = flag
        self.reference_id = reference_id
        self.reference_start = reference_start
        self.mapping_quality = mapping_quality
        self._cigartuples = cigartuples
        self._derived = None
        self.query_sequence = query_sequence
        self.query_qualities = query_qualities
        self.next_reference_id = next_reference_id
        self.next_reference_start = next_reference_start
        self.template_length = template_length
        self.tags = tags if tags is not None else {}

    # -- flags ---------------------------------------------------------------------

    @property
    def is_unmapped(self):
        return bool(self.flag & FUNMAP)

    @property
    def is_secondary(self):
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)

    # -- cigar-derived geometry ----------------------------------------------------
    # pysam serves these accessors from C per call; here one cached pass
    # (io/cigar.derived_stats) computes them all, invalidated when the
    # CIGAR is reassigned.

    @property
    def cigartuples(self):
        return self._cigartuples

    @cigartuples.setter
    def cigartuples(self, value):
        self._cigartuples = value
        self._derived = None

    def _stats(self):
        derived = self._derived
        if derived is None:
            derived = _cigar.derived_stats(self._cigartuples)
            self._derived = derived
        return derived

    @property
    def cigarstring(self):
        return _cigar.cigar_to_string(self._cigartuples)

    @cigarstring.setter
    def cigarstring(self, value):
        self._cigartuples = _cigar.parse_cigar(value)
        self._derived = None

    @property
    def reference_end(self):
        if self._cigartuples is None or self.reference_start < 0:
            return None
        return self.reference_start + self._stats()[2]

    @property
    def query_alignment_start(self):
        if self._cigartuples is None:
            return None
        return self._stats()[5]

    @property
    def query_alignment_end(self):
        if self._cigartuples is None:
            return None
        return self._stats()[6]

    def infer_query_length(self):
        if self._cigartuples is None:
            return None
        return self._stats()[3]

    def infer_read_length(self):
        """Read length inferred from CIGAR, including hard-clipped bases
        (pysam semantics; consumed at SVIM_inter.py:31)."""
        if self._cigartuples is None:
            return None
        return self._stats()[4]

    def get_cigar_stats(self):
        base_counts, op_counts = self._stats()[:2]
        # fresh lists per call (pysam returns new arrays; callers may mutate)
        return list(base_counts), list(op_counts)

    # -- tags ----------------------------------------------------------------------

    def get_tag(self, name):
        try:
            return self.tags[name][0]
        except KeyError:
            raise KeyError("tag '{0}' not present".format(name))

    def has_tag(self, name):
        return name in self.tags

    def set_tag(self, name, value, value_type=None):
        self.tags[name] = (value, value_type)

    def set_tags(self, tag_list):
        self.tags = {name: (value, value_type) for name, value, value_type in tag_list}


def parse_sam_line(line: str, header: AlignmentHeader) -> AlignmentRecord:
    fields = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq, cig, rnext, pnext, tlen, seq, qual = fields[:11]
    tags = {}
    for tag_field in fields[11:]:
        name, value_type, value = tag_field.split(":", 2)
        if value_type == "i":
            value = int(value)
        elif value_type == "f":
            value = float(value)
        tags[name] = (value, value_type)
    return AlignmentRecord(
        query_name=qname,
        flag=int(flag),
        reference_id=header.get_tid(rname) if rname != "*" else -1,
        reference_start=int(pos) - 1,
        mapping_quality=int(mapq),
        cigartuples=_cigar.parse_cigar(cig),
        query_sequence=None if seq == "*" else seq,
        query_qualities=None if qual == "*" else qual,
        next_reference_id=header.get_tid(rnext) if rnext not in ("*", "=") else -1,
        next_reference_start=int(pnext) - 1,
        template_length=int(tlen),
        tags=tags,
    )


class AlignmentFile:
    """SAM/BAM reader with sequential iteration and indexed-free region fetch.

    The whole file is decoded once into an in-memory record list; region
    fetches binary-search a coordinate table built lazily on first use.  This
    replaces pysam's .bai-backed fetch (SVIM_genotyping.py:49) for data that
    fits in host RAM, which holds for per-host shards in the sharded layout.
    """

    def __init__(self, filename: str, records: List[AlignmentRecord] = None,
                 header: AlignmentHeader = None):
        self.filename = filename
        if records is not None:
            self.header = header if header is not None else AlignmentHeader({}, [], [])
            self._records = records
        else:
            self.header, self._records = _load_alignment_file(filename)
        self._region_index = None

    # -- header surface --------------------------------------------------------------

    @property
    def references(self):
        return self.header.references

    @property
    def lengths(self):
        return self.header.lengths

    def get_tid(self, name):
        return self.header.get_tid(name)

    def getrname(self, tid):
        return self.header.get_reference_name(tid)

    def get_reference_length(self, contig):
        tid = self.header.get_tid(contig)
        if tid < 0:
            raise KeyError(contig)
        return self.header.lengths[tid]

    def check_index(self):
        # region queries are always available (in-memory table)
        return True

    # -- record access ---------------------------------------------------------------

    def __len__(self):
        return len(self._records)

    def _build_region_index(self):
        # per-tid list of (ref_start, ref_end, record_index), sorted by start,
        # preserving file order among equal starts (matches coordinate order)
        by_tid: Dict[int, List[Tuple[int, int, int]]] = {}
        for idx, rec in enumerate(self._records):
            if rec.reference_id < 0 or rec.cigartuples is None:
                continue
            end = rec.reference_end
            by_tid.setdefault(rec.reference_id, []).append((rec.reference_start, end, idx))
        for tid in by_tid:
            by_tid[tid].sort(key=lambda item: (item[0], item[2]))
        self._region_index = by_tid

    def fetch(self, contig: str = None, start: int = None, stop: int = None,
              until_eof: bool = False) -> Iterator[AlignmentRecord]:
        if contig is None:
            return iter(self._records)
        if self._region_index is None:
            self._build_region_index()
        tid = self.header.get_tid(contig)
        entries = self._region_index.get(tid, [])
        start = 0 if start is None else start
        stop = float("inf") if stop is None else stop

        def region_iter():
            for ref_start, ref_end, idx in entries:
                if ref_start >= stop:
                    break
                if ref_end > start:
                    yield self._records[idx]
        return region_iter()

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()
        return False


def _load_alignment_file(filename: str):
    """Sniff SAM text / gzipped SAM / BAM and decode fully."""
    with open(filename, "rb") as probe:
        magic = probe.read(4)
    if magic[:2] == b"\x1f\x8b":
        with gzip.open(filename, "rb") as handle:
            inner_magic = handle.read(4)
        if inner_magic == b"BAM\x01":
            from svim_tpu_torch.io import bam
            return bam.read_bam(filename)
        # gzipped SAM
        with gzip.open(filename, "rt") as handle:
            return _read_sam_text(handle)
    if magic == b"BAM\x01":
        raise ValueError("raw (non-BGZF) BAM stream is not supported: {0}".format(filename))
    with open(filename, "rt") as handle:
        return _read_sam_text(handle)


def _read_sam_text(handle):
    header_lines = []
    records: List[AlignmentRecord] = []
    header = None
    for line in handle:
        if line.startswith("@"):
            if header is not None:
                logging.warning("header line after alignment records in SAM input")
            header_lines.append(line.rstrip("\n"))
            continue
        if header is None:
            header = AlignmentHeader.from_text("\n".join(header_lines))
        if line.strip():
            try:
                records.append(parse_sam_line(line, header))
            except (ValueError, IndexError) as error:
                raise ValueError(
                    "input is not valid SAM (record line {0}: {1!r}...): {2}"
                    .format(len(records) + 1, line[:60], error)) from error
    if header is None:
        header = AlignmentHeader.from_text("\n".join(header_lines))
    return header, records
