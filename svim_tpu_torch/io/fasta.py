"""Indexed FASTA access (replaces pysam.FastaFile; reference usage:
SVIM_clustering.py:377, SVIM_COMBINE.py:133,277).

Random access uses the standard .fai index (samtools faidx format); the index
is built on the fly when missing.  fetch() clamps coordinates like htslib.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


class FastaIndexEntry:
    __slots__ = ("name", "length", "offset", "linebases", "linewidth")

    def __init__(self, name, length, offset, linebases, linewidth):
        self.name = name
        self.length = length
        self.offset = offset
        self.linebases = linebases
        self.linewidth = linewidth


def build_fasta_index(path: str) -> List[FastaIndexEntry]:
    """Scan a FASTA file and produce .fai entries (name, length, offset,
    linebases, linewidth).  Whole-buffer scan (find/count), not line
    iteration — genomes are tens of MB and this runs at io speed."""
    with open(path, "rb") as handle:
        data = handle.read()
    entries: List[FastaIndexEntry] = []
    # records start with '>' at line starts only
    if data.startswith(b">"):
        position = 0
    else:
        marker = data.find(b"\n>")
        position = marker + 1 if marker >= 0 else -1
    while position >= 0:
        header_end = data.find(b"\n", position)
        if header_end < 0:
            break
        name = data[position + 1:header_end].split()[0].decode()
        seq_start = header_end + 1
        marker = data.find(b"\n>", header_end)
        next_record = marker + 1 if marker >= 0 else -1
        seq_end = next_record if next_record >= 0 else len(data)
        block = data[seq_start:seq_end]
        first_newline = block.find(b"\n")
        if first_newline < 0:
            linebases = len(block.rstrip(b"\r\n"))
            linewidth = len(block)
        else:
            linewidth = first_newline + 1
            linebases = len(block[:first_newline].rstrip(b"\r"))
        length = len(block) - block.count(b"\n") - block.count(b"\r")
        entries.append(FastaIndexEntry(name, length, seq_start, linebases, linewidth))
        position = next_record
    return entries


def write_fasta_index(fasta_path: str, fai_path: str = None) -> str:
    fai_path = fai_path or fasta_path + ".fai"
    entries = build_fasta_index(fasta_path)
    with open(fai_path, "w") as out:
        for e in entries:
            out.write("{0}\t{1}\t{2}\t{3}\t{4}\n".format(
                e.name, e.length, e.offset, e.linebases, e.linewidth))
    return fai_path


class FastaFile:
    """Random-access FASTA reader with pysam-compatible fetch semantics."""

    def __init__(self, filename: str):
        if not os.path.exists(filename):
            raise IOError("FASTA file {0} not found".format(filename))
        self.filename = filename
        fai_path = filename + ".fai"
        if os.path.exists(fai_path):
            self._entries = []
            with open(fai_path) as fai:
                for line in fai:
                    fields = line.rstrip("\n").split("\t")
                    if len(fields) < 5:
                        continue
                    self._entries.append(FastaIndexEntry(
                        fields[0], int(fields[1]), int(fields[2]),
                        int(fields[3]), int(fields[4])))
        else:
            self._entries = build_fasta_index(filename)
            try:
                # cache the index on disk (samtools faidx behavior) so
                # repeated opens skip the scan
                with open(fai_path, "w") as fai:
                    for e in self._entries:
                        fai.write("{0}\t{1}\t{2}\t{3}\t{4}\n".format(
                            e.name, e.length, e.offset, e.linebases, e.linewidth))
            except OSError:
                pass  # read-only location: keep the in-memory index
        self._by_name: Dict[str, FastaIndexEntry] = {e.name: e for e in self._entries}
        self._handle = open(filename, "rb")
        # window fetches are hot (one per INS partition / consensus locus);
        # mmap slicing serves them from the page cache without per-call
        # seek+read syscalls
        try:
            import mmap
            self._map = mmap.mmap(self._handle.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            self._map = None  # empty or unmappable file: seek+read fallback

    # -- pysam-compatible surface ---------------------------------------------------

    @property
    def references(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self._entries)

    @property
    def lengths(self) -> Tuple[int, ...]:
        return tuple(e.length for e in self._entries)

    def get_reference_length(self, contig: str) -> int:
        return self._by_name[contig].length

    def fetch(self, reference: str = None, start: int = None, end: int = None) -> str:
        entry = self._by_name.get(reference)
        if entry is None:
            raise KeyError("sequence {0} not present".format(reference))
        start = 0 if start is None else max(0, start)
        end = entry.length if end is None else min(end, entry.length)
        if start >= end:
            return ""
        # file offset of base `start`, accounting for line breaks
        if entry.linebases == 0:
            return ""
        first_offset = entry.offset + (start // entry.linebases) * entry.linewidth + start % entry.linebases
        last_offset = entry.offset + ((end - 1) // entry.linebases) * entry.linewidth + (end - 1) % entry.linebases
        if self._map is not None:
            raw = self._map[first_offset:last_offset + 1]
        else:
            self._handle.seek(first_offset)
            raw = self._handle.read(last_offset - first_offset + 1)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None
        if self._handle is not None:
            self._handle.close()
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()
        return False
