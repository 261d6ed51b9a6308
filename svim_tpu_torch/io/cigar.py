"""CIGAR utilities shared by the SAM/BAM readers and the packing layer.

Op codes follow the SAM spec: M=0 I=1 D=2 N=3 S=4 H=5 P=6 ==7 X=8.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

CIGAR_OPS = "MIDNSHP=X"
OP_FOR_CHAR = {c: i for i, c in enumerate(CIGAR_OPS)}

# which ops consume reference / query / read (query incl. hard clips)
CONSUMES_REF = frozenset((0, 2, 3, 7, 8))
CONSUMES_QUERY = frozenset((0, 1, 4, 7, 8))
CONSUMES_READ = frozenset((0, 1, 4, 5, 7, 8))


def parse_cigar(cigar_string: str) -> Optional[List[Tuple[int, int]]]:
    """Parse a CIGAR string into (op, length) tuples; '*' -> None."""
    if cigar_string is None or cigar_string == "*" or cigar_string == "":
        return None
    tuples = []
    length = 0
    for ch in cigar_string:
        if ch.isdigit():
            length = length * 10 + ord(ch) - 48
        else:
            tuples.append((OP_FOR_CHAR[ch], length))
            length = 0
    return tuples


def cigar_to_string(tuples) -> Optional[str]:
    if tuples is None:
        return None
    return "".join("{0}{1}".format(length, CIGAR_OPS[op]) for op, length in tuples)


def reference_length(tuples) -> int:
    return sum(length for op, length in tuples if op in CONSUMES_REF)


def query_length(tuples, include_hard_clips: bool = False) -> int:
    consumed = CONSUMES_READ if include_hard_clips else CONSUMES_QUERY
    return sum(length for op, length in tuples if op in consumed)


def query_alignment_bounds(tuples) -> Tuple[int, int]:
    """(query_alignment_start, query_alignment_end) within the stored query
    sequence (soft clips only; hard-clipped bases are absent from the
    sequence), matching pysam's accessors."""
    start = 0
    for op, length in tuples:
        if op == 4:
            start += length
        elif op == 5:
            continue
        else:
            break
    end = query_length(tuples)
    for op, length in reversed(tuples):
        if op == 4:
            end -= length
        elif op == 5:
            continue
        else:
            break
    return start, end


def derived_stats(tuples):
    """One-pass derived geometry for a record's CIGAR: (base_counts,
    op_counts, reference_length, query_length, read_length,
    query_alignment_start, query_alignment_end).

    pysam computes each of these accessors in C per call; the object path
    here calls several of them per record, so one cached pass replaces
    repeated generator sums (the dominant cost of the host COLLECT loop)."""
    base_counts = [0] * 11
    op_counts = [0] * 11
    for op, length in tuples:
        base_counts[op] += length
        op_counts[op] += 1
    ref_len = (base_counts[0] + base_counts[2] + base_counts[3]
               + base_counts[7] + base_counts[8])
    query_len = (base_counts[0] + base_counts[1] + base_counts[4]
                 + base_counts[7] + base_counts[8])
    read_len = query_len + base_counts[5]
    start = 0
    for op, length in tuples:
        if op == 4:
            start += length
        elif op == 5:
            continue
        else:
            break
    end = query_len
    for op, length in reversed(tuples):
        if op == 4:
            end -= length
        elif op == 5:
            continue
        else:
            break
    return (base_counts, op_counts, ref_len, query_len, read_len, start, end)


def cigar_stats(tuples):
    """(base counts per op, op occurrence counts) over 11 slots, mirroring
    pysam.AlignedSegment.get_cigar_stats (used by the reference at
    SVIM_COLLECT.py:47 to detect hard clips)."""
    base_counts = [0] * 11
    op_counts = [0] * 11
    if tuples:
        for op, length in tuples:
            base_counts[op] += length
            op_counts[op] += 1
    return base_counts, op_counts
