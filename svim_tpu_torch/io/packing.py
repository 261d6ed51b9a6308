"""Packing of alignment records for the port.

Counterpart of svim_tpu/io/packing.py::pack_alignments, which builds its
batch through svim_tpu's build_packed and so imports JAX; this copy builds
the same batch through the port's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from svim_tpu.io.packing import PackedAlignments, bucket_size, compact_cigar_row
from svim_tpu_torch.io.bamscan import build_packed


def pack_alignments(records: Sequence,
                    min_sv_size: int = 0) -> PackedAlignments:
    """Pack AlignmentRecord objects into a PackedAlignments batch.

    Records without a CIGAR are packed with zero ops (they produce nothing in
    the kernels).  min_sv_size > 0 compacts each CIGAR (compact_cigar_row)
    before padding."""
    n = len(records)
    max_ops = 1
    cigars: List = []
    for record in records:
        cigar = record.cigartuples
        if cigar and min_sv_size > 0:
            arr = np.asarray(cigar, dtype=np.int64)
            compacted = compact_cigar_row((arr[:, 1] << 4) | arr[:, 0],
                                          min_sv_size)
            if compacted is not None:
                cigar = [(int(word) & 0xF, int(word) >> 4)
                         for word in compacted]
        cigars.append(cigar)
        if cigar is not None and len(cigar) > max_ops:
            max_ops = len(cigar)

    cigar_words = np.zeros((n, bucket_size(max_ops)), dtype=np.int32)
    ref_id = np.empty(n, dtype=np.int32)
    ref_start = np.empty(n, dtype=np.int32)
    mapq = np.empty(n, dtype=np.int32)
    flag = np.empty(n, dtype=np.int32)
    names: List[str] = []
    sequences: List[Optional[str]] = []
    for row, record in enumerate(records):
        ref_id[row] = record.reference_id
        ref_start[row] = record.reference_start
        mapq[row] = record.mapping_quality
        flag[row] = record.flag
        names.append(record.query_name)
        sequences.append(record.query_sequence)
        cigar = cigars[row]
        if cigar:
            arr = np.asarray(cigar, dtype=np.int64)
            cigar_words[row, :len(cigar)] = (arr[:, 1] << 4) | arr[:, 0]

    packed = build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                          sequences)
    packed.records = list(records)
    return packed
