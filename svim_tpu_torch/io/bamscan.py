"""Packed batches for the port's device passes.

Counterpart of svim_tpu/io/bamscan.py::build_packed: the same
PackedAlignments batch, but nothing is copied to a device here.  The
device columns (int32 CIGAR words in BAM encoding, alignment starts,
contig ids, strands) are uploaded by the first pass that needs them
(collect.packed._device_columns), on the thread that runs the kernels: the
streaming scanner builds batches on a prefetch thread.
"""

from __future__ import annotations

from svim_tpu.io.packing import PackedAlignments


def build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                 sequences) -> PackedAlignments:
    """Assemble a PackedAlignments batch.  Geometry columns (ref_end, qa
    bounds, ...) are filled by the fused COLLECT pass on first use."""
    return PackedAlignments(
        n=len(names), ref_id=ref_id, ref_start=ref_start, ref_end=None,
        mapq=mapq, flag=flag, qa_start=None, qa_end=None,
        read_len=None, cigar_words=cigar_words,
        names=names, sequences=sequences, records=None)
