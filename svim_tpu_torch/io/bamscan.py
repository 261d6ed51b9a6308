"""Packed batches on the port's device.

Counterpart of svim_tpu/io/bamscan.py::build_packed: the same
PackedAlignments batch, with its device columns (int32 CIGAR words in BAM
encoding, alignment starts, contig ids, strands) placed on `device` once.
"""

from __future__ import annotations

from svim_tpu.io.packing import PackedAlignments
from svim_tpu_torch.state import packed_to_torch


def build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                 sequences, device) -> PackedAlignments:
    """Assemble a PackedAlignments batch and copy its device columns to
    `device`; they ride in `device_cigars` as the packed_to_torch dict.
    Geometry columns (ref_end, qa bounds, ...) are filled by the fused
    COLLECT pass on first use."""
    packed = PackedAlignments(
        n=len(names), ref_id=ref_id, ref_start=ref_start, ref_end=None,
        mapq=mapq, flag=flag, qa_start=None, qa_end=None,
        read_len=None, cigar_words=cigar_words,
        names=names, sequences=sequences, records=None)
    packed.device_cigars = packed_to_torch(packed, device)
    return packed
