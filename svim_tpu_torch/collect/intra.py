"""Intra-alignment signature extraction: indels encoded in the CIGAR.

Behavioral contract: svim/SVIM_intra.py:8-51 — a linear walk over CIGAR ops
where M/=/X advance both coordinates, I advances the read, D advances the
reference, S advances the read; I/D runs >= min_sv_size become INS/DEL
signatures (INS captures the inserted sequence; --all_bnds adds a BND twin
per DEL).
"""

from __future__ import annotations

from typing import List, Tuple

from svim_tpu_torch.signatures import (
    SignatureDeletion,
    SignatureInsertion,
    SignatureTranslocation,
)

# (ref_advance?, read_advance?) per CIGAR op for the scan.  N/H/P advance
# neither, mirroring the reference walk (SVIM_intra.py:14-29 handles only
# M/I/D/S/=/X and ignores the rest).
_REF_ADVANCES = (True, False, True, False, False, False, False, True, True)
_READ_ADVANCES = (True, True, False, False, True, False, False, True, True)


def scan_cigar_indels(cigartuples, min_length: int) -> List[Tuple[int, int, int, str]]:
    """Return (pos_ref, pos_read, length, kind) for every I/D run >= min_length.

    pos_ref/pos_read are offsets from the alignment start at the point the
    indel begins (reference: SVIM_intra.py:8-30).
    """
    events = []
    pos_ref = 0
    pos_read = 0
    for op, length in cigartuples:
        if op == 1:  # I
            if length >= min_length:
                events.append((pos_ref, pos_read, length, "INS"))
        elif op == 2:  # D
            if length >= min_length:
                events.append((pos_ref, pos_read, length, "DEL"))
        if op < 9 and op != 3:
            if _REF_ADVANCES[op]:
                pos_ref += length
            if _READ_ADVANCES[op]:
                pos_read += length
    return events


def analyze_alignment_indel(alignment, bam, query_name, options):
    """Turn CIGAR indel events of one alignment into signatures
    (reference: SVIM_intra.py:33-51)."""
    sv_signatures = []
    translocation_signatures_all_bnds = []
    ref_chr = bam.getrname(alignment.reference_id)
    ref_start = alignment.reference_start
    for pos_ref, pos_read, length, kind in scan_cigar_indels(alignment.cigartuples, options.min_sv_size):
        if kind == "DEL":
            sv_signatures.append(SignatureDeletion(
                ref_chr, ref_start + pos_ref, ref_start + pos_ref + length, "cigar", query_name))
            if options.all_bnds:
                translocation_signatures_all_bnds.append(SignatureTranslocation(
                    ref_chr, ref_start + pos_ref, "fwd",
                    ref_chr, ref_start + pos_ref + length, "fwd", "cigar", query_name))
        else:
            try:
                insertion_seq = alignment.query_sequence[pos_read:pos_read + length]
            except TypeError:
                insertion_seq = ""
            sv_signatures.append(SignatureInsertion(
                ref_chr, ref_start + pos_ref, ref_start + pos_ref + length,
                "cigar", query_name, insertion_seq))
    return sv_signatures, translocation_signatures_all_bnds
