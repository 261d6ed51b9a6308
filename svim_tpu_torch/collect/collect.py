"""COLLECT drivers: iterate alignment files and gather signatures.

Behavioral contract: svim/SVIM_COLLECT.py — per-read grouping for
queryname-sorted input, SA-tag reconstruction of supplementary alignments for
coordinate-sorted input, mapq/flag filtering, and per-alignment dispatch to
the intra-/inter-alignment analyzers.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Tuple

from svim_tpu_torch.io.sam import AlignmentRecord
from svim_tpu_torch.collect.intra import analyze_alignment_indel
from svim_tpu_torch.collect.inter import analyze_read_segments


def bam_iterator(bam) -> Iterator[Tuple[List, List, List]]:
    """Group a queryname-sorted file into per-read
    (primary, supplementary, secondary) alignment lists
    (reference: SVIM_COLLECT.py:8-41)."""
    current_read_name = None
    current_prim, current_suppl, current_sec = [], [], []
    started = False
    for alignment in bam.fetch(until_eof=True):
        if started and alignment.query_name != current_read_name:
            yield (current_prim, current_suppl, current_sec)
            current_prim, current_suppl, current_sec = [], [], []
        started = True
        current_read_name = alignment.query_name
        if alignment.is_secondary:
            current_sec.append(alignment)
        elif alignment.is_supplementary:
            current_suppl.append(alignment)
        else:
            current_prim.append(alignment)
    if started:
        yield (current_prim, current_suppl, current_sec)


def retrieve_other_alignments(main_alignment, bam) -> List[AlignmentRecord]:
    """Reconstruct the other alignments of a read from its SA tag
    (reference: SVIM_COLLECT.py:44-93).

    Returns [] when the primary is hard-clipped (the SA segments could not be
    placed against its stored sequence) or has no SA tag."""
    if main_alignment.get_cigar_stats()[0][5] > 0:
        return []
    try:
        sa_tag = main_alignment.get_tag("SA").split(";")
    except KeyError:
        return []
    other_alignments = []
    for element in sa_tag:
        if element == "":
            continue
        fields = element.split(",")
        if len(fields) != 6:
            logging.warning(
                "SA tag does not consist of 6 fields. This could be a sign of "
                "invalid characters (e.g. commas or semicolons) in a chromosome "
                "name of the reference genome.")
            continue
        rname, pos, strand, cigar, mapq, nm = fields
        mapq_value = int(mapq)
        if not (0 <= mapq_value <= 255):
            # out-of-range SA mapq degrades to 0 (reference: SVIM_COLLECT.py:81-84)
            mapq_value = 0
        record = AlignmentRecord(
            query_name=main_alignment.query_name,
            query_sequence=main_alignment.query_sequence,
            flag=2048 if strand == "+" else 2064,
            reference_id=bam.get_tid(rname),
            reference_start=int(pos) - 1,
            mapping_quality=mapq_value,
            next_reference_id=-1,
            next_reference_start=-1,
            template_length=0,
            query_qualities=main_alignment.query_qualities,
        )
        record.cigarstring = cigar
        record.set_tags([("NM", int(nm), "i")])
        other_alignments.append(record)
    return other_alignments


def analyze_alignment_file_querysorted(bam, options):
    """COLLECT over a queryname-sorted file using real supplementary records
    (reference: SVIM_COLLECT.py:96-129)."""
    sv_signatures = []
    translocation_signatures_all_bnds = []
    read_nr = 0
    try:
        for primary_aln, suppl_aln, sec_aln in bam_iterator(bam):
            if (len(primary_aln) != 1 or primary_aln[0].is_unmapped
                    or primary_aln[0].mapping_quality < options.min_mapq):
                continue
            read_nr += 1
            if read_nr % 10000 == 0:
                logging.info("Processed read {0}".format(read_nr))
            good_suppl_alns = [aln for aln in suppl_aln
                               if not aln.is_unmapped and aln.mapping_quality >= options.min_mapq]
            sigs, trans_sigs = analyze_alignment_indel(
                primary_aln[0], bam, primary_aln[0].query_name, options)
            sv_signatures.extend(sigs)
            translocation_signatures_all_bnds.extend(trans_sigs)
            for alignment in good_suppl_alns:
                sigs, trans_sigs = analyze_alignment_indel(
                    alignment, bam, alignment.query_name, options)
                sv_signatures.extend(sigs)
                translocation_signatures_all_bnds.extend(trans_sigs)
            sigs, trans_sigs = analyze_read_segments(primary_aln[0], good_suppl_alns, bam, options)
            sv_signatures.extend(sigs)
            translocation_signatures_all_bnds.extend(trans_sigs)
    except KeyboardInterrupt:
        logging.warning("Execution interrupted by user. "
                        "Stop detection and continue with next step..")
    return sv_signatures, translocation_signatures_all_bnds


def analyze_alignment_file_coordsorted(bam, options):
    """COLLECT over a coordinate-sorted file, reconstructing supplementary
    alignments from SA tags (reference: SVIM_COLLECT.py:132-167)."""
    sv_signatures = []
    translocation_signatures_all_bnds = []
    read_nr = 0
    try:
        for current_alignment in bam.fetch(until_eof=True):
            if (current_alignment.is_unmapped or current_alignment.is_secondary
                    or current_alignment.mapping_quality < options.min_mapq):
                continue
            if current_alignment.is_supplementary:
                sigs, trans_sigs = analyze_alignment_indel(
                    current_alignment, bam, current_alignment.query_name, options)
                sv_signatures.extend(sigs)
                translocation_signatures_all_bnds.extend(trans_sigs)
            else:
                read_nr += 1
                if read_nr % 10000 == 0:
                    logging.info("Processed read {0}".format(read_nr))
                supplementary_alignments = retrieve_other_alignments(current_alignment, bam)
                good_suppl_alns = [aln for aln in supplementary_alignments
                                   if not aln.is_unmapped and aln.mapping_quality >= options.min_mapq]
                sigs, trans_sigs = analyze_alignment_indel(
                    current_alignment, bam, current_alignment.query_name, options)
                sv_signatures.extend(sigs)
                translocation_signatures_all_bnds.extend(trans_sigs)
                sigs, trans_sigs = analyze_read_segments(
                    current_alignment, good_suppl_alns, bam, options)
                sv_signatures.extend(sigs)
                translocation_signatures_all_bnds.extend(trans_sigs)
    except KeyboardInterrupt:
        logging.warning("Execution interrupted by user. "
                        "Stop detection and continue with next step..")
    return sv_signatures, translocation_signatures_all_bnds
