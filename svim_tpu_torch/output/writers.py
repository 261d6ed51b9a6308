"""BED and VCF writers.

Behavioral contract: svim/SVIM_CLUSTER.py:29-107 (signature cluster BED/VCF),
svim/SVIM_COMBINE.py:18-186 (candidate BEDs, final VCF with natural contig
sort and svim.<TYPE>.<N> identifier assignment).
"""

from __future__ import annotations

import logging
import os
import re
import time
from collections import defaultdict

from svim_tpu_torch.io.fasta import FastaFile


def _open_all(directory, names):
    os.makedirs(directory, exist_ok=True)
    return {name: open(os.path.join(directory, name), "w") for name in names}


def write_signature_clusters_bed(working_dir, clusters):
    """Seven BED files under <working_dir>/signatures
    (reference: SVIM_CLUSTER.py:29-69)."""
    (deletion_clusters, insertion_clusters, inversion_clusters,
     tandem_duplication_clusters, insertion_from_clusters,
     translocation_clusters) = clusters

    files = _open_all(os.path.join(working_dir, "signatures"), [
        "del.bed", "ins.bed", "inv.bed", "dup_tan_source.bed",
        "dup_tan_dest.bed", "trans.bed", "dup_int.bed"])
    try:
        for cluster in deletion_clusters:
            print(cluster.get_bed_entry(), file=files["del.bed"])
        for cluster in insertion_clusters:
            print(cluster.get_bed_entry(), file=files["ins.bed"])
        for cluster in inversion_clusters:
            print(cluster.get_bed_entry(), file=files["inv.bed"])
        for cluster in tandem_duplication_clusters:
            source_entry, dest_entry = cluster.get_bed_entries()
            print(source_entry, file=files["dup_tan_source.bed"])
            print(dest_entry, file=files["dup_tan_dest.bed"])
        for cluster in insertion_from_clusters:
            source_entry, dest_entry = cluster.get_bed_entries()
            print(source_entry, file=files["dup_int.bed"])
            print(dest_entry, file=files["dup_int.bed"])
        for cluster in translocation_clusters:
            source_entry, dest_entry = cluster.get_bed_entries()
            print(source_entry, file=files["trans.bed"])
            print(dest_entry, file=files["trans.bed"])
    finally:
        for handle in files.values():
            handle.close()


def write_signature_clusters_vcf(working_dir, clusters, version):
    """Intermediate signatures/all.vcf (reference: SVIM_CLUSTER.py:72-107)."""
    (deletion_clusters, insertion_clusters, inversion_clusters,
     tandem_duplication_clusters, _insertion_from_clusters,
     _translocation_clusters) = clusters

    os.makedirs(os.path.join(working_dir, "signatures"), exist_ok=True)
    with open(os.path.join(working_dir, "signatures", "all.vcf"), "w") as vcf_output:
        print("##fileformat=VCFv4.3", file=vcf_output)
        print("##source=SVIMV{0}".format(version), file=vcf_output)
        print("##ALT=<ID=DEL,Description=\"Deletion\">", file=vcf_output)
        print("##ALT=<ID=INV,Description=\"Inversion\">", file=vcf_output)
        print("##ALT=<ID=DUP,Description=\"Duplication\">", file=vcf_output)
        print("##ALT=<ID=DUP:TANDEM,Description=\"Tandem Duplication\">", file=vcf_output)
        print("##ALT=<ID=INS,Description=\"Insertion\">", file=vcf_output)
        print("##INFO=<ID=END,Number=1,Type=Integer,Description=\"End position of "
              "the variant described in this record\">", file=vcf_output)
        print("##INFO=<ID=SVTYPE,Number=1,Type=String,Description=\"Type of "
              "structural variant\">", file=vcf_output)
        print("##INFO=<ID=SVLEN,Number=.,Type=Integer,Description=\"Difference in "
              "length between REF and ALT alleles\">", file=vcf_output)
        print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO", file=vcf_output)

        vcf_entries = []
        for cluster_list in (deletion_clusters, insertion_clusters,
                             inversion_clusters, tandem_duplication_clusters):
            for cluster in cluster_list:
                vcf_entries.append((cluster.get_source(), cluster.get_vcf_entry()))
        for _source, entry in sorted(vcf_entries, key=lambda pair: pair[0]):
            print(entry, file=vcf_output)


def write_candidates(working_dir, candidates):
    """Eight candidate BED files under <working_dir>/candidates
    (reference: SVIM_COMBINE.py:18-58)."""
    (int_duplication_candidates, inversion_candidates, tan_duplication_candidates,
     deletion_candidates, novel_insertion_candidates, breakend_candidates) = candidates

    files = _open_all(os.path.join(working_dir, "candidates"), [
        "candidates_deletions.bed", "candidates_inversions.bed",
        "candidates_tan_duplications_source.bed", "candidates_tan_duplications_dest.bed",
        "candidates_int_duplications_source.bed", "candidates_int_duplications_dest.bed",
        "candidates_novel_insertions.bed", "candidates_breakends.bed"])
    try:
        for candidate in deletion_candidates:
            print(candidate.get_bed_entry(), file=files["candidates_deletions.bed"])
        for candidate in int_duplication_candidates:
            source_entry, dest_entry = candidate.get_bed_entries()
            print(source_entry, file=files["candidates_int_duplications_source.bed"])
            print(dest_entry, file=files["candidates_int_duplications_dest.bed"])
        for candidate in inversion_candidates:
            print(candidate.get_bed_entry(), file=files["candidates_inversions.bed"])
        for candidate in tan_duplication_candidates:
            source_entry, dest_entry = candidate.get_bed_entries()
            print(source_entry, file=files["candidates_tan_duplications_source.bed"])
            print(dest_entry, file=files["candidates_tan_duplications_dest.bed"])
        for candidate in novel_insertion_candidates:
            print(candidate.get_bed_entry(), file=files["candidates_novel_insertions.bed"])
        for candidate in breakend_candidates:
            source_entry, dest_entry = candidate.get_bed_entries()
            print(source_entry, file=files["candidates_breakends.bed"])
            print(dest_entry, file=files["candidates_breakends.bed"])
    finally:
        for handle in files.values():
            handle.close()


def sorted_nicely(vcf_entries):
    """Natural sort of ((contig, start, end), line, svtype) entries so chr10
    follows chr2 (reference: SVIM_COMBINE.py:61-68)."""
    def convert(text):
        return int(text) if text.isdigit() else text

    def alphanum_key(key):
        return [convert(part) for part in re.split("([0-9]+)", key)]

    return sorted(vcf_entries,
                  key=lambda entry: (alphanum_key(str(entry[0][0])),
                                     entry[0][1], entry[0][2]))


def write_final_vcf(int_duplication_candidates, inversion_candidates,
                    tandem_duplication_candidates, deletion_candidates,
                    novel_insertion_candidates, breakend_candidates,
                    version, contig_names, contig_lengths, types_to_output,
                    options):
    """Final variants.vcf (reference: SVIM_COMBINE.py:71-186)."""
    vcf_output = open(os.path.join(options.working_dir, "variants.vcf"), "w")

    print("##fileformat=VCFv4.2", file=vcf_output)
    print("##fileDate={0}".format(time.strftime("%Y-%m-%d|%I:%M:%S%p|%Z|%z")), file=vcf_output)
    print("##source=SVIM-v{0}".format(version), file=vcf_output)
    for contig_name, contig_length in zip(contig_names, contig_lengths):
        print("##contig=<ID={0},length={1}>".format(contig_name, contig_length), file=vcf_output)
    if "DEL" in types_to_output:
        print("##ALT=<ID=DEL,Description=\"Deletion\">", file=vcf_output)
    if "INV" in types_to_output:
        print("##ALT=<ID=INV,Description=\"Inversion\">", file=vcf_output)
    if ((not options.tandem_duplications_as_insertions and "DUP:TANDEM" in types_to_output)
            or (not options.interspersed_duplications_as_insertions and "DUP:INT" in types_to_output)):
        print("##ALT=<ID=DUP,Description=\"Duplication\">", file=vcf_output)
    if not options.tandem_duplications_as_insertions and "DUP:TANDEM" in types_to_output:
        print("##ALT=<ID=DUP:TANDEM,Description=\"Tandem Duplication\">", file=vcf_output)
    if not options.interspersed_duplications_as_insertions and "DUP:INT" in types_to_output:
        print("##ALT=<ID=DUP:INT,Description=\"Interspersed Duplication\">", file=vcf_output)
    if "INS" in types_to_output:
        print("##ALT=<ID=INS,Description=\"Insertion\">", file=vcf_output)
    if "BND" in types_to_output:
        print("##ALT=<ID=BND,Description=\"Breakend\">", file=vcf_output)
    print("##INFO=<ID=SVTYPE,Number=1,Type=String,Description=\"Type of structural variant\">", file=vcf_output)
    print("##INFO=<ID=CUTPASTE,Number=0,Type=Flag,Description=\"Genomic origin of "
          "interspersed duplication seems to be deleted\">", file=vcf_output)
    print("##INFO=<ID=END,Number=1,Type=Integer,Description=\"End position of the "
          "variant described in this record\">", file=vcf_output)
    print("##INFO=<ID=SVLEN,Number=1,Type=Integer,Description=\"Difference in length "
          "between REF and ALT alleles\">", file=vcf_output)
    print("##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description=\"Number of reads "
          "supporting this variant\">", file=vcf_output)
    print("##INFO=<ID=STD_SPAN,Number=1,Type=Float,Description=\"Standard deviation "
          "in span of merged SV signatures\">", file=vcf_output)
    print("##INFO=<ID=STD_POS,Number=1,Type=Float,Description=\"Standard deviation "
          "in position of merged SV signatures\">", file=vcf_output)
    print("##INFO=<ID=STD_POS1,Number=1,Type=Float,Description=\"Standard deviation "
          "of breakend 1 position\">", file=vcf_output)
    print("##INFO=<ID=STD_POS2,Number=1,Type=Float,Description=\"Standard deviation "
          "of breakend 2 position\">", file=vcf_output)
    if options.insertion_sequences:
        print("##INFO=<ID=SEQS,Number=.,Type=String,Description=\"Insertion sequences "
              "from all supporting reads\">", file=vcf_output)
    if options.read_names:
        print("##INFO=<ID=READS,Number=.,Type=String,Description=\"Names of all "
              "supporting reads\">", file=vcf_output)
    if options.zmws:
        print("##INFO=<ID=ZMWS,Number=1,Type=Integer,Description=\"Number of supporting "
              "ZMWs (PacBio only)\">", file=vcf_output)
    print("##FILTER=<ID=hom_ref,Description=\"Genotype is homozygous reference\">", file=vcf_output)
    print("##FILTER=<ID=not_fully_covered,Description=\"Tandem duplication is not "
          "fully covered by a single read\">", file=vcf_output)
    print("##FORMAT=<ID=GT,Number=1,Type=String,Description=\"Genotype\">", file=vcf_output)
    print("##FORMAT=<ID=DP,Number=1,Type=Integer,Description=\"Read depth\">", file=vcf_output)
    print("##FORMAT=<ID=AD,Number=R,Type=Integer,Description=\"Read depth for each "
          "allele\">", file=vcf_output)
    if not options.tandem_duplications_as_insertions and "DUP:TANDEM" in types_to_output:
        print("##FORMAT=<ID=CN,Number=1,Type=Integer,Description=\"Copy number of "
              "tandem duplication (e.g. 2 for one additional copy)\">", file=vcf_output)
    print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + options.sample,
          file=vcf_output)

    # sequence alleles need an indexed genome; degrade to symbolic on failure
    sequence_alleles = not options.symbolic_alleles
    reference = None
    if sequence_alleles:
        try:
            reference = FastaFile(options.genome)
        except (IOError, OSError):
            logging.warning("The given reference genome is missing ({path}). Sequence "
                            "alleles cannot be retrieved.".format(path=options.genome))
            sequence_alleles = False

    vcf_entries = []
    if "DEL" in types_to_output:
        for candidate in deletion_candidates:
            vcf_entries.append((candidate.get_source(),
                                candidate.get_vcf_entry(sequence_alleles, reference,
                                                        options.read_names, options.zmws),
                                "DEL"))
    if "INV" in types_to_output:
        for candidate in inversion_candidates:
            vcf_entries.append((candidate.get_source(),
                                candidate.get_vcf_entry(sequence_alleles, reference,
                                                        options.read_names, options.zmws),
                                "INV"))
    if "INS" in types_to_output:
        for candidate in novel_insertion_candidates:
            vcf_entries.append((candidate.get_destination(),
                                candidate.get_vcf_entry(sequence_alleles, reference,
                                                        options.insertion_sequences,
                                                        options.read_names, options.zmws),
                                "INS"))
    if options.tandem_duplications_as_insertions:
        if "INS" in types_to_output:
            for candidate in tandem_duplication_candidates:
                vcf_entries.append((candidate.get_destination(),
                                    candidate.get_vcf_entry_as_ins(sequence_alleles, reference,
                                                                   options.read_names, options.zmws),
                                    "INS"))
    else:
        if "DUP:TANDEM" in types_to_output:
            for candidate in tandem_duplication_candidates:
                vcf_entries.append((candidate.get_source(),
                                    candidate.get_vcf_entry_as_dup(options.read_names, options.zmws),
                                    "DUP_TANDEM"))
    if options.interspersed_duplications_as_insertions:
        if "INS" in types_to_output:
            for candidate in int_duplication_candidates:
                vcf_entries.append((candidate.get_destination(),
                                    candidate.get_vcf_entry_as_ins(sequence_alleles, reference,
                                                                   options.read_names, options.zmws),
                                    "INS"))
    else:
        if "DUP:INT" in types_to_output:
            for candidate in int_duplication_candidates:
                vcf_entries.append((candidate.get_source(),
                                    candidate.get_vcf_entry_as_dup(options.read_names, options.zmws),
                                    "DUP_INT"))
    if "BND" in types_to_output:
        for candidate in breakend_candidates:
            vcf_entries.append(((candidate.get_source()[0], candidate.get_source()[1],
                                 candidate.get_source()[1] + 1),
                                candidate.get_vcf_entry(options.read_names, options.zmws),
                                "BND"))
            vcf_entries.append(((candidate.get_destination()[0], candidate.get_destination()[1],
                                 candidate.get_destination()[1] + 1),
                                candidate.get_vcf_entry_reverse(options.read_names, options.zmws),
                                "BND"))

    if reference is not None:
        reference.close()

    # per-type counters drive the svim.<TYPE>.<N> identifiers
    svtype_counter = defaultdict(int)
    for _source, entry, svtype in sorted_nicely(vcf_entries):
        svtype_counter[svtype] += 1
        variant_id = "svim.{svtype}.{number}".format(svtype=svtype,
                                                     number=svtype_counter[svtype])
        print(entry.replace("PLACEHOLDERFORID", variant_id, 1), file=vcf_output)

    vcf_output.close()
