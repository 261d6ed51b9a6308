"""The reference: SVIM v2.0.0's `svim alignment` worked out plainly from the
made BAM and genome, into the lines the measured program writes.

COLLECT (collect.py), CLUSTER (cluster.py), COMBINE (SVIM_COMBINE.py:332-478)
and GENOTYPE (SVIM_genotyping.py:34-94) are computed here.  The consensus of
an insertion cluster of three or more signatures (SVIM's POA,
SVIM_COMBINE.py:188-254) is worked out here (consensus.py) for a sample of
those clusters drawn from the run's seed, the one of most inserted bases
always in it; for the others its outcome, the realigned start, size and
sequence, is read from the program's candidate BED and VCF and checked by
itself against SVIM's acceptance rule (`insertion_consensus`).  Everything
downstream of it, the genotype and the record, is recomputed."""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np

from svbench.reference import consensus
from svbench.reference.candidates import (
    CandidateBreakend,
    CandidateDeletion,
    CandidateDuplicationTandem,
    CandidateInversion,
    CandidateNovelInsertion,
)
from svbench.reference.cluster import cluster_candidates, cluster_signatures
from svbench.reference.collect import collect
from svbench.reference.fasta import FastaFile
from svbench.reference.merging import (
    flag_cutpaste_candidates,
    merge_translocations_at_insertions,
)

ALIGNMENT_CAP = 500   # alignments a locus (SVIM_genotyping.py:56)
WINDOW = 1000         # bp around a locus (SVIM_genotyping.py:49)
CONSENSUS_PADDING = 100   # bp of window each side (SVIM_COMBINE.py:198)
SIZE_DEVIATION = 2.0      # accepted size ratio (SVIM_COMBINE.py:201)
CONSENSUS_SAMPLE = 32     # insertion clusters whose consensus is worked out


def signature_lines(clusters):
    """The lines of the seven signature-cluster BED files and of all.vcf,
    by file name, in the order the program writes them
    (SVIM_CLUSTER.py:29-107)."""
    deletion, insertion, inversion, tandem, insertion_from, translocation = \
        clusters
    files = defaultdict(list)
    for name, group in (("del.bed", deletion), ("ins.bed", insertion),
                        ("inv.bed", inversion)):
        files[name] = [cluster.get_bed_entry() for cluster in group]
    for cluster in tandem:
        source, dest = cluster.get_bed_entries()
        files["dup_tan_source.bed"].append(source)
        files["dup_tan_dest.bed"].append(dest)
    for name, group in (("dup_int.bed", insertion_from),
                        ("trans.bed", translocation)):
        for cluster in group:
            files[name].extend(cluster.get_bed_entries())
    entries = [(cluster.get_source(), cluster.get_vcf_entry())
               for group in (deletion, insertion, inversion, tandem)
               for cluster in group]
    files["all.vcf"] = [entry for _, entry in sorted(entries,
                                                     key=lambda pair: pair[0])]
    return dict(files)


def members_key(members):
    return "[" + "][".join(member.as_string("|") for member in members) + "]"


class ProgramInsertions:
    """The program's insertion candidates: (start, end) by members, from
    candidates_novel_insertions.bed, and its INS records by (CHROM, POS,
    INFO), from variants.vcf."""

    def __init__(self, bed_lines, vcf_records):
        self.coordinates = {}
        for line in bed_lines:
            fields = line.split("\t")
            self.coordinates[fields[6]] = (int(fields[1]), int(fields[2]))
        self.alt = defaultdict(list)
        for fields in vcf_records:
            if fields[7].startswith("SVTYPE=INS;"):
                self.alt[(fields[0], fields[1], fields[7])].append(fields[4])


def insertion_consensus(cluster, program, reference):
    """(start, end, sequence, fault) of an insertion cluster of three or more
    signatures, as the program's consensus left it (the sequence None: it
    is read from the program's record).  `fault` is 1 where the outcome
    breaks SVIM's acceptance rule or cannot be found."""
    found = program.coordinates.get(members_key(cluster.members))
    if found is None:
        return cluster.start, cluster.end, "", 1
    start, end = found
    if (start, end) == (cluster.start, cluster.end):
        return start, end, None, 0
    positions = [member.start for member in cluster.members]
    low = max(0, min(positions) - CONSENSUS_PADDING)
    high = max(positions) + CONSENSUS_PADDING
    expected = cluster.end - cluster.start
    size = end - start
    accepted = (low <= start <= high and size > 0 and expected > 0
                and max(size, expected) / min(size, expected) < SIZE_DEVIATION)
    return start, end, None, 0 if accepted else 1


def _remove_insertions_at_duplications(insertions, int_duplications,
                                       tandem_duplications):
    """SVIM_COMBINE.py:404-457, its quirk included: tandem duplications are
    looked at only once the interspersed ones are exhausted."""
    int_iter = iter(sorted(int_duplications,
                           key=lambda cand: cand.get_destination()))
    tan_iter = iter(sorted(tandem_duplications,
                           key=lambda cand: cand.get_destination()))
    current_int = next(int_iter, None)
    current_tan = next(tan_iter, None)
    removed = []
    for index, region in enumerate(insertions):
        contig1, start1, end1 = region.get_source()
        length1 = end1 - start1
        if current_int is not None:
            contig2, start2, end2 = current_int.get_destination()
            while contig2 < contig1 or (contig2 == contig1 and end2 < start1):
                current_int = next(int_iter, None)
                if current_int is None:
                    break
                contig2, start2, end2 = current_int.get_destination()
        if current_int is not None:
            contig2, start2, end2 = current_int.get_destination()
            length2 = end2 - start2
            if (contig2 == contig1 and start2 < end1
                    and (length1 - length2) / max(length1, length2) < 0.2):
                removed.append(index)
        elif current_tan is not None:
            contig2, start2, end2 = current_tan.get_destination()
            while contig2 < contig1 or (contig2 == contig1 and end2 < start1):
                current_tan = next(tan_iter, None)
                if current_tan is None:
                    break
                contig2, start2, end2 = current_tan.get_destination()
            if current_tan is not None:
                contig2, start2, end2 = current_tan.get_destination()
                length2 = end2 - start2
                if (contig2 == contig1 and start2 < end1
                        and (length1 - length2) / max(length1, length2) < 0.2):
                    removed.append(index)
    return removed


def consensus_sample(clusters, seed, count=CONSENSUS_SAMPLE):
    """Indices of the insertion clusters whose consensus the reference works
    out: the one of most inserted bases, and count - 1 more drawn from the
    seed."""
    if len(clusters) <= count:
        return set(range(len(clusters)))
    largest = max(range(len(clusters)), key=lambda k: (sum(
        len(member.sequence) for member in clusters[k].members), -k))
    others = [k for k in range(len(clusters)) if k != largest]
    drawn = np.random.default_rng(int(seed) % (1 << 63)).choice(
        len(others), count - 1, replace=False)
    return {largest} | {others[k] for k in drawn.tolist()}


def combine(clusters, options, program, reference, seed=0, workers=8):
    """The six candidate lists (SVIM_COMBINE.py:332-478), the count of
    followed insertion consensus outcomes that break SVIM's acceptance
    rule.  With `skip_consensus` every insertion keeps its
    cluster's place and no sequence, as SVIM's --skip_consensus does."""
    deletion, insertion, inversion, tandem, insertion_from, translocation = \
        [list(group) for group in clusters]
    inversions = [CandidateInversion(c.contig, c.start, c.end, c.members,
                                     c.score, c.std_span, c.std_pos)
                  for c in inversion]
    tandems = []
    for c in tandem:
        source_contig, source_start, source_end = c.get_source()
        _, dest_start, dest_end = c.get_destination()
        tandems.append(CandidateDuplicationTandem(
            source_contig, source_start, source_end,
            int(round((dest_end - dest_start) / (source_end - source_start))),
            bool(sum(sig.fully_covered for sig in c.members)), c.members,
            c.score, c.std_span, c.std_pos))
    breakends = [CandidateBreakend(c.source_contig, c.source_start,
                                   c.direction1, c.dest_contig, c.dest_start,
                                   c.direction2, c.members, c.score,
                                   c.std_span, c.std_pos)
                 for c in translocation]
    new_from, removed_1 = merge_translocations_at_insertions(
        translocation, insertion, options)
    int_duplications = flag_cutpaste_candidates(insertion_from + new_from,
                                                deletion, options)
    removed_2 = _remove_insertions_at_duplications(insertion,
                                                   int_duplications, tandems)
    for index in sorted(set(removed_1 + removed_2), reverse=True):
        del insertion[index]
    deletions = [CandidateDeletion(c.contig, c.start, c.end, c.members,
                                   c.score, c.std_span, c.std_pos)
                 for c in deletion if c.score > 0]
    insertion = [c for c in insertion if c.score > 0]
    eligible = [k for k, c in enumerate(insertion) if len(c.members) >= 3]
    own = {}
    if not options.skip_consensus:
        sample = sorted(eligible[k] for k in consensus_sample(
            [insertion[k] for k in eligible], seed))
        own = dict(zip(sample, consensus.outcomes(
            [insertion[k] for k in sample], reference,
            options.max_consensus_length, workers)))
    insertions = []
    faults = 0
    for index, c in enumerate(insertion):
        if options.skip_consensus:
            start, end, sequence = c.start, c.end, ""
        elif len(c.members) < 3:
            start, end, sequence = c.start, c.end, c.members[0].sequence
        elif index in own:
            status, found = own[index]
            if status == 0:
                start, size, sequence = found
                end = start + size
            else:
                start, end, sequence = c.start, c.end, ""
        else:
            start, end, sequence, fault = insertion_consensus(c, program,
                                                              reference)
            faults += fault
        candidate = CandidateNovelInsertion(c.contig, start, end,
                                            "" if sequence is None else sequence,
                                            c.members, c.score, c.std_span,
                                            c.std_pos)
        candidate.from_program = sequence is None
        candidate.sampled = index in own
        # a sampled cluster that the program placed elsewhere
        candidate.elsewhere = (index in own and program.coordinates.get(
            members_key(c.members)) != (start, end))
        candidate.moved = (start, end) != (c.start, c.end)
        insertions.append(candidate)
    int_final = cluster_candidates(int_duplications, options)
    return (deletions, inversions, int_final, tandems, insertions,
            breakends), faults


class GenotypeIndex:
    """Eligible alignments a contig, sorted by start, for SVIM's region
    query around a locus."""

    def __init__(self, columns, header):
        ref_id, starts, ends, names = columns.arrays()
        self.name_ids = columns.name_ids
        self.lengths = header.lengths
        self.per_tid = {}
        for tid in np.unique(ref_id).tolist():
            rows = np.flatnonzero(ref_id == tid)
            rows = rows[np.lexsort((rows, starts[rows]))]
            span = int((ends[rows] - starts[rows]).max()) if len(rows) else 0
            self.per_tid[tid] = (starts[rows], ends[rows], names[rows], span)

    def reference_support(self, tid, start, end, kind, support_ids):
        entry = self.per_tid.get(tid)
        if entry is None:
            return 0
        starts, ends, ids, span = entry
        window_start = max(0, start - WINDOW)
        window_stop = min(self.lengths[tid], end + WINDOW)
        low = np.searchsorted(starts, window_start - span, side="left")
        high = np.searchsorted(starts, window_stop, side="left")
        w_starts, w_ends, w_ids = starts[low:high], ends[low:high], ids[low:high]
        qualifying = np.flatnonzero(
            (w_ends > window_start)
            & ~np.isin(w_ids, np.asarray(sorted(support_ids), dtype=np.int64)))
        qualifying = qualifying[:ALIGNMENT_CAP]
        c_starts, c_ends = w_starts[qualifying], w_ends[qualifying]
        if kind in ("DEL", "INV"):
            overlap = min((end - start) / 2, 2000)
            supports = (((c_starts < end - overlap) & (c_ends > end + 100))
                        | ((c_starts < start - 100) & (c_ends > start + overlap)))
        else:
            supports = (c_starts < start - 100) & (c_ends > end + 100)
        return len(np.unique(w_ids[qualifying][supports]))


def genotype(candidates, kind, index, header, options):
    """SVIM_genotyping.py:34-94 over one candidate list."""
    for candidate in candidates:
        if candidate.score < options.minimum_score:
            continue
        if kind in ("INS", "DUP_INT"):
            contig, start, _ = candidate.get_destination()
            end = start
        else:
            contig, start, end = candidate.get_source()
        names = set(sig.read for sig in candidate.members)
        support_ids = {index.name_ids[name] for name in names
                       if name in index.name_ids}
        alt = len(names)
        ref = index.reference_support(header.get_tid(contig), start, end,
                                      kind, support_ids)
        total = alt + ref
        if total >= options.minimum_depth:
            candidate.support_fraction = alt / total
            if candidate.support_fraction >= options.homozygous_threshold:
                candidate.genotype = "1/1"
            elif candidate.support_fraction >= options.heterozygous_threshold:
                candidate.genotype = "0/1"
            else:
                candidate.genotype = "0/0"
        elif total > 0:
            candidate.support_fraction = alt / total
            candidate.genotype = "./."
        else:
            candidate.support_fraction = "."
            candidate.genotype = "./."
        candidate.ref_reads = ref
        candidate.alt_reads = alt


def _natural(text):
    return [int(part) if part.isdigit() else part
            for part in re.split("([0-9]+)", text)]


def final_records(candidates, options, fasta, program):
    """variants.vcf's records as field lists, in the program's order and
    with its svim.<TYPE>.<N> identifiers (SVIM_COMBINE.py:71-186); the
    count of followed consensus outcomes whose record cannot be found or
    is not what the outcome says; (of the followed insertions of three or
    more signatures, those whose consensus the program did not apply: a
    symbolic record); and the count of sampled insertions whose record
    the program wrote with another allele, or did not write."""
    deletions, inversions, int_duplications, tandems, insertions, breakends = \
        candidates
    entries = []
    for candidate in deletions:
        entries.append((candidate.get_source(),
                        candidate.get_vcf_entry(True, fasta), "DEL"))
    for candidate in inversions:
        entries.append((candidate.get_source(),
                        candidate.get_vcf_entry(True, fasta), "INV"))
    missing = unapplied = followed = unlike = 0
    for candidate in insertions:
        line = candidate.get_vcf_entry(True, fasta)
        if candidate.sampled:
            fields = line.split("\t")
            unlike += candidate.elsewhere or program.alt.get(
                (fields[0], fields[1], fields[7]), []) != [fields[4]]
        if candidate.from_program:
            followed += 1
            fields = line.split("\t")
            alts = program.alt.get((fields[0], fields[1], fields[7]), [])
            if len(alts) != 1:
                missing += 1
            else:
                fields[4] = alts[0]
                if alts[0].startswith("<"):
                    fields[3] = "N"
                    unapplied += 1
                    if candidate.moved:
                        missing += 1
                else:
                    start = candidate.get_destination()[1]
                    fields[3] = fasta.fetch(candidate.source_contig,
                                            max(0, start - 1),
                                            max(0, start - 1) + 1).upper()
                    if (alts[0][:1] != fields[3]
                            or len(alts[0]) - 1 != candidate.source_end
                            - candidate.source_start):
                        missing += 1
                line = "\t".join(fields)
        entries.append((candidate.get_destination(), line, "INS"))
    for candidate in tandems:
        entries.append((candidate.get_source(),
                        candidate.get_vcf_entry_as_dup(), "DUP_TANDEM"))
    for candidate in int_duplications:
        entries.append((candidate.get_source(),
                        candidate.get_vcf_entry_as_dup(), "DUP_INT"))
    for candidate in breakends:
        source, dest = candidate.get_source(), candidate.get_destination()
        entries.append(((source[0], source[1], source[1] + 1),
                        candidate.get_vcf_entry(), "BND"))
        entries.append(((dest[0], dest[1], dest[1] + 1),
                        candidate.get_vcf_entry_reverse(), "BND"))
    entries.sort(key=lambda entry: (_natural(str(entry[0][0])), entry[0][1],
                                    entry[0][2]))
    counter = defaultdict(int)
    records = []
    for _, line, kind in entries:
        counter[kind] += 1
        records.append(line.replace("PLACEHOLDERFORID",
                                    "svim.{0}.{1}".format(kind, counter[kind]),
                                    1).split("\t"))
    return records, missing, (unapplied, followed), unlike


def analyse(bam_path, options, device, threads=8):
    """COLLECT and CLUSTER of the reference: (header, genotype columns,
    clusters, signature lines by file, reads walked, seconds by stage)."""
    started = time.perf_counter()
    header, signatures, columns, reads = collect(bam_path, options, threads)
    collected = time.perf_counter()
    clusters = cluster_signatures(signatures, options, device)
    lines = signature_lines(clusters)
    seconds = {"collect": collected - started,
               "cluster": time.perf_counter() - collected}
    return header, columns, clusters, lines, reads, seconds


def finish(analysis, options, program, seed=0, workers=8):
    """COMBINE, GENOTYPE and the records from an `analyse` result, the
    consensus of the clusters sampled from `seed` worked out in `workers`
    processes and that of the others followed from `program`
    (ProgramInsertions); the analysis is left as it was, so it serves
    several."""
    header, columns, clusters, lines, reads, seconds = analysis
    started = time.perf_counter()
    with FastaFile(options.genome) as fasta:
        candidates, faults = combine(clusters, options, program, fasta,
                                     seed, workers)
        index = GenotypeIndex(columns, header)
        deletions, inversions, int_duplications, _, insertions, _ = candidates
        for group, kind in ((deletions, "DEL"), (inversions, "INV"),
                            (insertions, "INS"),
                            (int_duplications, "DUP_INT")):
            genotype(group, kind, index, header, options)
        records, missing, unapplied, unlike = final_records(
            candidates, options, fasta, program)
    sampled = sum(1 for c in insertions if c.sampled)
    return dict(signature_lines=lines, records=records, reads=reads,
                consensus_faults=faults + missing,
                consensus_unapplied=unapplied,
                consensus_sampled=(unlike, sampled),
                insertion_bed=[c.get_bed_entry() for c in insertions],
                seconds=dict(seconds, finish=time.perf_counter() - started))
