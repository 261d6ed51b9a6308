"""The comparison that decides `correct`: what the last job of the window
wrote, against the plain reference (svbench/reference) run on the same
made BAM and genome.  Every number is a count of lines that differ, whose
limit is 0:

- signatures: the signatures of every cluster, from the signature-cluster
  BED files (COLLECT);
- clusters: the lines of the seven signature-cluster BED files and of
  signatures/all.vcf (CLUSTER);
- records: the records of variants.vcf, ##fileDate and the other header
  lines left out (COMBINE and GENOTYPE);
- poa: insertion clusters of three or more signatures, sampled from the
  run's seed (the one of most inserted bases always among them), whose
  consensus the reference works out itself (svbench/reference/consensus.py)
  and the program placed elsewhere or wrote with another allele;
- consensus: the other clusters' consensus outcomes, taken from the
  program, that break SVIM's acceptance rule or cannot be found;

and one count whose limit was set from readings (PERF.md):

- unapplied: the share, in %, of the insertion clusters of three or more
  signatures that the program wrote without a consensus (a symbolic
  record at the cluster's place), which SVIM allows only where its POA or
  realignment fails.
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter

from svbench.reference.options import reference_options
from svbench.reference.pipeline import ProgramInsertions, analyse, finish

# the largest share of insertions a job may leave without a consensus, in
# %: above every sound run's and far below the control's (PERF.md, 2)
UNAPPLIED_LIMIT = 10.0
SIGNATURE_FILES = ("del.bed", "ins.bed", "inv.bed", "dup_tan_source.bed",
                   "dup_tan_dest.bed", "trans.bed", "dup_int.bed", "all.vcf")


def _lines(path, skip_headers=False):
    with open(path) as handle:
        lines = handle.read().splitlines()
    if skip_headers:
        lines = [line for line in lines if not line.startswith("#")]
    return lines


def differing(first, second):
    """Lines in one multiset and not in the other, both ways."""
    a, b = Counter(first), Counter(second)
    return sum(((a - b) + (b - a)).values())


def members(lines):
    found = []
    for line in lines:
        field = line.rsplit("\t", 1)[-1]
        if field.startswith("[") and field.endswith("]"):
            found.extend(field[1:-1].split("]["))
    return found


def program_output(workdir):
    signatures = {name: _lines(os.path.join(workdir, "signatures", name),
                               skip_headers=name.endswith(".vcf"))
                  for name in SIGNATURE_FILES}
    insertions = _lines(os.path.join(workdir, "candidates",
                                     "candidates_novel_insertions.bed"))
    records = [line.split("\t") for line in
               _lines(os.path.join(workdir, "variants.vcf"), skip_headers=True)]
    return signatures, insertions, records


def reference_analysis(bam, genome, arguments, device, threads=8):
    """The reference's COLLECT and CLUSTER on the made input, and its
    options."""
    options = reference_options(arguments, genome, os.path.dirname(bam))
    return options, analyse(bam, options, device, threads)


def reference_output(analysis, insertions, records, skip_consensus=False,
                     seed=0, threads=8):
    """The reference's output from `analysis`, its insertion consensus
    worked out for the clusters sampled from `seed` and followed from the
    judged output for the others (`insertions`: its candidate BED lines,
    `records`: its VCF records): (signature lines by file, records as field
    lists, consensus faults, (consensus not applied, followed), reads
    walked, the reference's own insertion candidate BED lines, (sampled
    consensus unlike the judged output's, sampled))."""
    options, analysed = analysis
    options.skip_consensus = skip_consensus
    result = finish(analysed, options, ProgramInsertions(insertions, records),
                    seed, threads)
    options.skip_consensus = False
    print("reference seconds {0}".format(json.dumps(result["seconds"])),
          file=sys.stderr, flush=True)
    return (result["signature_lines"], result["records"],
            result["consensus_faults"], result["consensus_unapplied"],
            result["reads"], result["insertion_bed"],
            result["consensus_sampled"])


def numbers(output, reference):
    """{name: {"value": count, "limit": 0}} of `output` (signature lines by
    file, records) against the reference's."""
    signatures, records = output
    ours, our_records, consensus, unapplied, reads, _, sampled = reference
    bed_names = [name for name in SIGNATURE_FILES if name.endswith(".bed")]
    print("compared: {0} signatures, {1} cluster lines, {2} records, {4} "
          "insertion consensus worked out; the reference walked {3} "
          "reads".format(
              len(members(line for name in bed_names
                          for line in signatures.get(name, []))),
              sum(len(lines) for lines in signatures.values()), len(records),
              reads, sampled[1]), file=sys.stderr, flush=True)
    return {
        "signatures": {"value": differing(
            members(line for name in bed_names
                    for line in signatures.get(name, [])),
            members(line for name in bed_names for line in ours.get(name, []))),
            "limit": 0},
        "clusters": {"value": sum(differing(signatures.get(name, []),
                                            ours.get(name, []))
                                  for name in SIGNATURE_FILES), "limit": 0},
        "records": {"value": differing(["\t".join(r) for r in records],
                                       ["\t".join(r) for r in our_records]),
                    "limit": 0},
        "poa": {"value": sampled[0], "limit": 0},
        "consensus": {"value": consensus, "limit": 0},
        "unapplied": {"value": 100.0 * unapplied[0] / max(1, unapplied[1]),
                      "limit": UNAPPLIED_LIMIT},
    }


def check(workdir, bam, genome, arguments, device, seed, threads=8):
    """The numbers of the job written to `workdir`, against the reference,
    the consensus sample drawn from `seed`."""
    signatures, insertions, records = program_output(workdir)
    analysis = reference_analysis(bam, genome, arguments, device, threads)
    return numbers((signatures, records),
                   reference_output(analysis, insertions, records, seed=seed,
                                    threads=threads))
