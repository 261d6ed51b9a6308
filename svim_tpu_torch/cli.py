"""Command-line driver of the port: COLLECT -> CLUSTER -> COMBINE ->
GENOTYPE -> output, on the device `utils.device.select_device` picks.

Counterpart of svim_tpu/cli.py (svim/svim:25-217).  `alignment` mode takes
a coordinate-sorted BGZF BAM (one-shot or streaming COLLECT), SAM text, or
a queryname-sorted file; `reads` mode aligns raw reads first (align.py) and
collects from the resulting BAM, one file or a list of files.  The stages
are the port's; logging setup, argument parsing, writers, plots and the
host genotyping of parsed records are svim_tpu's.  --device_backend cpu
runs every stage on the CPU, host takes the record-based host COLLECT and
GENOTYPE, tpu is refused (utils/device.py).  --distributed runs this process
as one rank of a torch.distributed group (parallel/multihost.py): ranged
COLLECT, one table exchange, CLUSTER and the insertion consensus sharded
over the ranks, and only rank 0 writes.  --num_shards cuts the batched
ops' leading axis over the visible devices (parallel/mesh.py).
"""

from __future__ import annotations

import json
import logging
import os
import sys

from time import localtime, strftime

from svim_tpu_torch import __version__
from svim_tpu_torch.config import (
    guess_file_type,
    parse_arguments,
    read_file_list,
)
from svim_tpu_torch.output import (
    write_candidates,
    write_final_vcf,
    write_signature_clusters_bed,
    write_signature_clusters_vcf,
)
from svim_tpu_torch.utils.timing import StageTimer
from svim_tpu_torch.cluster.cluster import cluster_sv_signatures
from svim_tpu_torch.combine.combine import combine_clusters
from svim_tpu_torch.parallel import multihost
from svim_tpu_torch.utils.device import describe, select_device


def _setup_logging(options):
    """Root logger to <working_dir>/SVIM_<time>[.p<rank>].log and the
    console (the reference's format, svim/svim:34-47)."""
    log_formatter = logging.Formatter(
        "%(asctime)s [%(levelname)-7.7s]  %(message)s")
    root_logger = logging.getLogger()
    root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)
    os.makedirs(options.working_dir, exist_ok=True)
    rank_suffix = ""
    if options.distributed:
        rank_suffix = ".p{0}".format(multihost.process_index())
    file_handler = logging.FileHandler(
        os.path.join(options.working_dir, "SVIM_{0}{1}.log".format(
            strftime("%y%m%d_%H%M%S", localtime()), rank_suffix)), mode="w")
    file_handler.setFormatter(log_formatter)
    root_logger.addHandler(file_handler)
    console_handler = logging.StreamHandler()
    console_handler.setFormatter(log_formatter)
    root_logger.addHandler(console_handler)


def _plots(options, deletion_candidates, inversion_candidates,
           int_duplication_candidates, tan_dup_candidates,
           novel_insertion_candidates):
    """The reference's SV-length and genotype plots; skipped with a warning
    where matplotlib is not installed (they are not part of the calls)."""
    try:
        from svim_tpu_torch.plots import plot_sv_alleles, plot_sv_lengths
    except ModuleNotFoundError as error:
        if error.name != "matplotlib":
            raise
        logging.warning("matplotlib is not installed: skipping the SV length "
                        "and genotype plots.")
        return
    plot_sv_lengths(deletion_candidates, inversion_candidates,
                    int_duplication_candidates, tan_dup_candidates,
                    novel_insertion_candidates, options)
    if not options.skip_genotyping:
        plot_sv_alleles(deletion_candidates + inversion_candidates
                        + int_duplication_candidates
                        + novel_insertion_candidates, options)


def _collect_reads(options, device):
    """COLLECT for `reads` mode (svim_tpu/cli.py:79-130): align each reads
    file (or reuse its cached BAM), collect from the BAM, concatenate the
    files' signatures; genotyping uses the LAST file's alignments, matching
    the reference's trailing aln_file (svim:73-82).  Returns (alignment index
    or AlignmentFile, signatures, all_bnds twins), or None for an input of
    unknown type."""
    from svim_tpu_torch.align import run_alignment
    from svim_tpu_torch.collect.collect import (
        analyze_alignment_file_coordsorted,
    )
    from svim_tpu_torch.collect.packed import collect_soa_from_bam
    from svim_tpu_torch.io.packed_fetch import PackedAlignmentIndex
    from svim_tpu_torch.io.sam import AlignmentFile
    from svim_tpu_torch.sigtable import concat_soa

    logging.info("MODE: reads")
    logging.info("INPUT: {0}".format(os.path.abspath(options.reads)))
    logging.info("GENOME: {0}".format(os.path.abspath(options.genome)))
    reads_type = guess_file_type(options.reads)
    if reads_type == "unknown":
        return None
    if reads_type == "list":
        files = read_file_list(options.reads)
    else:
        files = [options.reads]
    use_packed = options.device_backend != "host"
    aln_file = None
    soa_parts = []
    sv_signatures = []
    twins = []
    for index, file_path in enumerate(files):
        file_type = reads_type
        if reads_type == "list":
            logging.info("Starting processing of file {0} from the "
                         "list..".format(index))
            file_type = guess_file_type(file_path)
            if file_type in ("unknown", "list"):
                return None
        bam_path = run_alignment(options.working_dir, options.genome,
                                 file_path, file_type, options.cores,
                                 options.aligner, options.nanopore)
        if use_packed:
            header, table, sigs, file_twins = collect_soa_from_bam(
                bam_path, options, device)
            aln_file = PackedAlignmentIndex(table, header)
            soa_parts.append(sigs)
        else:
            aln_file = AlignmentFile(bam_path)
            sigs, file_twins = analyze_alignment_file_coordsorted(aln_file,
                                                                  options)
            sv_signatures.extend(sigs)
        twins.extend(file_twins)
    if soa_parts:
        sv_signatures = (concat_soa(soa_parts) if reads_type == "list"
                         else soa_parts[0])
    return aln_file, sv_signatures, twins


def _collect(options, device):
    """COLLECT for either mode (svim_tpu/cli.py:76-194).

    `reads` mode goes through _collect_reads.  In `alignment` mode a
    coordinate-sorted BGZF BAM goes through the packed scanners (under
    --distributed: this rank's byte range, then the table exchange); SAM
    text and queryname-sorted input are parsed into records first.  Under
    --device_backend host every input is parsed into records and walked by
    the host code of collect/collect.py, with no device pass.  Returns
    (alignment index or AlignmentFile, signatures, all_bnds twins,
    options), or None for an input that cannot be used (logged as the
    reference does)."""
    from svim_tpu_torch.io.bamstream import peek_bam_header
    from svim_tpu_torch.io.packed_fetch import PackedAlignmentIndex
    from svim_tpu_torch.io.sam import AlignmentFile
    from svim_tpu_torch.collect import packed as collect_packed
    from svim_tpu_torch.collect.collect import (
        analyze_alignment_file_coordsorted,
        analyze_alignment_file_querysorted,
    )

    if options.sub == "reads":
        result = _collect_reads(options, device)
        return None if result is None else result + (options,)

    host = options.device_backend == "host"
    logging.info("MODE: alignment")
    logging.info("INPUT: {0}".format(os.path.abspath(options.bam_file)))
    with open(options.bam_file, "rb") as probe:
        is_bgzf = probe.read(2) == b"\x1f\x8b"
    if options.distributed:
        if not is_bgzf:
            logging.error("--distributed requires a coordinate-sorted BGZF BAM "
                          "input (byte-range ingestion).")
            return None
        merged_index, sigs, trans = multihost.collect_distributed(options,
                                                                  device)
        logging.info("Distributed COLLECT merged {0} signatures across {1} "
                     "processes on {2}".format(
                         sigs.total(), multihost.process_count(),
                         describe(device)))
        return merged_index, sigs, trans, options
    if is_bgzf and not host:
        try:
            peeked_order = peek_bam_header(options.bam_file).sort_order
        except (ValueError, OSError):
            peeked_order = None
        if peeked_order == "coordinate":
            header, table, sigs, trans = collect_packed.collect_soa_from_bam(
                options.bam_file, options, device)
            logging.info("Using the packed array COLLECT path on {0}".format(
                describe(device)))
            return PackedAlignmentIndex(table, header), sigs, trans, options

    aln_file = AlignmentFile(options.bam_file)
    try:
        sort_order = aln_file.header["HD"]["SO"]
    except KeyError:
        logging.error("Is the given input BAM file sorted? It does not "
                      "contain a sorting order in its header line.")
        return None
    if sort_order == "coordinate":
        if host:
            sigs, trans = analyze_alignment_file_coordsorted(aln_file, options)
        else:
            sigs, trans = collect_packed.collect_signatures_packed(
                aln_file, options, device)
    elif sort_order == "queryname":
        if host:
            sigs, trans = analyze_alignment_file_querysorted(aln_file, options)
        else:
            sigs, trans = collect_packed.collect_signatures_packed_querysorted(
                aln_file, options, device)
        logging.warning("Skipping genotyping because it requires a "
                        "coordinate-sorted input BAM file. The given file is "
                        "queryname-sorted according to its header line.")
        options = options.replace(skip_genotyping=True)
    else:
        logging.error("Input BAM file needs to be coordinate-sorted or "
                      "queryname-sorted. The given file, however, is unsorted "
                      "according to its header line.")
        return None
    return aln_file, sigs, trans, options


def run_pipeline(options, device):
    """The four-stage pipeline on `device`; returns the exit code."""
    root_logger = logging.getLogger()
    trace_requested = getattr(options, "profile_trace", False)
    timer = StageTimer(
        enabled=options.profile or trace_requested,
        trace_dir=(os.path.join(options.working_dir, "traces")
                   if trace_requested else None))
    if trace_requested:
        logging.warning("--profile_trace instruments host threads; traced "
                        "host-bound stage wall times run above their real "
                        "duration. Use --profile alone for timings.")

    if options.num_shards > 1:
        from svim_tpu_torch.parallel.mesh import log_layout

        log_layout(options.num_shards, device)

    logging.info("****************** STEP 1: COLLECT ******************")
    with timer.stage("collect", trace=True):
        result = _collect(options, device)
    if result is None:
        return 1
    (aln_file, sv_signatures, translocation_signatures_all_bnds,
     options) = result

    type_names = {
        "DEL": "deleted regions", "INS": "inserted regions",
        "INV": "inverted regions", "DUP_TAN": "tandem duplicated regions",
        "BND": "translocation breakpoints",
        "DUP_INT": "inserted regions with detected region of origin"}
    from svim_tpu_torch.sigtable import SignatureSoA

    if isinstance(sv_signatures, SignatureSoA):
        count_of = sv_signatures.count
    else:
        def count_of(sv_type):
            return sum(1 for sig in sv_signatures if sig.type == sv_type)
    for sv_type in ("DEL", "INS", "INV", "DUP_TAN", "BND"):
        logging.info("Found {0} signatures for {1}.".format(
            count_of(sv_type), type_names[sv_type]))
    if options.all_bnds:
        logging.info("Found {0} signatures for translocation breakpoints from "
                     "other SV classes (DEL, INV, DUP).".format(
                         len(translocation_signatures_all_bnds)))
    logging.info("Found {0} signatures for {1}.".format(
        count_of("DUP_INT"), type_names["DUP_INT"]))

    logging.info("****************** STEP 2: CLUSTER ******************")
    with timer.stage("cluster", trace=True):
        if (options.distributed and multihost.process_count() > 1
                and isinstance(sv_signatures, SignatureSoA)):
            # per-partition linkage sharded across ranks; identical global
            # cluster lists come back on every rank
            from svim_tpu_torch.parallel.cluster_shard import (
                cluster_sv_signatures_sharded,
            )

            signature_clusters = cluster_sv_signatures_sharded(
                sv_signatures, options, device)
        else:
            signature_clusters = cluster_sv_signatures(sv_signatures,
                                                       options, device)
        translocation_clusters_all_bnds = None
        if options.all_bnds:
            root_logger.setLevel(logging.WARNING)
            translocation_clusters_all_bnds = cluster_sv_signatures(
                translocation_signatures_all_bnds, options, device)
            root_logger.setLevel(logging.DEBUG if options.verbose
                                 else logging.INFO)

    # in distributed runs every process computes the full pipeline (the
    # stages after the exchange are deterministic); only process 0 writes
    primary = multihost.process_index() == 0

    logging.info("Finished clustering. Writing signature clusters..")
    if primary:
        written_clusters = signature_clusters
        if options.all_bnds:
            written_clusters = signature_clusters[:5] + (
                signature_clusters[5] + translocation_clusters_all_bnds[5],)
        write_signature_clusters_bed(options.working_dir, written_clusters)
        write_signature_clusters_vcf(options.working_dir, written_clusters,
                                     __version__)

    logging.info("****************** STEP 3: COMBINE ******************")
    with timer.stage("combine"):
        (deletion_candidates, inversion_candidates, int_duplication_candidates,
         tan_dup_candidates, novel_insertion_candidates,
         breakend_candidates) = combine_clusters(signature_clusters, options,
                                                 device)
        breakend_candidates_all_bnds = []
        if options.all_bnds:
            root_logger.setLevel(logging.WARNING)
            breakend_candidates_all_bnds = combine_clusters(
                translocation_clusters_all_bnds, options, device)[5]
            root_logger.setLevel(logging.DEBUG if options.verbose
                                 else logging.INFO)

    if not options.skip_genotyping:
        logging.info("****************** STEP 4: GENOTYPE ******************")
        from svim_tpu_torch.genotype import genotype
        from svim_tpu_torch.genotype import genotype_packed_multi

        genotype_groups = (
            (deletion_candidates, "DEL", "deletions"),
            (inversion_candidates, "INV", "inversions"),
            (novel_insertion_candidates, "INS", "novel insertions"),
            (int_duplication_candidates, "DUP_INT",
             "interspersed duplications"),
        )
        with timer.stage("genotype"):
            if hasattr(aln_file, "packed"):
                # the packed table of a BAM scan (one-shot, streaming, or
                # the ranks' merged one): one batched interval join on the
                # device
                genotype_packed_multi(genotype_groups, aln_file.packed,
                                      aln_file.header, options, device)
            else:
                # parsed records (SAM text): svim_tpu's host region queries
                for candidates, type_name, label in genotype_groups:
                    logging.info("Genotyping {0}..".format(label))
                    genotype(candidates, aln_file, type_name, options)

    logging.info("Write SV candidates..")
    logging.info("Final deletion candidates: {0}".format(
        len(deletion_candidates)))
    logging.info("Final inversion candidates: {0}".format(
        len(inversion_candidates)))
    logging.info("Final interspersed duplication candidates: {0}".format(
        len(int_duplication_candidates)))
    logging.info("Final tandem duplication candidates: {0}".format(
        len(tan_dup_candidates)))
    logging.info("Final novel insertion candidates: {0}".format(
        len(novel_insertion_candidates)))
    logging.info("Final breakend candidates: {0}".format(
        len(breakend_candidates)))
    if options.all_bnds:
        logging.info("Final breakend candidates from other SV classes (DEL, "
                     "INV, DUP): {0}".format(len(breakend_candidates_all_bnds)))
    all_breakends = breakend_candidates + breakend_candidates_all_bnds

    with timer.stage("output"):
        if primary:
            write_candidates(options.working_dir,
                             (int_duplication_candidates, inversion_candidates,
                              tan_dup_candidates, deletion_candidates,
                              novel_insertion_candidates, all_breakends))
            write_final_vcf(int_duplication_candidates, inversion_candidates,
                            tan_dup_candidates, deletion_candidates,
                            novel_insertion_candidates, all_breakends,
                            __version__, aln_file.references, aln_file.lengths,
                            options.types_to_output, options)

    logging.info("Draw plots..")
    root_logger.setLevel(logging.WARNING)
    with timer.stage("plots"):
        if primary:
            _plots(options, deletion_candidates, inversion_candidates,
                   int_duplication_candidates, tan_dup_candidates,
                   novel_insertion_candidates)
    root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)
    timer.report()
    if timer.enabled:
        # unrounded, for scripts that read the log (chip_smoke.py)
        from svim_tpu_torch.cluster.device_cluster import TELEMETRY
        from svim_tpu_torch.ops import launch_counts

        logging.info("Stage seconds: %s", json.dumps(timer.durations))
        logging.info("Kernel launches: %s", json.dumps(launch_counts()))
        logging.info("Cluster telemetry: %s", json.dumps(
            dict(TELEMETRY.as_dict(), eligible=TELEMETRY.eligible)))
        if options.distributed:
            logging.info("Exchange totals: %s", json.dumps({
                "sent": multihost.EXCHANGE.sent,
                "received": multihost.EXCHANGE.received,
                "rounds": multihost.EXCHANGE.rounds}))
    logging.info("Done.")
    return 0


def main(arguments=None):
    options = parse_arguments(program_version=__version__, arguments=arguments)
    if not options.sub:
        print("Please choose one of the two modes ('reads' or 'alignment'). "
              "See --help for more information.")
        return 1
    device = select_device(options.device_backend, options.distributed)
    if not options.distributed:
        return _run(options, device)
    multihost.initialize_from_env()
    try:
        return _run(options, device)
    finally:
        multihost.shutdown()


def _run(options, device):
    _setup_logging(options)
    logging.info("****************** Start svim-tpu (PyTorch port), version "
                 "{0} ******************".format(__version__))
    logging.info("CMD: python3 {0}".format(" ".join(sys.argv)))
    logging.info("WORKING DIR: {0}".format(os.path.abspath(options.working_dir)))
    logging.info("DEVICE: {0}".format(describe(device)))
    for field in sorted(vars(options)):
        logging.info("PARAMETER: {0}, VALUE: {1}".format(
            field, getattr(options, field)))
    try:
        return run_pipeline(options, device)
    except Exception as error:  # noqa: BLE001 - top-level CLI guard
        logging.error(error, exc_info=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
