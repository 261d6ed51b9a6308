"""Configuration contract and CLI for svim-tpu.

Mirrors the parameter surface of the reference CLI
(SVIM v2.0.0, src/svim/SVIM_input_parsing.py:7-478): two subcommands
(``reads`` and ``alignment``) sharing ~30 tuned parameters.  The parsed
options are carried in a frozen dataclass so that the same object can key
jit-compilation caches in the array path.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

ALL_SV_TYPES = "DEL,INS,INV,DUP:TANDEM,DUP:INT,BND"


@dataclasses.dataclass(frozen=True)
class Config:
    """Single config object threaded through all stages.

    Field names and defaults follow the reference option namespace
    (SVIM_input_parsing.py; defaults table at :63-260) so downstream code
    reads identically to the behavioral contract.
    """

    # mode + positionals
    sub: Optional[str] = None          # "reads" | "alignment"
    working_dir: str = "."
    bam_file: Optional[str] = None     # alignment mode
    reads: Optional[str] = None        # reads mode
    genome: Optional[str] = None

    verbose: bool = False

    # ALIGN group (reads mode only; SVIM_input_parsing.py:50-61)
    cores: int = 1
    aligner: str = "ngmlr"
    nanopore: bool = False

    # COLLECT (SVIM_input_parsing.py:63-113)
    min_mapq: int = 20
    min_sv_size: int = 40
    max_sv_size: int = 100000
    segment_gap_tolerance: int = 10
    segment_overlap_tolerance: int = 5
    all_bnds: bool = False

    # CLUSTER (SVIM_input_parsing.py:115-162)
    partition_max_distance: int = 1000
    position_distance_normalizer: float = 900
    edit_distance_normalizer: float = 1.0
    cluster_max_distance: float = 0.5

    # COMBINE (SVIM_input_parsing.py:164-186)
    del_ins_dup_max_distance: float = 1.0
    trans_sv_max_distance: int = 500
    skip_consensus: bool = False
    max_consensus_length: int = 10000

    # GENOTYPE (SVIM_input_parsing.py:188-220)
    skip_genotyping: bool = False
    minimum_score: int = 3
    homozygous_threshold: float = 0.8
    heterozygous_threshold: float = 0.2
    minimum_depth: int = 4

    # OUTPUT (SVIM_input_parsing.py:222-476)
    sample: str = "Sample"
    types: str = ALL_SV_TYPES
    symbolic_alleles: bool = False
    tandem_duplications_as_insertions: bool = False
    interspersed_duplications_as_insertions: bool = False
    insertion_sequences: bool = False
    read_names: bool = False
    zmws: bool = False

    # svim-tpu specific execution knobs (new capability; no reference analog)
    plot_histtype: str = "stepfilled"  # "stepfilled" (one polygon per series,
                                       # ~8x faster to render) | "bar" (the
                                       # reference's exact per-bin patches,
                                       # SVIM_plot.py:41-63)
    device_backend: str = "auto"       # "auto" (the card) | "cpu" | "host" (record-
                                       # based COLLECT/GENOTYPE) | "tpu" (refused)
    edit_backend: str = "auto"         # "auto" | "wavefront" | "python"
    cluster_backend: str = "device"    # "device" (on-device agglomeration, exact
                                       # fallback for f32-ambiguous partitions) | "exact"
    num_shards: int = 1                # data-parallel read shards over the mesh
    batch_reads: int = 4096            # reads per packed device batch
    incremental_cluster: str = "auto"  # "auto" (cluster scan-final partitions
                                       # mid-scan, reuse at CLUSTER when the
                                       # final partition content matches) | "off"
    stream_input: bool = False         # force the bounded-memory streaming scanner
    profile: bool = False              # per-stage wall-clock timing (untraced)
    profile_trace: bool = False        # additionally capture torch.profiler traces
                                       # (inflates host-stage wall times)
    distributed: bool = False          # one rank of a torch.distributed (Gloo) job:
                                       # SVIM_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def types_to_output(self) -> Tuple[str, ...]:
        return tuple(entry.strip() for entry in self.types.split(","))


def _add_common_options(parser: argparse.ArgumentParser) -> None:
    d = Config()
    collect = parser.add_argument_group("COLLECT")
    collect.add_argument("--min_mapq", type=int, default=d.min_mapq,
                         help="Minimum mapping quality of reads to consider (default: %(default)s).")
    collect.add_argument("--min_sv_size", type=int, default=d.min_sv_size,
                         help="Minimum SV size to detect (default: %(default)s).")
    collect.add_argument("--max_sv_size", type=int, default=d.max_sv_size,
                         help="Maximum SV size to detect (default: %(default)s).")
    collect.add_argument("--segment_gap_tolerance", type=int, default=d.segment_gap_tolerance,
                         help="Maximum tolerated gap between adjacent alignment segments (default: %(default)s).")
    collect.add_argument("--segment_overlap_tolerance", type=int, default=d.segment_overlap_tolerance,
                         help="Maximum tolerated overlap between adjacent alignment segments (default: %(default)s).")
    collect.add_argument("--all_bnds", action="store_true",
                         help="Output all breakends in addition to calls of other SV classes (default: %(default)s).")

    cluster = parser.add_argument_group("CLUSTER")
    cluster.add_argument("--partition_max_distance", type=int, default=d.partition_max_distance,
                         help="Maximum distance in bp between signatures in the same partition (default: %(default)s).")
    cluster.add_argument("--position_distance_normalizer", type=int, default=900,
                         help="Distance normalizer used for span-position distance (default: %(default)s).")
    cluster.add_argument("--edit_distance_normalizer", type=float, default=d.edit_distance_normalizer,
                         help="Edit-distance normalizer used for insertion clustering (default: %(default)s).")
    cluster.add_argument("--cluster_max_distance", type=float, default=d.cluster_max_distance,
                         help="Maximum span-position distance between signatures in a cluster (default: %(default)s).")

    combine = parser.add_argument_group("COMBINE")
    combine.add_argument("--del_ins_dup_max_distance", type=float, default=d.del_ins_dup_max_distance,
                         help="Maximum span-position distance between the origin of an insertion and a deletion to be flagged as a potential cut&paste insertion (default: %(default)s).")
    combine.add_argument("--trans_sv_max_distance", type=int, default=d.trans_sv_max_distance,
                         help="Maximum distance in bp between a translocation breakpoint and an SV signature to be combined (default: %(default)s).")
    combine.add_argument("--skip_consensus", action="store_true",
                         help="Disable consensus computation for insertions (default: %(default)s).")
    combine.add_argument("--max_consensus_length", type=int, default=d.max_consensus_length,
                         help="Maximum haplotype length for consensus computation (default: %(default)s).")

    genotype = parser.add_argument_group("GENOTYPE")
    genotype.add_argument("--skip_genotyping", action="store_true",
                          help="Disable genotyping (default: %(default)s).")
    genotype.add_argument("--minimum_score", type=int, default=d.minimum_score,
                          help="Minimum score for genotyping (default: %(default)s).")
    genotype.add_argument("--homozygous_threshold", type=float, default=d.homozygous_threshold,
                          help="Minimum variant allele fraction to be called homozygous (default: %(default)s).")
    genotype.add_argument("--heterozygous_threshold", type=float, default=d.heterozygous_threshold,
                          help="Minimum variant allele fraction to be called heterozygous (default: %(default)s).")
    genotype.add_argument("--minimum_depth", type=int, default=d.minimum_depth,
                          help="Minimum total read depth for genotyping (default: %(default)s).")

    output = parser.add_argument_group("OUTPUT")
    output.add_argument("--sample", type=str, default=d.sample,
                        help="Sample ID to include in output vcf file (default: %(default)s).")
    output.add_argument("--types", type=str, default=d.types,
                        help="SV types to include in output VCF (default: %(default)s).")
    output.add_argument("--symbolic_alleles", action="store_true",
                        help="Use symbolic alleles (<DEL>, <INV>, ...) in the VCF instead of true sequence alleles (default: %(default)s).")
    output.add_argument("--tandem_duplications_as_insertions", action="store_true",
                        help="Represent tandem duplications as insertions in output VCF (default: %(default)s).")
    output.add_argument("--interspersed_duplications_as_insertions", action="store_true",
                        help="Represent interspersed duplications as insertions in output VCF (default: %(default)s).")
    output.add_argument("--insertion_sequences", action="store_true",
                        help="Output insertion sequences in INFO tag of VCF (default: %(default)s).")
    output.add_argument("--plot_histtype", type=str, default=d.plot_histtype,
                        choices=("stepfilled", "bar"),
                        help="Length-histogram rendering: 'stepfilled' draws each stacked series as one polygon (faster); 'bar' reproduces the reference renderer's per-bin patches exactly (default: %(default)s).")
    output.add_argument("--read_names", action="store_true",
                        help="Output names of supporting reads in INFO tag of VCF (default: %(default)s).")
    output.add_argument("--zmws", action="store_true",
                        help="Look for information on ZMWs in PacBio read names (default: %(default)s).")

    execution = parser.add_argument_group("EXECUTION (svim-tpu)")
    execution.add_argument("--device_backend", type=str, default=d.device_backend,
                           choices=("auto", "tpu", "cpu", "host"),
                           help="Where the array path runs: 'auto' on the CUDA "
                                "card (an error without one), 'cpu' on the CPU; "
                                "'host' parses records and runs COLLECT and "
                                "GENOTYPE in host code with no device pass; 'tpu' "
                                "is refused, this package has no TPU backend "
                                "(default: %(default)s).")
    execution.add_argument("--edit_backend", type=str, default=d.edit_backend,
                           choices=("auto", "wavefront", "python"),
                           help="Edit-distance backend for insertion clustering: "
                                "'auto' runs the native host batch; 'wavefront' "
                                "runs the device-resident route (the wavefront "
                                "kernel on the card); 'python' forces pure Python "
                                "(default: %(default)s).")
    execution.add_argument("--cluster_backend", type=str, default=d.cluster_backend,
                           choices=("exact", "device"),
                           help="Clustering backend: 'device' (batched on-device "
                                "agglomeration for all SV types; partitions where "
                                "float32 cannot arbitrate a tie fall back to the exact "
                                "host path, so results match 'exact' bit-for-bit) or "
                                "'exact' (host float64 scipy only) "
                                "(default: %(default)s).")
    execution.add_argument("--num_shards", type=int, default=d.num_shards,
                           help="Number of data-parallel shards the batched device "
                                "passes are cut into, laid round-robin over the "
                                "visible cards (default: %(default)s).")
    execution.add_argument("--batch_reads", type=int, default=d.batch_reads,
                           help="Reads per packed device batch (default: %(default)s).")
    execution.add_argument("--incremental_cluster", type=str,
                           default=d.incremental_cluster,
                           choices=("auto", "off"),
                           help="Cluster partitions that are provably complete "
                                "behind the scan frontier WHILE the BAM scan still "
                                "runs; the CLUSTER stage reuses a mid-scan result "
                                "only when the final partition content matches "
                                "exactly, so output is identical either way "
                                "(default: %(default)s).")
    execution.add_argument("--stream_input", action="store_true",
                           help="Stream the input BAM window-by-window with bounded "
                                "memory (automatic for inputs over 96 MiB; "
                                "default: %(default)s).")
    execution.add_argument("--profile", action="store_true",
                           help="Log accurate per-stage wall-clock timings "
                                "(default: %(default)s).")
    execution.add_argument("--profile_trace", action="store_true",
                           help="Additionally capture torch.profiler traces of "
                                "COLLECT and CLUSTER (Chrome trace JSON) under "
                                "<working_dir>/traces for device timeline "
                                "inspection. The trace instrumentation inflates "
                                "HOST-bound stage wall times, so the "
                                "timings logged by a traced run are not "
                                "representative - use --profile alone for "
                                "timings (default: %(default)s).")
    execution.add_argument("--distributed", action="store_true",
                           help="Run as one process of a multi-process job: join "
                                "the torch.distributed (Gloo) group given by "
                                "SVIM_COORDINATOR / SVIM_NUM_PROCESSES / "
                                "SVIM_PROCESS_ID, ingest this process's BAM block "
                                "range, exchange signature tables as host bytes; "
                                "only process 0 writes outputs "
                                "(default: %(default)s).")


def parse_arguments(program_version: str = "2.0.0", arguments=None) -> Config:
    parser = argparse.ArgumentParser(
        prog="svim-tpu",
        description="svim-tpu {0}: TPU-native structural variant identification from long reads.".format(program_version),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    subparsers = parser.add_subparsers(dest="sub")
    # reference: SVIM_input_parsing.py:25-28
    parser.add_argument("--version", "-v", action="version",
                        version="%(prog)s {0}".format(program_version))

    parser_fasta = subparsers.add_parser("reads", help="Detect SVs from raw reads. Align reads first.")
    parser_fasta.add_argument("working_dir", type=str, help="Working and output directory.")
    parser_fasta.add_argument("reads", type=str, help="Read file (FASTA, FASTQ, gzipped or file list).")
    parser_fasta.add_argument("genome", type=str, help="Reference genome file (FASTA).")
    parser_fasta.add_argument("--verbose", action="store_true", help="Enable more verbose logging.")
    align = parser_fasta.add_argument_group("ALIGN")
    align.add_argument("--cores", type=int, default=1, help="CPU cores to use for the alignment (default: %(default)s).")
    align.add_argument("--aligner", type=str, default="ngmlr", choices=("ngmlr", "minimap2"),
                       help="Tool for read alignment (default: %(default)s).")
    align.add_argument("--nanopore", action="store_true", help="Use Nanopore settings for read alignment (default: %(default)s).")
    _add_common_options(parser_fasta)

    parser_bam = subparsers.add_parser("alignment", help="Detect SVs from an existing alignment (SAM/BAM).")
    parser_bam.add_argument("working_dir", type=str, help="Working and output directory.")
    parser_bam.add_argument("bam_file", type=str, help="Coordinate-sorted or queryname-sorted SAM/BAM file with aligned long reads.")
    parser_bam.add_argument("genome", type=str, help="Reference genome file (FASTA).")
    parser_bam.add_argument("--verbose", action="store_true", help="Enable more verbose logging.")
    _add_common_options(parser_bam)

    ns = parser.parse_args(arguments)
    fields = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(ns).items() if k in fields}
    return Config(**kwargs)


def guess_file_type(reads_path: str) -> str:
    """Sniff a reads file type from its extension (reference: SVIM_input_parsing.py:481-499)."""
    import logging
    if reads_path.endswith((".fa", ".fasta", ".FA")):
        logging.info("Recognized reads file as FASTA format.")
        return "fasta"
    if reads_path.endswith((".fq", ".fastq", ".FQ")):
        logging.info("Recognized reads file as FASTQ format.")
        return "fastq"
    if reads_path.endswith((".fa.gz", ".fasta.gz", ".FA.gz", ".fa.gzip", ".fasta.gzip", ".FA.gzip")):
        logging.info("Recognized reads file as gzipped FASTA format.")
        return "fasta_gzip"
    if reads_path.endswith((".fq.gz", ".fastq.gz", ".FQ.gz", ".fq.gzip", ".fastq.gzip", ".FQ.gzip")):
        logging.info("Recognized reads file as gzipped FASTQ format.")
        return "fastq_gzip"
    if reads_path.endswith((".fa.fn", ".fasta.fn", ".FA.fn", ".fq.fn", ".fastq.fn", ".FQ.fn")):
        logging.info("Recognized reads file as file list format.")
        return "list"
    logging.error("Unknown file ending of file {0}. Exiting.".format(reads_path))
    return "unknown"


def read_file_list(path: str):
    """Yield stripped lines of a read-file list (reference: SVIM_input_parsing.py:502-505)."""
    with open(path, "r") as file_list:
        for line in file_list:
            yield line.strip()
