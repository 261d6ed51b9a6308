"""Read alignment wrapper for `reads` mode.

Behavioral contract: svim/SVIM_alignment.py — align raw reads with ngmlr or
minimap2, pipe through samtools view/sort, index, and cache an existing
<prefix>.<aligner>.coordsorted.bam.
"""

from __future__ import annotations

import logging
import os
import subprocess


class ToolMissingError(Exception):
    pass


class AlignmentPipelineError(Exception):
    pass


_PREREQUISITES = ("gunzip", "samtools")


def check_prerequisites(aligner: str) -> None:
    for tool in _PREREQUISITES + (aligner,):
        try:
            subprocess.run([tool, "--help"], stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, check=True)
        except FileNotFoundError as error:
            raise ToolMissingError(
                "The alignment pipeline cannot be started because {0} was not "
                "found. Is it installed and in the PATH?".format(
                    error.filename or tool)) from error
        except subprocess.CalledProcessError as error:
            raise ToolMissingError(
                "The alignment pipeline cannot be started because {0} "
                "failed.".format(" ".join(error.cmd))) from error


def _aligner_stage(aligner: str, genome: str, reads_path: str, reads_type: str,
                   cores: int, nanopore: bool) -> str:
    reads = os.path.realpath(reads_path)
    if aligner == "minimap2":
        preset = "map-ont" if nanopore else "map-pb"
        return "minimap2 -t {0} -x {1} -a {2} {3}".format(cores, preset, genome, reads)
    # ngmlr cannot read gzipped input directly
    stage = ""
    if reads_type in ("fasta_gzip", "fastq_gzip"):
        stage = "gunzip -c {0} | ngmlr -t {1} -r {2}".format(reads, cores, genome)
    else:
        stage = "ngmlr -t {0} -r {1} -q {2}".format(cores, genome, reads)
    if nanopore:
        stage += " -x ont"
    return stage


def run_alignment(working_dir: str, genome: str, reads_path: str,
                  reads_type: str, cores: int, aligner: str,
                  nanopore: bool) -> str:
    """Produce (or reuse) a coordinate-sorted, indexed BAM for the reads
    (reference: SVIM_alignment.py:23-60)."""
    check_prerequisites(aligner)
    prefix = os.path.splitext(os.path.basename(reads_path))[0]
    bam_path = os.path.join(working_dir, "{0}.{1}.coordsorted.bam".format(prefix, aligner))
    if os.path.exists(bam_path) and os.path.exists(bam_path + ".bai"):
        logging.warning("Alignment output file {0} already exists. Skip alignment "
                        "and use the existing file.".format(bam_path))
        return bam_path

    pipeline = " | ".join([
        _aligner_stage(aligner, genome, reads_path, reads_type, cores, nanopore),
        "samtools view -b -@ {0}".format(cores),
        "samtools sort -@ {0} -o {1}".format(cores, bam_path),
    ])
    logging.info("Starting alignment pipeline..")
    for command in ("set -o pipefail && " + pipeline,
                    "samtools index " + bam_path):
        try:
            subprocess.run(command, shell=True, check=True, executable="/bin/bash")
        except subprocess.CalledProcessError as error:
            raise AlignmentPipelineError(
                "The alignment pipeline failed with exit code {0}. Command "
                "was: {1}".format(error.returncode, error.cmd)) from error
    logging.info("Alignment pipeline finished")
    return bam_path
