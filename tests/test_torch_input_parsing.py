"""Twin of tests/test_input_parsing.py for the port's config.py (51 lines
apart from svim_tpu's: help text and comments): the same cases on the
port's parse_arguments, guess_file_type and Config, and on each argv the
port's options equal svim_tpu's field for field (exact)."""

import pytest

from svim_tpu import config as jax_config
from svim_tpu_torch.config import Config, guess_file_type, parse_arguments

ARGVS = {
    "alignment": ["alignment", "wd", "x.bam", "g.fa"],
    "alignment_flags": ["alignment", "wd", "x.bam", "g.fa", "--min_sv_size",
                        "50", "--edit_backend", "wavefront",
                        "--incremental_cluster", "off", "--types", "DEL,INS",
                        "--all_bnds", "--stream_input", "--num_shards", "2",
                        "--insertion_sequences"],
    "reads": ["reads", "wd", "r.fastq", "g.fa", "--aligner", "minimap2",
              "--nanopore", "--cores", "4"],
}


def _fields(options):
    return {name: value for name, value in vars(options).items()}


def test_guess_file_type():
    for path in ("x.fa", "x.fasta", "x.FA", "x.fq", "x.fastq", "x.fa.gz",
                 "x.fastq.gzip", "x.fa.fn", "x.bam"):
        assert guess_file_type(path) == jax_config.guess_file_type(path)
    assert guess_file_type("x.fa") == "fasta"
    assert guess_file_type("x.FA") == "fasta"
    assert guess_file_type("x.fastq") == "fastq"
    assert guess_file_type("x.fa.gz") == "fasta_gzip"
    assert guess_file_type("x.fastq.gzip") == "fastq_gzip"
    assert guess_file_type("x.fa.fn") == "list"
    assert guess_file_type("x.bam") == "unknown"


@pytest.mark.parametrize("argv", sorted(ARGVS))
def test_options_equal_svim_tpus(argv):
    assert _fields(parse_arguments(arguments=ARGVS[argv])) \
        == _fields(jax_config.parse_arguments(arguments=ARGVS[argv]))


def test_defaults_match_reference_contract():
    options = parse_arguments(arguments=ARGVS["alignment"])
    assert options.min_mapq == 20
    assert options.min_sv_size == 40
    assert options.max_sv_size == 100000
    assert options.segment_gap_tolerance == 10
    assert options.segment_overlap_tolerance == 5
    assert options.partition_max_distance == 1000
    assert options.position_distance_normalizer == 900
    assert options.edit_distance_normalizer == 1.0
    assert options.cluster_max_distance == 0.5
    assert options.del_ins_dup_max_distance == 1.0
    assert options.trans_sv_max_distance == 500
    assert options.max_consensus_length == 10000
    assert options.minimum_score == 3
    assert options.homozygous_threshold == 0.8
    assert options.heterozygous_threshold == 0.2
    assert options.minimum_depth == 4
    assert options.sample == "Sample"
    assert options.types_to_output == ("DEL", "INS", "INV", "DUP:TANDEM",
                                       "DUP:INT", "BND")
    assert not options.all_bnds and not options.skip_genotyping


def test_reads_mode_options():
    options = parse_arguments(arguments=ARGVS["reads"])
    assert options.sub == "reads"
    assert options.aligner == "minimap2"
    assert options.nanopore
    assert options.cores == 4


def test_config_is_immutable_and_replaceable():
    options = Config()
    with pytest.raises(Exception):
        options.min_mapq = 10
    updated = options.replace(min_mapq=10)
    assert updated.min_mapq == 10 and options.min_mapq == 20
    assert _fields(updated) == _fields(jax_config.Config().replace(
        min_mapq=10))


def test_version_flag_exits_with_version(capsys):
    for flag in ("--version", "-v"):
        with pytest.raises(SystemExit) as excinfo:
            parse_arguments(arguments=[flag])
        assert excinfo.value.code == 0
        assert capsys.readouterr().out.strip() == "svim-tpu 2.0.0"
