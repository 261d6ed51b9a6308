"""SVIM v2.0.0's documented `svim alignment` defaults, as the reference
reads them (the README's option table; genotyping and output options
included).  A configuration's arguments that change a result would be
applied here by name; those of the benchmark's configurations
(`--edit_backend`, `--profile`) choose an implementation and change no
result.  The control (svbench/control.py) sets
`skip_consensus`."""

from __future__ import annotations

from types import SimpleNamespace

DEFAULTS = dict(
    min_mapq=20, min_sv_size=40, max_sv_size=100000,
    segment_gap_tolerance=10, segment_overlap_tolerance=5, all_bnds=False,
    partition_max_distance=1000, position_distance_normalizer=900,
    edit_distance_normalizer=1.0, cluster_max_distance=0.5,
    del_ins_dup_max_distance=1.0, trans_sv_max_distance=500,
    skip_consensus=False, max_consensus_length=10000,
    skip_genotyping=False, minimum_score=3, homozygous_threshold=0.8,
    heterozygous_threshold=0.2, minimum_depth=4, sample="Sample",
    types="DEL,INS,INV,DUP:TANDEM,DUP:INT,BND", symbolic_alleles=False,
    tandem_duplications_as_insertions=False,
    interspersed_duplications_as_insertions=False,
    insertion_sequences=False, read_names=False, zmws=False)

# arguments that pick an implementation of the same result
NEUTRAL = {"--edit_backend", "--profile", "--device_backend",
           "--incremental_cluster", "--batch_reads", "--cluster_backend"}


def reference_options(arguments, genome, working_dir):
    """The defaults, with `arguments` (a configuration's CLI words) checked:
    an argument that the reference does not model is refused, so that a
    configuration never runs against a reference that ignores it."""
    words = list(arguments)
    index = 0
    while index < len(words):
        word = words[index]
        if word not in NEUTRAL:
            raise ValueError("the reference does not model {0}".format(word))
        index += 1 if word == "--profile" else 2
    options = SimpleNamespace(**DEFAULTS, genome=genome,
                              working_dir=working_dir)
    options.types_to_output = tuple(
        entry.strip() for entry in options.types.split(","))
    return options
