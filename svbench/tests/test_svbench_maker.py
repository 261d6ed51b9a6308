"""The frozen maker makes the program's maker's bytes, at small sizes: the
BAM, the genome, the truth and the summary (the seconds aside).  Only the
tests import the program."""

import hashlib
import json

import pytest

from svbench import maker
from svim_tpu_torch import workloads

SMALL = {
    "classes": dict(contig_length=3_000_000, partner_length=1_000_000,
                    depth=10, ins_sizes=(50, 600), split_loci=5),
    "longtail": dict(contig_length=1_200_000, partner_length=1_000_000,
                     depth=10, ins_sizes=(50, 600), pileup=50, long_ins=1),
}


def _digest(path):
    with open(path, "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()


@pytest.mark.parametrize("mix", sorted(SMALL))
def test_the_frozen_maker_makes_the_programs_bytes(tmp_path, mix):
    knobs = SMALL[mix]
    maker.make(str(tmp_path / "frozen"), 3, **knobs)
    workloads.sample_workload(str(tmp_path / "program"), 3, **knobs)
    for name in ("sample.bam", "genome.fa", "truth.json"):
        assert _digest(tmp_path / "frozen" / name) == \
            _digest(tmp_path / "program" / name), name
    summaries = []
    for side in ("frozen", "program"):
        with open(tmp_path / side / "sample.json") as handle:
            summary = json.load(handle)
        summary.pop("seconds")
        summaries.append(summary)
    assert summaries[0] == summaries[1]


def test_the_same_seed_makes_the_same_bam_and_another_seed_another(tmp_path):
    knobs = SMALL["classes"]
    for name, seed in (("a", 4), ("b", 4), ("c", 5)):
        maker.make(str(tmp_path / name), seed, **knobs)
    assert _digest(tmp_path / "a" / "sample.bam") == _digest(tmp_path / "b" / "sample.bam")
    assert _digest(tmp_path / "a" / "sample.bam") != _digest(tmp_path / "c" / "sample.bam")


def test_a_seed_over_32_bits_makes_a_sample(tmp_path):
    maker.make(str(tmp_path), 2**31 + 12345, **SMALL["classes"])
    with open(tmp_path / "sample.json") as handle:
        assert json.load(handle)["reads"] > 1000


def test_a_plan_seed_gives_every_seed_the_same_loci(tmp_path):
    """With plan_seed the loci (sizes, coverages) are the plan's for every
    seed, only their order and places and the reads change; at the plan's
    own seed the bytes are the plain maker's."""
    knobs = SMALL["classes"]
    maker.make(str(tmp_path / "plain"), 1, **knobs)
    maker.make(str(tmp_path / "one"), 1, plan_seed=1, **knobs)
    assert _digest(tmp_path / "plain" / "sample.bam") == \
        _digest(tmp_path / "one" / "sample.bam")
    truths, reads = [], []
    for seed in (1, 2, 3):
        maker.make(str(tmp_path / str(seed)), seed, plan_seed=1, **knobs)
        with open(tmp_path / str(seed) / "truth.json") as handle:
            records = json.load(handle)["records"]
        truths.append(sorted((r["svtype"], r["length"]) for r in records))
        with open(tmp_path / str(seed) / "sample.json") as handle:
            reads.append(json.load(handle)["reads"])
    assert truths[0] == truths[1] == truths[2]
    assert reads[0] == reads[1] == reads[2]
    assert _digest(tmp_path / "2" / "sample.bam") != _digest(tmp_path / "3" / "sample.bam")
