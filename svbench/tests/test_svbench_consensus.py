"""The reference's insertion consensus (svbench/reference/consensus.py)
against the program's, byte for byte, on seeded clusters shaped as the
maker's: inserted sequences cut from one motif at lengths within a tenth
of each other, a few substitutions each, placed a few bases apart between
100 bp of reference.  Only the tests import the program."""

import random

import pytest

from svbench.reference import consensus as reference


def _text(rng, length):
    return "".join(rng.choice("ACGT") for _ in range(length))


def _cluster(rng, size, members):
    motif = _text(rng, size + size // 10 + 1)
    flank = _text(rng, 260)
    haplotypes = []
    for _ in range(members):
        insert = list(motif[:size + rng.randint(-size // 10, size // 10)])
        for _ in range(rng.randint(0, 4)):
            insert[rng.randrange(len(insert))] = rng.choice("ACGT")
        cut = 100 + rng.randint(-8, 8)
        haplotypes.append(flank[:cut] + "".join(insert) + flank[cut:])
    return haplotypes, flank, 5000, size


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pair_alignments_match_the_program(seed):
    from svim_tpu_torch.combine import consensus as program

    rng = random.Random(seed)
    for _ in range(40):
        a = _text(rng, rng.choice([1, 7, 60, 200, 500]))
        cut = rng.randint(0, len(a))
        b = rng.choice([a[:cut] + _text(rng, rng.randint(0, 300)) + a[cut:],
                        _text(rng, rng.choice([1, 30, 400]))])
        assert reference.align_global(a, b) == program.align_global(a, b)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_cluster_outcomes_match_the_program(seed):
    from svim_tpu_torch.combine import consensus as program
    from svim_tpu_torch.native import poa_consensus_native, star_polish_native

    rng = random.Random(seed)
    for size in (30, 120, 400):
        inputs = _cluster(rng, size, rng.randint(3, 14))
        haplotypes = inputs[0]
        seed_consensus = poa_consensus_native(haplotypes)
        assert reference.graph_consensus(haplotypes) == seed_consensus
        assert (reference.star_consensus(haplotypes, center=seed_consensus)
                == star_polish_native(haplotypes, seed_consensus))
        assert reference.outcome(inputs) == program.consensus_from_inputs(
            inputs + (len(haplotypes),))


def test_outcomes_in_worker_processes_keep_the_order():
    rng = random.Random(9)

    class Member:
        def __init__(self, start, sequence):
            self.start, self.sequence = start, sequence

    class Fasta:
        def __init__(self, text):
            self.text = text

        def fetch(self, contig, start, end):
            return self.text[start:end]

    class Cluster:
        def __init__(self, members, start, end):
            self.contig, self.members = "chr", members
            self.start, self.end = start, end

    genome = _text(rng, 2000)
    clusters = [Cluster([Member(900 + k, _text(rng, 50 + k)) for k in range(3)],
                        900, 951 + n) for n in range(3)]
    found = reference.outcomes(clusters, Fasta(genome), workers=2)
    assert found == reference.outcomes(clusters, Fasta(genome), workers=1)
