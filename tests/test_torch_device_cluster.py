"""The port's device clustering against its exact backend and against
svim_tpu's device backend: the cases of tests/test_device_cluster.py,
each built once with each package's signature classes from the same seed.
The port's `partition_and_cluster(..., device)` on the CPU must give the
exact backend's clusters and svim_tpu's, in order (scipy's fcluster
numbering, member order included); the DUP_INT candidate round and the
fused route's DUP_INT and BND partitions likewise, the latter labelled on
the device (telemetry `device`) as often as in svim_tpu."""

import random

import pytest
import torch

import svim_tpu.candidates as jax_candidates
import svim_tpu.signatures as jax_signatures
import svim_tpu_torch.candidates as port_candidates
import svim_tpu_torch.signatures as port_signatures
from svim_tpu.cluster import partition_and_cluster as jax_partition_and_cluster
from svim_tpu.cluster import device_cluster as jax_device_cluster
from svim_tpu.cluster.cluster import (
    partition_and_cluster_candidates as jax_cluster_candidates,
)
from svim_tpu.config import parse_arguments as jax_parse_arguments
from svim_tpu_torch.cluster import device_cluster as port_device_cluster
from svim_tpu_torch.cluster.cluster import (
    partition_and_cluster as port_partition_and_cluster,
)
from svim_tpu_torch.cluster.cluster import (
    partition_and_cluster_candidates as port_cluster_candidates,
)
from svim_tpu_torch.config import parse_arguments as port_parse_arguments

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)
CPU = torch.device("cpu")


def _clusters_key(clusters):
    """Order-sensitive cluster fingerprint (member identity order included)."""
    return [(c.contig, c.start, c.end, c.size, round(c.score, 6),
             tuple(m.read for m in c.members)) for c in clusters]


def _options(tmp_path, wide):
    """(svim_tpu's options, the port's) over one genome: 200 bp of chr1, or
    (`wide`) 400 kb of chr1 and 1 kb of chr2 for INS haplotype windows."""
    genome = tmp_path / "genome.fa"
    if wide:
        rng = random.Random(9)
        sequence = "".join(rng.choice("ACGT") for _ in range(400_000))
        genome.write_text(">chr1\n" + sequence + "\n>chr2\n"
                          + sequence[:1000] + "\n")
    else:
        genome.write_text(">chr1\n" + "A" * 100 + "C" * 100 + "\n")
    arguments = ["alignment", str(tmp_path), str(tmp_path / "reads.bam"),
                 str(genome)]
    return (jax_parse_arguments(arguments=arguments),
            port_parse_arguments(arguments=arguments))


def _deletions(signatures):
    rng = random.Random(23)
    out = []
    for group in range(6):
        center = 20000 * (group + 1)
        span = rng.randint(100, 700)
        for i in range(rng.randint(3, 40)):
            start = center + rng.randint(-40, 40)
            end = start + span + rng.randint(-12, 12)
            out.append(signatures.SignatureDeletion(
                "chr1", start, end, "cigar", "read_{0}_{1}".format(group, i)))
    # a same-read duplicate, for the dedup on the device
    out.append(signatures.SignatureDeletion("chr1", 20010, 20310, "cigar",
                                            "read_0_0"))
    return out


def _inversions(signatures):
    rng = random.Random(5)
    out = []
    for group in range(4):
        center = 50000 * (group + 1)
        span = rng.randint(300, 1500)
        for i in range(8):
            direction = rng.choice(["left_fwd", "left_rev", "right_fwd",
                                    "right_rev"])
            out.append(signatures.SignatureInversion(
                "chr1", center + rng.randint(-30, 30),
                center + span + rng.randint(-30, 30), "suppl",
                "read_{0}_{1}".format(group, i % 5), direction))
    return out


def _tandem_duplications(signatures):
    rng = random.Random(77)
    out = []
    for group in range(5):
        start = 30000 * (group + 1)
        span = rng.randint(80, 400)
        for i in range(rng.randint(3, 25)):
            s = start + rng.randint(-25, 25)
            out.append(signatures.SignatureDuplicationTandem(
                "chr1", s, s + span + rng.randint(-10, 10), rng.randint(1, 3),
                True, "suppl", "read_{0}_{1}".format(group, i)))
    return out


def _insertions(signatures):
    rng = random.Random(31)
    out = []
    for group in range(5):
        start = 40000 * (group + 1)
        motif = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(60, 220)))
        for i in range(rng.randint(3, 20)):
            noisy = list(motif)
            for _ in range(rng.randint(0, 5)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            s = start + rng.randint(-35, 35)
            out.append(signatures.SignatureInsertion(
                "chr1", s, s + len(noisy), "cigar",
                "read_{0}_{1}".format(group, i), "".join(noisy)))
    return out


def _interspersed_duplications(signatures):
    rng = random.Random(13)
    out = []
    for group in range(4):
        start = 25000 * (group + 1)
        span = rng.randint(100, 500)
        dest = 200000 + 3000 * group
        for i in range(rng.randint(3, 18)):
            s = start + rng.randint(-30, 30)
            out.append(signatures.SignatureInsertionFrom(
                "chr1", s, s + span + rng.randint(-8, 8), "chr1",
                dest + rng.randint(-20, 20), "suppl",
                "read_{0}_{1}".format(group, i)))
    return out


def _translocations(signatures):
    rng = random.Random(3)
    out = []
    for group in range(4):
        pos1 = 20000 * (group + 1)
        pos2 = 150000 + 5000 * group
        # direction pairs mixed inside a partition: their walls send those
        # partitions to the host
        for i in range(rng.randint(4, 16)):
            d1 = rng.choice(["fwd", "rev"])
            d2 = rng.choice(["fwd", "rev"])
            out.append(signatures.SignatureTranslocation(
                "chr1", pos1 + rng.randint(-40, 40), d1,
                "chr2", pos2 + rng.randint(-40, 40), d2, "suppl",
                "read_{0}_{1}".format(group, i)))
    return out


def _fuzz_deletions(trial):
    """The DEL fuzz's trial `trial`: many partition shapes, same-read
    duplicates."""
    def build(signatures):
        rng = random.Random(1001)
        out = []
        for number in range(trial + 1):
            out = []
            for group in range(rng.randint(2, 8)):
                center = rng.randint(10_000, 5_000_000)
                span = rng.randint(50, 2000)
                n = rng.randint(3, 60)
                for _ in range(n):
                    start = center + rng.randint(-400, 400)
                    end = start + span + rng.randint(-30, 30)
                    read = "r{0}_{1}".format(group, rng.randint(0, n // 2))
                    out.append(signatures.SignatureDeletion(
                        "chr1", start, end, "cigar", read))
        return out
    return build


def _tie_grid(trial, kind):
    """Trial `trial` of the tie grids: quantized coordinates, so exact
    distance ties, which must go to the host; `kind` "DEL" or "DUP_TAN"."""
    def build(signatures):
        rng = random.Random(trial)
        dels, tans = [], []
        for group in range(rng.randint(2, 5)):
            center = 10000 * (group + 1)
            span = rng.choice([100, 200, 400])
            for _ in range(rng.randint(3, 40)):
                start = center + rng.choice([-100, -50, 0, 50, 100])
                end = start + span + rng.choice([-10, 0, 10])
                read = "r{0}_{1}".format(group, rng.randint(0, 15))
                if rng.random() < 0.5:
                    dels.append(signatures.SignatureDeletion(
                        "chr1", start, end, "cigar", read))
                else:
                    tans.append(signatures.SignatureDuplicationTandem(
                        "chr1", start, end, 1, True, "suppl", read))
        return dels if kind == "DEL" else tans
    return build


CASES = [
    ("deletions", _deletions, False, "deleted regions"),
    ("inversions", _inversions, False, "inverted regions"),
    ("tandem", _tandem_duplications, False, "tandem duplicated regions"),
    ("insertions", _insertions, True, "inserted regions"),
    ("interspersed", _interspersed_duplications, True,
     "inserted regions with detected region of origin"),
    ("translocations", _translocations, True, "translocation breakpoints"),
] + [("fuzz {0}".format(trial), _fuzz_deletions(trial), False,
      "deleted regions") for trial in range(6)] + [
    ("tie grid {0} {1}".format(trial, kind), _tie_grid(trial, kind), False,
     "deleted regions" if kind == "DEL" else "tandem duplicated regions")
    for trial in range(6) for kind in ("DEL", "DUP_TAN")]


@pytest.mark.parametrize("name, build, wide, label", CASES,
                         ids=[case[0] for case in CASES])
def test_device_backend_matches_exact_and_svim_tpu(tmp_path, name, build,
                                                   wide, label):
    jax_options, port_options = _options(tmp_path, wide)
    signatures = build(port_signatures)
    exact = port_partition_and_cluster(
        signatures, port_options.replace(cluster_backend="exact"), label, CPU)
    device = port_partition_and_cluster(
        signatures, port_options.replace(cluster_backend="device"), label,
        CPU)
    reference = jax_partition_and_cluster(
        build(jax_signatures), jax_options.replace(cluster_backend="device"),
        label)
    assert _clusters_key(device) == _clusters_key(exact)
    assert _clusters_key(device) == _clusters_key(reference)


def _dup_int_candidates(signatures, candidates):
    rng = random.Random(8)
    out = []
    for group in range(3):
        start = 30000 * (group + 1)
        span = rng.randint(150, 400)
        dest = 250000 + 4000 * group
        for i in range(rng.randint(3, 12)):
            s = start + rng.randint(-25, 25)
            members = [signatures.SignatureInsertionFrom(
                "chr1", s, s + span, "chr1", dest, "suppl",
                "read_{0}_{1}_{2}".format(group, i, j)) for j in range(2)]
            out.append(candidates.CandidateDuplicationInterspersed(
                "chr1", s, s + span + rng.randint(-10, 10), "chr1",
                dest + rng.randint(-15, 15), dest + span,
                members, 5 + rng.random(), None, None, False))
    return out


def test_device_backend_candidate_round_matches(tmp_path):
    """The second DUP_INT clustering round through the device path."""
    jax_options, port_options = _options(tmp_path, True)
    label = "interspersed duplication candidates"

    def key(cands):
        return [(c.get_source(), c.get_destination(), round(c.score, 6),
                 tuple(m.read for m in c.members)) for c in cands]

    candidates = _dup_int_candidates(port_signatures, port_candidates)
    exact = port_cluster_candidates(
        candidates, port_options.replace(cluster_backend="exact"), label, CPU)
    device = port_cluster_candidates(
        candidates, port_options.replace(cluster_backend="device"), label,
        CPU)
    reference = jax_cluster_candidates(
        _dup_int_candidates(jax_signatures, jax_candidates),
        jax_options.replace(cluster_backend="device"), label)
    assert key(device) == key(exact)
    assert key(device) == key(reference)


def _fused_partitions(signatures, element_type):
    """Four tie-free partitions of six DUP_INT or BND signatures."""
    rng = random.Random(41)
    parts = []
    for locus in range(4):
        base = 100_000 + locus * 50_000
        size = 300 + locus * 13
        part = []
        for member in range(6):
            j = rng.randint(-200, 200)
            part.append(signatures.SignatureInsertionFrom(
                "chr2", base + j, base + j + size + member * 7, "chr1",
                5_000 + locus * 1_000 + rng.randint(-200, 200), "suppl",
                "rd{0}_{1}".format(locus, member)))
        parts.append(part)
    if element_type == "DUP_INT":
        return parts
    parts = []
    for locus in range(4):
        base = 100_000 + locus * 50_000
        parts.append([signatures.SignatureTranslocation(
            "chr1", base + rng.randint(-300, 300), "fwd",
            "chr2", 7_000 + locus * 900 + rng.randint(-300, 300), "rev",
            "suppl", "rb{0}_{1}".format(locus, member))
            for member in range(6)])
    return parts


@pytest.mark.parametrize("element_type", ["DUP_INT", "BND"])
def test_coordinate_route_dispatches_dup_int_and_bnd(tmp_path, element_type):
    """DUP_INT and BND ride the fused route: tie-free partitions are
    labelled on the device (telemetry `device`), as many as in svim_tpu,
    with svim_tpu's clusters, partition by partition."""
    assert element_type in port_device_cluster.FUSED_TYPES
    jax_options, port_options = _options(tmp_path, True)

    def keys(results):
        return {index: [tuple(m.read for m in cluster)
                        for cluster in entry.clusters]
                for index, entry in results.items()}

    port_device_cluster.TELEMETRY.reset()
    pending = port_device_cluster.dispatch_partitions_device(
        _fused_partitions(port_signatures, element_type), element_type, None,
        port_options, port_device_cluster.DeviceBatcher(port_options, CPU))
    results = port_device_cluster.consume_partitions_device(pending)
    port_labelled = port_device_cluster.TELEMETRY.device

    jax_device_cluster.TELEMETRY.reset()
    reference = jax_device_cluster.cluster_partitions_device(
        _fused_partitions(jax_signatures, element_type), element_type, None,
        jax_options)
    assert all(entry.clusters is not None for entry in results.values())
    assert port_labelled >= 3
    assert port_labelled == jax_device_cluster.TELEMETRY.device
    assert keys(results) == keys(reference)
