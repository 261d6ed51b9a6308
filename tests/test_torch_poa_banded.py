"""The port's graph aligner (svim_tpu_torch/native/poa.cpp: one traceback
byte a DP cell, the insertion states in closed form along a row) against
svim_tpu's (svim_tpu/native/poa.cpp, the design it replaced), byte for
byte, on insertion clusters shaped as the benchmark's: inserted sequences
of 50-3,000 bp cut from one motif within a tenth of each other, 12-30
members with a few substitutions and small indels each (so rows with
several predecessors and aligned rings occur), between reference flanks
that the consensus trims off first.  Also: the budget that makes both give
up, the column-by-column fallback that long alignments take, the DP cells
that `consensus.poa_cells` counts against those the reference's band
ladder (svbench/reference/consensus.py) visits, the spans of a
consensus's three parts in a job's --profile record, and the reader of
`poa_cell_ns`."""

import ctypes
import random
import subprocess

import pytest

from svbench import run
from svbench.reference import consensus as reference
from svim_tpu.native import poa_consensus_native as jax_poa
from svim_tpu_torch.combine.consensus import _common_affixes
from svim_tpu_torch.native import (
    POA_FULL_DP_CELLS,
    POA_MAX_CELLS,
    poa_consensus_cells,
    poa_consensus_native,
)
from svim_tpu_torch import workloads
from svim_tpu_torch.utils import timing
from tests.test_torch_sample_workload import SMALL
from tests.test_torch_tracing import _job as _cli_job

FIRST_BAND = 16


def _text(rng, length):
    return "".join(rng.choice("ACGT") for _ in range(length))


def _cluster(seed, size, members, indels=3):
    """The haplotypes of one insertion cluster with their shared ends
    trimmed, as the consensus hands them to the graph aligner."""
    rng = random.Random(seed)
    motif = _text(rng, size + size // 10 + 1)
    flank = _text(rng, 260)
    haplotypes = []
    for _ in range(members):
        insert = list(motif[:size + rng.randint(-size // 10, size // 10)])
        for _ in range(rng.randint(0, 4)):
            insert[rng.randrange(len(insert))] = rng.choice("ACGT")
        for _ in range(rng.randint(0, indels)):
            at = rng.randrange(len(insert))
            if rng.random() < 0.5:
                del insert[at:at + rng.randint(1, 4)]
            else:
                insert[at:at] = _text(rng, rng.randint(1, 4))
        cut = 100 + rng.randint(-8, 8)
        haplotypes.append(flank[:cut] + "".join(insert) + flank[cut:])
    prefix, suffix = _common_affixes(haplotypes)
    return [h[prefix:len(h) - suffix] for h in haplotypes]


def _ladder_cells(graph_length, length, band):
    """Cells of one band rung of an alignment against a chain of
    `graph_length` nodes (the first member): row 0 whole, node r at depth
    r within `band` of it, the last node reaching the end."""
    cells = length + 1
    for depth in range(1, graph_length + 1):
        lo = max(0, min(length, depth - band))
        hi = length if depth == graph_length else max(
            0, min(length, depth + band))
        cells += hi - min(lo, hi) + 1
    return cells


# (seed, inserted size, members): the cell's sizes, log-uniform over
# 50-3,000 bp, and four of 1.5-3 kb whose first alignment climbs to 512
CLUSTERS = [(1, 50, 30), (2, 90, 24), (3, 160, 12), (4, 300, 18),
            (5, 600, 14), (6, 1100, 12), (7, 70, 16), (8, 220, 30),
            (9, 450, 20), (10, 800, 12)]
LONG = [(30, 1500, 12), (19, 2000, 12), (13, 2500, 12), (15, 3000, 12)]


@pytest.mark.parametrize("seed,size,members", CLUSTERS + LONG)
def test_the_port_equals_svim_tpu(seed, size, members):
    haplotypes = _cluster(seed, size, members)
    consensus, cells = poa_consensus_cells(haplotypes)
    assert consensus is not None
    assert consensus == jax_poa(haplotypes)
    assert cells > 0


@pytest.mark.parametrize("seed,size,members", LONG)
def test_the_long_clusters_first_alignment_climbs_to_512(seed, size,
                                                         members):
    """The first alignment is the second member against the first's chain,
    from the first rung: its cells are the rungs 16, 32, ..., 512, each of
    which touched its band's edge and retried but the last."""
    first, second = _cluster(seed, size, members)[:2]
    consensus, cells = poa_consensus_cells([first, second])
    assert consensus == jax_poa([first, second])
    rungs = [FIRST_BAND << k for k in range(6)]
    assert rungs[-1] == 512
    assert cells == sum(_ladder_cells(len(first), len(second), band)
                        for band in rungs)


def test_a_budget_under_the_alignments_cells_gives_none_on_both():
    haplotypes = _cluster(21, 400, 12)
    first_rung = _ladder_cells(len(haplotypes[0]), len(haplotypes[1]),
                               FIRST_BAND)
    for max_cells in (100, first_rung - 1):
        assert poa_consensus_native(haplotypes, max_cells=max_cells) is None
        assert jax_poa(haplotypes, max_cells=max_cells) is None
    # a budget that the first rung fits and a later one does not: none,
    # after the cells of the rungs that fitted
    consensus, cells = poa_consensus_cells(haplotypes, max_cells=first_rung)
    assert consensus is None and cells >= first_rung
    assert jax_poa(haplotypes, max_cells=first_rung) is None
    # a whole matrix over the budget takes the ladder, whose rungs may fit
    small = _cluster(22, 40, 4, indels=0)
    found = [poa_consensus_native(small, max_cells=budget)
             for budget in (1000, 1400, 1800, 2600, 5000)]
    assert found == [jax_poa(small, max_cells=budget)
                     for budget in (1000, 1400, 1800, 2600, 5000)]
    assert None in found and found[-1] is not None


def _poa_library(tmp_path, *flags):
    """poa.cpp built on its own with extra compiler flags."""
    from svim_tpu_torch.native import _FLAGS, _POA_SOURCE

    path = str(tmp_path / "poa.so")
    subprocess.run(["g++"] + _FLAGS + list(flags) + ["-o", path, _POA_SOURCE],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    lib.poa_consensus_native.restype = ctypes.c_int
    return lib


def _call(lib, sequences):
    blob = "".join(sequences).encode()
    lens = (ctypes.c_int64 * len(sequences))(*[len(s) for s in sequences])
    cap = 2 * max(len(s) for s in sequences) + 64
    out = ctypes.create_string_buffer(cap)
    length, cells = ctypes.c_int64(0), ctypes.c_int64(0)
    status = lib.poa_consensus_native(
        blob, lens, ctypes.c_int(len(sequences)),
        ctypes.c_int64(POA_MAX_CELLS), ctypes.c_int64(POA_FULL_DP_CELLS), out,
        ctypes.c_int64(cap), ctypes.byref(length), ctypes.byref(cells))
    assert status == 0
    return out.raw[:length.value].decode(), cells.value


def test_the_column_by_column_fallback_gives_the_same_bytes(tmp_path):
    """Alignments too long for the closed form's exact span fill a row
    column by column; with that span at 0 every alignment does."""
    lib = _poa_library(tmp_path, "-DPOA_CLOSED_FORM_SPAN=0")
    for seed, size, members in CLUSTERS[:5]:
        haplotypes = _cluster(seed, size, members)
        assert _call(lib, haplotypes) == poa_consensus_cells(haplotypes)
        assert _call(lib, haplotypes)[0] == jax_poa(haplotypes)


class _Budget:
    """The reference's cell budget, recording each banded rung's cells as
    the reference compares them with it."""

    def __init__(self, seen):
        self.seen = seen

    def __lt__(self, cells):   # `cells > POA_MAX_CELLS`
        if cells <= POA_MAX_CELLS:
            self.seen.append(cells)
        return cells > POA_MAX_CELLS


@pytest.mark.parametrize("seed,size,members,indels",
                         [(31, 30, 6, 2), (32, 150, 8, 3)])
def test_the_count_is_the_cells_the_reference_ladder_visits(
        seed, size, members, indels, monkeypatch):
    haplotypes = _cluster(seed, size, members, indels)
    seen = []
    align = reference.align_to_graph

    def counted(graph, seq, band=None):
        if band is None:   # the whole matrix
            seen.append((len(graph.topo) + 1) * (len(seq) + 1))
        return align(graph, seq, band)

    monkeypatch.setattr(reference, "align_to_graph", counted)
    monkeypatch.setattr(reference, "POA_MAX_CELLS", _Budget(seen))
    expected = reference.graph_consensus(haplotypes)
    consensus, cells = poa_consensus_cells(haplotypes)
    assert consensus == expected
    assert cells == sum(seen) > 0
    # and the running job counts them
    timer = timing.StageTimer()
    with timer.job(), timer.stage("combine"):
        assert poa_consensus_native(haplotypes) == expected
        assert poa_consensus_native(haplotypes[:1]) == haplotypes[0]
    assert timer.counts == {"consensus.poa_cells": cells}


def test_a_jobs_record_holds_the_consensus_parts_and_the_seeds_cells(
        tmp_path):
    """A whole job with --profile on a small sample whose insertions are
    noisy (the golden one's trim to nothing before the graph aligner): the
    seed, the polish and the realignment on the pool's threads, inside the
    clusters' own span, and the DP cells of the seed."""
    bam, genome = workloads.sample_workload(str(tmp_path), 1, **SMALL)
    code, _lines, seen = _cli_job(tmp_path, "job", bam, genome, "--profile")
    assert code == 0 and len(seen) == 1
    spans, counts = seen[0]["spans"], seen[0]["counts"]
    parts = [spans["combine." + name]
             for name in ("poa", "polish", "realign")]
    assert all(seconds > 0 for seconds in parts)
    assert sum(parts) <= spans["combine.consensus_cluster"]
    assert counts["consensus.poa_cells"] > 0
    reader = run.metric_reader("poa_cell_ns")
    assert reader.read({"stages": seen}) == pytest.approx(
        spans["combine.poa"] * 1e9 / counts["consensus.poa_cells"])


def _job(poa=None, cells=None):
    job = {"combine": 13.0, "spans": {"combine.consensus": 10.0},
           "counts": {"consensus.workers": 8}}
    if poa is not None:
        job["spans"]["combine.poa"] = poa
    if cells is not None:
        job["counts"]["consensus.poa_cells"] = cells
    return job


def test_the_reader_gives_seconds_a_cell_in_ns():
    reader = run.metric_reader("poa_cell_ns")
    assert reader.UNIT == "ns/cell"
    jobs = [_job(poa=60.0, cells=10 ** 10), _job(poa=20.0, cells=4 * 10 ** 9)]
    assert reader.read({"stages": jobs}) == pytest.approx((6.0 + 5.0) / 2)


@pytest.mark.parametrize("jobs", [
    [], [_job()], [_job(poa=60.0)], [_job(cells=10 ** 10)],
    [_job(poa=60.0, cells=0)], [_job(poa=60.0, cells=10 ** 10), _job()]])
def test_the_reader_gives_nothing_where_a_job_lacks_its_fields(jobs):
    assert run.metric_reader("poa_cell_ns").read({"stages": jobs}) is None
