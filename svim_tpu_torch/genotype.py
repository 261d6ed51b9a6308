"""GENOTYPE stage on the port's device.

Counterpart of svim_tpu/genotype.py::genotype_packed_multi
(SVIM_genotyping.py:34-94): candidate locus/support extraction and the
genotype assignment are svim_tpu's (imported); the reference-support
interval join runs on `device` (ops.genotype_kernel), with the numpy join
for the candidates the kernel cannot serve.
"""

from __future__ import annotations

import logging

from svim_tpu.genotype import (
    _finish_genotype_jobs,
    _genotype_index,
    _prepare_genotype_jobs,
)


def genotype_packed_multi(groups, table, header, options, device):
    """Genotype several candidate groups with one batched device join.

    groups is [(candidates, type, label_or_None)]; `table` needs
    ref_id/ref_start/ref_end/mapq columns and a names list."""
    from svim_tpu_torch.ops.genotype_kernel import genotype_ref_support_device

    _id_of_name, per_tid = _genotype_index(table, options.min_mapq)
    all_pending = []
    all_jobs = []
    for candidates, type, label in groups:
        if label is not None:
            logging.info("Genotyping {0}..".format(label))
        pending, jobs = _prepare_genotype_jobs(candidates, table, header,
                                               type, options)
        all_pending.extend(pending)
        all_jobs.extend(jobs)

    counts = [None] * len(all_pending)
    if all_pending:
        counts = genotype_ref_support_device(all_jobs, per_tid, device)
    _finish_genotype_jobs(all_pending, counts, table, options)
