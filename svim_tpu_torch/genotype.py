"""GENOTYPE stage on the port's device.

Counterpart of svim_tpu/genotype.py::genotype_packed_multi
(SVIM_genotyping.py:34-94): candidate locus/support extraction and the
genotype assignment are svim_tpu's host code, copied, as is the record-based
`genotype` for inputs without packed columns; the reference-support
interval join runs on `device` (ops.genotype_kernel), with the numpy join
for the candidates the kernel cannot serve.
"""

from __future__ import annotations

import logging

ALIGNMENT_CAP = 500     # alignments inspected per locus (SVIM_genotyping.py:56)
WINDOW = 1000           # fetch window around the locus (SVIM_genotyping.py:49)
# candidates whose reference support _finish_genotype_jobs took from the
# device join ("kernel") and from the host join, _ref_support_host ("host")
JOINED = {"kernel": 0, "host": 0}


def _assign_genotype(candidate, alt_support, ref_support, options):
    """VAF thresholds -> genotype fields (reference: SVIM_genotyping.py:77-94)."""
    total = alt_support + ref_support
    if total >= options.minimum_depth:
        candidate.support_fraction = alt_support / total
        if candidate.support_fraction >= options.homozygous_threshold:
            candidate.genotype = "1/1"
        elif candidate.support_fraction >= options.heterozygous_threshold:
            candidate.genotype = "0/1"
        else:
            candidate.genotype = "0/0"
    elif total > 0:
        candidate.support_fraction = alt_support / total
        candidate.genotype = "./."
    else:
        candidate.support_fraction = "."
        candidate.genotype = "./."
    candidate.ref_reads = ref_support
    candidate.alt_reads = alt_support


_genotype_index_cache = {}
_FUNMAP = 0x4
_FSECONDARY = 0x100


def _genotype_index(table, min_mapq):
    """Name-id column + per-contig coordinate index for a packed table,
    memoized per (table object, min_mapq) — built once, reused across the
    four per-type genotyping calls.

    The reference only counts alignments with mapq >= min_mapq that are
    mapped and not secondary (SVIM_genotyping.py:58-66).  GenotypeTable rows
    are prefiltered at scan time (io/bamstream.py), but a PackedAlignments
    batch may carry unfiltered rows — the filter is re-applied here from the
    mapq (and, when present, flag) columns so correctness never depends on
    the producer."""
    import numpy as np

    cached = _genotype_index_cache.get((id(table), min_mapq))
    if cached is not None and cached[0] is table:
        return cached[1], cached[2]

    ref_id = np.asarray(table.ref_id)
    starts_all = np.asarray(table.ref_start, dtype=np.int64)
    ends_all = np.asarray(table.ref_end, dtype=np.int64)
    mapq_all = np.asarray(table.mapq)
    eligible = mapq_all >= min_mapq
    flags = getattr(table, "flag", None)
    if flags is not None:
        eligible &= (np.asarray(flags) & (_FUNMAP | _FSECONDARY)) == 0
    name_ids = np.empty(len(ref_id), dtype=np.int64)
    id_of_name = {}
    names = table.names
    take = getattr(names, "take", None)
    if take is not None:
        # one vectorized decode for the whole column (per-row __getitem__
        # pays numpy call overhead each)
        names = take(np.arange(len(ref_id)))
    for row in range(len(ref_id)):
        name_ids[row] = id_of_name.setdefault(names[row], len(id_of_name))
    per_tid = {}
    for tid in np.unique(ref_id):
        if tid < 0:
            continue
        rows = np.nonzero((ref_id == tid) & eligible)[0]
        order = np.lexsort((rows, starts_all[rows]))
        rows = rows[order]
        spans = ends_all[rows] - starts_all[rows]
        max_span = int(spans.max()) if len(spans) else 0
        per_tid[int(tid)] = (starts_all[rows], ends_all[rows], name_ids[rows],
                             max_span)
    # keep only the latest table to avoid unbounded growth
    _genotype_index_cache.clear()
    _genotype_index_cache[(id(table), min_mapq)] = (table, id_of_name, per_tid)
    return id_of_name, per_tid


def _ref_support_host(per_tid, tid, start, end, type, support_ids,
                      contig_length):
    """Numpy interval join for one candidate (exact reference semantics
    including the 500-alignment cap counted in coordinate order)."""
    import numpy as np

    entry = per_tid.get(tid)
    if entry is None:
        return 0
    starts, ends, ids, max_span = entry
    window_start = max(0, start - WINDOW)
    window_stop = min(contig_length, end + WINDOW)
    hi = np.searchsorted(starts, window_stop, side="left")
    # a row can only overlap the window if it starts within max_span of it
    lo = np.searchsorted(starts, window_start - max_span, side="left")
    w_starts = starts[lo:hi]
    w_ends = ends[lo:hi]
    w_ids = ids[lo:hi]
    in_window = w_ends > window_start
    not_support = ~np.isin(w_ids, np.asarray(support_ids, dtype=np.int64))
    qualifying = in_window & not_support
    # the 500-cap counts qualifying alignments in coordinate order
    qualifying_positions = np.nonzero(qualifying)[0]
    if len(qualifying_positions) > ALIGNMENT_CAP:
        qualifying_positions = qualifying_positions[:ALIGNMENT_CAP]
    c_starts = w_starts[qualifying_positions]
    c_ends = w_ends[qualifying_positions]
    c_ids = w_ids[qualifying_positions]
    if type in ("DEL", "INV"):
        minimum_overlap = min((end - start) / 2, 2000)
        supports = (((c_starts < (end - minimum_overlap)) & (c_ends > (end + 100)))
                    | ((c_starts < (start - 100)) & (c_ends > (start + minimum_overlap))))
    else:
        supports = (c_starts < (start - 100)) & (c_ends > (end + 100))
    return len(np.unique(c_ids[supports]))


def _prepare_genotype_jobs(candidates, table, header, type, options):
    """First half of genotype_packed: per-candidate locus/support extraction.

    Returns (pending, jobs): pending entries are
    (candidate, alt_support, type, tid, start, end, support_ids, length) and
    jobs are the matching device-kernel inputs."""
    id_of_name, per_tid = _genotype_index(table, options.min_mapq)
    type_class = 0 if type in ("DEL", "INV") else 1

    num_candidates = len(candidates)
    pending = []
    jobs = []
    for nr, candidate in enumerate(candidates):
        if (nr + 1) % 10000 == 0:
            logging.info("Processed {0} of {1} candidates".format(nr + 1, num_candidates))
        if candidate.score < options.minimum_score:
            continue
        if type in ("INS", "DUP_INT"):
            contig, start, end = candidate.get_destination()
            end = start
        else:
            contig, start, end = candidate.get_source()
        tid = header.get_tid(contig)
        support_names = set(sig.read for sig in candidate.members)
        alt_support = len(support_names)
        support_ids = [id_of_name[name] for name in support_names
                       if name in id_of_name]
        contig_length = (header.lengths[tid] if per_tid.get(tid) is not None
                         else None)
        pending.append((candidate, alt_support, type, tid, start, end,
                        support_ids, contig_length))
        jobs.append((tid, start, end, type_class, support_ids, contig_length))
    return pending, jobs


def _finish_genotype_jobs(pending, counts, table, options):
    """Second half: assign genotypes, running the numpy join for entries the
    kernel could not serve."""
    _id_of_name, per_tid = _genotype_index(table, options.min_mapq)
    for (candidate, alt_support, type, tid, start, end, support_ids,
         contig_length), ref_support in zip(pending, counts):
        if ref_support is None:
            ref_support = _ref_support_host(per_tid, tid, start, end, type,
                                            support_ids, contig_length)
            JOINED["host"] += 1
        else:
            JOINED["kernel"] += 1
        _assign_genotype(candidate, alt_support, ref_support, options)


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
    # --device_backend host keeps the numpy join of _finish_genotype_jobs
    if all_pending and getattr(options, "device_backend", "auto") != "host":
        counts = genotype_ref_support_device(
            all_jobs, per_tid, device, getattr(options, "num_shards", 1))
    _finish_genotype_jobs(all_pending, counts, table, options)


def genotype(candidates, bam, type, options):
    """Genotype candidates in place (reference: SVIM_genotyping.py:34-94)."""
    num_candidates = len(candidates)
    for nr, candidate in enumerate(candidates):
        if (nr + 1) % 10000 == 0:
            logging.info("Processed {0} of {1} candidates".format(nr + 1, num_candidates))
        if candidate.score < options.minimum_score:
            continue
        if type in ("INS", "DUP_INT"):
            contig, start, end = candidate.get_destination()
            # insertion loci are points on the reference
            end = start
        else:
            contig, start, end = candidate.get_source()
        contig_length = bam.get_reference_length(contig)
        alignment_it = bam.fetch(contig=contig, start=max(0, start - WINDOW),
                                 stop=min(contig_length, end + WINDOW))

        reads_supporting_variant = set(sig.read for sig in candidate.members)
        reads_supporting_reference = set()
        aln_no = 0
        for current_alignment in alignment_it:
            if aln_no >= ALIGNMENT_CAP:
                break
            if current_alignment.query_name in reads_supporting_variant:
                continue
            if (current_alignment.is_unmapped or current_alignment.is_secondary
                    or current_alignment.mapping_quality < options.min_mapq):
                continue
            aln_no += 1
            if type in ("DEL", "INV"):
                minimum_overlap = min((end - start) / 2, 2000)
                if (current_alignment.reference_start < (end - minimum_overlap)
                        and current_alignment.reference_end > (end + 100)
                        or current_alignment.reference_start < (start - 100)
                        and current_alignment.reference_end > (start + minimum_overlap)):
                    reads_supporting_reference.add(current_alignment.query_name)
            if type in ("INS", "DUP_INT"):
                if (current_alignment.reference_start < (start - 100)
                        and current_alignment.reference_end > (end + 100)):
                    reads_supporting_reference.add(current_alignment.query_name)

        alt_support = len(reads_supporting_variant)
        ref_support = len(reads_supporting_reference)
        total = alt_support + ref_support
        if total >= options.minimum_depth:
            candidate.support_fraction = alt_support / total
            if candidate.support_fraction >= options.homozygous_threshold:
                candidate.genotype = "1/1"
            elif candidate.support_fraction >= options.heterozygous_threshold:
                candidate.genotype = "0/1"
            else:
                candidate.genotype = "0/0"
        elif total > 0:
            candidate.support_fraction = alt_support / total
            candidate.genotype = "./."
        else:
            candidate.support_fraction = "."
            candidate.genotype = "./."
        candidate.ref_reads = ref_support
        candidate.alt_reads = alt_support
