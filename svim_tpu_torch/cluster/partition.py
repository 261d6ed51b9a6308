"""Gap-cut partitioning of sorted signature streams.

Reference semantics: svim/SVIM_clustering.py:17-29 — sort by get_key() and
cut a new partition whenever the downstream distance to the previous
signature exceeds partition_max_distance.
"""

from __future__ import annotations

from typing import List

import numpy as np


def form_partitions(sv_signatures, max_distance) -> List[list]:
    sorted_signatures = sorted(sv_signatures, key=lambda evi: evi.get_key())
    partitions = []
    current_partition = []
    for signature in sorted_signatures:
        if current_partition and current_partition[-1].downstream_distance_to(signature) > max_distance:
            partitions.append(current_partition)
            current_partition = []
        current_partition.append(signature)
    if current_partition:
        partitions.append(current_partition)
    return partitions


def form_partitions_table(table, max_distance) -> list:
    """Column-wise `form_partitions` over a SignatureTable.

    Produces LazyMembers views whose member order and partition boundaries
    are identical to the object path (tests/test_soa.py): np.lexsort is
    stable like `sorted`, contig ranks substitute for string comparison, and
    the gap cut reproduces each type's `downstream_distance_to`
    (svim/SVIM_clustering.py:17-29, SVSignature.py get_key semantics)."""
    from svim_tpu_torch.sigtable import LazyMembers

    if table.n == 0:
        return []
    contig_rank = table.contigs.lexicographic_rank()
    sig_type = table.type
    source_rank = contig_rank[table.contig_code]
    if sig_type == "DUP_INT":
        # key = (dest contig, source contig, dest start); gap on dest start,
        # cut when either contig changes (SVSignature.py:133-146)
        dest_rank = contig_rank[table.contig2_code]
        order = np.lexsort((table.pos2, source_rank, dest_rank))
        same = ((dest_rank[order][1:] == dest_rank[order][:-1])
                & (source_rank[order][1:] == source_rank[order][:-1]))
        anchor = table.pos2[order]
        gap = anchor[1:] - anchor[:-1]
    elif sig_type == "INS":
        # key/gap both on start (SVSignature.py:80-91)
        order = np.lexsort((table.start, source_rank))
        same = source_rank[order][1:] == source_rank[order][:-1]
        anchor = table.start[order]
        gap = anchor[1:] - anchor[:-1]
    elif sig_type == "BND":
        # key on pos1; gap = next start - (this start + 1)
        order = np.lexsort((table.start, source_rank))
        same = source_rank[order][1:] == source_rank[order][:-1]
        anchor = table.start[order]
        gap = anchor[1:] - (anchor[:-1] + 1)
    else:
        # DEL / INV / DUP_TAN: key = (contig, end); gap = next start - this end
        order = np.lexsort((table.end, source_rank))
        same = source_rank[order][1:] == source_rank[order][:-1]
        gap = table.start[order][1:] - table.end[order][:-1]
    cut = ~same | (gap > max_distance)
    return [LazyMembers(table, part)
            for part in np.split(order, np.flatnonzero(cut) + 1)]
