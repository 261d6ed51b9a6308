"""Vectorized pairwise distance matrices for CLUSTER.

Counterpart of svim_tpu/cluster/accel.py (the same host code; the forced
edit-distance backends of precompute_ins_edit_distances go through the
port's batch_edit_distances, so `--edit_backend wavefront` reaches the
port's kernel on the caller's device).

Replaces the O(n^2) Python call loops (reference: SVIM_clustering.py:145-169,
HOT LOOP #3) with array computation.  All positional terms are built from
integer deltas and divided in float64 with the same operation order as the
scalar code, so the values are bit-identical to the reference; insertion
haplotype edit distances are exact Myers distances over a per-partition
cached reference window.

The same matrix serves same-read dedup and linkage (the reference recomputes
distances after dedup; since pair distances are independent of other
elements, the surviving submatrix is identical).
"""

from __future__ import annotations

import numpy as np

from svim_tpu_torch.cluster.distance import BND_NORMALIZER, SAME_READ_WALL
from svim_tpu_torch.cluster.edit_distance import batch_edit_distances, edit_distance

WINDOW_PADDING = 100  # reference window around insertion starts (SVIM_clustering.py:32)


class PartitionWindow:
    """Reference bases covering a whole partition of insertion signatures,
    fetched once and sliced per pair (identical characters to per-pair
    fetches)."""

    def __init__(self, reference, contig, min_start, max_start):
        self.offset = max(0, min_start - WINDOW_PADDING)
        self.sequence = reference.fetch(
            contig, self.offset, max(0, max_start + WINDOW_PADDING)).upper()

    def slice(self, start, end):
        start = max(0, start)
        end = max(0, end)
        return self.sequence[start - self.offset:end - self.offset]


_TRIU_CACHE = {}


def triu_indices_cached(n: int):
    """np.triu_indices(n, k=1) memoized: partitions cap at 128 elements and
    the profile showed the tri/broadcast rebuild costing more than the
    linkage it feeds on dense-tie workloads."""
    cached = _TRIU_CACHE.get(n)
    if cached is None:
        cached = np.triu_indices(n, k=1)
        _TRIU_CACHE[n] = cached
    return cached


def _span_position_terms(starts, ends, position_distance_normalizer):
    """(pos_dist, span_dist) matrices with reference op order."""
    centers = (starts + ends) // 2
    spans = ends - starts
    delta_center = np.abs(centers[:, None] - centers[None, :])
    delta_span = np.abs(spans[:, None] - spans[None, :])
    max_span = np.maximum(spans[:, None], spans[None, :])
    position_distance = delta_center / position_distance_normalizer
    span_distance = delta_span / max_span
    return position_distance, span_distance


def _pair_key(first, second):
    return (id(first), id(second))


def _source_columns(elements):
    """(starts, ends) int64 arrays WITHOUT materializing Signature objects
    when `elements` is a sigtable view (LazyMembers); object fallback
    otherwise.  BND table rows store end = pos1 + 1, matching get_source()."""
    table = getattr(elements, "table", None)
    if table is not None:
        indices = elements.indices
        return table.start[indices], table.end[indices]
    n = len(elements)
    starts = np.fromiter((e.get_source()[1] for e in elements),
                         dtype=np.int64, count=n)
    ends = np.fromiter((e.get_source()[2] for e in elements),
                       dtype=np.int64, count=n)
    return starts, ends


def _dest_start_column(elements):
    """Destination start positions (DUP_INT pos / BND pos2) as int64."""
    table = getattr(elements, "table", None)
    if table is not None:
        return table.pos2[elements.indices]
    return np.fromiter((e.get_destination()[1] for e in elements),
                       dtype=np.int64, count=len(elements))


def _element_contig(elements):
    """Contig name of the first element (partitions are single-contig)."""
    table = getattr(elements, "table", None)
    if table is not None:
        return table.contigs.names[int(table.contig_code[elements.indices[0]])]
    return elements[0].contig


def _ins_sequence_bytes(elements):
    """Upper-cased ASCII bytes of every element's inserted sequence,
    concatenated, plus per-element lengths — one blob gather for table views
    (no str objects), join of .sequence otherwise."""
    table = getattr(elements, "table", None)
    if table is not None:
        indices = elements.indices
        blob = table.seq_blob
        offs = table.seq_off[indices]
        lens = table.seq_len[indices]
        joined = b"".join(blob[off:off + length]
                          for off, length in zip(offs.tolist(), lens.tolist()))
        return joined.upper(), lens
    lens = np.fromiter((len(e.sequence) for e in elements), dtype=np.int64,
                       count=len(elements))
    return "".join(e.sequence for e in elements).upper().encode(), lens


class InsEditCache:
    """Batched INS haplotype edit distances, queryable two ways: a scalar
    {(id(a), id(b)): distance} lookup (pair fast path), and per-partition
    (pairs_i, pairs_j, values) arrays for vectorized matrix fills.  The pair
    arrays are the np.triu/nonzero enumeration distance_matrix() performs, so
    consumers can reuse them directly."""

    __slots__ = ("pairs", "by_partition")

    def __init__(self):
        self.pairs = {}
        self.by_partition = {}

    def __getitem__(self, key):
        return self.pairs[key]

    def partition_arrays(self, sample):
        """(pairs_i, pairs_j, values) for this exact partition list, or
        None."""
        return self.by_partition.get(id(sample))


def _ins_pair_hints(spans, starts, pairs_i, pairs_j):
    """Proven per-pair distance upper bounds: either swap the inserts
    outright, or align insert<->insert and move the Delta-long reference
    run."""
    si = spans[pairs_i]
    sj = spans[pairs_j]
    return np.minimum(si + sj,
                      np.maximum(si, sj)
                      + 2 * np.abs(starts[pairs_i] - starts[pairs_j]))


def _native_indexed_ed():
    from svim_tpu_torch.native import aligner

    return aligner.edit_distance_pairs_indexed


def precompute_ins_edit_distances(samples, reference, options, device=None):
    """One batched edit-distance pass over the near pairs of ALL insertion
    partitions (the clustering inner loop, SVIM_clustering.py:64-77).
    Returns an InsEditCache.

    The default route ships only indices to the native batch (haplotypes are
    assembled in C++ worker scratch from per-element sequences and one
    reference window per partition); forced backends fall back to explicit
    string pairs through batch_edit_distances ("wavefront" on `device`)."""
    backend = getattr(options, "edit_backend", "auto")
    native_indexed = _native_indexed_ed() if backend == "auto" else None
    cache = InsEditCache()

    # per-partition pair enumeration (shared by both routes)
    prepared = []   # (sample, starts, pairs_i, pairs_j, hints)
    for sample in samples:
        if len(sample) < 2:
            continue
        sample_type = getattr(sample, "type", None) or sample[0].type
        if sample_type != "INS":
            continue
        starts, _spans, pairs_i, pairs_j, hints = ins_near_pairs(sample,
                                                                 options)
        if not len(pairs_i):
            continue
        prepared.append((sample, starts, pairs_i, pairs_j, hints))
    if not prepared:
        return cache

    if native_indexed is not None:
        seq_parts = []
        seq_len_parts = []
        elem_start_parts = []
        win_parts = []
        win_coords = []
        pair_a_parts = []
        pair_b_parts = []
        pair_win_parts = []
        hint_parts = []
        base = 0
        for w, (sample, starts, pairs_i, pairs_j, hints) in enumerate(prepared):
            window = PartitionWindow(reference, _element_contig(sample),
                                     int(starts.min()), int(starts.max()))
            win_parts.append(window.sequence.encode())
            win_coords.append(window.offset)
            # one blob gather / join+upper per partition (not per element):
            # ASCII upper is per-character, so the bytes are identical
            seq_bytes, seq_lens = _ins_sequence_bytes(sample)
            seq_parts.append(seq_bytes)
            seq_len_parts.append(seq_lens)
            elem_start_parts.append(starts)
            pair_a_parts.append(pairs_i.astype(np.int64) + base)
            pair_b_parts.append(pairs_j.astype(np.int64) + base)
            pair_win_parts.append(np.full(len(pairs_i), w, dtype=np.int32))
            hint_parts.append(hints)
            base += len(sample)
        seq_len = np.concatenate(seq_len_parts)
        seq_off = np.zeros(len(seq_len), dtype=np.int64)
        np.cumsum(seq_len[:-1], out=seq_off[1:])
        win_len = np.fromiter((len(w) for w in win_parts), dtype=np.int64,
                              count=len(win_parts))
        win_off = np.zeros(len(win_len), dtype=np.int64)
        np.cumsum(win_len[:-1], out=win_off[1:])
        values = native_indexed(
            b"".join(seq_parts), seq_off, seq_len,
            np.concatenate(elem_start_parts),
            b"".join(win_parts), win_off, win_len,
            np.asarray(win_coords, dtype=np.int64),
            np.concatenate(pair_a_parts).astype(np.int32),
            np.concatenate(pair_b_parts).astype(np.int32),
            np.concatenate(pair_win_parts),
            np.concatenate(hint_parts).astype(np.int64), WINDOW_PADDING)
        values = np.asarray(values, dtype=np.int64)
        consumed = 0
        for sample, starts, pairs_i, pairs_j, _hints in prepared:
            part = values[consumed:consumed + len(pairs_i)]
            consumed += len(pairs_i)
            cache.by_partition[id(sample)] = (pairs_i, pairs_j, part)
            if len(sample) <= 2:
                # scalar lookups (ins_pair_distance) happen only on the
                # 2-element fast path; matrix partitions consume the arrays
                for i, j, value in zip(pairs_i.tolist(), pairs_j.tolist(),
                                       part.tolist()):
                    key = _pair_key(sample[i], sample[j])
                    cache.pairs[key] = value
                    cache.pairs[(key[1], key[0])] = value
        return cache

    # forced-backend route: explicit haplotype strings
    haplotype_pairs = []
    band_hints = []
    for sample, starts, pairs_i, pairs_j, hints in prepared:
        haplotype_pairs.extend(ins_haplotype_pairs(
            sample, starts, pairs_i, pairs_j, reference))
        band_hints.extend(hints.tolist())
    values = np.asarray(batch_edit_distances(haplotype_pairs, backend,
                                             band_hints=band_hints,
                                             device=device),
                        dtype=np.int64)
    consumed = 0
    for sample, _starts, pairs_i, pairs_j, _hints in prepared:
        part = values[consumed:consumed + len(pairs_i)]
        consumed += len(pairs_i)
        cache.by_partition[id(sample)] = (pairs_i, pairs_j, part)
        if len(sample) <= 2:
            for i, j, value in zip(pairs_i.tolist(), pairs_j.tolist(),
                                   part.tolist()):
                key = _pair_key(sample[i], sample[j])
                cache.pairs[key] = value
                cache.pairs[(key[1], key[0])] = value
    return cache


def ins_near_pairs(sample, options):
    """Near-pair enumeration for one INS partition — the EXACT f64 np.triu
    order distance_matrix() uses.  Returns (starts, spans, pairs_i, pairs_j,
    hints)."""
    starts, ends = _source_columns(sample)
    spans = ends - starts
    position_distance = (np.abs(starts[:, None] - starts[None, :])
                         / options.position_distance_normalizer)
    near = position_distance <= 2 * options.cluster_max_distance
    pairs_i, pairs_j = np.nonzero(np.triu(near, k=1))
    pairs_i = pairs_i.astype(np.int32)
    pairs_j = pairs_j.astype(np.int32)
    return (starts, spans, pairs_i, pairs_j,
            _ins_pair_hints(spans, starts, pairs_i, pairs_j))


def ins_haplotype_pairs(sample, starts, pairs_i, pairs_j, reference):
    """Reference-padded haplotype string pairs for the given near pairs
    (same assembly as the explicit-pairs route above /
    SVIM_clustering.py:32-45)."""
    window = PartitionWindow(reference, _element_contig(sample),
                             int(starts.min()), int(starts.max()))
    sequences = [element.sequence.upper() for element in sample]
    pairs = []
    for i, j in zip(pairs_i.tolist(), pairs_j.tolist()):
        w_start = min(starts[i], starts[j]) - WINDOW_PADDING
        w_end = max(starts[i], starts[j]) + WINDOW_PADDING
        pairs.append((
            window.slice(w_start, starts[i]) + sequences[i]
            + window.slice(starts[i], w_end),
            window.slice(w_start, starts[j]) + sequences[j]
            + window.slice(starts[j], w_end)))
    return pairs


def ins_haplotype_segments(partitions, reference):
    """The haplotype pairs of ins_haplotype_pairs for many partitions at
    once, as byte segments (wavefront_kernel.HaplotypePairs) instead of
    strings: one blob holds each partition's reference window (fetched once,
    as PartitionWindow) and its members' upper-cased inserted sequences, and
    each side of a pair is the window's slice before the member's start,
    its sequence, and the slice after, with PartitionWindow.slice's
    clipping.  `partitions`: (sample, starts, pairs_i, pairs_j) each, their
    pairs in that order."""
    from svim_tpu_torch.ops.wavefront_kernel import HaplotypePairs

    pieces = []
    parts = []
    base = 0
    for sample, starts, pairs_i, pairs_j in partitions:
        if not len(pairs_i):
            continue
        window = PartitionWindow(reference, _element_contig(sample),
                                 int(starts.min()), int(starts.max()))
        window_bytes = window.sequence.encode()
        sequences, sequence_lengths = _ins_sequence_bytes(sample)
        pieces += [window_bytes, sequences]
        size = len(window_bytes)
        sequence_starts = base + size + np.concatenate(
            [[0], np.cumsum(sequence_lengths[:-1])]).astype(np.int64)

        def at(position):
            # PartitionWindow.slice's bounds as places in the blob
            return base + np.clip(np.maximum(0, position) - window.offset,
                                  0, size)

        first = starts[pairs_i].astype(np.int64)
        second = starts[pairs_j].astype(np.int64)
        low = at(np.minimum(first, second) - WINDOW_PADDING)
        high = at(np.maximum(first, second) + WINDOW_PADDING)
        pair_parts = np.empty((len(pairs_i), 2, 6), dtype=np.int64)
        for side, (member, start) in enumerate(((pairs_i, first),
                                                (pairs_j, second))):
            cut = at(start)
            pair_parts[:, side, 0] = low
            pair_parts[:, side, 1] = np.maximum(0, cut - low)
            pair_parts[:, side, 2] = sequence_starts[member]
            pair_parts[:, side, 3] = sequence_lengths[member]
            pair_parts[:, side, 4] = cut
            pair_parts[:, side, 5] = np.maximum(0, high - cut)
        parts.append(pair_parts)
        base += size + len(sequences)
    return HaplotypePairs(
        np.frombuffer(b"".join(pieces), dtype=np.uint8),
        np.concatenate(parts) if parts else np.zeros((0, 2, 6), np.int64))


def ins_pair_distance(first, second, reference, options, ed_cache=None):
    """Scalar INS distance with optional cached edit distance (same float op
    order as the reference, SVIM_clustering.py:64-77)."""
    span1 = first.get_source()[2] - first.get_source()[1]
    span2 = second.get_source()[2] - second.get_source()[1]
    position_distance = (abs(first.get_source()[1] - second.get_source()[1])
                         / options.position_distance_normalizer)
    if position_distance > 2 * options.cluster_max_distance:
        span_distance = abs(span1 - span2) / max(span1, span2)
        return position_distance + span_distance
    if ed_cache is not None:
        distance = ed_cache[_pair_key(first, second)]
    else:
        from svim_tpu_torch.cluster.distance import compute_haplotype_edit_distance
        distance = compute_haplotype_edit_distance(first, second, reference)
    sequence_distance = (distance / max(span1, span2)
                         / options.edit_distance_normalizer)
    return position_distance + sequence_distance


def distance_matrix(elements, element_type, reference, options, ed_cache=None):
    """Full pairwise span-position distance matrix (no same-read wall)."""
    n = len(elements)
    starts, ends = _source_columns(elements)

    if element_type in ("DEL", "DUP_TAN", "INV"):
        position_distance, span_distance = _span_position_terms(
            starts, ends, options.position_distance_normalizer)
        return position_distance + span_distance

    if element_type == "DUP_INT":
        position_distance, span_distance = _span_position_terms(
            starts, ends, options.position_distance_normalizer)
        dest_starts = _dest_start_column(elements)
        dest_distance = (np.abs(dest_starts[:, None] - dest_starts[None, :])
                         / options.position_distance_normalizer)
        return position_distance + dest_distance + span_distance

    if element_type == "BND":
        dest_starts = _dest_start_column(elements)
        dist1 = np.abs(starts[:, None] - starts[None, :])
        dist2 = np.abs(dest_starts[:, None] - dest_starts[None, :])
        matrix = (dist1 + dist2) / BND_NORMALIZER
        table = getattr(elements, "table", None)
        if table is not None:
            dir1 = table.dir1[elements.indices]
            dir2 = table.dir2[elements.indices]
        else:
            dir1 = np.fromiter((0 if e.direction1 == "fwd" else 1 for e in elements),
                               dtype=np.int8, count=n)
            dir2 = np.fromiter((0 if e.direction2 == "fwd" else 1 for e in elements),
                               dtype=np.int8, count=n)
        mismatch = (dir1[:, None] != dir1[None, :]) | (dir2[:, None] != dir2[None, :])
        matrix[mismatch] = SAME_READ_WALL
        return matrix

    if element_type == "INS":
        spans = ends - starts
        position_distance = (np.abs(starts[:, None] - starts[None, :])
                             / options.position_distance_normalizer)
        max_span = np.maximum(spans[:, None], spans[None, :])
        span_distance = np.abs(spans[:, None] - spans[None, :]) / max_span
        near = position_distance <= 2 * options.cluster_max_distance
        matrix = position_distance + span_distance
        # sequence distance for local pairs: exact edit distance over
        # reference-padded haplotypes (SVIM_clustering.py:64-77)
        arrays = (ed_cache.partition_arrays(elements)
                  if isinstance(ed_cache, InsEditCache) else None)
        if arrays is not None:
            # vectorized fill from the precomputed pair arrays (identical
            # np.triu enumeration; same elementwise f64 op order as the
            # scalar expression below)
            pairs_i, pairs_j, values = arrays
            filled = (position_distance[pairs_i, pairs_j]
                      + values / max_span[pairs_i, pairs_j]
                      / options.edit_distance_normalizer)
            matrix[pairs_i, pairs_j] = filled
            matrix[pairs_j, pairs_i] = filled
            np.fill_diagonal(matrix, 0.0)
            return matrix
        pairs_i, pairs_j = np.nonzero(np.triu(near, k=1))
        if len(pairs_i):
            if ed_cache is not None:
                distances = [ed_cache[_pair_key(elements[i], elements[j])]
                             for i, j in zip(pairs_i.tolist(), pairs_j.tolist())]
            else:
                window = PartitionWindow(reference, elements[0].contig,
                                         int(starts.min()), int(starts.max()))
                sequences = [e.sequence.upper() for e in elements]
                haplotype_pairs = []
                for i, j in zip(pairs_i.tolist(), pairs_j.tolist()):
                    w_start = min(starts[i], starts[j]) - WINDOW_PADDING
                    w_end = max(starts[i], starts[j]) + WINDOW_PADDING
                    haplotype_pairs.append((
                        window.slice(w_start, starts[i]) + sequences[i]
                        + window.slice(starts[i], w_end),
                        window.slice(w_start, starts[j]) + sequences[j]
                        + window.slice(starts[j], w_end)))
                distances = batch_edit_distances(
                    haplotype_pairs, getattr(options, "edit_backend", "auto"))
            for (i, j), distance in zip(zip(pairs_i.tolist(), pairs_j.tolist()),
                                        distances):
                value = (position_distance[i, j]
                         + distance / max_span[i, j] / options.edit_distance_normalizer)
                matrix[i, j] = matrix[j, i] = value
        np.fill_diagonal(matrix, 0.0)
        return matrix

    raise ValueError("unknown signature type {0}".format(element_type))


def read_index_array(elements):
    """Integer read-identity column (same id <=> same read name)."""
    table = getattr(elements, "table", None)
    if table is not None:
        # pool codes are already a read-identity equivalence (one code per
        # interned name); consumers only compare for equality
        return table.read_code[elements.indices].astype(np.int64)
    index_of = {}
    out = np.empty(len(elements), dtype=np.int64)
    for pos, element in enumerate(elements):
        out[pos] = index_of.setdefault(element.read, len(index_of))
    return out


def dedup_same_read(matrix, reads, cluster_max_distance):
    """Indices to drop: j > i, same read, distance <= threshold
    (reference: SVIM_clustering.py:145-151)."""
    if len(np.unique(reads)) == len(reads):
        return set()
    same_read = reads[:, None] == reads[None, :]
    close = matrix <= cluster_max_distance
    drop = np.triu(same_read & close, k=1).any(axis=0)
    return set(np.nonzero(drop)[0].tolist())


def condensed_with_wall(matrix, reads, wall_same_read):
    """Condensed upper-triangle vector, applying the same-read wall."""
    n = matrix.shape[0]
    if wall_same_read:
        same_read = reads[:, None] == reads[None, :]
        matrix = np.where(same_read, float(SAME_READ_WALL), matrix)
    return matrix[triu_indices_cached(n)]
