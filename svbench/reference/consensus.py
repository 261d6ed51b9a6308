"""The consensus of an insertion cluster of three or more signatures
(SVIM_COMBINE.py:188-254), as the measured program states it, worked out
plainly in NumPy: haplotypes padded with 100 bp of reference, their
partial-order alignment (two-piece affine gaps, SPOA's algorithm 1
scores), two rounds of star polish, the realignment of the consensus to
the reference window and SVIM's acceptance of a unique gap run whose size
is within a factor of two of the cluster's.

Every dynamic programme here runs a row at a time.  Within a row the
horizontal gap states are closed forms over a running maximum: opening a
gap piece from a cell that is itself in a gap state always scores below
extending that state (each opening costs more than an extension), so a
piece's value at column j is the best of the non-gap cells k < j, and of
the other piece's cells, plus its opening and j - 1 - k extensions.  The
values, the choices and their ties are those of the cell-by-cell
recurrences."""

from __future__ import annotations

import re

import numpy as np

MATCH, MISMATCH = 2.0, -4.0
OPEN1, EXT1, OPEN2, EXT2 = -4.0, -2.0, -24.0, -1.0
NEG = -np.inf
FULL_DP_CELLS = 16_384          # larger pair alignments run banded first
ALIGN_MAX_CELLS = 256_000_000   # a pair alignment's budget
POA_MAX_CELLS = 120_000_000     # a graph alignment's budget
POA_FULL_DP_CELLS = 16_384
POA_FIRST_BAND = 16
PAIR_FIRST_BAND = 64
POLISH_ROUNDS = 2
WINDOW_PADDING = 100
SIZE_DEVIATION = 2.0


def _bytes(text):
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _gap(sources, opening, extension):
    """out[t - 1] = max over s < t of sources[s] + opening
    + (t - 1 - s) * extension, for t = 1 .. len(sources)."""
    steps = np.arange(len(sources), dtype=np.float64) * extension
    return np.maximum.accumulate(sources - steps) + opening + steps


def _shift(values, first):
    """`values` one column to the right, `first` in front, the last
    dropped."""
    out = np.empty_like(values)
    out[0] = first
    out[1:] = values[:-1]
    return out


# ---------------------------------------------------------------- pairs

def _rows(values, low, high, first, last):
    """Columns first..last of rows held over columns low..high, -inf
    outside."""
    out = np.full((values.shape[0], last - first + 1), NEG)
    start, stop = max(first, low), min(last, high)
    if start <= stop:
        out[:, start - first:stop - first + 1] = \
            values[:, start - low:stop - low + 1]
    return out


def _gap_rows(sources, opening, extension):
    """_gap along each row of a 2-D array."""
    steps = np.arange(sources.shape[1], dtype=np.float64) * extension
    return np.maximum.accumulate(sources - steps, axis=1) + opening + steps


def _shift_rows(values, first):
    out = np.empty_like(values)
    out[:, 0] = first
    out[:, 1:] = values[:, :-1]
    return out


def _pair_matrices(a, bs, lo, hi):
    """The two-piece Gotoh matrices of a against each of bs at once, each
    over its own columns lo[m, i]..hi[m, i] of row i (the rows' common
    columns are computed together, a sequence's cells outside its own
    -inf).  Returns per row (its first column, traceback bytes: bits 0-1
    0 match, 1 vertical, 2 horizontal; 0x04 vertical won with piece 2;
    0x08 / 0x10 vertical piece 1 / 2 extended; 0x20 horizontal won with
    piece 2; 0x40 / 0x80 horizontal piece 1 / 2 extended), and each
    sequence's final score."""
    count, la = len(bs), len(a)
    lengths = np.array([len(b) for b in bs])
    padded = np.zeros((count, int(lengths.max()) + 1), dtype=np.uint8)
    for m, b in enumerate(bs):
        padded[m, :len(b)] = b
    low, high = lo.min(axis=0), hi.max(axis=0)
    rows = []
    # the first row: horizontal gaps only
    first_hi = int(high[0])
    flags = np.zeros((count, first_hi + 1), dtype=np.uint8)
    best = np.full((count, first_hi + 1), NEG)
    best[:, 0] = 0.0
    if first_hi >= 1:
        inside = np.arange(1, first_hi + 1) <= hi[:, :1]
        sources = np.full((count, first_hi), NEG)
        sources[:, 0] = 0.0
        h2 = _gap_rows(sources, OPEN2, EXT2)
        h1 = _gap_rows(np.maximum(sources, _shift_rows(h2, NEG)), OPEN1, EXT1)
        row_best = np.maximum(h1, h2)
        before = _shift_rows(row_best, 0.0)
        flags[:, 1:] = (2 | (h2 > h1) * 0x20
                        | (_shift_rows(h1, NEG) + EXT1 >= before + OPEN1) * 0x40
                        | (_shift_rows(h2, NEG) + EXT2 >= before + OPEN2) * 0x80)
        best[:, 1:] = np.where(inside, row_best, NEG)
    rows.append((0, flags))
    v1 = np.full_like(best, NEG)
    v2 = np.full_like(best, NEG)
    held = (0, first_hi)
    for i in range(1, la + 1):
        jlo, jhi = int(low[i]), int(high[i])
        width = jhi - jlo + 1
        columns = np.arange(jlo, jhi + 1)
        inside = (columns >= lo[:, i:i + 1]) & (columns <= hi[:, i:i + 1])
        flags = np.zeros((count, width), dtype=np.uint8)
        row_best = np.full((count, width), NEG)
        row_v1 = np.full((count, width), NEG)
        row_v2 = np.full((count, width), NEG)
        left = np.full(count, NEG)
        start = jlo
        if jlo == 0:
            open1, ext1 = best[:, 0] + OPEN1, v1[:, 0] + EXT1
            open2, ext2 = best[:, 0] + OPEN2, v2[:, 0] + EXT2
            c1, c2 = np.maximum(open1, ext1), np.maximum(open2, ext2)
            flags[:, 0] = (1 | (c2 > c1) * 0x04 | (ext1 >= open1) * 0x08
                           | (ext2 >= open2) * 0x10)
            row_v1[:, 0] = np.where(inside[:, 0], c1, NEG)
            row_v2[:, 0] = np.where(inside[:, 0], c2, NEG)
            left = row_best[:, 0] = np.where(inside[:, 0], np.maximum(c1, c2),
                                             NEG)
            start = 1
        if start <= jhi:
            rest = slice(start - jlo, width)
            within = inside[:, rest]
            above = _rows(best, held[0], held[1], start, jhi)
            open1 = above + OPEN1
            ext1 = _rows(v1, held[0], held[1], start, jhi) + EXT1
            open2 = above + OPEN2
            ext2 = _rows(v2, held[0], held[1], start, jhi) + EXT2
            c1, c2 = np.maximum(open1, ext1), np.maximum(open2, ext2)
            second = c2 > c1
            vbest = np.where(second, c2, c1)
            score = _rows(best, held[0], held[1], start - 1, jhi - 1) + np.where(
                padded[:, start - 1:jhi] == a[i - 1], MATCH, MISMATCH)
            plain = np.where(within, np.maximum(vbest, score), NEG)
            sources = _shift_rows(plain, 0.0)
            sources[:, 0] = left
            h2 = _gap_rows(sources, OPEN2, EXT2)
            h1 = _gap_rows(np.maximum(sources, _shift_rows(h2, NEG)),
                           OPEN1, EXT1)
            hsecond = h2 > h1
            hbest = np.where(hsecond, h2, h1)
            cell = np.where(within, np.maximum(plain, hbest), NEG)
            before = _shift_rows(cell, 0.0)
            before[:, 0] = left
            state = np.where((vbest >= score) & (vbest >= hbest), 1,
                             np.where(hbest >= score, 2, 0))
            flags[:, rest] = (
                state | second * 0x04 | (ext1 >= open1) * 0x08
                | (ext2 >= open2) * 0x10 | hsecond * 0x20
                | (_shift_rows(h1, NEG) + EXT1 >= before + OPEN1) * 0x40
                | (_shift_rows(h2, NEG) + EXT2 >= before + OPEN2) * 0x80)
            row_best[:, rest] = cell
            row_v1[:, rest] = np.where(within, c1, NEG)
            row_v2[:, rest] = np.where(within, c2, NEG)
        rows.append((jlo, flags))
        best, v1, v2, held = row_best, row_v1, row_v2, (jlo, jhi)
    final = np.array([best[m, length - held[0]] if length >= held[0] else NEG
                      for m, length in enumerate(lengths.tolist())])
    return rows, final


def _pair_walk(a, b, m, rows, lo, hi, banded):
    """Sequence m's alignment rows, walked back honouring gap pieces;
    None where a banded path touches its corridor."""
    la, lb = len(a), len(b)
    row_a, row_b = [], []
    i, j = la, lb
    at, flags = rows[i]
    state = flags[m, j - at] & 3
    piece = 0
    while i > 0 or j > 0:
        if banded and ((lo[i] > 0 and j <= lo[i]) or (hi[i] < lb and j >= hi[i])):
            return None
        at, flags = rows[i]
        here = flags[m, j - at]
        if state == 0:
            row_a.append(a[i - 1])
            row_b.append(b[j - 1])
            i -= 1
            j -= 1
            at, flags = rows[i]
            state = flags[m, j - at] & 3
            piece = 0
        elif state == 1:
            if not piece:
                piece = 2 if here & 0x04 else 1
            extended = here & (0x10 if piece == 2 else 0x08)
            row_a.append(a[i - 1])
            row_b.append(45)
            i -= 1
            if not extended:
                at, flags = rows[i]
                state = flags[m, j - at] & 3
                piece = 0
        else:
            if not piece:
                piece = 2 if here & 0x20 else 1
            extended = here & (0x80 if piece == 2 else 0x40)
            row_a.append(45)
            row_b.append(b[j - 1])
            j -= 1
            if not extended:
                at, flags = rows[i]
                state = flags[m, j - at] & 3
                piece = 0
    return (bytes(reversed(row_a)).decode(), bytes(reversed(row_b)).decode())


def _pair_batch(a, bs, bands):
    """The alignments of a against each of bs, bands[m] None for the whole
    matrix; None for a banded one whose path touches its corridor."""
    la = len(a)
    ranks = np.arange(la + 1)
    lo = np.zeros((len(bs), la + 1), dtype=np.int64)
    hi = np.zeros((len(bs), la + 1), dtype=np.int64)
    for m, (b, band) in enumerate(zip(bs, bands)):
        lb = len(b)
        if band is None:
            hi[m] = lb
        else:
            delta = lb - la
            lo[m] = np.maximum(0, ranks + min(0, delta) - band)
            hi[m] = np.minimum(lb, ranks + max(0, delta) + band)
    rows, final = _pair_matrices(a, bs, lo, hi)
    a_list = a.tolist()
    out = []
    for m, (b, band) in enumerate(zip(bs, bands)):
        if band is not None and final[m] == NEG:
            out.append(None)
            continue
        out.append(_pair_walk(a_list, b.tolist(), m, rows, lo[m].tolist(),
                              hi[m].tolist(), band is not None))
    return out


def align_many(a, bs):
    """Global alignments of a against each of bs (strings): per sequence
    the two rows with '-' for gaps.  Small problems run the whole matrix;
    larger ones a corridor of 64 each side of the two ends' diagonals,
    doubled while the best path touches it, and the whole matrix once the
    corridor would cover it."""
    out = [None] * len(bs)
    if not a:
        return [("-" * len(b), b) for b in bs]
    x = _bytes(a)
    la = len(a)
    pending = {}
    for m, b in enumerate(bs):
        if not b:
            out[m] = (a, "-" * la)
        elif (la + 1) * (len(b) + 1) <= FULL_DP_CELLS:
            pending[m] = None
        else:
            pending[m] = PAIR_FIRST_BAND
    while pending:
        for m, band in pending.items():
            lb = len(bs[m])
            if band is not None and abs(lb - la) + 2 * band >= lb:
                band = pending[m] = None
            cells = (la + 1) * ((lb + 1) if band is None
                                else abs(lb - la) + 2 * band + 1)
            if cells > ALIGN_MAX_CELLS:
                raise MemoryError("alignment too large: {0}x{1}".format(la, lb))
        order = sorted(pending)
        found = _pair_batch(x, [_bytes(bs[m]) for m in order],
                            [pending[m] for m in order])
        for m, result in zip(order, found):
            if result is None:
                pending[m] *= 2
            else:
                out[m] = result
                del pending[m]
    return out


def align_global(a, b):
    """align_many of one sequence."""
    return align_many(a, [b])[0]


# ---------------------------------------------------------------- graph

class Graph:
    """A partial-order graph: per node its base, its predecessors with the
    weights of their edges, the ring of nodes aligned to it and the count
    of sequences through it."""

    def __init__(self):
        self.base, self.preds, self.weights = [], [], []
        self.ring, self.coverage = [], []
        self.topo, self.rank = [], []

    def add_node(self, base):
        self.base.append(base)
        self.preds.append([])
        self.weights.append([])
        self.ring.append([])
        self.coverage.append(0)
        return len(self.base) - 1

    def add_edge(self, source, target, weight):
        if source < 0:
            return
        preds = self.preds[target]
        if source in preds:
            self.weights[target][preds.index(source)] += weight
        else:
            preds.append(source)
            self.weights[target].append(weight)

    def toposort(self):
        count = len(self.base)
        successors = [[] for _ in range(count)]
        missing = [0] * count
        for node in range(count):
            for pred in self.preds[node]:
                successors[pred].append(node)
                missing[node] += 1
        order = [node for node in range(count) if missing[node] == 0]
        head = 0
        while head < len(order):
            for node in successors[order[head]]:
                missing[node] -= 1
                if missing[node] == 0:
                    order.append(node)
            head += 1
        self.topo = order
        self.rank = [0] * count
        for rank, node in enumerate(order):
            self.rank[node] = rank


def _window(values, low, high, first, last):
    """Columns first..last of a row held over low..high, -inf outside."""
    out = np.full(last - first + 1, NEG)
    start, stop = max(first, low), min(last, high)
    if start <= stop:
        out[start - first:stop - first + 1] = values[start - low:stop - low + 1]
    return out


def align_to_graph(graph, seq, band=None):
    """(touched, steps) of the global alignment of `seq` (a uint8 array)
    to the graph, steps as (node or -1, position in seq or -1); band None
    runs every column of every node, a band only those within it of the
    node's depth (`touched` where the best path meets the band's edge).
    None where the banded cells exceed the budget."""
    n = len(graph.topo)
    rows = n + 1
    length = len(seq)
    pred_rows = []
    has_succ = [False] * rows
    for node in graph.topo:
        preds = graph.preds[node]
        pred_rows.append([graph.rank[p] + 1 for p in preds] if preds else [0])
        for p in preds:
            has_succ[graph.rank[p] + 1] = True
    lo, hi = [0] * rows, [length] * rows
    if band is not None:
        depth = [0] * rows
        for r in range(1, rows):
            depth[r] = max([1] + [depth[p] + 1 for p in pred_rows[r - 1]
                                  if graph.preds[graph.topo[r - 1]]])
            lo[r] = max(0, min(length, depth[r] - band))
            hi[r] = length if not has_succ[r] else max(0, min(length, depth[r] + band))
            if lo[r] > hi[r]:
                lo[r] = hi[r]
        if sum(h - l + 1 for l, h in zip(lo, hi)) > POA_MAX_CELLS:
            return None
    best, d1s, d2s, state, m_from, d1_from, d2_from, d_ext, i_ext = (
        [None] * rows for _ in range(9))

    # the start row: characters of seq only
    width = length + 1
    first = np.full(width, NEG)
    first[0] = 0.0
    start_state = np.zeros(width, dtype=np.uint8)
    start_ext = np.zeros(width, dtype=np.uint8)
    if length:
        sources = np.full(length, NEG)
        sources[0] = 0.0
        i2 = _gap(sources, OPEN2, EXT2)
        i1 = _gap(np.maximum(sources, _shift(i2, NEG)), OPEN1, EXT1)
        row_best = np.maximum(i1, i2)
        before = _shift(row_best, 0.0)
        first[1:] = row_best
        start_state[1:] = np.where(i1 >= i2, 3, 4)
        start_ext[1:] = ((_shift(i1, NEG) + EXT1 >= before + OPEN1) * 1
                         | (_shift(i2, NEG) + EXT2 >= before + OPEN2) * 2)
    best[0], state[0], i_ext[0] = first, start_state, start_ext
    d1s[0] = d2s[0] = np.full(width, NEG)

    scores = {}
    for r in range(1, rows):
        jlo, jhi = lo[r], hi[r]
        w = jhi - jlo + 1
        base = graph.base[graph.topo[r - 1]]
        if base not in scores:
            # the score of a match at each column, -inf at column 0
            scores[base] = np.concatenate(
                [[NEG], np.where(seq == base, MATCH, MISMATCH)])
        sub = scores[base][jlo:jhi + 1]
        preds = pred_rows[r - 1]
        if len(preds) == 1:
            pr = preds[0]
            reach = _window(best[pr], lo[pr], hi[pr], jlo - 1, jhi)
            above = reach[1:]
            open1 = above + OPEN1
            ext1 = _window(d1s[pr], lo[pr], hi[pr], jlo, jhi) + EXT1
            open2 = above + OPEN2
            ext2 = _window(d2s[pr], lo[pr], hi[pr], jlo, jhi) + EXT2
            d1 = np.maximum(open1, ext1)
            d2 = np.maximum(open2, ext2)
            live1, live2 = d1 > NEG, d2 > NEG
            d1f = np.where(live1, pr, -1)
            d2f = np.where(live2, pr, -1)
            dx = (live1 & (ext1 >= open1)) | ((live2 & (ext2 >= open2)) << 1)
            m = reach[:-1] + sub
            mf = np.where(m > NEG, pr, -1)
        else:
            d1 = np.full(w, NEG)
            d2 = np.full(w, NEG)
            m = np.full(w, NEG)
            d1f = np.full(w, -1)
            d2f = np.full(w, -1)
            mf = np.full(w, -1)
            dx = np.zeros(w, dtype=np.uint8)
            for pr in preds:
                reach = _window(best[pr], lo[pr], hi[pr], jlo - 1, jhi)
                above = reach[1:]
                open1 = above + OPEN1
                ext1 = _window(d1s[pr], lo[pr], hi[pr], jlo, jhi) + EXT1
                cand = np.maximum(open1, ext1)
                better = cand > d1
                d1 = np.where(better, cand, d1)
                d1f[better] = pr
                dx = np.where(better, (dx & 2) | (ext1 >= open1), dx)
                open2 = above + OPEN2
                ext2 = _window(d2s[pr], lo[pr], hi[pr], jlo, jhi) + EXT2
                cand = np.maximum(open2, ext2)
                better = cand > d2
                d2 = np.where(better, cand, d2)
                d2f[better] = pr
                dx = np.where(better, (dx & 1) | (ext2 >= open2) * 2, dx)
                cand = reach[:-1] + sub
                better = cand > m
                m = np.where(better, cand, m)
                mf[better] = pr
        states = np.empty((5, w))
        states[0], states[1], states[2] = m, d1, d2
        plain = states[:3].max(axis=0)
        states[3, 0] = states[4, 0] = NEG
        ix = np.zeros(w, dtype=np.uint8)
        if w > 1:
            states[4, 1:] = _gap(plain[:-1], OPEN2, EXT2)
            states[3, 1:] = _gap(np.maximum(plain[:-1], states[4, :-1]),
                                 OPEN1, EXT1)
        row_state = states.argmax(axis=0)
        row_best = states.max(axis=0)
        if w > 1:
            ix[1:] = ((states[3, :-1] + EXT1 >= row_best[:-1] + OPEN1) * 1
                      | (states[4, :-1] + EXT2 >= row_best[:-1] + OPEN2) * 2)
        best[r], d1s[r], d2s[r], state[r] = row_best, d1, d2, row_state
        m_from[r], d1_from[r], d2_from[r] = mf, d1f, d2f
        d_ext[r], i_ext[r] = dx, ix

    end_row, end_best = 0, NEG
    for r in range(rows):
        if r > 0 and has_succ[r]:
            continue
        value = best[r][length - lo[r]]
        if value > end_best:
            end_best, end_row = value, r
    if band is not None and end_best == NEG:
        return True, []

    steps = []
    touched = False
    r, j = end_row, length
    current = int(state[r][j - lo[r]])
    while r > 0 or j > 0:
        if band is not None and r > 0 and (
                (j == lo[r] and lo[r] > 0) or (j == hi[r] and hi[r] < length)):
            touched = True
        at = j - lo[r]
        if current == 0:
            steps.append((graph.topo[r - 1], j - 1))
            source = int(m_from[r][at])
            if source < 0:
                return True, []
            j -= 1
            r = source
            current = int(state[r][j - lo[r]])
        elif current in (1, 2):
            steps.append((graph.topo[r - 1], -1))
            source = int((d1_from if current == 1 else d2_from)[r][at])
            if source < 0:
                return True, []
            extended = d_ext[r][at] & (1 if current == 1 else 2)
            r = source
            if not extended:
                current = int(state[r][j - lo[r]])
        else:
            steps.append((-1, j - 1))
            extended = i_ext[r][at] & (1 if current == 3 else 2)
            j -= 1
            if not extended:
                current = int(state[r][j - lo[r]])
    steps.reverse()
    return touched, steps


def integrate(graph, seq, steps):
    """Adds an aligned sequence to the graph: a match reuses its node, a
    mismatch the node of its base in the aligned ring (a new one joins the
    ring), an insertion adds a node; edges along the sequence gain 1."""
    previous = -1
    for node, position in steps:
        if position < 0:
            continue
        base = int(seq[position])
        if node >= 0:
            if graph.base[node] == base:
                target = node
            else:
                target = next((other for other in graph.ring[node]
                               if graph.base[other] == base), -1)
                if target < 0:
                    target = graph.add_node(base)
                    graph.ring[target] = graph.ring[node] + [node]
                    for other in graph.ring[target]:
                        graph.ring[other].append(target)
        else:
            target = graph.add_node(base)
        graph.coverage[target] += 1
        graph.add_edge(previous, target, 1.0)
        previous = target


def heaviest_path(graph):
    """The path of the largest edge weight; the node of more coverage
    wins a tie."""
    graph.toposort()
    count = len(graph.base)
    score = [0.0] * count
    source = [-1] * count
    best_score, best_node = -1.0, -1
    for node in graph.topo:
        value, chosen = 0.0, -1
        for pred, weight in zip(graph.preds[node], graph.weights[node]):
            candidate = score[pred] + weight
            if candidate > value or (candidate == value and chosen >= 0 and
                                     graph.coverage[pred] > graph.coverage[chosen]):
                value, chosen = candidate, pred
        score[node], source[node] = value, chosen
        if value > best_score or (value == best_score and best_node >= 0 and
                                  graph.coverage[node] > graph.coverage[best_node]):
            best_score, best_node = value, node
    path = []
    node = best_node
    while node >= 0:
        path.append(graph.base[node])
        node = source[node]
    return bytes(reversed(path)).decode()


def graph_consensus(sequences):
    """The heaviest path of the sequences' partial-order graph, the first
    sequence its seed; each next one aligned whole where the matrix is
    small, else in a band that starts at the last accepted width (16 at
    first) and doubles while the path meets its edge.  None where a band
    exceeds the budget or no band up to the whole holds the path."""
    graph = Graph()
    previous = -1
    for base in _bytes(sequences[0]).tolist():
        node = graph.add_node(base)
        graph.coverage[node] = 1
        graph.add_edge(previous, node, 1.0)
        previous = node
    start_band = POA_FIRST_BAND
    for sequence in sequences[1:]:
        seq = _bytes(sequence)
        graph.toposort()
        length = len(seq)
        steps = None
        if (len(graph.topo) + 1) * (length + 1) <= POA_FULL_DP_CELLS:
            steps = align_to_graph(graph, seq)[1]
        if steps is None:
            band = start_band
            while band <= 2 * (length + 2):
                found = align_to_graph(graph, seq, band)
                if found is None:
                    return None
                touched, steps = found
                if not touched:
                    start_band = band
                    break
                band *= 2
            else:
                return None
        integrate(graph, seq, steps)
    return heaviest_path(graph)


# ---------------------------------------------------------------- votes

def _vote(chars, rows):
    """The column's base: the most frequent character, gaps counted for
    the rows without one, a base before a gap and the first seen before a
    later one on a tie; none unless it is a base held by half the rows."""
    counts, first = {}, {}
    for index, char in enumerate(chars):
        if char not in counts:
            counts[char] = 0
            first[char] = index
        counts[char] += 1
    if "-" not in counts:
        counts["-"] = 0
        first["-"] = len(chars)
    counts["-"] += rows - len(chars)
    choice = max(counts, key=lambda char: (counts[char], char != "-",
                                           -first[char]))
    if choice != "-" and 2 * counts[choice] >= rows:
        return choice
    return None


def star_consensus(sequences, center=None):
    """Every sequence aligned to a center and the columns, and the blocks
    inserted before each, voted: the center is the sequence of median
    length (a voter) or, when given, the previous consensus (no voter)."""
    if len(sequences) == 1 and center is None:
        return sequences[0]
    if center is None:
        order = sorted(range(len(sequences)),
                       key=lambda k: (len(sequences[k]), k))
        pick = order[len(order) // 2]
        center = sequences[pick]
        others = [s for k, s in enumerate(sequences) if k != pick]
        columns = [[char] for char in center]
        rows = len(others) + 1
    else:
        others = list(sequences)
        columns = [[] for _ in center]
        rows = len(others)
    blocks = [[] for _ in range(len(center) + 1)]
    for row_center, row_seq in align_many(center, others):
        position = 0
        pending = []
        aligned = ["-"] * len(center)
        for char_center, char_seq in zip(row_center, row_seq):
            if char_center == "-":
                pending.append(char_seq)
            else:
                if pending:
                    blocks[position].append("".join(pending))
                    pending = []
                aligned[position] = char_seq
                position += 1
        if pending:
            blocks[position].append("".join(pending))
        for index, char in enumerate(aligned):
            columns[index].append(char)
    out = []
    for position in range(len(center) + 1):
        if blocks[position]:
            for column in range(max(len(block) for block in blocks[position])):
                base = _vote([block[column] for block in blocks[position]
                              if column < len(block)], rows)
                if base:
                    out.append(base)
        if position < len(center):
            base = _vote(columns[position], rows)
            if base:
                out.append(base)
    return "".join(out)


def _common_ends(sequences):
    limit = min(len(s) for s in sequences)
    first = sequences[0]
    prefix = 0
    while prefix < limit and all(s[prefix] == first[prefix] for s in sequences):
        prefix += 1
    suffix = 0
    while suffix < limit - prefix and all(
            s[len(s) - 1 - suffix] == first[len(first) - 1 - suffix]
            for s in sequences):
        suffix += 1
    return prefix, suffix


def consensus(sequences):
    """The consensus of similar sequences: the bases that every one shares
    at either end set aside, the partial-order graph's heaviest path (the
    star consensus where the graph's budget is exceeded), then polished
    by rounds of the star vote around it until it no longer changes."""
    if len(sequences) > 1:
        prefix, suffix = _common_ends(sequences)
        if prefix or suffix:
            middles = [s[prefix:len(s) - suffix] for s in sequences]
            head = sequences[0][:prefix]
            tail = sequences[0][len(sequences[0]) - suffix:] if suffix else ""
            if not any(middles):
                return head + tail
            if all(middles):
                return head + consensus(middles) + tail
    found = graph_consensus(sequences) if len(sequences) > 1 else None
    if found is None:
        found = star_consensus(sequences)
    for _ in range(POLISH_ROUNDS):
        if not found:
            break
        largest = max(len(s) for s in sequences)
        if (len(found) + 1) * (largest + 1) > ALIGN_MAX_CELLS:
            raise MemoryError("polish too large")
        refined = star_consensus(sequences, center=found)
        if refined == found:
            break
        found = refined
    return found


def haplotypes(cluster, fasta):
    """(haplotypes, reference window, window start, expected size) of an
    insertion cluster: each member's inserted sequence between the
    reference around it, 100 bp beyond the members' outermost starts."""
    starts = [member.start for member in cluster.members]
    window_start = min(starts) - WINDOW_PADDING
    window_end = max(starts) + WINDOW_PADDING
    out = []
    for member in cluster.members:
        out.append(fasta.fetch(cluster.contig, max(0, window_start),
                               max(0, member.start)).upper()
                   + member.sequence.upper()
                   + fasta.fetch(cluster.contig, max(0, member.start),
                                 max(0, window_end)).upper())
    window = fasta.fetch(cluster.contig, max(0, window_start),
                         max(0, window_end)).upper()
    return out, window, window_start, cluster.end - cluster.start


def outcome(inputs, maximum_length=10000):
    """(status, (start, size, sequence) or ()) of an insertion cluster's
    `haplotypes`: status 0 a unique accepted gap run, 1 haplotypes over
    `maximum_length`, 2 a matrix over its budget, 3 no gap run within a
    factor of two of the cluster's size, 4 more than one."""
    sequences, window, window_start, expected = inputs
    if max(len(s) for s in sequences) > maximum_length:
        return 1, ()
    try:
        found = consensus(sequences)
        row_consensus, row_window = align_global(found, window)
    except MemoryError:
        return 2, ()
    good = []
    for run in re.finditer(r"-+", row_window):
        size = run.end() - run.start()
        if max(size, expected) / min(size, expected) < SIZE_DEVIATION:
            good.append((run.start(), size))
    if not good:
        return 3, ()
    if len(good) > 1:
        return 4, ()
    at, size = good[0]
    return 0, (max(0, window_start) + at, size, row_consensus[at:at + size])


def outcomes(clusters, fasta, maximum_length=10000, workers=8):
    """`outcome` of each cluster, worked out in `workers` processes of
    their own, the largest first."""
    inputs = [haplotypes(cluster, fasta) for cluster in clusters]
    order = sorted(range(len(inputs)), key=lambda k: -sum(
        len(s) for s in inputs[k][0]) * max(len(s) for s in inputs[k][0]))
    found = [None] * len(inputs)
    if workers <= 1 or len(inputs) <= 1:
        for k in order:
            found[k] = outcome(inputs[k], maximum_length)
        return found
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        for k, result in zip(order, pool.map(
                outcome, [inputs[k] for k in order],
                [maximum_length] * len(order))):
            found[k] = result
    return found
