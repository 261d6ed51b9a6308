"""Exact Levenshtein distances of many string pairs in plain PyTorch: the
dynamic programme swept one anti-diagonal at a time over a batch of pairs,
on whatever device it is given.  A pair's common prefix and suffix are
dropped first (they never change its distance)."""

from __future__ import annotations

import numpy as np
import torch

BATCH_CELLS = 48 << 20   # pairs x row width held in one batch
# a shorter pair joins a longer pair's sweep where the cells it adds there
# cost less than the anti-diagonal steps of a sweep of its own: a step
# costs about as much as this many cells, on the card (a dozen launches)
# and on the CPU
MERGE_CELLS_PER_STEP = {"cuda": 1 << 20, "cpu": 4096}


def _codes(text):
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _trim(a, b):
    limit = min(len(a), len(b))
    head = 0
    while head < limit and a[head] == b[head]:
        head += 1
    tail = 0
    while tail < limit - head and a[len(a) - 1 - tail] == b[len(b) - 1 - tail]:
        tail += 1
    return a[head:len(a) - tail], b[head:len(b) - tail]


def _batch(pairs, device):
    """Distances of `pairs` (row string shorter or equal), one sweep."""
    count = len(pairs)
    rows = max(len(a) for a, _ in pairs)
    cols = max(len(b) for _, b in pairs)
    width = rows + 1
    # a[i - 1] at row i; b reversed and padded so that the cell (i, k - i)
    # reads b[k - i - 1] from one slice of the row per diagonal k
    a_codes = np.full((count, width), 254, dtype=np.uint8)
    b_rev = np.full((count, width + cols + width), 255, dtype=np.uint8)
    n = np.empty(count, dtype=np.int64)
    m = np.empty(count, dtype=np.int64)
    for index, (a, b) in enumerate(pairs):
        n[index], m[index] = len(a), len(b)
        a_codes[index, 1:1 + len(a)] = _codes(a)
        # b[t] sits at column width + cols - 1 - t
        if len(b):
            b_rev[index, width + cols - len(b):width + cols] = _codes(b)[::-1]
    a_t = torch.from_numpy(a_codes).to(device)
    b_t = torch.from_numpy(b_rev).to(device)
    rows_index = torch.arange(width, device=device, dtype=torch.int32)[None, :]
    big = torch.iinfo(torch.int32).max // 2
    previous2 = torch.full((count, width), big, dtype=torch.int32, device=device)
    previous = torch.full((count, width), big, dtype=torch.int32, device=device)
    previous[:, 0] = 0   # diagonal 0: the cell (0, 0)
    current = torch.empty_like(previous)
    shifted = torch.empty_like(previous)
    shifted[:, 0] = big
    totals = torch.from_numpy(n + m).to(device)
    n_t = torch.from_numpy(n).to(device)[:, None]
    result = torch.zeros(count, dtype=torch.int32, device=device)
    ends = set((n + m).tolist())
    for k in range(1, int((n + m).max()) + 1):
        # from above (i - 1, j) and from the left (i, j - 1), one more
        shifted[:, 1:] = previous[:, :-1]
        torch.minimum(shifted, previous, out=current)
        current += 1
        # from the diagonal (i - 1, j - 1), one more on a mismatch:
        # b[k - i - 1] for rows i >= 1 lies at column width + cols - k + i
        low = width + cols - k
        shifted[:, 1:] = previous2[:, :-1]
        shifted[:, 1:] += (a_t[:, 1:] != b_t[:, low + 1:low + width])
        torch.minimum(current, shifted, out=current)
        # the first column (j = 0) and the first row (i = 0) are k
        current[:, 0] = k
        if k < width:
            current[:, k] = k
        current.masked_fill_(rows_index > k, big)
        shifted[:, 0] = big
        if k in ends:
            result = torch.where(totals == k,
                                 current.gather(1, n_t).squeeze(1), result)
        previous2, previous, current = previous, current, previous2
    return result.cpu().numpy()


def edit_distances(pairs, device):
    """Levenshtein distance of each (a, b) in `pairs`, as a list of ints."""
    results = [0] * len(pairs)
    trimmed = {}
    for index, (a, b) in enumerate(pairs):
        a, b = _trim(a, b)
        if not a or not b:
            results[index] = len(a) + len(b)
        else:
            trimmed[index] = (a, b) if len(a) <= len(b) else (b, a)
    # the longest sweeps first; a pair joins the current sweep where the
    # cells it adds to it cost less than a sweep of its own
    order = sorted(trimmed, key=lambda index: -sum(map(len, trimmed[index])))
    merge = MERGE_CELLS_PER_STEP[torch.device(device).type]
    while order:
        first = trimmed[order[0]]
        steps = len(first[0]) + len(first[1])
        batch, rest, widest = [order[0]], [], len(first[0]) + 1
        for index in order[1:]:
            a, b = trimmed[index]
            own_steps = len(a) + len(b)
            wider = max(widest, len(a) + 1)
            joins = (4 * own_steps >= 3 * steps
                     or (len(a) + 1) * steps <= merge * own_steps)
            if joins and (len(batch) + 1) * wider <= BATCH_CELLS:
                batch.append(index)
                widest = wider
            else:
                rest.append(index)
        for index, distance in zip(batch, _batch([trimmed[i] for i in batch],
                                                 device).tolist()):
            results[index] = int(distance)
        order = rest
    return results
