"""The strip layout of the port's wavefront kernel (csrc/wavefront.cu) as a
numpy model, held to the port's plain version and to svim_tpu's jnp
`banded_distance` on the same seeded pairs.  Every comparison is exact.

The model has the kernel's parts, with its constants as parameters so that
strings of 200-4,096 characters reach every part:

  * the ladder: rungs in one warp's fronts (63, 255, 1023 in the kernel),
    each tried where it is below half the pair's band and gives up when no
    cell of its last two fronts is within it; then, for a band wider than a
    warp holds, rungs of the strip kernel (4095) and the band itself;
  * `_fronts_pass`: a warp's one-parity anti-diagonal fronts with the give-up
    check every 16 front pairs;
  * `_strip_pass`: strips of R rows, each sweeping the columns its band
    reaches, its top row the previous strip's bottom row (INF past the
    columns that strip wrote), its bottom row checked for give-up;
  * `_lane_sweep`: one strip as the warp runs it, lane t one column behind
    lane t-1 with S rows a lane, D(i-1, j) from lane t-1's last step, the
    boundary column while a lane's column is <= 0, the mask skipped on
    steps whose cells all lie in the band, and the bottom row written for
    the columns the next strip reads;
  * `_handoff`: the strips of a CTA's K warps run in any order the kernel's
    counts allow, their bottom rows going through rings of kRing columns
    (the last warp's through the device-memory row): every top row a warp
    reads holds the column it wants.
"""

import random

import numpy as np
import pytest
import torch

from svim_tpu.ops import wavefront_kernel as jax_wavefront
from svim_tpu_torch.ops import wavefront_kernel as torch_wavefront

INF = torch_wavefront.INF
# the kernel's constants (csrc/wavefront.cu)
KERNEL = {"warp_rungs": (63, 255, 1023), "warp_slots": 32 * 33,
          "strip_rungs": (4095,), "lanes": 32, "rows_a_lane": 32}
# the same design scaled down: 200-4,096 characters reach every rung
SCALED = {"warp_rungs": (7, 31, 127), "warp_slots": 4 * 40,
          "strip_rungs": (511,), "lanes": 4, "rows_a_lane": 8}
torch.set_num_threads(1)


def _boundary(index, w):
    return index if index <= w else INF


def _fronts_pass(a, b, w, may_stop):
    """One warp pass at band w over one-parity fronts (|m - n| <= w): D(m, n)
    within the band, or INF when `may_stop` and, at a check after every 16th
    front pair, no cell of the last two fronts is <= w."""
    m, n = len(a), len(b)
    offset = (min(w, n) + 1) & ~1
    half = offset >> 1
    slots = ((min(w, m) + offset) >> 1) + 1
    q = np.arange(slots)
    fronts = [np.full(slots, INF, dtype=np.int64),
              np.full(slots, INF, dtype=np.int64)]
    fronts[0][half] = 0
    a_pad = np.concatenate([[-1], a, [-1]])
    b_pad = np.concatenate([[-2], b, [-2]])
    last = m + n
    for d in range(1, last + 1):
        parity = d & 1
        base = offset - parity
        reach = min(w, d)
        q_lo = max((base - reach + 1) >> 1, (base + d - 2 * n + 1) >> 1)
        q_hi = min((base + reach) >> 1, (base + 2 * m - d) >> 1)
        previous = np.concatenate([[INF], fronts[1 - parity], [INF]])
        neighbours = np.minimum(previous[q + parity], previous[q + 1 + parity])
        i = (d >> 1) + q - half + parity
        j = (d >> 1) - q + half
        inside = (i >= 1) & (i <= m) & (j >= 1) & (j <= n)
        differ = np.where(inside, a_pad[np.clip(i, 0, m + 1)]
                          != b_pad[np.clip(j, 0, n + 1)], 1)
        value = np.minimum(neighbours + 1, fronts[parity] + differ)
        fronts[parity] = np.where((q >= q_lo) & (q <= q_hi), value, INF)
        r = (d - 1) >> 1
        if may_stop and (parity == 0 or d == last) and (r & 15) == 15:
            if min(fronts[0].min(), fronts[1].min()) > w:
                return INF
    final = (m - n + offset - (last & 1)) >> 1
    return int(fronts[last & 1][final])


def _strip_geometry(m, n, w, rows, strip):
    """Rows, columns and the top row's reach of one strip of `rows` rows."""
    i_first = strip * rows + 1
    j0 = max(1, i_first - w)
    j_end = min(n, min(m, i_first + rows - 1) + w)
    top_end = min(n, i_first - 1 + w)
    return i_first, j0, j_end, top_end


def _strip_rows(a, b, w, top, i_first, i_last, j0, j_end):
    """Rows i_first..i_last of the band-restricted DP over columns j0..j_end
    from the row above them (`top`, INF where unwritten), row by row:
    D(i, j) = j + min over k <= j of (X(k) - k), X the row above's
    contribution, INF outside |i - j| <= w.  Returns the rows, (R, n+1)."""
    n = len(b)
    columns = np.arange(j0, j_end + 1)
    out = np.full((i_last - i_first + 1, n + 1), INF, dtype=np.int64)
    above = top
    for row, i in enumerate(range(i_first, i_last + 1)):
        cost = (b[columns - 1] != a[i - 1]).astype(np.int64)
        x = np.minimum(above[columns] + 1, above[columns - 1] + cost)
        inside = np.abs(i - columns) <= w
        x = np.where(inside, x, INF)
        left = _boundary(i, w) if j0 == 1 else INF  # D(i, j0 - 1)
        chain = np.minimum.accumulate(
            np.concatenate([[left + 1 - j0], x - columns]))[1:] + columns
        values = np.minimum(np.where(inside, chain, INF), INF)
        out[row, j0:j_end + 1] = values
        out[row, 0] = _boundary(i, w)
        above = out[row]
    return out


def _lane_sweep(a, b, w, top, i_first, j0, j_end, lanes, rows_a_lane, m):
    """One strip as a warp sweeps it: lane t at step s is at column j0 + s -
    t with rows i_first + t S .. + S - 1 in registers.  Returns the bottom
    row as the warp writes it (columns 0..j_end it reached), D(m, n) when
    the strip holds row m, and the least bottom-row value it saw."""
    n = len(b)
    S = rows_a_lane
    rows = np.arange(S)
    lane_first = i_first + np.arange(lanes) * S            # (lanes,)
    i_cells = lane_first[:, None] + rows[None, :]            # (lanes, S)
    ca = np.where(i_cells <= m, a[np.clip(i_cells, 1, m) - 1], -1)
    before = (j0 - np.arange(lanes) - 1) <= 0
    left = np.where(before[:, None], np.where(i_cells <= w, i_cells, INF),
                    INF)
    previous_up = np.where(before, np.where(lane_first - 1 <= w,
                                            lane_first - 1, INF), INF)
    previous_up[0] = top[j0 - 1]
    bottom = left[:, -1].copy()
    written = np.full(n + 1, -1, dtype=np.int64)
    answer, least = None, INF
    for s in range(j_end - j0 + lanes):
        j = j0 + s - np.arange(lanes)
        cb = b[np.clip(j, 1, n) - 1]
        up = np.concatenate([[top[j0 + s] if j0 + s <= min(
            n, i_first - 1 + w) else INF], bottom[:-1]])
        diagonal, previous_up = previous_up, up
        base = i_first - j0 - s
        fast = (base >= -w and base + lanes * S + lanes - 2 <= w
                and j0 + s - (lanes - 1) >= 1)
        new = np.empty_like(left)
        carry_up, carry_diag = up, diagonal
        for x in range(S):
            value = np.minimum(np.minimum(carry_up, left[:, x]) + 1,
                               carry_diag + (ca[:, x] != cb))
            if not fast:
                value = np.where(np.abs(i_cells[:, x] - j) <= w, value, INF)
                value = np.where(j <= 0, np.where(i_cells[:, x] <= w,
                                                  i_cells[:, x], INF), value)
            carry_diag = left[:, x]
            carry_up = value
            new[:, x] = value
        left = new
        bottom = left[:, -1].copy()
        hit = (j == n) & (i_cells[:, 0] <= m) & (i_cells[:, -1] >= m)
        if hit.any():
            lane = int(np.flatnonzero(hit)[0])
            answer = int(left[lane, m - lane_first[lane]])
        if 0 <= j[-1] <= j_end:
            written[j[-1]] = bottom[-1]
            least = min(least, int(bottom[-1]))
    return written, answer, least


def _strip_pass(a, b, w, may_stop, lanes, rows_a_lane, engine="rows"):
    """The strip kernel's pass at band w (m, n >= 1, |m - n| <= w): strips of
    lanes * rows_a_lane rows in order; INF when `may_stop` and a strip's
    bottom row (above row m) holds no value <= w."""
    m, n = len(a), len(b)
    rows = lanes * rows_a_lane
    top = np.asarray([_boundary(j, w) for j in range(n + 1)], dtype=np.int64)
    for strip in range((m + rows - 1) // rows):
        i_first, j0, j_end, top_end = _strip_geometry(m, n, w, rows, strip)
        top = np.where(np.arange(n + 1) <= top_end, top, INF)
        i_last = min(m, i_first + rows - 1)
        if engine == "rows":
            block = _strip_rows(a, b, w, top, i_first, i_last, j0, j_end)
            bottom = np.where(np.arange(n + 1) <= j_end, block[-1], INF)
            least = int(bottom[max(0, j0 - 1):j_end + 1].min())
            answer = int(block[-1, n]) if i_last == m else None
        else:
            written, answer, least = _lane_sweep(
                a, b, w, top, i_first, j0, j_end, lanes, rows_a_lane, m)
            bottom = np.where(written >= 0, written, top)
        if i_last == m:
            return answer
        if may_stop and least > w:
            return INF
        top = bottom
    raise AssertionError("no strip holds row m")


def _slots_needed(m, n, w):
    offset = (min(w, n) + 1) & ~1
    return ((min(w, m) + offset) >> 1) + 1


def _model_ladder(a, b, band, warp_rungs, warp_slots, strip_rungs, lanes,
                  rows_a_lane, engine="rows"):
    """What the kernel returns for one pair at `band`: the warp ladder, the
    warp pass where the band fits `warp_slots`, else the strip kernel's
    rungs and its pass at the band."""
    a = np.frombuffer(a.encode(), dtype=np.uint8).astype(np.int64)
    b = np.frombuffer(b.encode(), dtype=np.uint8).astype(np.int64)
    m, n = len(a), len(b)
    if m + n == 0:
        return 0, "trivial"
    if abs(m - n) > band:
        return INF, "trivial"
    if m == 0 or n == 0:
        return max(m, n), "trivial"
    w = min(band, max(m, n))
    for rung in warp_rungs:
        if 2 * rung < w and abs(m - n) <= rung:
            value = _fronts_pass(a, b, rung, True)
            if value <= rung:
                return value, "warp rung {0}".format(rung)
    if _slots_needed(m, n, w) <= warp_slots:
        return _fronts_pass(a, b, w, False), "warp"
    for rung in strip_rungs:
        if 2 * rung < w and abs(m - n) <= rung:
            value = _strip_pass(a, b, rung, True, lanes, rows_a_lane, engine)
            if value <= rung:
                return value, "strip rung {0}".format(rung)
    return _strip_pass(a, b, w, False, lanes, rows_a_lane, engine), "strip"


def _edit(rng, text, edits):
    out = list(text)
    for _ in range(edits):
        position = int(rng.integers(0, max(1, len(out))))
        kind = int(rng.integers(0, 3))
        if kind == 0 and out:
            out[position] = "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            out.insert(position, "ACGT"[int(rng.integers(0, 4))])
        elif out:
            del out[position]
    return "".join(out)


def _random(rng, size):
    return "".join("ACGT"[k] for k in rng.integers(0, 4, size))


def _ladder_pairs(seed, low, high, edits):
    """Seeded pairs of `low`-`high` characters: a copy with each count of
    `edits` (None: an unrelated string), then far-apart lengths, empty and
    one-character strings."""
    rng = np.random.default_rng(seed)
    pairs = []
    for count in edits:
        a = _random(rng, int(rng.integers(low, high + 1)))
        b = (_random(rng, int(rng.integers(low, high + 1))) if count is None
             else _edit(rng, a, count))
        pairs.append((a, b[:high]))
    pairs += [("", ""), ("", "ACGT"), ("ACG", ""), ("A", "C"), ("A", ""),
              (_random(rng, 20), _random(rng, high)),
              (_random(rng, low), _random(rng, low))]
    return pairs


def _codes(pairs, length):
    a_codes = jax_wavefront._encode([a for a, _ in pairs], length)
    b_codes = jax_wavefront._encode([b for _, b in pairs], length)
    a_lens = np.asarray([len(a) for a, _ in pairs], dtype=np.int32)
    b_lens = np.asarray([len(b) for _, b in pairs], dtype=np.int32)
    return a_codes, a_lens, b_codes, b_lens


def _references(pairs, length, band):
    codes = _codes(pairs, length)
    plain = torch_wavefront.banded_distance_torch(
        *[torch.from_numpy(x) for x in codes], band).numpy()
    jnp = np.asarray(jax_wavefront.banded_distance(*codes, band))
    np.testing.assert_array_equal(plain, jnp)
    return plain


@pytest.mark.parametrize("band,length,edits", [
    (1024, 1024, (0, 3, 6, 20, 40, 90, 200, 400, None, None)),
    (4096, 4096, (5, 25, 100, 250, 300, 900, None)),
    (300, 1024, (4, 20, 60, 200, 350, None)),
])
def test_scaled_ladder_equals_plain_and_jnp(band, length, edits):
    """Distances on each scaled rung (7, 31, 127 in warps; 511 in strips),
    above the last rung, |m - n| > W and empty strings: the ladder returns
    the plain version's (and jnp's) value on every pair, above the band
    too."""
    pairs = _ladder_pairs(band + length, 200, length, edits)
    want = _references(pairs, length, band)
    got, routes = zip(*[_model_ladder(a, b, band, **SCALED)
                        for a, b in pairs])
    np.testing.assert_array_equal(np.asarray(got), want)
    if band == 4096:
        assert {"warp rung 7", "warp rung 31", "warp rung 127",
                "strip rung 511", "strip", "trivial"} <= set(routes)
    if band == 300:
        assert "strip" in routes and (want > band).any()


def test_kernel_ladder_equals_plain_and_jnp():
    """The kernel's own rungs (63, 255, 1023), 1056 warp slots and 32 x 32
    rows a strip, at W = L = 4096: the ladder's rungs and the strip pass."""
    pairs = _ladder_pairs(77, 2600, 4096, (10, 120, 700, None))
    want = _references(pairs, 4096, 4096)
    got, routes = zip(*[_model_ladder(a, b, 4096, **KERNEL)
                        for a, b in pairs])
    np.testing.assert_array_equal(np.asarray(got), want)
    assert {"warp rung 63", "warp rung 255", "warp rung 1023",
            "strip"} <= set(routes)


@pytest.mark.parametrize("lanes,rows_a_lane,band", [(4, 3, 9), (4, 3, 40),
                                                    (3, 5, 200), (8, 2, 64)])
def test_lane_sweep_equals_rows(lanes, rows_a_lane, band):
    """The warp's skewed sweep (lanes one column apart, S rows a lane, the
    boundary column, the mask skipped on steps inside the band) gives the
    strips the row-by-row model gives, and the plain version's value."""
    pairs = _ladder_pairs(lanes * 10 + band, 30, 160, (0, 2, 8, 30, None))
    pairs = [(a, b) for a, b in pairs if a and b and abs(len(a) - len(b))
             <= band]
    want = _references(pairs, 160, band)
    for (a, b), expected in zip(pairs, want):
        codes = [np.frombuffer(t.encode(), dtype=np.uint8).astype(np.int64)
                 for t in (a, b)]
        w = min(band, max(len(a), len(b)))
        rows = _strip_pass(*codes, w, False, lanes, rows_a_lane, "rows")
        lanes_value = _strip_pass(*codes, w, False, lanes, rows_a_lane,
                                  "lanes")
        assert rows == lanes_value == expected


def _handoff(m, n, w, rows, warps, ring, chunk, seed):
    """Runs the hand-off of one strip pass as the kernel's counts allow, the
    warps picked at random: strip k's warp stores its bottom row's columns
    chunk by chunk into ring (k mod warps) (the last warp into the L+1 row),
    loads its top row's columns chunk by chunk, and waits as the kernel
    waits (the producer's written count; before overwriting a slot, the
    read count of the consumer of this warp's last strip and of this one).  Returns (strip, column, what the slot held: the
    strip that stored it and its column) for every load."""
    rng = random.Random(seed)
    strips = (m + rows - 1) // rows
    stride = n + 64
    written = [0] * warps
    read = [0] * warps
    rings = [[None] * ring for _ in range(warps - 1)]
    row = [(-1, j) for j in range(n + 1)]
    loads = []

    def sweep(warp):
        for strip in range(warp, strips, warps):
            i_first, j0, j_end, top_end = _strip_geometry(m, n, w, rows,
                                                          strip)
            consumer_j0 = max(1, i_first + rows - w)
            steps = j_end - j0 + 32
            for s0 in range(0, steps, chunk):
                c0 = j0 + s0
                need = min(c0 + chunk - 1, top_end)
                if strip > 0 and need >= c0 - 1:
                    producer = (warp + warps - 1) % warps
                    while written[producer] < (strip - 1) * stride + need + 1:
                        yield
                source = row if warp == 0 else rings[warp - 1]
                size = len(source)
                columns = ([j0 - 1] if s0 == 0 else []) + [
                    c for c in range(c0, c0 + chunk) if c <= top_end]
                loads.extend((strip, c, source[c % size]) for c in columns)
                if warp > 0:
                    read[warp] = strip * stride + need + 1
                if s0 == 0 and warp != warps - 1 and strip >= warps:
                    last = strip - warps + 1
                    while read[warp + 1] < last * stride + min(
                            n, last * rows + w) + 1:
                        yield
                victim = c0 - ring
                if warp != warps - 1 and strip + 1 < strips \
                        and victim >= consumer_j0 - 1:
                    while read[warp + 1] < (strip + 1) * stride + victim + 1:
                        yield
                sink = row if warp == warps - 1 else rings[warp]
                last = j0 + min(s0 + chunk, steps) - 1 - 31
                for j in range(max(0, c0 - 31), min(last, j_end) + 1):
                    sink[j % len(sink)] = (strip, j)
                written[warp] = strip * stride + min(last, j_end) + 1
                yield

    running = [sweep(warp) for warp in range(warps)]
    spins = 0
    while running:
        current = rng.choice(running)
        try:
            next(current)
        except StopIteration:
            running.remove(current)
        spins += 1
        assert spins < 10 ** 6, "the hand-off does not progress"
    return loads


@pytest.mark.parametrize("m,n,w,rows,warps,ring,chunk", [
    (700, 650, 800, 32, 4, 64, 8),    # every column, several rounds
    (900, 880, 60, 32, 3, 64, 8),     # a narrow band: strips shift right
    (300, 310, 400, 64, 8, 128, 32),  # fewer strips than warps
    (1200, 1150, 1500, 32, 1, 64, 16),  # one warp: the row is the link
    (2000, 2000, 2000, 128, 8, 256, 32),  # the kernel's ring and chunk
])
def test_handoff_loads_the_strip_above(m, n, w, rows, warps, ring, chunk):
    """Whatever order the warps run in, every top-row column a strip loads
    is the one the strip above stored (strip 0: row 0), and no warp waits
    forever."""
    for seed in range(3):
        loads = _handoff(m, n, w, rows, warps, ring, chunk, seed)
        assert loads
        for strip, column, stored in loads:
            assert stored == (strip - 1, column)
