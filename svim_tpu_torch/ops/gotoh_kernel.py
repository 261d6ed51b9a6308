"""Batched two-piece-affine global alignment (Gotoh) on the card, each
pair's alignment the one the host's `gotoh_align_auto` gives.

No counterpart in svim_tpu, which aligns the insertion consensus on the
host (svim_tpu/native, combine/consensus.py); this is the card route of the
port's consensus pool (combine/consensus.py): the members against the
center in each polish round and the consensus against the reference window.

Three layers, as for the port's other kernels:
  * `gotoh_align_batch_torch` — the plain PyTorch version of one rung: the
    DP in anti-diagonal tensor steps (every cell of a front depends only on
    the two fronts before it), then the traceback walk on the host; runs on
    any device.
  * `gotoh_align_batch_cuda` — the wrapper of the hand-written kernel
    (csrc/gotoh.cu: one warp a pair, strips of 32 columns, the traceback
    walked on the card; one call a rung, its copies and its wait inside),
    equal to the plain version pair for pair; counted in `LAUNCHES`.
  * `gotoh_align_batch` — the band ladder of `gotoh_align_auto`, decided a
    pair: the full matrix up to FULL_DP_CELLS cells, else band 64 doubling
    while the path grazes the corridor (the pairs that report `touched`
    run again at the next rung), then the full matrix; a CPU device takes
    the plain version, a card the kernel.

A rung takes the pairs' bytes as one blob and an int64 (B, 5) numpy plan
of (a offset, a length, b offset, b length, band), band < 0 for the full
matrix, and gives the uint8 op strings (pair k's la + lb bytes at the sum
of the earlier pairs' la + lb; its states, first op first, end at its
region's end) and an int32 (B, 2) array of (op string length, touched).
A state is 0 a diagonal step (a base against b base), 1 a gap in b (a base
against '-'), 2 a gap in a ('-' against b base).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
import torch

from svim_tpu_torch.native import aligner
from svim_tpu_torch.ops._build import check_launch
from svim_tpu_torch.utils import timing

# the host aligner's scores: match, mismatch, open1, ext1, open2, ext2
SCORES = (aligner.MATCH, aligner.MISMATCH, aligner.GAP_OPEN1,
          aligner.GAP_EXT1, aligner.GAP_OPEN2, aligner.GAP_EXT2)
FULL_DP_CELLS = aligner.FULL_DP_CELLS_AUTO
MAX_CELLS = aligner.MAX_CELLS
FIRST_BAND = 64
NEG_INF = -1e30   # a cell outside the corridor, as the host aligner's kNegInf

LAUNCHES = 0   # rungs run by gotoh_align_batch_cuda (chip_smoke reads it)
# the span of a rung (on a card, the caller's wait for it): a pool
# thread's, apart from the job thread's `fetch` that device_wait_s reads
FETCH = "gotoh_fetch"
_launch_lock = threading.Lock()
_library = None


def corridor(la, lb, band):
    """(lo_off, hi_off) of a rung: row i holds the columns
    [max(0, i + lo_off), min(lb, i + hi_off)]; band < 0 is the full matrix.
    Works on numbers and on numpy arrays alike."""
    full = np.asarray(band) < 0
    lo_off = np.where(full, -la, np.minimum(0, lb - la) - band)
    hi_off = np.where(full, lb, np.maximum(0, lb - la) + band)
    if np.ndim(lo_off) == 0:
        return int(lo_off), int(hi_off)
    return lo_off.astype(np.int64), hi_off.astype(np.int64)


def band_cells(la, lb, band):
    """The DP cells a rung computes for a pair: its corridor's cells,
    the sum over rows i = 0..la of min(lb, i + hi_off) - max(0, i +
    lo_off) + 1, in closed form; elementwise on numpy arrays."""
    la, lb, band = (np.asarray(x, dtype=np.int64) for x in (la, lb, band))
    lo_off, hi_off = corridor(la, lb, band)
    # rows 0..last take i + hi_off, the others lb
    last = np.minimum(np.maximum(lb - hi_off, -1), la)
    right = (last + 1) * hi_off + last * (last + 1) // 2 + (la - last) * lb
    # rows first..la take i + lo_off, the others 0
    first = np.minimum(np.maximum(-lo_off, 0), la + 1)
    count = la - first + 1
    left = count * lo_off + (first + la) * count // 2
    return right - left + la + 1


def _budget(la, lb, band) -> None:
    """gotoh_align_auto's budget: MemoryError where a rung's DP (the
    banded corridor's bound, or the full matrix) exceeds MAX_CELLS."""
    cells = np.where(band < 0, (la + 1) * (lb + 1),
                     (la + 1) * (np.abs(lb - la) + 2 * band + 1))
    over = np.flatnonzero(np.ravel(cells > MAX_CELLS))
    if len(over):
        k = over[0]
        raise MemoryError("alignment DP too large: {0}x{1}".format(
            np.ravel(la)[k], np.ravel(lb)[k]))


def first_band(la, lb):
    """The first rung of gotoh_align_auto for pairs of non-empty sides:
    -1 (the full matrix) up to FULL_DP_CELLS cells or where band 64 would
    cover the pair, else 64; elementwise."""
    full = (la + 1) * (lb + 1) <= FULL_DP_CELLS
    banded = np.abs(lb - la) + 2 * FIRST_BAND < lb
    return np.where(full | ~banded, -1, FIRST_BAND)


def next_band(la, lb, band):
    """The rung after a banded one whose path grazed its corridor:
    twice the band while it stays inside the pair, then the full
    matrix; elementwise."""
    band = band * 2
    return np.where(np.abs(lb - la) + 2 * band < lb, band, -1)


# --- the plain version ----------------------------------------------------


def gotoh_align_batch_torch(seqs, plan, scores=SCORES):
    """One rung for every pair of `plan`, in anti-diagonal tensor steps on
    `seqs`'s device; the walk on the host.  Returns (ops, result) on the
    device of `seqs` (see the module's docstring)."""
    device = seqs.device
    plan = np.asarray(plan, dtype=np.int64).reshape(-1, 5)
    batch = len(plan)
    a_off, la, b_off, lb, band = plan.T
    region = la + lb
    ops = np.zeros(int(region.sum()), dtype=np.uint8)
    result = np.zeros((batch, 2), dtype=np.int32)
    if batch == 0:
        return torch.from_numpy(ops).to(device), torch.from_numpy(result).to(
            device)
    match, mismatch, open1, ext1, open2, ext2 = (float(x) for x in scores)
    lo_off, hi_off = corridor(la, lb, band)
    rows, cols = int(la.max()) + 1, int(lb.max()) + 1

    def column(values):
        return torch.from_numpy(np.asarray(values, dtype=np.int64)).to(
            device)[:, None]

    t_la, t_lb = column(la), column(lb)
    i = torch.arange(rows, device=device)[None, :]
    row_lo = torch.clamp(i + column(lo_off), min=0)
    row_hi = torch.minimum(t_lb, i + column(hi_off))
    codes = seqs.to(torch.int32)
    last = len(seqs) - 1
    a_codes = codes[(column(a_off) + torch.clamp(i - 1, min=0)).clamp(
        max=last)]
    b_base = column(b_off)
    neg = torch.full((batch, rows), NEG_INF, dtype=torch.float32,
                     device=device)

    def shift(front):   # front[:, i - 1], -1e30 at i = 0
        return torch.cat([neg[:, :1], front[:, :-1]], dim=1)

    def bit(condition, position):
        return condition.to(torch.int32) << position

    trace = torch.zeros((batch, rows, cols), dtype=torch.uint8, device=device)
    # the fronts d - 1 (cell (i, d - 1 - i) at index i) and d - 2
    best1 = v1_1 = v2_1 = h1_1 = h2_1 = best2 = neg
    end_best = torch.full((batch,), NEG_INF, dtype=torch.float32,
                          device=device)
    pair = torch.arange(batch, device=device)[:, None].expand(batch, rows)
    top = (i == 0).expand(batch, rows)
    for d in range(int(region.max()) + 1):
        j = d - i
        live = ((j >= row_lo) & (j <= row_hi) & (i <= t_la)
                & (j >= 0)).expand(batch, rows)
        # the cell above (i - 1, j) and the diagonal (i - 1, j - 1) sit one
        # index lower on the fronts d - 1 and d - 2; the left (i, j - 1)
        # at the same index on d - 1
        up_best, up_v1, up_v2 = shift(best1), shift(v1_1), shift(v2_1)
        diag = shift(best2)
        cb = codes[(b_base + torch.clamp(j - 1, min=0)).clamp(max=last)]

        v_open1 = up_best + open1
        v_ext1 = up_v1 + ext1
        v1 = torch.maximum(v_open1, v_ext1)
        v_open2 = up_best + open2
        v_ext2 = up_v2 + ext2
        v2 = torch.maximum(v_open2, v_ext2)
        v_piece2 = v2 > v1
        vbest = torch.where(v_piece2, v2, v1)
        v_bits = (bit(v_piece2, 2) | bit(v_ext1 >= v_open1, 3)
                  | bit(v_ext2 >= v_open2, 4))

        h_open1 = best1 + open1
        h_ext1 = h1_1 + ext1
        h1 = torch.maximum(h_open1, h_ext1)
        h_open2 = best1 + open2
        h_ext2 = h2_1 + ext2
        h2 = torch.maximum(h_open2, h_ext2)
        hbest = torch.maximum(h1, h2)
        h_bits = (bit(h2 > h1, 5) | bit(h_ext1 >= h_open1, 6)
                  | bit(h_ext2 >= h_open2, 7))

        score = diag + torch.where(a_codes == cb, match, mismatch)
        take_v = (vbest >= score) & (vbest >= hbest)
        take_h = ~take_v & (hbest >= score)
        best = torch.where(take_v, vbest, torch.where(take_h, hbest, score))
        flags = bit(take_v, 0) | bit(take_h, 1) | v_bits | h_bits

        # row 0: horizontal gaps only; column 0: vertical gaps only; the
        # origin (0, 0) scores 0
        side = (j == 0).expand(batch, rows) & ~top
        origin = top & (j == 0)
        flags = torch.where(top, 2 | h_bits, torch.where(side, 1 | v_bits,
                                                         flags))
        best = torch.where(top, hbest, torch.where(side, vbest, best))
        v1, v2 = torch.where(top, neg, v1), torch.where(top, neg, v2)
        h1 = torch.where(side | origin, neg, h1)
        h2 = torch.where(side | origin, neg, h2)
        best = torch.where(origin, torch.zeros_like(best), best)
        flags = torch.where(origin, torch.zeros_like(flags), flags)

        best = torch.where(live, best, neg)
        v1, v2 = torch.where(live, v1, neg), torch.where(live, v2, neg)
        h1, h2 = torch.where(live, h1, neg), torch.where(live, h2, neg)
        trace[pair[live], i.expand(batch, rows)[live],
              j.expand(batch, rows)[live]] = flags[live].to(torch.uint8)
        ends = (t_la[:, 0] + t_lb[:, 0]) == d
        if bool(ends.any()):
            end_best = torch.where(
                ends, best.gather(1, t_la.clamp(max=rows - 1))[:, 0],
                end_best)
        best2 = best1
        best1, v1_1, v2_1, h1_1, h2_1 = best, v1, v2, h1, h2

    trace = trace.cpu().numpy()
    end_best = end_best.cpu().numpy()
    starts = np.cumsum(region) - region
    for k in range(batch):
        if end_best[k] <= NEG_INF / 2:
            result[k] = (0, 1)   # the corridor cut the end cell off
            continue
        length, touched = _walk(trace[k], int(la[k]), int(lb[k]),
                                int(lo_off[k]), int(hi_off[k]),
                                ops[starts[k]:starts[k] + region[k]])
        result[k] = (0 if touched else length, touched)
    return torch.from_numpy(ops).to(device), torch.from_numpy(result).to(
        device)


def _walk(trace, la, lb, lo_off, hi_off, out):
    """The traceback walk of one pair from (la, lb) with the host's gap-piece
    persistence; its states go to the end of `out`, last first.  Returns
    (length, touched): touched when the path reaches the corridor's inner
    edge, where the walk stops."""
    i, j = la, lb
    state, piece, length = -1, 0, 0
    last = len(out) - 1
    while i > 0 or j > 0:
        lo_i, hi_i = max(0, i + lo_off), min(lb, i + hi_off)
        if (lo_i > 0 and j <= lo_i) or (hi_i < lb and j >= hi_i) \
                or not lo_i <= j <= hi_i:
            return length, 1
        flags = int(trace[i, j])
        if state < 0:
            state, piece = flags & 3, 0
        out[last - length] = state
        length += 1
        if state == 0:
            i, j, state = i - 1, j - 1, -1
        elif state == 1:
            if piece == 0:
                piece = 2 if flags & 0x04 else 1
            i -= 1
            if not flags & (0x10 if piece == 2 else 0x08):
                state = -1
        else:
            if piece == 0:
                piece = 2 if flags & 0x20 else 1
            j -= 1
            if not flags & (0x80 if piece == 2 else 0x40):
                state = -1
    return length, 0


# --- the kernel -----------------------------------------------------------


def _kernel_library():
    global _library
    with _launch_lock:
        if _library is None:
            from svim_tpu_torch.ops._build import load

            library = load("gotoh")
            pointer, floating = ctypes.c_void_p, ctypes.c_float
            library.gotoh_rung.argtypes = (
                [pointer, ctypes.c_longlong, pointer, ctypes.c_int]
                + [floating] * 6 + [pointer] * 9)
            library.gotoh_rung.restype = ctypes.c_int
            _library = library
    return _library


NEED_MORE = -2   # gotoh_rung's code for a buffer too small


class Workspace:
    """A caller's buffers for the kernel on one card, kept from rung to
    rung and grown as gotoh_rung asks (torch.empty on the workspace's
    stream): the upload (the plan's parameters, then the sequences) in
    page-locked host memory and on the card, the traceback and the strip
    boundaries on the card, the download (each pair's length and touched
    flag, then the op strings) on the card and in page-locked host memory;
    and the caller's own stream.  A thread of the consensus pool borrows
    one (`WORKSPACES`), so that its rungs neither queue behind the other
    threads' on one stream nor wait on their allocations and copies."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.capacity = np.zeros(4, dtype=np.int64)   # gotoh_rung's sizes
        self.buffers = ()

    def grow(self, need):
        """Buffers of at least `need` (upload bytes, traceback words,
        boundary float4s, download bytes), half again as large."""
        self.capacity = np.maximum(self.capacity, need + need // 2 + 1)
        upload, trace, left, download = (int(x) for x in self.capacity)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.buffers = (
                torch.empty(upload, dtype=torch.uint8, pin_memory=True),
                torch.empty(upload, dtype=torch.uint8, device=self.device),
                torch.empty(trace, dtype=torch.int32, device=self.device),
                torch.empty((left, 4), dtype=torch.float32,
                            device=self.device),
                torch.empty(download, dtype=torch.uint8, device=self.device),
                torch.empty(download, dtype=torch.uint8, pin_memory=True))


class WorkspacePool:
    """Workspaces to lend, one to each caller that aligns at the same
    time: a pool thread borrows one for a batch and gives it back, so the
    process keeps as many as threads ever aligned at once, with their
    streams and grown buffers, from job to job (a job's pool threads are
    new, and a buffer cached for a stream that no thread uses again would
    only hold memory)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free = []

    @contextlib.contextmanager
    def borrow(self, device):
        with self._lock:
            workspace = next((free for free in self._free
                              if free.device == device), None)
            if workspace is not None:
                self._free.remove(workspace)
        if workspace is None:
            workspace = Workspace(device)
        try:
            yield workspace
        finally:
            with self._lock:
                self._free.append(workspace)


WORKSPACES = WorkspacePool()


def gotoh_align_batch_cuda(blob, plan, workspace, scores=SCORES):
    """One rung for every pair of `plan` (int64 (B, 5)) over `blob` (the
    sequences' bytes, a uint8 numpy array) through csrc/gotoh.cu's
    gotoh_rung, on the workspace's card and stream: one copy up, the
    kernel, one copy down, waited for inside the call, which holds no
    interpreter lock.  Returns (ops, result) as numpy views of the
    workspace's download buffer, which the next rung reuses; equal to
    gotoh_align_batch_torch's."""
    global LAUNCHES
    plan = np.ascontiguousarray(plan, dtype=np.int64).reshape(-1, 5)
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    a_off, la, b_off, lb, _ = plan.T
    if ((a_off < 0) | (b_off < 0) | (la < 0) | (lb < 0)
            | (a_off + la > len(blob)) | (b_off + lb > len(blob))).any():
        raise ValueError("a pair lies outside the sequence blob")
    batch = len(plan)
    if batch == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros((0, 2), dtype=np.int32)
    library = _kernel_library()
    need = np.zeros(4, dtype=np.int64)
    with torch.cuda.device(workspace.device):
        while True:
            pointers = [buffer.data_ptr() for buffer in workspace.buffers]
            code = library.gotoh_rung(
                blob.ctypes.data, len(blob), plan.ctypes.data, batch,
                *(float(x) for x in scores), *(pointers or [None] * 6),
                workspace.capacity.ctypes.data, need.ctypes.data,
                workspace.stream.cuda_stream)
            if code != NEED_MORE:
                break
            workspace.grow(need)
    check_launch("gotoh", code)
    with _launch_lock:
        LAUNCHES += 1
    host = workspace.buffers[5].numpy()
    result = host[:8 * batch].view(np.int32).reshape(batch, 2)
    return host[8 * batch:int(need[3])], result


# --- the ladder -----------------------------------------------------------


class Alignments:
    """The alignments of a batch of pairs: pair k's states are
    ops[starts[k]:starts[k] + lengths[k]] (0 diagonal, 1 gap in b, 2 gap in
    a); `cells` the DP cells of every rung the batch ran, `aligned` the
    pairs whose two sides were not empty (the others need no DP)."""

    def __init__(self, ops, starts, lengths, cells, aligned):
        self.ops = ops
        self.starts = starts
        self.lengths = lengths
        self.cells = cells
        self.aligned = aligned

    def rows(self, k, a: str, b: str):
        """(row_a, row_b) of pair k, as align_global spells them."""
        states = self.ops[self.starts[k]:self.starts[k] + self.lengths[k]]
        text_a = np.frombuffer(a.encode(), dtype=np.uint8)
        text_b = np.frombuffer(b.encode(), dtype=np.uint8)
        gap = np.uint8(ord("-"))
        row_a = np.full(len(states), gap)
        row_b = np.full(len(states), gap)
        in_a, in_b = states != 2, states != 1
        row_a[in_a] = text_a
        row_b[in_b] = text_b
        return row_a.tobytes().decode(), row_b.tobytes().decode()


def gotoh_align_batch(pairs, device, workspace=None) -> Alignments:
    """gotoh_align_auto for every (a, b) pair of byte strings, on `device`:
    the plain version on the CPU, the kernel on a card (in `workspace`, a
    new one where none is given).  A pair with an empty side needs no DP:
    all of the other side against gaps.  Each rung is the span
    `gotoh_fetch`: on a card, the caller's wait for it.  Raises
    MemoryError where a pair's next rung exceeds MAX_CELLS, as the host
    aligner does."""
    if device.type == "cpu":
        def run(plan):
            ops, result = gotoh_align_batch_torch(torch.from_numpy(blob),
                                                  plan)
            return ops.numpy(), result.numpy()
    elif device.type == "cuda":
        workspace = workspace or Workspace(device)

        def run(plan):
            return gotoh_align_batch_cuda(blob, plan, workspace)
    else:
        raise ValueError("no gotoh kernel for device {0}".format(device))
    count = len(pairs)
    la = np.fromiter((len(a) for a, _ in pairs), dtype=np.int64, count=count)
    lb = np.fromiter((len(b) for _, b in pairs), dtype=np.int64, count=count)
    region = la + lb
    region_end = np.cumsum(region)
    ops = np.zeros(int(region.sum()), dtype=np.uint8)
    lengths = region.copy()
    for k in np.flatnonzero((la == 0) | (lb == 0)):
        ops[region_end[k] - region[k]:region_end[k]] = 2 if la[k] == 0 else 1
    live = np.flatnonzero((la > 0) & (lb > 0))
    aligned, cells, rung = len(live), 0, 0
    if aligned:
        blob = np.frombuffer(b"".join(a + b for a, b in pairs),
                             dtype=np.uint8).copy()
        a_off = region_end - region
        bands = first_band(la[live], lb[live])
    while len(live):
        live_a, live_b = la[live], lb[live]
        _budget(live_a, live_b, bands)
        plan = np.stack([a_off[live], live_a, a_off[live] + live_a, live_b,
                         bands], axis=1)
        cells += int(band_cells(live_a, live_b, bands).sum())
        with timing.span(FETCH):
            rung_ops, result = run(plan)
        touched = result[:, 1] != 0
        if (touched & (bands < 0)).any():
            raise RuntimeError("the full matrix reported a touched corridor")
        done = np.flatnonzero(~touched)
        lengths[live[done]] = result[done, 0]
        if rung == 0 and aligned == count:
            # the pairs' regions are the batch's own (a copy: a card's
            # rung reads into a buffer that its next rung reuses)
            ops = rung_ops.copy()
        else:
            rung_end = np.cumsum(live_a + live_b)
            for index in done:
                k, n = live[index], result[index, 0]
                ops[region_end[k] - n:region_end[k]] = \
                    rung_ops[rung_end[index] - n:rung_end[index]]
        live, bands = live[touched], next_band(live_a[touched],
                                               live_b[touched],
                                               bands[touched])
        rung += 1
    return Alignments(ops, region_end - lengths, lengths, cells, aligned)
