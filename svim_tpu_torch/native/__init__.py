"""Native C++ runtime components, built on demand with g++ via ctypes.

Counterpart of svim_tpu/native (the same sources, with the `#include
<string>` that g++ 13 needs).  Provides:
- aligner.align_global(a, b): two-piece-affine global alignment (SPOA
  algorithm=1 scoring), used by the insertion consensus;
- aligner.edit_distance(a, b): exact Myers bit-parallel Levenshtein
  (edlib replacement) over 64-bit words;
- bamscan_native(data, min_mapq, k): BAM record scan into packed columns;
- BamScanSession: the BGZF scan session behind COLLECT.

The library is built at first use into `svim_tpu_torch/_build/`
(git-ignored), keyed by a hash of the sources and the flags like the CUDA
kernels (ops/_build.py).  There is no Python stand-in for the scan session:
`get_library` raises when g++ is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

from svim_tpu_torch.utils.cores import available_cores

_SOURCE = os.path.join(os.path.dirname(__file__), "svimnative.cpp")
_POA_SOURCE = os.path.join(os.path.dirname(__file__), "poa.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
# SVIM_NATIVE_TSAN=1 selects a ThreadSanitizer-instrumented build of the
# same sources (race tooling for the thread pools: BGZF inflate, ed batch,
# star_polish fan-out).  Run python under
# LD_PRELOAD=$(g++ -print-file-name=libtsan.so.2) so the runtime loads
# before CPython.
_TSAN = os.environ.get("SVIM_NATIVE_TSAN") == "1"
_FLAGS = (["-O1", "-g", "-fsanitize=thread"] if _TSAN
          else ["-O3", "-march=x86-64-v3"]) + ["-shared", "-fPIC",
                                               "-std=c++17"]
_LINK = ["-lz", "-lpthread", "-ldl"]
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Path of the built library (keyed by the sources and the flags)."""
    digest = hashlib.sha256(" ".join(_FLAGS + _LINK).encode())
    for source in (_SOURCE, _POA_SOURCE):
        with open(source, "rb") as handle:
            digest.update(handle.read())
    return os.path.join(BUILD_DIR, "svimnative_{0}.so".format(
        digest.hexdigest()[:16]))


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # sees a half-written library
    partial = "{0}.{1}.tmp".format(path, os.getpid())
    command = ["g++"] + _FLAGS + ["-o", partial, _SOURCE, _POA_SOURCE] + _LINK
    try:
        result = subprocess.run(command, capture_output=True, text=True)
    except FileNotFoundError as error:
        raise RuntimeError("g++ not found: the native host library of "
                           "svim_tpu_torch builds with g++") from error
    if result.returncode != 0:
        raise RuntimeError("g++ failed to build the native host library:\n"
                           "{0}{1}".format(result.stdout,
                                           result.stderr[-4000:]))
    os.replace(partial, path)
    logging.debug("Built the native host library into %s", path)


def get_library():
    """The loaded shared library, building it on first use.  Raises when
    g++ is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.gotoh_align.restype = ctypes.c_int
        lib.gotoh_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.gotoh_align_auto.restype = ctypes.c_int
        lib.gotoh_align_auto.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.myers_distance.restype = ctypes.c_int64
        lib.myers_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.edit_distance_fast.restype = ctypes.c_int64
        lib.edit_distance_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.edit_distance_batch.restype = ctypes.c_int
        lib.edit_distance_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.edit_distance_batch_hinted.restype = ctypes.c_int
        lib.edit_distance_batch_hinted.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.edit_distance_pairs_indexed.restype = ctypes.c_int
        lib.edit_distance_pairs_indexed.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.bgzf_uncompressed_size.restype = ctypes.c_int64
        lib.bgzf_uncompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.bgzf_decompress.restype = ctypes.c_int
        lib.bgzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int]
        lib.poa_consensus_native.restype = ctypes.c_int
        lib.poa_consensus_native.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.star_polish.restype = ctypes.c_int
        lib.star_polish.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.bam_count.restype = ctypes.c_int
        lib.bam_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.bam_inflate_count.restype = ctypes.c_int
        lib.bam_inflate_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.bam_inflate_count_window.restype = ctypes.c_int
        lib.bam_inflate_count_window.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.cigar_compact_counts.restype = ctypes.c_int
        lib.cigar_compact_counts.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int]
        lib.cigar_compact_fill.restype = ctypes.c_int
        lib.cigar_compact_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.bam_carve_window.restype = ctypes.c_int
        lib.bam_carve_window.argtypes = (
            [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int64] + [ctypes.c_void_p] * 13
            + [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)])
        lib.bam_fill.restype = ctypes.c_int
        lib.bam_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.bam_scan_session_start.restype = ctypes.c_void_p
        lib.bam_scan_session_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64]
        lib.bam_scan_session_next.restype = ctypes.c_int64
        lib.bam_scan_session_next.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.bam_scan_session_fill.restype = ctypes.c_int
        lib.bam_scan_session_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.bam_scan_session_end.restype = ctypes.c_int
        lib.bam_scan_session_end.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _buffer_arg(buffer):
    """Zero-copy ctypes argument for bytes OR bytearray buffers (decompressed
    BAM windows are bytearrays to avoid a whole-stream copy)."""
    if isinstance(buffer, bytes):
        return buffer
    return (ctypes.c_char * len(buffer)).from_buffer(buffer)


class aligner:
    """Namespace mirroring the Python fallback API in combine.consensus."""

    MATCH = 2.0
    MISMATCH = -4.0
    GAP_OPEN1 = -4.0
    GAP_EXT1 = -2.0
    GAP_OPEN2 = -24.0
    GAP_EXT2 = -1.0

    # keep in lockstep with combine/consensus.py FULL_DP_CELLS_AUTO /
    # MAX_DP_CELLS_NATIVE and svimnative.cpp kGotoh*Cells
    FULL_DP_CELLS_AUTO = 16_384
    MAX_CELLS = 256_000_000

    @staticmethod
    def align_global(a: str, b: str, full_dp_cells: int = None):
        """Two-piece-affine global alignment; DPs over `full_dp_cells` run
        the banded corridor with band doubling (gotoh_align_auto)."""
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if full_dp_cells is None:
            full_dp_cells = aligner.FULL_DP_CELLS_AUTO
        la, lb = len(a), len(b)
        out_a = ctypes.create_string_buffer(la + lb + 1)
        out_b = ctypes.create_string_buffer(la + lb + 1)
        out_len = ctypes.c_int64(0)
        status = lib.gotoh_align_auto(
            a.encode(), la, b.encode(), lb,
            aligner.MATCH, aligner.MISMATCH,
            aligner.GAP_OPEN1, aligner.GAP_EXT1,
            aligner.GAP_OPEN2, aligner.GAP_EXT2,
            full_dp_cells, aligner.MAX_CELLS,
            out_a, out_b, ctypes.byref(out_len))
        if status == -1:
            raise MemoryError(
                "alignment DP too large: {0}x{1}".format(la, lb))
        if status != 0:
            raise RuntimeError("gotoh_align failed")
        n = out_len.value
        return out_a.raw[:n].decode(), out_b.raw[:n].decode()

    @staticmethod
    def edit_distance(a: str, b: str) -> int:
        """Output-sensitive exact Levenshtein (banded + doubling)."""
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        a_bytes = a.encode()
        b_bytes = b.encode()
        return int(lib.edit_distance_fast(a_bytes, len(a_bytes),
                                          b_bytes, len(b_bytes)))

    @staticmethod
    def edit_distance_batch(pairs, n_threads: int = 0, band_hints=None):
        """Exact distances for many (a, b) pairs across a thread pool.

        band_hints: optional per-pair proven upper bounds on the distance —
        caps the band-doubling search (still exact; a wrong hint only costs
        a fallback pass)."""
        import numpy as np

        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if not pairs:
            return []
        if n_threads <= 0:
            n_threads = min(8, available_cores() or 1)
        chunks = []
        a_off = np.empty(len(pairs), dtype=np.int64)
        a_len = np.empty(len(pairs), dtype=np.int64)
        b_off = np.empty(len(pairs), dtype=np.int64)
        b_len = np.empty(len(pairs), dtype=np.int64)
        offset = 0
        for row, (a, b) in enumerate(pairs):
            a_bytes = a.encode()
            b_bytes = b.encode()
            chunks.append(a_bytes)
            chunks.append(b_bytes)
            a_off[row] = offset
            a_len[row] = len(a_bytes)
            offset += len(a_bytes)
            b_off[row] = offset
            b_len[row] = len(b_bytes)
            offset += len(b_bytes)
        blob = b"".join(chunks)
        out = np.empty(len(pairs), dtype=np.int64)

        def ptr(array):
            return array.ctypes.data_as(ctypes.c_void_p)

        if band_hints is not None:
            hints = np.asarray(band_hints, dtype=np.int64)
            lib.edit_distance_batch_hinted(
                blob, ptr(a_off), ptr(a_len), ptr(b_off), ptr(b_len),
                ptr(hints), len(pairs), ptr(out), n_threads)
        else:
            lib.edit_distance_batch(blob, ptr(a_off), ptr(a_len), ptr(b_off),
                                    ptr(b_len), len(pairs), ptr(out), n_threads)
        return out.tolist()

    @staticmethod
    def edit_distance_pairs_indexed(seq_blob: bytes, seq_off, seq_len,
                                    elem_start, win_blob: bytes, win_off,
                                    win_len, win_coord, pair_a, pair_b,
                                    pair_win, hints, padding: int,
                                    n_threads: int = 0):
        """Exact distances for INS haplotype pairs described by indices: each
        haplotype is window[ws:start] + sequence + window[start:we] assembled
        in C++ worker scratch (no per-pair Python strings).  Arrays must be
        contiguous: seq_off/seq_len/elem_start int64 per element,
        win_off/win_len/win_coord int64 per window, pair_a/pair_b/pair_win
        int32 per pair, hints int64 per pair or None."""
        import numpy as np

        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        n_pairs = len(pair_a)
        if n_pairs == 0:
            return []
        if n_threads <= 0:
            n_threads = min(8, available_cores() or 1)
        out = np.empty(n_pairs, dtype=np.int64)

        def ptr(array):
            return array.ctypes.data_as(ctypes.c_void_p)

        lib.edit_distance_pairs_indexed(
            seq_blob, ptr(seq_off), ptr(seq_len), ptr(elem_start),
            win_blob, ptr(win_off), ptr(win_len), ptr(win_coord),
            ptr(pair_a), ptr(pair_b), ptr(pair_win),
            ptr(hints) if hints is not None else None,
            padding, n_pairs, ptr(out), n_threads)
        return out

    @staticmethod
    def edit_distance_full(a: str, b: str) -> int:
        """Unbanded Myers bit-parallel recurrence (validation oracle)."""
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        a_bytes = a.encode()
        b_bytes = b.encode()
        return int(lib.myers_distance(a_bytes, len(a_bytes), b_bytes, len(b_bytes)))


POA_MAX_CELLS = 120_000_000   # per-alignment DP cell budget (banded included)
# Banded graph alignment (band 64 with doubling whenever the optimal path
# grazes a band edge) is the DEFAULT for every cluster size since round 4:
# measured 8.2x faster on bench-shaped 24-member clusters with IDENTICAL
# consensus output (60/60; the SPOA-oracle differential gates tie-free
# exactness at this default).  Worst case the doubling walks back to the
# full DP (~2x), so nothing regresses on dissimilar inputs.
# Tiny alignments stay on the full DP: they are trivial anyway, and the
# banded loop's band floor (64) cannot cover sequences shorter than ~62
# bases (2*(len+2) < 64 would skip every band).
POA_FULL_DP_CELLS = 16_384


def poa_consensus_native(sequences, max_cells: int = POA_MAX_CELLS,
                         full_dp_cells: int = POA_FULL_DP_CELLS):
    """True partial-order-alignment consensus (SPOA's role).

    Alignments whose full DP fits in `full_dp_cells` run unbanded; larger
    ones (long insertion clusters with many members — the reference handles
    10 kb haplotypes, SVIM_COMBINE.py:202) run a banded graph alignment with
    band doubling, so the former hard cell cap no longer forces the star-MSA
    fallback.  Returns the consensus string, or None when the native library
    is unavailable or even the banded DP exceeds `max_cells`."""
    lib = get_library()
    if lib is None or not sequences:
        return None
    blob = "".join(sequences).encode()
    lens = (ctypes.c_int64 * len(sequences))(*[len(s) for s in sequences])
    out_cap = 2 * max(len(s) for s in sequences) + 64
    out = ctypes.create_string_buffer(out_cap)
    out_len = ctypes.c_int64(0)
    status = lib.poa_consensus_native(blob, lens, len(sequences), max_cells,
                                      full_dp_cells, out, out_cap,
                                      ctypes.byref(out_len))
    if status != 0:
        return None
    return out.raw[:out_len.value].decode()


def star_polish_native(sequences, center: str):
    """One consensus polish round: align every sequence to `center` and
    re-vote columns + insertion blocks, entirely in C++ (native twin of
    combine/consensus._star_consensus(center=...); differential test pins
    byte equality).  Returns the refined consensus, or None when the native
    library is unavailable."""
    lib = get_library()
    if lib is None or not sequences or not center:
        return None
    blob = "".join(sequences).encode()
    lens = (ctypes.c_int64 * len(sequences))(*[len(s) for s in sequences])
    center_bytes = center.encode()
    out_cap = len(center_bytes) + len(blob) + 64
    out = ctypes.create_string_buffer(out_cap)
    out_len = ctypes.c_int64(0)
    status = lib.star_polish(blob, lens, len(sequences),
                             center_bytes, len(center_bytes),
                             aligner.MATCH, aligner.MISMATCH,
                             aligner.GAP_OPEN1, aligner.GAP_EXT1,
                             aligner.GAP_OPEN2, aligner.GAP_EXT2,
                             out, out_cap, ctypes.byref(out_len))
    if status != 0:
        return None
    return out.raw[:out_len.value].decode()


def bam_carve_window(buffer: bytes, start: int, min_mapq: int, max_records: int):
    """Carve filtered record descriptors from a decompressed window.

    Returns (columns dict of numpy arrays sized to the record count,
    consumed offset, exhausted flag) or None when the library is
    unavailable."""
    import numpy as np

    lib = get_library()
    if lib is None or max_records <= 0:
        return None
    columns = {
        "rec_off": np.empty(max_records, dtype=np.int64),
        "ref_id": np.empty(max_records, dtype=np.int32),
        "pos": np.empty(max_records, dtype=np.int32),
        "mapq": np.empty(max_records, dtype=np.int32),
        "flag": np.empty(max_records, dtype=np.int32),
        "name_off": np.empty(max_records, dtype=np.int64),
        "name_len": np.empty(max_records, dtype=np.int32),
        "cigar_off": np.empty(max_records, dtype=np.int64),
        "n_cigar": np.empty(max_records, dtype=np.int32),
        "seq_off": np.empty(max_records, dtype=np.int64),
        "seq_len": np.empty(max_records, dtype=np.int32),
        "sa_off": np.empty(max_records, dtype=np.int64),
        "sa_len": np.empty(max_records, dtype=np.int32),
    }

    def ptr(array):
        return array.ctypes.data_as(ctypes.c_void_p)

    consumed = ctypes.c_int64(0)
    exhausted = ctypes.c_int(0)
    count = lib.bam_carve_window(
        _buffer_arg(buffer), len(buffer), start, min_mapq, max_records,
        ptr(columns["rec_off"]), ptr(columns["ref_id"]), ptr(columns["pos"]),
        ptr(columns["mapq"]), ptr(columns["flag"]), ptr(columns["name_off"]),
        ptr(columns["name_len"]), ptr(columns["cigar_off"]), ptr(columns["n_cigar"]),
        ptr(columns["seq_off"]), ptr(columns["seq_len"]), ptr(columns["sa_off"]),
        ptr(columns["sa_len"]), ctypes.byref(consumed), ctypes.byref(exhausted))
    trimmed = {key: value[:count] for key, value in columns.items()}
    return trimmed, consumed.value, bool(exhausted.value)


_WINDOW_POOL: list = []   # retired streaming-window mmaps, reused warm
_WINDOW_POOL_LOCK = threading.Lock()
_WINDOW_POOL_MAX = 8
_WINDOW_STEP = 32 * 1024 * 1024


def _window_buffer(size: int):
    """Pooled anonymous mmap of capacity >= size (rounded to 32 MiB steps).

    Fresh anonymous mmaps per streaming window hit this kernel's variable
    page-compaction stalls (the same churn _stream_buffer avoids for the
    one-shot scanner — measured 10-40x swings on identical windowed scans).
    A retired buffer is reused only when nothing else references it; live
    LazySequences/LazyStrings views of in-flight batches keep their window's
    buffer out of rotation automatically."""
    import mmap as mmap_mod
    import sys

    with _WINDOW_POOL_LOCK:
        for buffer in _WINDOW_POOL:
            # refs: pool list + loop variable + getrefcount argument
            if len(buffer) >= size and sys.getrefcount(buffer) == 3:
                return buffer
        capacity = max(_WINDOW_STEP,
                       (size + _WINDOW_STEP - 1) // _WINDOW_STEP * _WINDOW_STEP)
        buffer = mmap_mod.mmap(-1, capacity)
        _WINDOW_POOL.append(buffer)
        if len(_WINDOW_POOL) > _WINDOW_POOL_MAX:
            for stale in list(_WINDOW_POOL[:-_WINDOW_POOL_MAX]):
                # refs: pool + list() copy + loop variable + getrefcount arg
                if sys.getrefcount(stale) == 4:
                    _WINDOW_POOL.remove(stale)
                    stale.close()
        return buffer


def bam_scan_fused_window(compressed: bytes, prefix=b"", walk_start: int = -1,
                          min_mapq: int = 0, min_sv_size: int = 0,
                          n_threads: int = 0):
    """Streaming-window fused pass: inflate one BGZF block range BEHIND the
    carried prefix AND count/compact its records in the same chase (the
    window counterpart of bam_scan_fused).  walk_start -1 parses the BAM
    header first (window 0); 0 starts at the prefix (carried windows).

    Returns (buffer, out_size, n, max_ops, body_offset, consumed) or None.
    The buffer is a POOLED mmap whose capacity may exceed out_size — bytes
    at offsets >= out_size are stale garbage; consumers must slice by the
    returned size, never relative to len(buffer).  A bamscan_native(buffer,
    ..., counted=(n, max_ops, body_offset), body_offset=body_offset) on the
    SAME thread memcpys the rows from the cached offsets/compaction arena."""
    lib = get_library()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = max(1, min(8, available_cores() or 1) - 1)
    total = lib.bgzf_uncompressed_size(compressed, len(compressed))
    if total < 0:
        return None
    out_size = len(prefix) + total
    if out_size == 0:
        # a group of only zero-ISIZE blocks (e.g. an isolated BGZF EOF block
        # when the previous window ended exactly at the last data block) with
        # no carried prefix: a valid EMPTY window, not corruption
        return b"", 0, 0, 0, 0, 0
    out = _window_buffer(out_size)
    if prefix:
        out[:len(prefix)] = prefix
    view = (ctypes.c_char * out_size).from_buffer(out)
    n = ctypes.c_int64(0)
    max_ops = ctypes.c_int64(0)
    body = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    status = lib.bam_inflate_count_window(
        compressed, len(compressed), view, out_size, len(prefix),
        walk_start, min_mapq, min_sv_size, n_threads,
        ctypes.byref(n), ctypes.byref(max_ops), ctypes.byref(body),
        ctypes.byref(consumed))
    del view
    if status != 0:
        return None
    return out, out_size, n.value, max_ops.value, body.value, consumed.value


def bgzf_decompress_with_prefix(data: bytes, prefix=b"", n_threads: int = 0):
    """Multithreaded BGZF inflate into a buffer that STARTS with `prefix`
    (the streaming scanner's carried partial record).  Only the small prefix
    is copied — previously the caller concatenated carry + 128 MiB window,
    copying the whole window every roll.

    The buffer is an anonymous mmap, NOT a bytearray: bytearray(n) memsets
    the whole window on the allocating thread (~19 single-threaded 128 MiB
    zero-fills per whole-genome scan), while mmap pages are zero-filled
    lazily by the kernel and first-touched IN PARALLEL by the inflate
    workers.  mmap slices return real bytes, so downstream decode()/find()
    consumers are unaffected.  Returns the buffer or None."""
    lib = get_library()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = min(8, available_cores() or 1)
    total = lib.bgzf_uncompressed_size(data, len(data))
    if total < 0:
        return None
    if total + len(prefix) == 0:
        return b""
    import mmap as mmap_mod
    out = mmap_mod.mmap(-1, len(prefix) + total)
    if prefix:
        out[:len(prefix)] = prefix
    if total:
        view = (ctypes.c_char * total).from_buffer(out, len(prefix))
        status = lib.bgzf_decompress(data, len(data), view, total, n_threads)
        del view
        if status != 0:
            out.close()
            return None
    return out


def bgzf_decompress_parallel(data: bytes, n_threads: int = 0):
    """Multithreaded BGZF inflate (htslib-style block parallelism).
    Returns bytes, or None when the native library is unavailable or the
    stream is not BGZF."""
    lib = get_library()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = min(8, available_cores() or 1)
    total = lib.bgzf_uncompressed_size(data, len(data))
    if total < 0:
        return None
    if total == 0:
        return bytearray()
    # inflate straight into a bytearray: create_string_buffer + .raw would
    # allocate AND copy the whole uncompressed stream (hundreds of MB for
    # whole-genome BAMs) on every call
    out = bytearray(total)
    view = (ctypes.c_char * total).from_buffer(out)
    status = lib.bgzf_decompress(data, len(data), view, total, n_threads)
    del view
    if status != 0:
        return None
    return out


def _scan_workers(reserve: int) -> int:
    """Inflate worker count for the fused scan paths.

    Overridable via SVIM_SCAN_WORKERS.  The round-4 'bandwidth-bound,
    2 == 3 == 4 workers' reading did not reproduce: the round-5 control
    (scripts/measure_inflate_bw.cpp + the real-BAM rerun in BENCH_NOTES.md
    'Round 5: inflate control') measured pure inflate scaling near-linearly
    to 6.8 GB/s at 4 threads against a 29 GB/s 4-thread memcpy ceiling, and
    the fused inflate+walk at 0.047 s with 4 workers vs 0.064 s with 3 on
    the same 307 MB stream — the r4 plateau was box degradation, not DRAM.
    `reserve` keeps cores for the walker/caller when measurement shows that
    wins; callers pass what their own A/B found."""
    try:
        forced = int(os.environ.get("SVIM_SCAN_WORKERS", "0"))
    except ValueError:
        forced = 0
    if forced > 0:
        return min(8, forced)
    return max(1, min(8, (available_cores() or 1) - reserve))


_STREAM_POOL: list = []   # up to two retired inflate buffers (ping-pong)


def _stream_buffer(total: int) -> bytearray:
    """Reusable inflate output buffer.

    Allocating + zero-filling a fresh hundreds-of-MB bytearray per scan
    costs a full memset plus first-touch page faults (and, on some kernels,
    triggers wildly variable compaction work).  A buffer is
    recycled only when it has exactly the right size and nobody else holds a
    reference — downstream LazySequences/LazyStrings views keep a scan's
    buffer alive, which safely defeats reuse while results are live.  Two
    slots cover the common scan-while-previous-results-alive pattern."""
    import sys

    for buffer in _STREAM_POOL:
        # refs: pool list + loop variable + getrefcount argument
        if len(buffer) == total and sys.getrefcount(buffer) == 3:
            return buffer
    buffer = bytearray(total)
    _STREAM_POOL.append(buffer)
    del _STREAM_POOL[:-2]
    return buffer


def bam_scan_fused(compressed: bytes, min_mapq: int, min_sv_size: int = 0,
                   n_threads: int = 0):
    """Inflate a BGZF BAM stream AND count passing records in one fused
    native pass (the count walk chases the inflate frontier, so it costs no
    extra wall time).  Returns (data bytearray, (n, max_ops, body_offset)) or
    None when the library is unavailable / the stream is not BGZF BAM.

    A following bamscan_native(data, ..., counted=...) on the SAME thread
    skips its bam_count pass, and bam_fill reuses the cached record offsets.
    """
    lib = get_library()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = _scan_workers(reserve=1)
    total = lib.bgzf_uncompressed_size(compressed, len(compressed))
    if total <= 0:
        return None
    out = _stream_buffer(total)
    view = (ctypes.c_char * total).from_buffer(out)
    n = ctypes.c_int64(0)
    max_ops = ctypes.c_int64(0)
    body_offset = ctypes.c_int64(0)
    status = lib.bam_inflate_count(compressed, len(compressed), view, total,
                                   min_mapq, min_sv_size, n_threads,
                                   ctypes.byref(n), ctypes.byref(max_ops),
                                   ctypes.byref(body_offset))
    del view
    if status != 0:
        return None
    return out, (n.value, max_ops.value, body_offset.value)


def cigar_compact_rows(buffer, cigar_off, n_cigar, min_sv_size: int,
                       bucket_size_fn):
    """Batch CIGAR compaction over raw BAM bytes: two native passes (counts,
    then fill into a bucket-padded batch).  Returns the (N, K) int32 array or
    None when the library is unavailable or compaction would not shrink the
    batch below the raw bucket."""
    import numpy as np

    lib = get_library()
    if lib is None or min_sv_size <= 0:
        return None
    n = len(cigar_off)
    if n == 0:
        return None
    off = np.ascontiguousarray(cigar_off, dtype=np.int64)
    ops = np.ascontiguousarray(n_cigar, dtype=np.int32)

    def ptr(array):
        return array.ctypes.data_as(ctypes.c_void_p)

    n_threads = min(8, available_cores() or 1)
    counts = np.empty(n, dtype=np.int32)
    buffer_arg = _buffer_arg(buffer)
    lib.cigar_compact_counts(buffer_arg, ptr(off), ptr(ops), n, min_sv_size,
                             ptr(counts), n_threads)
    k = bucket_size_fn(max(1, int(counts.max())))
    if k >= bucket_size_fn(max(1, int(ops.max()))):
        return None
    out = np.zeros((n, k), dtype=np.int32)
    lib.cigar_compact_fill(buffer_arg, ptr(off), ptr(ops), n, min_sv_size, k,
                           ptr(out), n_threads)
    return out


def bamscan_native(data: bytes, min_mapq: int, bucket_size_fn,
                   min_sv_size: int = 0, counted=None, n_threads: int = 0,
                   body_offset=None, size=None):
    """Scan uncompressed BAM bytes natively.  Returns the same tuple layout as
    the Python scanner core, or None when the library is unavailable.

    size: usable byte count of `data` when it is a POOLED buffer whose
    capacity exceeds the stream (bam_scan_fused_window's out_size) — without
    it the walk would run into stale garbage past the stream end.

    min_sv_size > 0 enables CIGAR compaction during the fill (sub-threshold
    op runs collapse into synthetic advance ops — see
    io/packing.compact_cigar_row): the padded batch is sized from the
    compacted op counts, typically (N, 32) instead of (N, 8192).

    counted: optional (n, max_ops, body_offset) from bam_scan_fused — skips
    the bam_count pass (the fill reuses the fused pass's cached offsets when
    called from the same thread, and falls back to a sequential walk
    otherwise)."""
    import numpy as np

    lib = get_library()
    if lib is None:
        return None
    if size is None:
        size = len(data)
    if body_offset is None:
        # header walk stays in Python (tiny)
        import struct
        (l_text,) = struct.unpack_from("<i", data, 4)
        offset = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", data, offset)
        offset += 4
        references, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, offset)
            offset += 4
            references.append(data[offset:offset + l_name - 1].decode())
            offset += l_name
            (l_ref,) = struct.unpack_from("<i", data, offset)
            offset += 4
            lengths.append(l_ref)
        body_offset = offset
        text = data[8:8 + l_text].split(b"\x00", 1)[0].decode()
    else:
        # streaming window: the caller already holds the header
        text, references, lengths = None, None, None

    data_arg = _buffer_arg(data)
    if counted is not None and counted[2] == body_offset:
        n, max_ops = counted[0], counted[1]
    else:
        n_out = ctypes.c_int64(0)
        max_ops_out = ctypes.c_int64(0)
        if lib.bam_count(data_arg, size, body_offset, min_mapq,
                         min_sv_size, ctypes.byref(n_out),
                         ctypes.byref(max_ops_out)) != 0:
            raise ValueError("truncated BAM stream")
        n = n_out.value
        max_ops = max_ops_out.value
    k = bucket_size_fn(max(1, max_ops))

    cigar_words = np.zeros((n, k), dtype=np.int32)
    ref_id = np.empty(n, dtype=np.int32)
    pos = np.empty(n, dtype=np.int32)
    mapq = np.empty(n, dtype=np.int32)
    flag = np.empty(n, dtype=np.int32)
    name_off = np.empty(n, dtype=np.int64)
    name_len = np.empty(n, dtype=np.int32)
    seq_off = np.empty(n, dtype=np.int64)
    seq_len = np.empty(n, dtype=np.int32)
    sa_off = np.empty(n, dtype=np.int64)
    sa_len = np.empty(n, dtype=np.int32)

    def ptr(array):
        return array.ctypes.data_as(ctypes.c_void_p)

    if n_threads <= 0:
        n_threads = min(8, available_cores() or 1)
    if lib.bam_fill(data_arg, size, body_offset, min_mapq, min_sv_size, k,
                    ptr(cigar_words), ptr(ref_id), ptr(pos),
                    ptr(mapq), ptr(flag), ptr(name_off), ptr(name_len),
                    ptr(seq_off), ptr(seq_len), ptr(sa_off), ptr(sa_len),
                    n_threads) != 0:
        raise ValueError("truncated BAM stream")
    return (text, references, lengths, cigar_words, ref_id, pos,
            mapq, flag, name_off, name_len, seq_off, seq_len, sa_off, sa_len)

class BamScanSession:
    """Incremental whole-file scan: background inflate + record walk handing
    row ranges to the caller as the walk passes them.

    Same throughput as bam_scan_fused but without its all-or-nothing
    barrier: the caller packs + dispatches device batches for rows [a, b)
    while rows past b are still inflating (chunked scan/compute overlap —
    the round-4 answer to the inflate floor being >40% of the warm path).

    Usage:
        session = BamScanSession(compressed, min_mapq, min_sv_size)
        while True:
            claim = session.next_rows(batch)   # blocks until ready
            row_start, n, max_ops, body_offset, done = claim
            if n: columns = session.fill(row_start, n, k)
            if done: break
        session.close()

    The inflated stream is session.data (pooled bytearray, valid until the
    next scan reuses it after close() AND all lazy views die).

    walk_start/walk_end (inflated coordinates, -1 = unbounded) restrict the
    record walk to a sub-range of the stream: multi-host ranks compose
    header blocks + their owned blocks + a small overhang and walk only
    their own records (collect.packed.collect_soa_pipelined_range).
    """

    def __init__(self, compressed: bytes, min_mapq: int, min_sv_size: int = 0,
                 n_threads: int = 0, walk_start: int = -1, walk_end: int = -1):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        total = lib.bgzf_uncompressed_size(compressed, len(compressed))
        if total <= 0:
            raise ValueError("not a BGZF BAM stream")
        if n_threads <= 0:
            n_threads = _scan_workers(reserve=2)
        self.data = _stream_buffer(total)
        self._view = (ctypes.c_char * total).from_buffer(self.data)
        self._compressed = compressed  # the workers read it; keep it alive
        self._lib = lib
        self._handle = lib.bam_scan_session_start(
            compressed, len(compressed), self._view, total,
            min_mapq, min_sv_size, n_threads, walk_start, walk_end)
        if not self._handle:
            del self._view
            raise ValueError("not a BGZF BAM stream")

    def next_rows(self, min_rows: int):
        """Block until >= min_rows new rows exist (or the scan finished) and
        claim them.  Returns (row_start, n, max_ops, body_offset, done)."""
        row_start = ctypes.c_int64(0)
        max_ops = ctypes.c_int64(0)
        body = ctypes.c_int64(0)
        done = ctypes.c_int(0)
        n = self._lib.bam_scan_session_next(
            self._handle, min_rows, ctypes.byref(row_start),
            ctypes.byref(max_ops), ctypes.byref(body), ctypes.byref(done))
        if n < 0:
            status = int(n)
            self.close()
            raise ValueError(
                "truncated or corrupt BGZF BAM stream (status {0})"
                .format(status))
        return (row_start.value, int(n), max_ops.value, body.value,
                bool(done.value))

    def fill(self, row_start: int, n: int, k: int, n_threads: int = 2):
        """Column arrays for rows [row_start, row_start + n); cigar_words is
        (n, k) int32.  Offsets address into self.data."""
        import numpy as np

        cigar_words = np.zeros((n, k), dtype=np.int32)
        ref_id = np.empty(n, dtype=np.int32)
        pos = np.empty(n, dtype=np.int32)
        mapq = np.empty(n, dtype=np.int32)
        flag = np.empty(n, dtype=np.int32)
        name_off = np.empty(n, dtype=np.int64)
        name_len = np.empty(n, dtype=np.int32)
        seq_off = np.empty(n, dtype=np.int64)
        seq_len = np.empty(n, dtype=np.int32)
        sa_off = np.empty(n, dtype=np.int64)
        sa_len = np.empty(n, dtype=np.int32)

        def ptr(array):
            return array.ctypes.data_as(ctypes.c_void_p)

        if self._lib.bam_scan_session_fill(
                self._handle, row_start, n, k, ptr(cigar_words), ptr(ref_id),
                ptr(pos), ptr(mapq), ptr(flag), ptr(name_off), ptr(name_len),
                ptr(seq_off), ptr(seq_len), ptr(sa_off), ptr(sa_len),
                n_threads) != 0:
            raise ValueError("scan session fill out of range")
        return (cigar_words, ref_id, pos, mapq, flag, name_off, name_len,
                seq_off, seq_len, sa_off, sa_len)

    def close(self):
        """Join the background threads and free the native session."""
        if self._handle:
            self._lib.bam_scan_session_end(self._handle)
            self._handle = None
        if self._view is not None:
            del self._view
            self._view = None

    def __del__(self):  # safety net; close() is the real contract
        try:
            self.close()
        except Exception:
            pass
