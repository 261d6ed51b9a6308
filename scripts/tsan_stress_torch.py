#!/usr/bin/env python3
"""ThreadSanitizer stress run over the port's native thread pools.

The port keeps its own copy of the native host library
(svim_tpu_torch/native/svimnative.cpp, poa.cpp): the BGZF inflate pool, the
edit-distance batch pool, the star_polish alignment fan-out, the fused
scan's count walk chasing the inflate frontier and the incremental scan
session.  This script drives all of them concurrently from multiple Python
threads against a TSAN-instrumented build of that copy (the switch
SVIM_NATIVE_TSAN=1 of svim_tpu_torch.native), as scripts/tsan_stress.py
does for svim_tpu's.

Run via tests/test_torch_tsan.py, or directly:

    LD_PRELOAD=$(g++ -print-file-name=libtsan.so.2) \
    TSAN_OPTIONS="halt_on_error=1" SVIM_NATIVE_TSAN=1 \
    python scripts/tsan_stress_torch.py

Exit 0 + no "WARNING: ThreadSanitizer" on stderr = clean.
"""

import os
import random
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

assert os.environ.get("SVIM_NATIVE_TSAN") == "1", \
    "set SVIM_NATIVE_TSAN=1 (and LD_PRELOAD libtsan) before running"

from svim_tpu_torch import native  # noqa: E402


def make_bam_bytes():
    import logging
    logging.disable(logging.INFO)
    from svim_tpu_torch.io import bam as bamio
    from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line
    import tempfile

    rng = random.Random(5)
    header = AlignmentHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:10000000\n")
    lines = []
    for i in range(800):
        start = rng.randint(0, 9_000_000)
        length = rng.randint(500, 3000)
        seq = "".join(rng.choice("ACGT") for _ in range(length))
        lines.append("r{0}\t0\tchr1\t{1}\t60\t{2}M\t*\t0\t0\t{3}\t*".format(
            i, start + 1, length, seq))
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    records = [parse_sam_line(line, header) for line in lines]
    path = tempfile.mktemp(suffix=".bam")
    bamio.write_bam(path, header, records)
    with open(path, "rb") as handle:
        data = handle.read()
    os.unlink(path)
    return data


def main():
    lib = native.get_library()
    assert lib is not None, "TSAN native build failed"
    compressed = make_bam_bytes()
    rng = random.Random(11)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(200, 1500)))
            for _ in range(24)]
    center = seqs[0]
    errors = []

    def inflate_loop():
        try:
            from svim_tpu_torch.io.packing import bucket_size
            for _ in range(6):
                native.bgzf_decompress_parallel(compressed, n_threads=4)
                data, counted = native.bam_scan_fused(compressed, 20, 40,
                                                      n_threads=4)
                native.bgzf_decompress_with_prefix(compressed, b"carrybytes",
                                                   n_threads=4)
                # streaming fused-window pass: inflate-behind-prefix +
                # count walk chasing the frontier
                native.bam_scan_fused_window(compressed, b"", -1, 20, 40,
                                             n_threads=4)
                # streaming-path pools: carve + threaded cigar compaction
                body_offset = counted[2]
                carved = native.bam_carve_window(bytes(data), body_offset,
                                                 0, 4096)
                if carved is not None:
                    columns, _consumed, _exhausted = carved
                    if len(columns["ref_id"]):
                        native.cigar_compact_rows(
                            bytes(data), columns["cigar_off"],
                            columns["n_cigar"], 40, bucket_size)
                # incremental scan session: background inflate
                # workers + walker publishing ranges while this thread
                # claims and fills them in small batches
                session = native.BamScanSession(compressed, 20, 40,
                                                n_threads=3)
                while True:
                    row_start, n, max_ops, _body, done = session.next_rows(7)
                    if n:
                        session.fill(row_start, n,
                                     bucket_size(max(1, max_ops)),
                                     n_threads=2)
                    if done:
                        break
                session.close()
                # walk-bounded session (multi-host byte ranges):
                # the walker skips to walk_start and stops at walk_end
                # while the inflate workers still cover the whole stream
                total = native.get_library().bgzf_uncompressed_size(
                    compressed, len(compressed))
                bounded = native.BamScanSession(
                    compressed, 20, 40, n_threads=3,
                    walk_start=total // 3, walk_end=2 * total // 3)
                try:
                    while True:
                        (row_start, n, max_ops,
                         _body, done) = bounded.next_rows(5)
                        if n:
                            bounded.fill(row_start, n,
                                         bucket_size(max(1, max_ops)),
                                         n_threads=2)
                        if done:
                            break
                except ValueError:
                    pass  # arbitrary bounds may cut a record: walk error ok
                bounded.close()
        except Exception as error:  # pragma: no cover
            errors.append(error)

    def ed_loop():
        try:
            pairs = [(seqs[i], seqs[(i * 7 + 1) % len(seqs)])
                     for i in range(len(seqs))] * 4
            for _ in range(6):
                native.aligner.edit_distance_batch(pairs, n_threads=4)
        except Exception as error:  # pragma: no cover
            errors.append(error)

    def polish_loop():
        try:
            for _ in range(6):
                native.star_polish_native(seqs[:12], center)
                native.poa_consensus_native(seqs[:8])
        except Exception as error:  # pragma: no cover
            errors.append(error)

    threads = [threading.Thread(target=fn)
               for fn in (inflate_loop, inflate_loop, ed_loop, ed_loop,
                          polish_loop, polish_loop)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    print("TSAN_STRESS_OK")


if __name__ == "__main__":
    main()
