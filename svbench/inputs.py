"""The made-input cache: one directory a traffic mix under svbench/.inputs,
holding the inputs of one seed.  A run of another seed, or of a changed
maker, replaces them.  The maker runs in a child process of its own, so
that its memory never counts in the measuring process."""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, ".inputs")
STAMP = "stamp.json"


def maker_hash():
    with open(os.path.join(HERE, "maker.py"), "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()[:16]


def _make(directory, seed, knobs):
    import sys

    sys.path.insert(0, os.path.dirname(HERE))
    from svbench import maker

    maker.make(directory, seed, digest=False, **knobs)


def find_or_make(name, seed, knobs):
    """(bam path, genome path, sample.json contents, seconds spent making:
    0 when the cache held them)."""
    directory = os.path.join(ROOT, name)
    stamp = dict(seed=int(seed), maker=maker_hash(), knobs=knobs)
    try:
        with open(os.path.join(directory, STAMP)) as handle:
            cached = json.load(handle) == stamp
    except (OSError, ValueError):
        cached = False
    started = time.perf_counter()
    if not cached:
        shutil.rmtree(directory, ignore_errors=True)
        os.makedirs(directory)
        child = multiprocessing.get_context("spawn").Process(
            target=_make, args=(directory, int(seed), knobs))
        child.start()
        child.join()
        if child.exitcode != 0:
            shutil.rmtree(directory, ignore_errors=True)
            raise RuntimeError("the maker failed ({0}) for {1} seed "
                               "{2}".format(child.exitcode, name, seed))
        with open(os.path.join(directory, STAMP), "w") as handle:
            json.dump(stamp, handle)
        # the new input written back to disk now, not during the window
        os.sync()
    made_s = 0.0 if cached else time.perf_counter() - started
    with open(os.path.join(directory, "sample.json")) as handle:
        sample = json.load(handle)
    return (os.path.join(directory, "sample.bam"),
            os.path.join(directory, "genome.fa"), sample, made_s)
