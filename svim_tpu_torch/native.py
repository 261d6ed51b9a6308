"""svim_tpu's native host library, built for the port.

The port runs svim_tpu's C++ host code (BGZF scan session, edit-distance
batches, POA consensus) through svim_tpu.native, which compiles
svimnative.cpp and poa.cpp with g++ at first use.  svimnative.cpp uses
std::string without including <string>; libstdc++ up to g++ 12 supplies it
through other headers, g++ 13's does not, so there svim_tpu's own build
fails and svim_tpu falls back to its Python paths.  `host_library` builds
the same sources with the same flags plus `-include string` into the path
svim_tpu loads from, then lets svim_tpu load it; a later svim_tpu run in
the same checkout loads that library too, so the build logs where it wrote.

Temporary: delete this module once svimnative.cpp includes <string>
(ROADMAP Queue 3), and let svim_tpu.native build for both packages.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading

_lock = threading.Lock()


def _is_fresh(native) -> bool:
    """svim_tpu.native's own staleness rule: the library exists and is not
    older than its sources."""
    return os.path.exists(native._LIBRARY) and os.path.getmtime(
        native._LIBRARY) >= max(os.path.getmtime(native._SOURCE),
                                os.path.getmtime(native._POA_SOURCE))


def host_library():
    """svim_tpu's loaded native library, built here first when it is
    missing or stale.  Raises when g++ cannot build it."""
    from svim_tpu import native

    with _lock:
        if not native._TSAN and not _is_fresh(native):
            # compile to a private name, then rename: a concurrent loader
            # never sees a half-written library
            partial = "{0}.{1}.tmp".format(native._LIBRARY, os.getpid())
            command = ["g++", "-O3", "-march=x86-64-v3", "-include", "string",
                       "-shared", "-fPIC", "-std=c++17", "-o", partial,
                       native._SOURCE, native._POA_SOURCE, "-lz", "-lpthread",
                       "-ldl"]
            result = subprocess.run(command, capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError("g++ failed to build svim_tpu's native "
                                   "library:\n{0}{1}".format(
                                       result.stdout, result.stderr[-4000:]))
            os.replace(partial, native._LIBRARY)
            logging.warning("Built svim_tpu's native library with "
                            "-include string into %s (svim_tpu loads it "
                            "from there too).", native._LIBRARY)
    library = native.get_library()
    if library is None:
        raise RuntimeError("svim_tpu's native library did not load")
    return library
