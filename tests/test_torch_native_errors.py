"""The port's native calls on the ranged inflate and in the consensus: a
library that fails to build or load raises, and only what the native
functions signal by design takes the Python route, with the bytes
svim_tpu's copies give on that route.

svim_tpu's copies (`svim_tpu/io/bamrange.py::_inflate`,
`svim_tpu/combine/consensus.py`) catch every exception there and go on in
Python; the port catches only the native refusals: None from
`bgzf_decompress_parallel`, `poa_consensus_native` and
`star_polish_native`, and `aligner.align_global`'s
RuntimeError("gotoh_align failed").  Everything is bytes: the tolerance is
equality.
"""

import numpy as np
import pytest

from svim_tpu import native as jax_native
from svim_tpu.combine import consensus as jax_consensus
from svim_tpu.io import bamrange as jax_bamrange
from svim_tpu_torch import native
from svim_tpu_torch.combine import consensus
from svim_tpu_torch.io import bamrange
from svim_tpu_torch.io.bam import bgzf_compress


def _haplotypes(seed=7, count=6, length=180, noise=0.06):
    """Noisy copies of one random sequence (substitutions, insertions and
    deletions), with no shared first or last base so that nothing is
    trimmed before the DP."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=length))
    copies = []
    for index in range(count):
        out = []
        for char in base:
            roll = rng.random()
            if roll < noise / 3:
                continue
            if roll < 2 * noise / 3:
                out.append(rng.choice(list("ACGT")))
            elif roll < noise:
                out.append(char + rng.choice(list("ACGT")))
            else:
                out.append(char)
        copies.append("ACGT"[index % 4] + "".join(out) + "TGCA"[index % 4])
    return copies


def _broken(*args, **kwargs):
    raise RuntimeError("g++ failed for svimnative.cpp")


SEQUENCES = _haplotypes()
CALLS = {
    "bamrange._inflate": lambda: bamrange._inflate(
        bgzf_compress(b"BAM\x01" + bytes(range(256)) * 64)),
    "consensus.align_global": lambda: consensus.align_global(
        SEQUENCES[0], SEQUENCES[1]),
    "consensus.poa_consensus": lambda: consensus.poa_consensus(SEQUENCES),
    "consensus._polish_round": lambda: consensus._polish_round(
        SEQUENCES, SEQUENCES[0]),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_a_failed_native_build_raises(call, monkeypatch):
    monkeypatch.setattr(native, "get_library", _broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        CALLS[call]()


def test_a_binding_error_is_not_caught(monkeypatch):
    """An error of the native call other than its refusal (here a ctypes
    argument error) reaches the caller."""
    def bad_binding(*args, **kwargs):
        raise TypeError("argument 3: wrong type")

    monkeypatch.setattr(native.aligner, "align_global", bad_binding)
    with pytest.raises(TypeError):
        consensus.align_global("ACGTTA", "ACTTA")
    monkeypatch.setattr(native.aligner, "align_global", _broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        consensus.align_global("ACGTTA", "ACTTA")


def test_inflate_takes_gzip_only_where_native_returns_none(monkeypatch):
    payload = b"BAM\x01" + bytes(range(256)) * 300
    compressed = bgzf_compress(payload)
    assert bamrange._inflate(compressed) == payload
    monkeypatch.setattr(native, "bgzf_decompress_parallel",
                        lambda data, n_threads=0: None)
    monkeypatch.setattr(jax_native, "bgzf_decompress_parallel",
                        lambda data, n_threads=0: None)
    assert bamrange._inflate(compressed) == payload
    assert bamrange._inflate(compressed) == jax_bamrange._inflate(compressed)


def test_align_global_refusal_takes_the_python_route(monkeypatch):
    a, b = SEQUENCES[0], SEQUENCES[2]
    native_rows = consensus.align_global(a, b)
    assert native_rows == jax_consensus.align_global(a, b)

    def refused(*args, **kwargs):
        raise RuntimeError("gotoh_align failed")

    monkeypatch.setattr(native.aligner, "align_global", refused)
    monkeypatch.setattr(jax_native.aligner, "align_global", refused)
    python_rows = consensus.align_global(a, b)
    assert python_rows == jax_consensus.align_global(a, b)
    assert python_rows == consensus._align_global_py_auto(a, b)
    assert python_rows[0].replace("-", "") == a
    assert python_rows[1].replace("-", "") == b


def test_align_global_memory_error_keeps_status_2(monkeypatch):
    def too_large(*args, **kwargs):
        raise MemoryError("alignment DP too large")

    monkeypatch.setattr(native.aligner, "align_global", too_large)
    with pytest.raises(MemoryError):
        consensus.align_global("ACGTTA", "ACTTA")
    inputs = (SEQUENCES[:3], "ACGT" * 40, 1000, 50, 3)
    assert consensus.consensus_from_inputs(inputs) == (2, ())


def test_polish_size_check_raises_memory_error(monkeypatch):
    monkeypatch.setattr(consensus, "MAX_DP_CELLS_NATIVE", 100)
    with pytest.raises(MemoryError):
        consensus._polish_round(SEQUENCES, SEQUENCES[0])
    inputs = (SEQUENCES[:3], "ACGT" * 40, 1000, 50, 3)
    assert consensus.consensus_from_inputs(inputs) == (2, ())


@pytest.mark.parametrize("refused", ["poa_consensus_native",
                                     "star_polish_native", "both"])
def test_native_none_takes_the_python_route(refused, monkeypatch):
    """None from the POA seed or the polish round: the star MSA and the
    Python polish run, with svim_tpu's bytes on the same route."""
    names = (["poa_consensus_native", "star_polish_native"]
             if refused == "both" else [refused])
    for name in names:
        monkeypatch.setattr(native, name, lambda *args, **kwargs: None)
        monkeypatch.setattr(jax_native, name, lambda *args, **kwargs: None)
    got = consensus.poa_consensus(SEQUENCES)
    assert got == jax_consensus.poa_consensus(SEQUENCES)
    assert got
    polished = consensus._polish_round(SEQUENCES, SEQUENCES[1])
    assert polished == jax_consensus._polish_round(SEQUENCES, SEQUENCES[1])
    if "star_polish_native" in names:
        assert polished == consensus._star_consensus(SEQUENCES,
                                                     center=SEQUENCES[1])


def test_native_routes_equal_svim_tpu():
    """With the library loaded and nothing refused, the port's consensus
    equals svim_tpu's (the native route of both)."""
    assert consensus.poa_consensus(SEQUENCES) == \
        jax_consensus.poa_consensus(SEQUENCES)
    assert consensus._polish_round(SEQUENCES, SEQUENCES[0]) == \
        jax_consensus._polish_round(SEQUENCES, SEQUENCES[0])
