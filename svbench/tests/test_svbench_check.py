"""The comparison that decides `correct`, driven through a whole run at the
traffic's warm-up size on the CPU (the run's look for a card skipped with
--cpu_rehearsal): a sound run is correct; the control and the faults that
a cell can have are not.  Only the tests import the program."""

import contextlib
import io
import json

import pytest

from svbench import control, run

CELL = "defaults-classes30x"


def _run(seed, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run.main(["--workload", CELL, "--seed", str(seed),
                         "--seconds", "0", "--trace", "0", "--cpu_rehearsal"])
    assert code == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_sound_run_is_correct_and_its_checks_come_last():
    result = _run(21)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert all(item["value"] <= item["limit"] for item in result["checks"].values())
    assert result["device"]["platform"] == "cpu"


def test_without_a_card_a_measuring_run_fails_and_prints_nothing(capsys):
    code = run.main(["--workload", CELL, "--seed", "3", "--seconds", "1",
                     "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_the_control_fails_the_comparison(tmp_path, monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert control.main(["--workload", CELL, "--seeds", "22",
                             "--cpu_rehearsal"]) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    sound = result["program"]
    assert all(item["value"] <= item["limit"] for item in sound.values())
    failed = [name for name, item in result["control"].items()
              if item["value"] > item["limit"]]
    assert "poa" in failed


def test_half_of_the_signatures_left_out_is_not_correct(monkeypatch):
    from svim_tpu_torch import cli

    original = cli.cluster_sv_signatures

    def half(signatures, options, device):
        every = (signatures.materialize_all()
                 if hasattr(signatures, "materialize_all") else list(signatures))
        return original(every[::2], options, device)

    monkeypatch.setattr(cli, "cluster_sv_signatures", half)
    result = _run(23)
    assert result["correct"] is False
    assert result["checks"]["signatures"]["value"] > 0


def test_an_answer_altered_where_it_is_written_is_not_correct(monkeypatch):
    from svim_tpu_torch import cli

    original = cli.write_final_vcf

    def altered(int_dup, inversions, tandems, deletions, *rest):
        deletions[0].source_end += 1
        return original(int_dup, inversions, tandems, deletions, *rest)

    monkeypatch.setattr(cli, "write_final_vcf", altered)
    result = _run(24)
    assert result["correct"] is False
    assert result["checks"]["records"]["value"] == 2


def test_a_consensus_altered_where_it_is_made_is_not_correct(monkeypatch):
    from svim_tpu_torch.combine import consensus

    original = consensus.consensus_from_inputs

    def altered(*args, **kwargs):
        status, found = original(*args, **kwargs)
        if status == 0:
            start, size, sequence = found
            swap = {"A": "C", "C": "G", "G": "T", "T": "A"}
            middle = len(sequence) // 2
            sequence = (sequence[:middle] + swap.get(sequence[middle], "A")
                        + sequence[middle + 1:])
            found = (start, size, sequence)
        return status, found

    monkeypatch.setattr(consensus, "consensus_from_inputs", altered)
    result = _run(25)
    assert result["correct"] is False
    assert result["checks"]["poa"]["value"] > 0
