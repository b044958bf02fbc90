"""The check catches a broken timed path: a rehearsal (the whole run but
the look for a card) with the program broken underneath must come out
``correct: false``, once for each fault the cells can have, and a sound
rehearsal ``correct: true``. (No cell spans chips, so the exchange
between chips cannot be left out.) The faults on one recording run with
the cells' own count of recordings, so that one recording is as small a
share of the answers as in a cell."""

import numpy as np
import pytest

from harness import runner
from harness.cell import load_cell
from harness.runner import measure

BATCH = "hsip_tpu_torch.track.batch"
SCAN = "hsip_tpu_torch.track.scan"


def _patch_scan_output(monkeypatch, alter):
    """Alter the positions the device scan produced, where the program
    turns them into rows (both routes)."""
    import importlib

    batch = importlib.import_module(BATCH)
    original = batch.build_device_scan_output

    def broken(frame_indices, empty, finals, *args, **kwargs):
        return original(frame_indices, empty, alter(np.array(finals)), *args, **kwargs)

    monkeypatch.setattr(batch, "build_device_scan_output", broken)
    monkeypatch.setattr(importlib.import_module(SCAN), "build_device_scan_output", broken)


def state_unchanged(monkeypatch):
    """The tracker's step returns its state unchanged: every position
    after the first detection is that first one."""
    def alter(finals):
        found = np.nonzero(finals >= 0)[0]
        if found.size:
            finals[found] = finals[found[0]]
        return finals
    _patch_scan_output(monkeypatch, alter)


def answer_altered(monkeypatch):
    """The first position of every recording moved by a pixel."""
    def alter(finals):
        found = np.nonzero(finals >= 0)[0]
        if found.size:
            finals[found[0]] += 1
        return finals
    _patch_scan_output(monkeypatch, alter)


def half_left_out(monkeypatch):
    """Half of the batch left out: library mode tracks the first half of
    the source's recordings; a per-file call writes no tables for every
    second recording."""
    import importlib

    batch = importlib.import_module(BATCH)
    track = batch.track_collection_device

    def half_batch(collection, *args, **kwargs):
        from hsip_tpu_torch.collection import VideoCollection

        videos = list(collection)
        return track(VideoCollection(videos[: max(1, len(videos) // 2)]), *args, **kwargs)

    monkeypatch.setattr(batch, "track_collection_device", half_batch)
    pipeline = importlib.import_module("hsip_tpu_torch.pipeline")
    write = pipeline._write_ddt_split_tables
    written = []

    def half_written(output, output_dir, stem, verbose=True):
        written.append(stem)
        return write(output, output_dir, stem, verbose) if len(written) % 2 else {}

    monkeypatch.setattr(pipeline, "_write_ddt_split_tables", half_written)


def one_answer_wrong(monkeypatch, every):
    """One recording in ``every`` tracked: its first position moved by a
    pixel (one library slot, or one recording of a per-file cycle)."""
    seen = []

    def alter(finals):
        seen.append(None)
        found = np.nonzero(finals >= 0)[0]
        if len(seen) % every == 1 % every and found.size:
            finals[found[0]] += 1
        return finals
    _patch_scan_output(monkeypatch, alter)


def one_recording_skipped(monkeypatch, every):
    """The table writer fails on one recording in ``every``: library mode
    warns, skips it and writes the rest."""
    import importlib

    pipeline = importlib.import_module("hsip_tpu_torch.pipeline")
    write = pipeline._write_ddt_split_tables
    seen = []

    def failing(output, output_dir, stem, verbose=True):
        seen.append(stem)
        if len(seen) % every == 1 % every:
            raise OSError("no space left on device")
        return write(output, output_dir, stem, verbose)

    monkeypatch.setattr(pipeline, "_write_ddt_split_tables", failing)


@pytest.mark.parametrize("workload", ["nova.library", "nova.per_file"])
def test_sound_rehearsal_is_correct(workload):
    result = measure(workload, 2**31 + 5, 0.3, False, rehearse=True)
    assert result["correct"] is True
    assert result["checks"]["rows_off_pct"]["value"] == 0.0


@pytest.mark.parametrize("fault", [state_unchanged, answer_altered, half_left_out])
@pytest.mark.parametrize("workload", ["nova.library", "nova.per_file"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault, workload):
    fault(monkeypatch)
    result = measure(workload, 2**31 + 5, 0.3, False, rehearse=True)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault,workload", [
    (one_answer_wrong, "nova.library"), (one_answer_wrong, "nova.per_file"),
    (one_recording_skipped, "nova.library")])
def test_one_recording_at_fault_makes_the_run_incorrect(monkeypatch, fault,
                                                        workload):
    n = int(load_cell(workload).traffic["recordings"])
    monkeypatch.setattr(runner, "REHEARSAL_RECORDINGS", n)
    fault(monkeypatch, n)
    # Long enough for a per-file window to cycle through every recording.
    result = measure(workload, 2**31 + 7, 2.0, False, rehearse=True)
    assert result["attempted"] >= n
    assert 1 <= result["failed"] < result["attempted"]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_missing_answer_counts_no_frames_and_is_not_correct():
    from harness.check import compare_calls, is_correct

    expected = [{"all": "1 2\n"}, {"all": "3 4\n", "pre_ddt": "3 4\n"}]
    written = {("a", "r0", "all"): "1 2\n", ("b", "r0", "all"): "1 2\n",
               ("b", "r1", "all"): "3 4\n", ("b", "r1", "pre_ddt"): "3 4\n",
               ("a", "r1", "all"): "3 4\n"}  # call a lost r1's pre-DDT table
    calls = [{"index": 0, "out_dir": "a", "recordings": [0, 1]},
             {"index": 1, "out_dir": "b", "recordings": [0, 1]}]
    verdict = compare_calls(calls, ["x/r0.cihx", "x/r1.cihx"], expected,
                            lambda d, stem, kind: written.get((d, stem, kind)))
    assert verdict["delivered"] == [[0], [0, 1]]
    assert verdict["answers_missing"] == 0 and verdict["answers_wrong"] == 1
    del written[("a", "r0", "all")]
    verdict = compare_calls(calls, ["x/r0.cihx", "x/r1.cihx"], expected,
                            lambda d, stem, kind: written.get((d, stem, kind)))
    assert verdict["delivered"] == [[], [0, 1]]
    assert verdict["answers_missing"] == 1
    assert not is_correct(verdict, {"rows_off_pct": 100.0,
                                    "answers_wrong_pct": 100.0})
