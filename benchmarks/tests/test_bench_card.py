"""On the card: one short run of a cell through the command the check
uses, which must print a correct line naming the card. Skips without a
card (``cuda`` marker; decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the harness refuses to run without one")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "nova.per_file",
         "--seed", "2147483647", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent, check=True,
    ).stdout.strip().splitlines()[-1]
    line = json.loads(out)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line


def test_without_a_card_the_harness_refuses():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "nova.library",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent,
    )
    assert done.returncode == 2 and done.stdout == ""
