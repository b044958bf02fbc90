"""The control of the check: the reference computed in bfloat16 (the
precision below the configuration's float32 profiles) must come out not
correct, by the same rule as a run of the benchmark. At a size a test run
holds; the readings at the cells' own sizes come from
``benchmarks/control.py`` on the chip machine (PERF.md, section 2)."""

import json

import pytest

import control


@pytest.mark.parametrize("workload", ["nova.library", "nova.per_file"])
def test_control_fails_a_compared_number(workload, capsys):
    assert control.main(["--workload", workload, "--seeds", "2", "3",
                         "--frames", "256", "--recordings", "4"]) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        reading = json.loads(line)
        assert reading["correct"] is False, reading
        assert any(c["value"] > c["limit"] for c in reading["checks"].values()), reading
