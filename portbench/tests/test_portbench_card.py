"""On the card: a short run of each cell through ``run.py`` prints a
correct result line, and the control on the same state is not correct
(``python -m pytest portbench/tests -m cuda`` on a machine with one)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["n216_sample", "n8064_wl"]

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/calibrate.py", "--workload", cell,
         "--seeds", "1", "--first-seed", str(2**31 + 78), "--seconds", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["correct"] and not row["control_correct"]
