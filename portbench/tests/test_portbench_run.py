"""Whole runs of the harness: without a card, on the CPU at a test size,
with the program broken underneath, and the control."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402

# CPU sizes: two walkers, equilibration over at once, one warm-up cycle
# and one timed; the N=8064 cycle cut to one sweep of the tables
RESIZE = {
    "n216_sample": {"params": {"n_walkers": 2, "eq_mc_cycles": 1,
                               "mc_vol_prob": 0.02},
                    "warmup_cycles": 1, "rate_cycles": 1},
    "n8064_wl": {"params": {"n_walkers": 2}, "warmup_cycles": 0,
                 "rate_cycles": 1,
                 "schedule": {"cycle_s": 0.05, "trials_per_cycle": 4096}},
}
SEED = 2**32 + 12345


def _one_sweep(app):
    eng = app.engine
    if hasattr(eng, "trials_per_cycle"):
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K * eng.T


def _run(cell, fault=None, **kw):
    def setup(app):
        _one_sweep(app)
        if fault is not None:
            fault(app)

    torch.set_num_threads(4)
    return harness.run(cell, SEED, 0.1, device="cpu", fault=setup,
                       resize=RESIZE[cell], **kw)


def test_no_card_no_result(tmp_path):
    """Without a card the run exits 2 and prints no result line, also in
    a directory that holds only BENCHMARK.json and the benchmark."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for root in (ROOT, str(tmp_path)):
        if root != ROOT:
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
            shutil.copytree(os.path.join(ROOT, "portbench"),
                            os.path.join(root, "portbench"),
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "n216_sample",
             "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(RESIZE))
def test_sound_run_and_control(cell, capsys):
    res = _run(cell, with_control=True)
    assert res.correct and res.failed == 0
    if cell == "n8064_wl":
        # two window cycles of one sweep, planned and run alike
        err = capsys.readouterr().err
        line = next(x for x in err.splitlines()
                    if x.startswith("schedule:"))
        assert "2 cycles of 4096 trials (planned 4096)" in line
        planned = int(line.split("planned ")[2].split(",")[0])
        assert line.endswith(f"ran {planned}") and planned > 0
    assert not res.control["correct"]
    assert res.metrics["setup_s"][0] > 0
    rate = "moves_per_s" if cell == "n216_sample" else "trials_per_s"
    assert res.metrics[rate][0] > 0


@pytest.mark.parametrize("fault,caught", [("unchanged", "stuck"),
                                          ("half", "moves_short"),
                                          ("altered", "e_gap_ev"),
                                          ("reject_all", "acc_trans"),
                                          # N=8064's walls keep accepted
                                          # translations near the sound
                                          # share; its volume moves show
                                          ("accept_all",
                                           {"n216_sample": "acc_trans",
                                            "n8064_wl": "acc_vol"})],
                         ids=["unchanged", "half", "altered", "reject_all",
                              "accept_all"])
@pytest.mark.parametrize("cell", sorted(RESIZE))
def test_broken_program_is_not_correct(cell, fault, caught):
    res = _run(cell, FAULTS[fault])
    assert not res.correct
    # a number the run could not read (the weights' growth of a state
    # that never moved) fails as well
    failed = [k for k, v, lim in res.checks if not check.within(v, lim)]
    assert (caught if isinstance(caught, str) else caught[cell]) in failed


def test_result_line_shape(capsys, monkeypatch):
    """run.py's line: the contract's keys, ``checks`` last."""
    from portbench import run as runmod

    res = harness.Result(True, 2, 0, [("e_gap_ev", 1e-4, 1e-2)],
                         {"moves_per_s": (1.0, "moves/s"),
                          "setup_s": (2.0, "s")},
                         {"platform": "gpu", "kind": "x", "count": 1,
                          "memory_peak_bytes": 1}, None)
    monkeypatch.setattr(harness, "run", lambda *a, **k: res)
    monkeypatch.setattr(harness, "cell_files",
                        lambda *a, **k: ({"chips": 1}, {}, {}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runmod, "_power_limit", lambda: 700.0)
    assert runmod.main(["--workload", "n216_sample", "--seed", "1",
                        "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check e_gap_ev 0.0001 limit 0.01"
