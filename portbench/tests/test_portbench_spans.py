"""The program's spans in a traced run (``portbench/spans.py``): the
readers on made-up chrome traces, and on the card a short traced run of
each cell with the program's tracing on, in which every blocking CUDA
runtime call of the window lies inside a ``mw/wait/*`` range."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.spans import host_syncs, quantities, read_spans  # noqa: E402
from portbench.tests.test_portbench_trace import EVENTS  # noqa: E402
from portbench.trace import read_trace  # noqa: E402


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, at):
    """A runtime call at ``ts`` and the kernel it launched at ``at``."""
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr),
            _x("kernel", f"k{corr}", at, 5, corr)]


TRACE = [
    _x("user_annotation", "run_cycles", 0, 100),
    _x("user_annotation", "mw/cycle", 0, 60),
    _x("user_annotation", "mw/volume_move", 10, 20),
    _x("user_annotation", "mw/full_energy", 12, 6),
    _x("user_annotation", "mw/volume_move", 40, 10),
    _x("user_annotation", "mw/wait/move_codes", 55, 5),
    _x("user_annotation", "mw/wait/heartbeat", 90, 10),
    _x("user_annotation", "checkpoint", 120, 30),     # the final one
    *_launch(11, 1, 20),       # volume move 1, outside its full energy
    *_launch(13, 2, 22),       # volume move 1 and its full energy
    *_launch(45, 3, 50),       # volume move 2
    *_launch(70, 4, 75),       # the loop only
    *_launch(125, 5, 130),     # after the window
    _x("cuda_runtime", "cudaStreamSynchronize", 56, 3),
    _x("cuda_runtime", "cudaDeviceSynchronize", 91, 8),
    _x("cuda_runtime", "cudaStreamSynchronize", 80, 2),
]


def test_read_spans():
    r = read_spans(TRACE)
    assert r["window_s"] == pytest.approx(120e-6)
    assert r["wait_s"] == pytest.approx(15e-6)
    sp = r["spans"]
    assert sp["mw/volume_move"] == {"count": 2, "host_s": pytest.approx(
        30e-6), "launches": 3}
    assert sp["mw/full_energy"]["launches"] == 1
    assert sp["mw/cycle"]["launches"] == 3
    assert sp["run_cycles"]["launches"] == 4
    assert sp["mw/wait/heartbeat"]["launches"] == 0
    assert "checkpoint" not in sp
    q = quantities(r, {"spans": {"mw/setup": {"total_ns": 2.5e9}}})
    assert q == pytest.approx({"host_wait_share": 12.5,
                               "vol_move_launches": 1.5,
                               "app_setup_s": 2.5})
    assert quantities(None, None) == {}


def test_host_syncs():
    assert sorted(host_syncs(TRACE)) == [
        ("cudaDeviceSynchronize", "mw/wait/heartbeat", True),
        ("cudaStreamSynchronize", "mw/wait/move_codes", True),
        ("cudaStreamSynchronize", "run_cycles", False)]


def test_program_ranges_leave_read_trace_as_it_was():
    mw = [_x("user_annotation", "mw/cycle", 0, 60),
          _x("user_annotation", "mw/volume_move", 62, 26),
          _x("user_annotation", "mw/therm", 101, 18)]
    a, b = read_trace(EVENTS), read_trace(EVENTS + mw)
    for k in a:
        if k != "idle_gaps":
            assert a[k] == b[k], k
    assert sum(dict(a["idle_gaps"]).values()) == pytest.approx(
        sum(dict(b["idle_gaps"]).values()))
    assert "mw/volume_move" in dict(b["idle_gaps"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["n216_sample", "n8064_wl"])
def test_every_wait_on_the_card_is_a_span(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/spans.py", "--workload", cell,
         "--seed", str(2**31 + 91), "--seconds", "4", "--trace", "1",
         "--timed", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["syncs"] > 0 and line["stray_syncs"] == {}
    want = {"host_wait_share", "vol_move_launches", "app_setup_s"}
    if cell == "n8064_wl":
        want.add("substep_launches")
        assert line["window_counters"]["volume_moves"] == \
            line["metrics"]["vol_moves.n8064"]
    assert want <= set(line["spans"])
