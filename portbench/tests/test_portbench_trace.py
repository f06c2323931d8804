"""The trace reader and the per-layer readers on made-up inputs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.blocklog import Blocks, read_blocks  # noqa: E402
from portbench.trace import read_trace  # noqa: E402


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", "run_cycles", 0, 100),
    _x("user_annotation", "volume_moves", 60, 30),
    _x("user_annotation", "therm", 100, 20),
    _x("user_annotation", "checkpoint", 130, 50),     # the final one
    _x("kernel", "k1", 10, 40),
    _x("kernel", "k1", 30, 30),                       # overlaps: one union
    _x("gpu_memcpy", "copy", 70, 10),
    _x("kernel", "k2", 140, 10),                      # after the window
]


def test_read_trace():
    t = read_trace(EVENTS)
    assert t["window_s"] == pytest.approx(130e-6)
    assert t["busy_s"] == pytest.approx(60e-6)       # [10, 60] + [70, 80]
    assert t["launches"] == 3
    assert t["frontend_s"] == pytest.approx(20e-6)
    assert dict(t["device_ops"]) == pytest.approx({"k1": 70e-6,
                                                   "copy": 10e-6})
    # gaps [0,10] and [60,70] in the loop and the volume moves, [80,90]
    # in the volume moves, [90,100] in the loop, [100,120] in therm,
    # [120,130] outside every range
    assert dict(t["idle_gaps"]) == pytest.approx({
        "run_cycles": 20e-6, "volume_moves": 20e-6, "therm": 20e-6,
        "other": 10e-6})


def test_no_loop_no_reading():
    assert read_trace([_x("kernel", "k", 0, 1)]) is None


def test_block_lines(tmp_path):
    log = tmp_path / "mc.log"
    log.write_text(
        "# block 100: 100 cycles in 9.9s = dispatch 9.0 + therm 0.1 + "
        "wl/monitor 0.2 + ckpt/other 0.6\n")
    off = log.stat().st_size
    with open(log, "a") as fh:
        fh.write("# block 150: 50 cycles in 5.0s = dispatch 4.8 + therm 0.0"
                 " + wl/monitor 0.1 + ckpt/other 0.1\n# other line\n")
    b = read_blocks(str(log), off)
    assert (b.cycles, b.total_s) == (50, 5.0)


@pytest.mark.parametrize("metric", [
    m["name"] for m in harness.manifest()["per_layer"]])
def test_readers_read_nothing_without_a_trace(metric):
    ctx = {"trace": None, "blocks": Blocks(), "cycles": 0, "peak": None,
           "timed_s": {}, "vol_moves": 0, "ops": 0.0, "bytes": 0.0}
    assert harness.reader(metric)(ctx) is None


def test_roofline_without_peak_reads_nothing():
    ctx = {"trace": {"busy_s": 1.0, "window_s": 1.0}, "peak": None,
           "ops": 1e12, "bytes": 1e9}
    assert harness.reader("cycle_roofline.n216")(ctx) is None
    ctx["peak"] = {"f32_ops_per_s": 67e12, "bytes_per_s": 3.35e12}
    assert harness.reader("cycle_roofline.n216")(ctx) == pytest.approx(
        100.0 / 67)
