"""The port's wedge guard (mc_water_ls_mw_tpu_torch/liveness.py): the
cases of tests/test_liveness.py against the port's module, the same
decisions as the JAX module's on the same samples, and the probe's
refusal to time anything but a card.

The decision core must flag exactly the wedge signature (no output-file
progress AND ~0 process CPU) and must NOT flag healthy set-up work (CPU
moving, no files yet) or a healthy steady state (output mtimes
advancing, ~0 CPU).
"""

import os
import subprocess
import time

import numpy as np
import pytest

from mc_water_ls_mw_tpu import liveness as jlive
from mc_water_ls_mw_tpu_torch import liveness as tlive
from mc_water_ls_mw_tpu_torch.liveness import (
    BackoffPolicy,
    WedgeMonitor,
    install_wedge_guard,
    newest_output_mtime,
    probe_device,
    steady_output_mtime,
)


def test_same_constants_as_jax():
    assert tlive._OUTPUT_MARKERS == jlive._OUTPUT_MARKERS
    assert tlive.PROBE_DEGRADED_S == jlive.PROBE_DEGRADED_S


@pytest.mark.parametrize("ticks, expect", [
    # neither CPU nor files move: age accumulates past the window
    ([(200.0, 0.5, 100.0, 200.0), (400.0, 1.0, 100.0, 400.0)], True),
    # a therm flush lands: the stall age resets even with ~0 CPU, and
    # is measured from the last progress point, not from the start
    ([(300.0, 0.5, 100.0, 300.0), (350.0, 0.6, 351.0, 0.0),
      (700.0, 0.7, 351.0, 350.0), (712.0, 0.7, 351.0, 362.0)], True),
], ids=["full_stall", "resets_on_file_progress"])
def test_monitor_stall_age(ticks, expect):
    mon = WedgeMonitor(now=0.0, cpu=0.0, mtime=100.0, window_s=360.0,
                       startup_window_s=360.0)
    for now, cpu, mtime, age in ticks:
        got = mon.tick(now, cpu, mtime)
        assert got == age
    assert (got > mon.wedged_after) is expect


def test_monitor_startup_window_tolerates_long_setup():
    # a cold start at ~0 host CPU with no steady output for many
    # minutes must NOT read as wedged inside the startup window; an
    # mc.log banner line (generic progress, NOT steady) resets the
    # stall age but must NOT tighten the window
    mon = WedgeMonitor(now=0.0, cpu=0.0, mtime=0.0, window_s=360.0,
                       startup_window_s=1200.0)
    assert mon.tick(60.0, 0.5, 61.0) == 0.0     # mc.log banner line
    assert mon.wedged_after == 1200.0           # still startup
    age = mon.tick(700.0, 1.0, 61.0)
    assert age == 640.0 < mon.wedged_after
    # first therm row / heartbeat = steady output: tight window from now
    assert mon.tick(900.0, 1.5, 901.0, steady=901.0) == 0.0
    assert mon.wedged_after == 360.0
    assert mon.tick(1300.0, 1.6, 901.0, steady=901.0) \
        == 400.0 > mon.wedged_after


def test_monitor_restart_requires_new_steady_output():
    # after a restart the directory already holds old checkpoints;
    # their (old) mtimes must not count as steady progress
    mon = WedgeMonitor(now=0.0, cpu=0.0, mtime=500.0, window_s=360.0,
                       startup_window_s=1200.0, steady=500.0)
    assert mon.tick(400.0, 0.1, 500.0, steady=500.0) == 400.0
    assert mon.wedged_after == 1200.0
    assert mon.tick(600.0, 0.1, 601.0, steady=601.0) == 0.0
    assert mon.wedged_after == 360.0


@pytest.mark.parametrize("ticks, ages", [
    # set-up: no output files at all, but host CPU moves; then it ends
    # and the process parks
    ([(300.0, 20.0), (600.0, 40.0), (900.0, 41.0), (990.0, 41.5)],
     [0.0, 0.0, 300.0, 390.0]),
    # a ~1% CPU trickle (helper threads of a parked process) must NOT
    # read as progress
    ([(200.0, 2.0), (400.0, 4.0)], [200.0, 400.0]),
], ids=["cpu_burn_is_progress", "ignores_trickle_cpu"])
def test_monitor_cpu_rate(ticks, ages):
    mon = WedgeMonitor(now=0.0, cpu=0.0, mtime=0.0, window_s=360.0,
                       cpu_rate=0.05, startup_window_s=360.0)
    assert [mon.tick(t, c, 0.0) for t, c in ticks] == ages
    assert ages[-1] > mon.wedged_after


def test_monitor_sustained_trickle_never_resets_stall():
    # judged cumulatively a trickle eventually clears any threshold;
    # judged per tick as a rate the stall age keeps growing
    mon = WedgeMonitor(now=0.0, cpu=0.0, mtime=0.0, window_s=360.0,
                       cpu_rate=0.05, startup_window_s=360.0)
    t, cpu = 0.0, 0.0
    for _ in range(100):                 # 2000 s of 1.4% trickle
        t += 20.0
        cpu += 0.28
        age = mon.tick(t, cpu, 0.0)
    assert age == 2000.0 > mon.wedged_after


def test_monitor_decides_as_jax_on_random_samples():
    rng = np.random.default_rng(7)
    kw = dict(window_s=300.0, cpu_rate=0.05, startup_window_s=900.0,
              steady=10.0)
    mons = [m.WedgeMonitor(0.0, 0.0, 10.0, **kw) for m in (jlive, tlive)]
    t = cpu = mtime = steady = 0.0
    for _ in range(500):
        t += rng.uniform(5.0, 60.0)
        cpu += rng.choice([0.0, 0.1, 5.0])
        if rng.uniform() < 0.1:
            mtime = t
        if rng.uniform() < 0.05:
            steady = t
        out = [(m.tick(t, cpu, mtime, steady=steady), m.wedged_after)
               for m in mons]
        assert out[0] == out[1]


def test_output_mtimes_pick_run_outputs_only(tmp_path):
    old = tmp_path / "ice000_therm.dat"
    old.write_text("row\n")
    os.utime(old, (1000.0, 1000.0))
    log = tmp_path / "mc.log"
    log.write_text("#\n")
    os.utime(log, (2000.0, 2000.0))
    ck = tmp_path / "checkpoint000.npz.1"
    ck.write_bytes(b"x")
    os.utime(ck, (1500.0, 1500.0))
    hb = tmp_path / "heartbeat"
    hb.write_text("12\n")
    os.utime(hb, (1800.0, 1800.0))
    noise = tmp_path / "run_00.log"
    noise.write_text("chatter\n")
    os.utime(noise, (9000.0, 9000.0))
    assert newest_output_mtime(str(tmp_path)) == 2000.0
    # mc.log is no steady output; the heartbeat is
    assert steady_output_mtime(str(tmp_path)) == 1800.0
    for f in (newest_output_mtime, steady_output_mtime):
        assert f(str(tmp_path)) == getattr(jlive, f.__name__)(str(tmp_path))
        assert f(str(tmp_path / "missing")) == 0.0


class _FakeRes:
    def __init__(self, stdout):
        self.stdout = stdout


def test_probe_device_bands():
    ok, s = probe_device(_run=lambda t: _FakeRes("PROBE_OP_S 0.8\n"))
    assert ok == "ok" and s == 0.8
    deg, s = probe_device(_run=lambda t: _FakeRes("PROBE_OP_S 48.2\n"))
    assert deg == "degraded" and s == 48.2
    # claim failure / garbage output / timeout all read as fail
    assert probe_device(_run=lambda t: _FakeRes(""))[0] == "fail"

    def _timeout(t):
        raise subprocess.TimeoutExpired("probe", t)

    assert probe_device(timeout_s=30, _run=_timeout) == ("fail", 30.0)


def test_probe_device_fails_without_a_card(monkeypatch):
    # the real probe in a throwaway process: with no card it reports
    # "fail", never a time of the CPU
    monkeypatch.delenv("LIVENESS_PROBE_CMD", raising=False)
    import torch

    status, op_s = probe_device(timeout_s=120)
    if torch.cuda.is_available():
        assert status == "ok" and op_s >= 0.0
    else:
        assert (status, op_s) == ("fail", 0.0)


def test_probe_honours_the_override(monkeypatch):
    monkeypatch.setenv("LIVENESS_PROBE_CMD", "echo PROBE_OP_S 0.25")
    assert probe_device() == ("ok", 0.25)


def test_backoff_policy_waits_through_degraded_stretch():
    # in the degraded state relaunching does not help, only waiting
    # does: growing waits, capped, released at once on recovery
    p = BackoffPolicy(start_s=60.0, factor=2.0, cap_s=900.0)
    waits = [p.decide("degraded") for _ in range(6)]
    assert waits == [60.0, 120.0, 240.0, 480.0, 900.0, 900.0]
    assert p.decide("ok") == 0.0            # recovery releases
    assert p.decide("fail") == 60.0         # ...and resets the ladder


def test_install_guard_exits_via_hook(tmp_path):
    fired = {}

    def fake_exit(code):
        fired["code"] = code
        # the real guard never returns from _exit; end the thread
        raise SystemExit

    t = install_wedge_guard(str(tmp_path), window_s=0.05, poll_s=0.02,
                            _exit=fake_exit, startup_window_s=0.05)
    deadline = time.time() + 5.0
    while "code" not in fired and time.time() < deadline:
        time.sleep(0.02)
    assert fired.get("code") == 3
    t.join(timeout=5.0)
