"""Liveness guard for long runs on the card.

The counterpart of ``mc_water_ls_mw_tpu/liveness.py``, with its names,
constants and decisions.  The reference's failure posture is
cooperative (SIGTERM handler + queue-time guard, timer.f90:105-127 /
main.f90:229-239): it assumes the machine underneath keeps working.  A
process driving a CUDA card can instead stop making progress while it
stays alive:

* its main thread parks inside a CUDA call that never returns (a
  kernel that does not finish, a collective whose peer is gone, a
  fault that leaves the CUDA context hung).  Such a process sits at
  ~0 host CPU, and a SIGTERM handler (the app's checkpoint-and-exit
  hook) never runs from a parked main thread;
* a fresh process may still claim the card and see it as available
  while the parked one stays stuck, so a claim is NOT a health check;
* what IS reliable: a healthy run writes a therm row / checkpoint every
  cycle block and a ``heartbeat`` every chunk of cycles (app.py), and a
  healthy set-up (building kernels, building the state) burns host CPU.

So the guard watches exactly those two signals: output-file mtimes in
the run directory plus the process's own CPU clock.  If neither moves
for ``window_s``, the process exits with a distinctive code so a
supervisor (``python -m mc_water_ls_mw_tpu_torch.tools.watchdog``) can
relaunch it - the app resumes from the newest dual-slot checkpoint
(io/checkpoint.py; mc_checkpoint_write, mc_moves.F90:324-501).  As in
the JAX package the app does not install the guard itself: a run script
calls ``install_wedge_guard``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

#: files whose mtime counts as run progress (therm series flush every
#: cycle block; mc.log on monitor/flatness events; the heartbeat every
#: chunk; checkpoints on the dump interval).  Each entry is (match_kind,
#: pattern) and newest_output_mtime is driven from this table, so the
#: rules cannot drift from the constant.
_OUTPUT_MARKERS = (
    ("suffix", "_therm.dat"),
    ("exact", "mc.log"),
    ("exact", "heartbeat"),
    ("prefix", "checkpoint"),
)


def _is_output(name):
    for kind, pat in _OUTPUT_MARKERS:
        if kind == "suffix" and name.endswith(pat):
            return True
        if kind == "exact" and name == pat:
            return True
        if kind == "prefix" and name.startswith(pat):
            return True
    return False


def newest_output_mtime(dirpath="."):
    """Newest mtime of any run-output file in ``dirpath`` (0.0 if
    none exist yet)."""
    t = 0.0
    try:
        names = os.listdir(dirpath)
    except OSError:
        return t
    for f in names:
        if _is_output(f):
            try:
                t = max(t, os.path.getmtime(os.path.join(dirpath, f)))
            except OSError:
                pass
    return t


def steady_output_mtime(dirpath="."):
    """Newest mtime of a STEADY-STATE output (therm rows / checkpoints
    / the heartbeat) - files that only advance once the cycle loop is
    actually running.  mc.log is excluded on purpose: set-up writes
    banner lines to it before the kernels are built and the state is
    made, and the startup->steady transition must not be triggered by
    those."""
    t = 0.0
    try:
        names = os.listdir(dirpath)
    except OSError:
        return t
    for f in names:
        if f.endswith("_therm.dat") or f.startswith("checkpoint") \
                or f == "heartbeat":
            try:
                path = os.path.join(dirpath, f)
                if os.path.getsize(path) > 0:
                    t = max(t, os.path.getmtime(path))
            except OSError:
                pass
    return t


class WedgeMonitor:
    """Pure decision core of the guard (testable without threads).

    Feed it (wall time, process CPU time, newest output mtime)
    samples; ``tick`` returns the current stall age in seconds - 0.0
    while the run shows progress, and the caller should treat
    ``tick(...) > wedged_after`` as wedged.  Progress = a NEW output-file
    mtime (strictly newer than the last seen) or a per-tick CPU RATE
    above ``cpu_rate`` (set-up work in flight).  The rate is judged on
    the CPU burned since the PREVIOUS tick, not cumulative since the
    last progress point: ``time.process_time`` sums all threads, so a
    parked process whose helper threads trickle ~1% CPU forever must
    still read as stalled (it would eventually clear any cumulative
    threshold).

    ``startup_window_s`` applies until the first STEADY-STATE output
    (a therm row / checkpoint / heartbeat - ``steady`` argument of
    ``tick``) is ever observed: a cold start can wait long at low host
    CPU (the card's first kernels, a large state) - healthy, but
    indistinguishable from a wedge by the steady-state signals - and
    the early mc.log banner lines must NOT end the startup phase.  Once
    the cycle loop has produced steady output even once, the tight
    window takes over.
    """

    def __init__(self, now, cpu, mtime, window_s=360.0,
                 cpu_rate=0.05, startup_window_s=2400.0,
                 steady=0.0):
        self.window_s = float(window_s)
        self.startup_window_s = float(startup_window_s)
        self.cpu_rate = float(cpu_rate)
        self._cpu = cpu
        self._now = now
        self._mtime = mtime
        self._steady = steady
        self._progress_at = now
        self._steady_seen = False

    def tick(self, now, cpu, mtime, steady=None):
        dt = now - self._now
        dcpu = cpu - self._cpu
        self._now = now
        self._cpu = cpu
        if steady is not None and steady > self._steady:
            self._steady = steady
            self._steady_seen = True
        busy = dt > 0.0 and (dcpu / dt) > self.cpu_rate
        if mtime > self._mtime or busy:
            self._mtime = mtime
            self._progress_at = now
            return 0.0
        return now - self._progress_at

    @property
    def wedged_after(self):
        if not self._steady_seen:
            return max(self.window_s, self.startup_window_s)
        return self.window_s


def install_wedge_guard(dirpath=".", window_s=360.0, poll_s=20.0,
                        exit_code=3, _exit=os._exit,
                        startup_window_s=2400.0):
    """Start the guard as a daemon thread; returns the thread.

    On detection it prints one line and calls ``_exit(exit_code)`` -
    a hard exit on purpose: the parked thread sits inside a CUDA call
    that will never return, so cooperative shutdown is not available.
    Exit code 3 is what the watchdog treats as "relaunch and resume".
    """

    def run():
        mon = WedgeMonitor(time.time(), time.process_time(),
                           newest_output_mtime(dirpath),
                           window_s=window_s,
                           startup_window_s=startup_window_s,
                           steady=steady_output_mtime(dirpath))
        while True:
            time.sleep(poll_s)
            age = mon.tick(time.time(), time.process_time(),
                           newest_output_mtime(dirpath),
                           steady=steady_output_mtime(dirpath))
            if age > mon.wedged_after:
                print(f"wedge guard: no output progress and CPU rate "
                      f"<{mon.cpu_rate:.0%} for {age:.0f}s; "
                      "exiting for watchdog restart", flush=True)
                _exit(exit_code)

    t = threading.Thread(target=run, daemon=True,
                         name="wedge-guard")
    t.start()
    return t


# ---------------------------------------------------------------------------
# Degraded-card probe + relaunch backoff.
#
# The card has THREE failure states, and only one of them is cured by a
# relaunch:
#   * wedged client  - this process parked in a CUDA call; relaunch
#     helps (the wedge guard above exits 3 for exactly this);
#   * crashed worker - the child died; relaunch helps;
#   * degraded card  - every process sees trivial ops take far longer
#     than they should (the card held by another process, clocks held
#     down, a card recovering from a fault); relaunching does NOT
#     help - each relaunch re-pays its set-up just to stall again,
#     burning the restart budget.  Only waiting helps.
# So before a relaunch the supervisor runs a cheap timed probe in a
# throwaway subprocess and, while the probe lands in the degraded band
# or fails, sleeps with exponential backoff instead of relaunching.
# ---------------------------------------------------------------------------

#: the probe op must complete within this after the card is claimed on
#: a healthy card (one small reduction and its synchronise)
PROBE_DEGRADED_S = 15.0

#: claim the card, then time one trivial op and its synchronise.  No
#: card: exit without the PROBE_OP_S line, which reads as "fail" - the
#: probe never times the CPU instead.
_PROBE_SRC = r"""
import sys, time
import torch
if not torch.cuda.is_available():
    sys.exit("PROBE no CUDA device")
x = torch.ones((8, 128), device="cuda")
torch.cuda.synchronize()
t0 = time.time()
x.sum()
torch.cuda.synchronize()
print("PROBE_OP_S %.3f" % (time.time() - t0), flush=True)
"""


def probe_device(timeout_s=240.0, _run=None):
    """Time one trivial CUDA op in a throwaway subprocess.

    Returns ``(status, op_seconds)`` with status in {"ok", "degraded",
    "fail"}.  "fail" covers a missing card, a claim failure and a probe
    timeout - all count as not-relaunch-worthy for the backoff policy,
    since a card that cannot even be claimed needs waiting, not a
    relaunch.  ``_run`` is injectable for tests.
    """
    if _run is None:
        # LIVENESS_PROBE_CMD lets supervision tests substitute a fake
        # card without a device claim in every relaunch
        override = os.environ.get("LIVENESS_PROBE_CMD")
        cmd = (["sh", "-c", override] if override
               else [sys.executable, "-c", _PROBE_SRC])

        def _run(timeout):
            return subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout,
            )
    try:
        res = _run(timeout_s)
    except subprocess.TimeoutExpired:
        return "fail", float(timeout_s)
    for line in (res.stdout or "").splitlines():
        if line.startswith("PROBE_OP_S"):
            op_s = float(line.split()[1])
            if op_s > PROBE_DEGRADED_S:
                return "degraded", op_s
            return "ok", op_s
    return "fail", 0.0


class BackoffPolicy:
    """Pure decision core for the relaunch-vs-wait loop (testable).

    ``decide(status)`` consumes one probe outcome and returns the
    seconds to wait before the next probe - 0.0 means "relaunch now".
    Degraded/fail outcomes wait with exponential backoff (base
    ``start_s``, doubling to ``cap_s``); an ok outcome resets the
    backoff and releases the relaunch.
    """

    def __init__(self, start_s=60.0, factor=2.0, cap_s=900.0):
        self.start_s = float(start_s)
        self.factor = float(factor)
        self.cap_s = float(cap_s)
        self._next = self.start_s

    def decide(self, status):
        if status == "ok":
            self._next = self.start_s
            return 0.0
        wait = self._next
        self._next = min(self._next * self.factor, self.cap_s)
        return wait
