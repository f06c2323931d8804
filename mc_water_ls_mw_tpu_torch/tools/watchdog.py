"""Watchdog supervisor for long single-process runs on the card.

A process driving a CUDA card can hang inside a CUDA call while the
card itself stays healthy (liveness.py: main thread parked, output
frozen, ~0 CPU).  The dual-slot checkpoints (io/checkpoint.py;
mc_checkpoint_write, mc_moves.F90:324-501) make restarts cheap, so the
pragmatic recovery is supervision: watch a file of the run for
staleness, kill and relaunch on a hang, let the app resume from the
newest valid checkpoint.  The counterpart of the JAX package's
``scripts/watchdog.py``, with its flags and log lines, gated on the
port's ``liveness.probe_device``.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.watchdog \\
        --workdir runs/n216_sample_torch --cmd "python run.py" \\
        --watch heartbeat --stale 900 --max-restarts 8 --budget 10800

or, over the CLI:

    python -m mc_water_ls_mw_tpu_torch.tools.watchdog --workdir RUN \\
        --cmd "mw-water-ls-torch ice.input" --watch heartbeat

(``heartbeat`` is rewritten after every chunk of ``jit_chunk`` cycles,
app.py).  The budget is total wall-clock seconds across restarts; each
launch gets the REMAINING budget via the WL_QTIME environment variable
so the run itself still exits cleanly inside its slot (timer.f90
semantics, main.f90:229-239).  The launched run takes the card unless
its own command asks for the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..liveness import BackoffPolicy, probe_device


def _kill_group(proc, grace_s):
    """SIGTERM then SIGKILL the run's process group, tolerating the
    race where the process dies between the staleness check and the
    kill (the supervisor must survive to relaunch).

    The direct child is a shell wrapper; waiting on IT is not enough:
    the wrapper may die on SIGTERM while the grandchild run is parked in
    a CUDA call - its SIGTERM handler (the app's checkpoint-and-exit
    hook) can never run from a parked main thread - and outlives the
    supervisor.  So after the grace, ALWAYS send SIGKILL to the group;
    it is idempotent on the dead.

    The grace must likewise be granted to the GROUP, not the direct
    child: if the wrapper dies instantly on SIGTERM, proc.wait returns
    before the grandchild app has had its grace to run the
    checkpoint-and-exit hook - so after proc.wait returns early, the
    remaining grace is waited out against group existence
    (os.killpg(pg, 0)) before the unconditional SIGKILL."""
    try:
        pg = os.getpgid(proc.pid)
    except ProcessLookupError:
        proc.wait(timeout=10)
        return
    try:
        os.killpg(pg, signal.SIGTERM)
    except ProcessLookupError:
        proc.wait(timeout=10)
        return
    deadline = time.time() + grace_s
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        pass
    # wrapper may be gone while grandchildren still checkpoint: give
    # the rest of the group the remaining grace before the hard kill
    while time.time() < deadline:
        try:
            os.killpg(pg, 0)
        except ProcessLookupError:
            break
        time.sleep(min(2.0, max(0.1, deadline - time.time())))
    try:
        os.killpg(pg, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def log(fh, msg):
    line = f"[watchdog {time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.watchdog",
        description="supervise a run: relaunch it on a hang or a crash")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--cmd", default="python run.py")
    ap.add_argument("--watch", default="mc.log",
                    help="file whose mtime indicates liveness")
    ap.add_argument("--stale", type=float, default=900.0,
                    help="seconds of watch-file staleness = hang")
    ap.add_argument("--grace", type=float, default=600.0,
                    help="startup grace before staleness applies "
                         "(set-up produces no output)")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--budget", type=float, default=10800.0,
                    help="total wall-clock budget (s) across restarts")
    ap.add_argument("--poll", type=float, default=30.0)
    ap.add_argument("--kill-grace", type=float, default=60.0,
                    help="grace (s) the whole process group gets "
                         "between SIGTERM and SIGKILL on a hang kill")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the degraded-card probe gate before "
                         "relaunches")
    ap.add_argument("--probe-backoff", type=float, default=60.0,
                    help="first wait (s) of the degraded-card "
                         "exponential backoff")
    return ap.parse_args(argv)


def _probe_gate(fh, args, t_end):
    """Degraded-card gate: while every process sees trivial ops stall,
    relaunching does not help - only waiting does.  Probe before the
    relaunch; while degraded (or failing), back off exponentially
    WITHOUT burning a restart slot.  Returns False when the budget ran
    out during the wait."""
    policy = BackoffPolicy(start_s=args.probe_backoff)
    while True:
        if time.time() > t_end - 180:
            log(fh, "budget exhausted during backend probe; done")
            return False
        status, op_s = probe_device()
        wait = policy.decide(status)
        if wait == 0.0:
            log(fh, f"backend probe ok (op {op_s:.1f}s); relaunching")
            return True
        wait = min(wait, max(0.0, t_end - time.time() - 180))
        log(fh, f"backend probe {status} (op {op_s:.1f}s): waited "
                f"{wait:.0f}s instead of relaunching")
        time.sleep(wait)


def _supervise(fh, args, t_end):
    restarts = 0
    while True:
        remaining = t_end - time.time()
        if remaining < 120:
            log(fh, f"budget exhausted ({remaining:.0f}s left)")
            return 0
        env = dict(os.environ, WL_QTIME=str(int(remaining)))
        log(fh, f"launch #{restarts}: {args.cmd!r} "
                f"(remaining budget {remaining:.0f}s)")
        with open(f"run_{restarts:02d}.log", "w") as out:
            proc = subprocess.Popen(
                args.cmd, shell=True, env=env,
                stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            t_launch = time.time()
            hang = False
            while True:
                try:
                    rc = proc.wait(timeout=args.poll)
                    break
                except subprocess.TimeoutExpired:
                    pass
                try:
                    age = time.time() - os.path.getmtime(args.watch)
                except OSError:
                    age = time.time() - t_launch
                in_grace = time.time() - t_launch < args.grace
                if age > args.stale and not in_grace:
                    log(fh, f"watch file {args.watch!r} stale "
                            f"{age:.0f}s > {args.stale:.0f}s: "
                            "killing process group")
                    hang = True
                    _kill_group(proc, args.kill_grace)
                    rc = proc.returncode
                    break
                if time.time() > t_end - 60:
                    log(fh, "budget reached: stopping run cleanly")
                    _kill_group(proc, 120)
                    log(fh, "done (budget)")
                    return 0
        if not hang and rc == 0:
            log(fh, "run exited cleanly (rc=0); done")
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            log(fh, f"giving up after {restarts - 1} restarts")
            return 1
        log(fh, f"run ended rc={rc} hang={hang}; restarting "
                "(auto-resume from newest checkpoint)")
        if not args.no_probe and not _probe_gate(fh, args, t_end):
            return 0
        time.sleep(10)


def main(argv=None):
    args = parse_args(argv)
    cwd = os.getcwd()
    os.chdir(args.workdir)
    t_end = time.time() + args.budget
    try:
        with open("watchdog.log", "a") as fh:
            return _supervise(fh, args, t_end)
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    sys.exit(main())
