"""The port's watchdog supervisor (mc_water_ls_mw_tpu_torch.tools.watchdog):
the five cases of tests/test_watchdog.py, run as
``python -m mc_water_ls_mw_tpu_torch.tools.watchdog``.

Simulates the hang it exists for: a run that stops updating its watch
file but keeps the process alive must be killed and relaunched; a run
that exits cleanly must end supervision.  ``LIVENESS_PROBE_CMD`` stands
in for the card's probe.  The two hang cases go stale after 3 s (12 s
in tests/test_watchdog.py): the 5 s start-up grace, which a relaunch
needs before it rewrites the watch file, stays.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def workdir(request):
    """Scratch dir under the repo: where /tmp is private to a process, a
    pytest workdir would not be shared between the watchdog and the job
    subprocesses it supervises."""
    d = REPO / "tests" / f".wd_torch_{request.node.name[:40]}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _run(workdir, cmd, probe=False, env=None, **kw):
    args = [
        sys.executable, "-m", "mc_water_ls_mw_tpu_torch.tools.watchdog",
        "--workdir", str(workdir),
        "--cmd", cmd,
        "--watch", "out.log",
        "--poll", "1",
        "--kill-grace", "5",
    ]
    if not probe:
        args.append("--no-probe")
    for k, v in kw.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    run_env = dict(os.environ, **(env or {}))
    return subprocess.run(
        args, capture_output=True, text=True, timeout=120,
        env=run_env, cwd=REPO,
    )


# the job's writes are fsynced: some container file systems commit a
# killed process's un-synced writes only after a ~15 s flush interval
_PUT = textwrap.dedent("""
    import os, sys, time
    def put(name, txt):
        f = open(name, "w"); f.write(txt)
        f.flush(); os.fsync(f.fileno()); f.close()
""")


def test_clean_exit_ends_supervision(workdir):
    cmd = (
        f"{sys.executable} -c \"open('out.log','w').write('done')\""
    )
    res = _run(workdir, cmd, stale=5, grace=2, budget=600,
               max_restarts=2)
    assert res.returncode == 0
    assert "exited cleanly" in (workdir / "watchdog.log").read_text()


def test_hang_is_killed_and_relaunched(workdir):
    # first launch hangs after one heartbeat; relaunches find the
    # marker file and exit cleanly
    script = workdir / "job.py"
    script.write_text(_PUT + textwrap.dedent("""
        put("out.log", "beat")
        put("qtime", os.environ["WL_QTIME"])
        if os.path.exists("ran_once"):
            sys.exit(0)                      # clean on relaunch
        put("ran_once", "x")
        time.sleep(3600)                     # simulated device hang
    """))
    res = _run(workdir, f"{sys.executable} {script}",
               stale=3, grace=5, budget=600, max_restarts=3)
    log = (workdir / "watchdog.log").read_text()
    assert "killing process group" in log
    assert "restarting" in log
    assert "exited cleanly" in log
    assert res.returncode == 0
    assert os.path.exists(workdir / "run_00.log")
    assert os.path.exists(workdir / "run_01.log")
    # each launch got the remaining budget via WL_QTIME
    assert 0 < int((workdir / "qtime").read_text()) < 600


def test_degraded_backend_waits_instead_of_relaunching(workdir):
    # the probe gate must log a wait on a degraded probe and only
    # relaunch once a probe lands in the ok band.  The fake probe is
    # degraded on its first call (no marker yet) and ok afterwards.
    script = workdir / "job.py"
    script.write_text(_PUT + textwrap.dedent("""
        put("out.log", "beat")
        if os.path.exists("ran_once"):
            sys.exit(0)                      # clean on relaunch
        put("ran_once", "x")
        sys.exit(7)                          # crash -> probe gate
    """))
    fake_probe = (
        "if [ -e probe_once ]; then echo PROBE_OP_S 0.1; "
        "else touch probe_once; echo PROBE_OP_S 99.0; fi"
    )
    res = _run(workdir, f"{sys.executable} {script}", probe=True,
               stale=60, grace=5, budget=600, max_restarts=3,
               probe_backoff=1,
               env={"LIVENESS_PROBE_CMD": fake_probe})
    assert res.returncode == 0
    log = (workdir / "watchdog.log").read_text()
    assert "backend probe degraded (op 99.0s): waited" in log
    assert "backend probe ok (op 0.1s); relaunching" in log
    assert "exited cleanly" in log


def test_budget_exhaustion_stops(workdir):
    script = workdir / "job.py"
    script.write_text(
        "import time\nopen('out.log','w').write('b')\n"
        "time.sleep(3600)\n"
    )
    res = _run(workdir, f"{sys.executable} {script}",
               stale=3600, grace=3600, budget=8, max_restarts=1)
    assert res.returncode == 0
    log = (workdir / "watchdog.log").read_text()
    assert "budget" in log


def test_budget_stop_kills_sigterm_immune_grandchild(workdir):
    # the shell wrapper dies on the group SIGTERM so proc.wait()
    # returns, but the grandchild (parked in a native call, its SIGTERM
    # handler unable to run) must not outlive the supervisor: the kill
    # path escalates to SIGKILL on the whole group
    wrapper = workdir / "wrapper.py"
    wrapper.write_text(_PUT + textwrap.dedent(f"""
        import subprocess
        if os.path.exists("ran_once"):
            sys.exit(0)                  # clean on relaunch
        g = subprocess.Popen([
            {sys.executable!r}, "-c",
            "import signal,time;"
            "signal.signal(signal.SIGTERM, signal.SIG_IGN);"
            "time.sleep(3600)",
        ])
        put("grandchild.pid", str(g.pid))
        put("ran_once", "x")
        put("out.log", "beat")
        time.sleep(3600)                 # goes stale; wrapper dies
                                         # on the group SIGTERM, the
                                         # grandchild ignores it
    """))
    res = _run(workdir, f"{sys.executable} {wrapper}",
               stale=3, grace=5, budget=600, max_restarts=3)
    assert res.returncode == 0
    log = (workdir / "watchdog.log").read_text()
    assert "killing process group" in log
    pid = int((workdir / "grandchild.pid").read_text())
    deadline = time.time() + 30
    alive = True
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            alive = False
            break
        time.sleep(0.5)
    assert not alive, "SIGTERM-immune grandchild survived"
