"""One run of one cell: the program's normal path, timed and checked.

The cell is found by name: its entry in ``BENCHMARK.json``, its file
``portbench/workloads/<cell>.json`` (configuration, overrides, frozen
inputs, warm-up, limits) and its configuration's file
``portbench/configs/<config>.json`` (the deployment's parameters).
A run

1. copies the cell's frozen ``ice.input`` and weights into a run
   directory under TMPDIR, reads them with the program's
   ``io.namelist.read_input`` (configuration parameters, then the
   cell's overrides, then ``seed``) and sets up
   ``app.Application``, which picks the engine;
2. warms up on the app's own engine past the end of equilibration and
   times a few cycles to size the window, or, for a cell whose file
   has a ``schedule``, runs a window of fixed cycles whose volume moves
   are the same in number for every seed (``schedule.py``);
3. runs the window as one ``Application.run`` call, timed by the app's
   own ``# block`` lines (the final checkpoint falls outside);
4. hands what the window produced to ``check`` once the program is
   freed, and reads the metrics of the cell from their readers,
   ``portbench/metrics/<metric>.py`` (``<quantity>.py`` for a metric
   ``<quantity>.<part>``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import signal
import sys
import tempfile
import time

import torch

from . import check, schedule, work
from .blocklog import read_blocks
from .peaks import PEAKS
from .trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def cell_files(name, root=ROOT):
    """(workload entry, workload file, configuration file) of a cell."""
    bench = manifest(root)
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    wl = _load(os.path.join(root, "portbench", "workloads", name + ".json"))
    cfg = _load(os.path.join(root, cfg_entry["file"]))
    if wl["config"] != entry["config"] or wl["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: workload file and BENCHMARK.json differ")
    return entry, wl, cfg


def cell_metrics(name, trace, root=ROOT):
    """The manifest's metrics that a run of this cell reports."""
    bench = manifest(root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader_path(metric, root=ROOT):
    """The reader of ``metric``: ``metrics/<metric>.py``, or for a
    metric named ``<quantity>.<part>`` (one quantity split by the
    end-to-end metric it moves) the quantity's own
    ``metrics/<quantity>.py``."""
    d = os.path.join(root, "portbench", "metrics")
    own = os.path.join(d, metric + ".py")
    if os.path.isfile(own):
        return own
    return os.path.join(d, metric.split(".")[0] + ".py")


def reader(metric, root=ROOT):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"),
        reader_path(metric, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _hist_total(s):
    m = s.master_hist
    return (m.hi.double() + m.lo.double()).sum(0) + s.hist.double().sum(1)


def _config(s):
    """Each walker's positions [L, W, N, 3] in molecule order and cells
    [L, W, 3, 3]: the reference's layout."""
    r = s.r
    if hasattr(s, "mol2slot"):
        # the cell engine's slab layout: molecules through mol2slot
        idx = s.mol2slot.long()[None].expand(3, -1, -1)
        r = torch.stack([torch.gather(r[l], 1, idx)
                         for l in range(r.shape[0])])
    return (r.permute(0, 3, 2, 1).contiguous(),
            s.h.permute(0, 3, 1, 2).contiguous())


def _outputs(app, start, cycles, per_cycle) -> check.Outputs:
    """What the window produced, beside ``start`` (the configuration
    and counters before it, ``_start``)."""
    s = app.state
    r, h = _config(s)
    energy = s.energy + getattr(s, "energy_err", 0.0)
    return check.Outputs(
        r=r, h=h, energy=energy.clone(), volume=s.volume.clone(),
        mu=s.mu.clone(), att1=s.att.clone(), acc1=s.acc.clone(),
        hist1=_hist_total(s), weight=s.weight.clone(), hist=s.hist.clone(),
        f=s.f.clone(), cycles=cycles, moves_per_cycle=per_cycle, **start)


def _start(s):
    """The configuration and counters at the start of the window; the
    configuration waits on the host, out of the program's memory peak."""
    r0, h0 = _config(s)
    return {"r0": r0.cpu(), "h0": h0.cpu(), "att0": s.att.clone(),
            "acc0": s.acc.clone(), "hist0": _hist_total(s)}


@dataclasses.dataclass
class Result:
    correct: bool
    walkers: int
    failed: int
    checks: list            # [(name, value, limit)]
    metrics: dict           # name -> (value, unit)
    device: dict
    breakdown: dict | None
    control: dict | None = None
    values: dict | None = None     # every number of the comparison
    build_s: float = 0.0    # of setup_s: building or finding the kernels


def run(cell, seed, seconds, trace=False, *, device="cuda", root=ROOT,
        t_start=None, fault=None, with_control=False, resize=None):
    """One run of ``cell``; ``fault(app)`` breaks the program under the
    harness after set-up (the tests' faults), ``resize`` replaces keys
    of the workload file and adds ``params`` to its overrides (the tests'
    CPU sizes), ``with_control`` also reads the control's numbers."""
    from mc_water_ls_mw_tpu_torch.app import Application
    from mc_water_ls_mw_tpu_torch.io.namelist import read_input

    t_start = time.monotonic() if t_start is None else t_start
    entry, wl, cfg = cell_files(cell, root)
    resize = dict(resize or {})
    ov = {**cfg["params"], **wl["overrides"], **resize.pop("params", {}),
          "seed": int(seed)}
    wl = {**wl, **resize}
    ov = {k: tuple(v) if isinstance(v, list) else v for k, v in ov.items()}
    build_s = 0.0
    rundir = tempfile.mkdtemp(prefix=f"portbench-{cell}-")
    cwd = os.getcwd()
    try:
        data = os.path.join(root, wl["data"])
        for f in sorted(os.listdir(data)):
            shutil.copy(os.path.join(data, f), rundir)
        prm = read_input(os.path.join(rundir, "ice.input"),
                         extra_overrides=ov)
        window = seconds
        if trace:
            window = min(seconds, wl.get("trace_seconds", seconds))
        plan = wl.get("schedule")
        if plan is not None:
            # a window of fixed cycles, each seed's holding the same
            # volume moves (schedule.py)
            cycles = max(1, math.ceil(window / plan["cycle_s"]))
            pseed, vol_planned = schedule.program_seed(
                seed, prm, plan["trials_per_cycle"],
                wl["warmup_cycles"] + wl["rate_cycles"], cycles)
            prm = dataclasses.replace(prm, seed=pseed)
        if torch.device(device).type == "cuda":
            # the kernels are built (a checkout's first run) or found
            # before anything is timed, so that the warm-up's rate is
            # the run's
            from mc_water_ls_mw_tpu_torch.cuda_build import build_all

            t_build = time.monotonic()
            build_all()
            build_s = time.monotonic() - t_build
        app = Application(prm, workdir=rundir, device=device).setup()
        dev = app.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if fault is not None:
            fault(app)
        eng = app.engine
        # warm-up past equilibration, then a few timed cycles
        if wl["warmup_cycles"]:
            app.state, _ = eng.run_cycles(app.state, wl["warmup_cycles"])
            _sync(dev)
        t0 = time.monotonic()
        app.state, _ = eng.run_cycles(app.state, wl["rate_cycles"])
        _sync(dev)
        s_per_cycle = (time.monotonic() - t0) / wl["rate_cycles"]
        if plan is None:
            cycles = max(1, math.ceil(window / s_per_cycle))
        per_cycle = int(getattr(eng, "trials_per_cycle", app.prm.nwater))
        s = app.state
        start = _start(s)
        log = os.path.join(rundir, "mc.log")
        offset = os.path.getsize(log)
        tracer = Tracer(app, wl.get("timed_ranges", ())) if trace else None
        _sync(dev)
        setup_s = time.monotonic() - t_start
        if tracer:
            tracer.start()
        app.run(max_cycles=cycles, jit_chunk=wl["jit_chunk"])
        reading = tracer.stop(os.path.join(rundir, "trace.json")) \
            if tracer else None
        blocks = read_blocks(log, offset)
        ran = blocks.cycles
        peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)
        out = _outputs(app, start, cycles, per_cycle)
        runp = {"temperature": app.prm.temperature,
                "pressure_au": app.prm.pressure, "nbins": app.prm.nbins,
                "mu_min": app.prm.mu_min, "mu_max": app.prm.mu_max}
        W, N = app.prm.n_walkers, app.prm.nwater
        itemsize = app.state.r.element_size()
        timed_s = tracer.timed_s if tracer else {}
        app.close()
        # drop every reference to the program's state (the app's SIGTERM
        # handler and the tracer's wrappers hold the app)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        del app, eng, s, tracer, start
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the comparison, with the program freed
        ref = check.reference(out, runp)
        limits = wl["limits"]
        vals, bad = check.numbers(out, ref, runp, limits)
        ok, rows = check.judge(vals, limits)
        ctl = None
        if with_control:
            cvals, _ = check.control(out, ref, runp, limits)
            ctl = {"values": cvals, "correct": check.judge(cvals, limits)[0]}
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        d_att = (out.att1 - out.att0).long()
        ctx = {
            "setup_s": setup_s, "blocks": blocks, "cycles": ran,
            "moves": W * per_cycle * ran, "trace": reading,
            "timed_s": timed_s,
            "vol_moves": int(d_att[1, 0]),
            "ops": work.window_ops(ref.pairs, ref.triplets, N, d_att[0],
                                   d_att[1]),
            "bytes": work.window_bytes(ran, out.r.shape[0], N, W, itemsize),
            "peak": PEAKS.get(name),
        }
        if plan is not None:
            print(f"schedule: program seed {prm.seed}, {cycles} cycles of "
                  f"{per_cycle} trials (planned {plan['trials_per_cycle']}),"
                  f" volume moves planned {vol_planned}, ran "
                  f"{ctx['vol_moves']}", file=sys.stderr)
        metrics = {}
        for m in cell_metrics(cell, trace, root):
            v = reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": entry["chips"],
                   "memory_peak_bytes": int(peak_bytes)}
        breakdown = None
        if reading is not None:
            devinfo["busy_s"] = reading["busy_s"]
            devinfo["window_s"] = reading["window_s"]
            breakdown = {"device_ops": [list(x) for x in
                                        reading["device_ops"]],
                         "idle_gaps": [list(x) for x in
                                       reading["idle_gaps"]]}
        return Result(ok, W, int(bad.sum()), rows, metrics, devinfo,
                      breakdown, ctl, vals, build_s)
    finally:
        os.chdir(cwd)
        shutil.rmtree(rundir, ignore_errors=True)
