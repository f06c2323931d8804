"""The program's own spans in a traced run, read from the same
chrome-trace events and over the same window as ``trace.read_trace``.

The port records spans (``mc_water_ls_mw_tpu_torch.tracing``, names
``mw/...``, ``mw/wait/<site>`` where the host blocks on the card) as
``record_function`` ranges once its tracing is enabled.  ``read_spans``
gives each range name its count, host seconds and the device launches
(kernels, copies, fills) it holds: a launch belongs to every range whose
host interval holds the CUDA runtime call that launched it (the events'
``correlation`` id).  ``host_syncs`` lists the runtime calls in the
window that block the host and whether a ``mw/wait/*`` range holds
each; ``quantities`` gives the per-layer numbers read from them.

    python3 portbench/spans.py --workload <cell> --seed <n> \
        --seconds <s> [--trace 0|1] [--tracing 0|1] [--timed 0|1]

runs one cell once through ``harness.run`` with the program's tracing
enabled (``--tracing 1``, the default) or not, and prints one JSON line:
the run's ``correct``, end-to-end and (``--trace 1``) per-layer metrics
and breakdown, the program's counters and, with ``--trace 1``, the span
quantities, the spans that took most host time and the blocking calls
outside every ``mw/wait/*`` range.  ``--timed 0`` drops the cell's
``timed_ranges`` (whose synchronises are the harness's, not the
program's).  The counters are the whole run's (set-up and warm-up
included) and, in ``window_counters``, the traced window's.
``--tracing 1 --trace 0`` against ``--tracing 0 --trace 0`` on one seed
is what tracing costs when on.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

T_START = time.monotonic()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls that return only once the card (or a stream) has caught
# up: the synchronises and the synchronous copies
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize",
              "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH_v2",
              "cuMemcpyHtoD_v2")
WAIT = "mw/wait/"


def _ranges(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def window(events):
    """(w0, w1) in microseconds, as ``trace.read_trace`` takes it: from
    the first ``run_cycles`` range to the start of the last
    ``checkpoint`` range (the final one); None without a loop."""
    ranges = _ranges(events)
    loops = [e["ts"] for e in ranges if e["name"] == "run_cycles"]
    if not loops:
        return None
    ckpt = [e["ts"] for e in ranges if e["name"] == "checkpoint"]
    w1 = max(ckpt) if ckpt else max(e["ts"] + e["dur"] for e in ranges)
    return min(loops), w1


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def read_spans(events):
    """{"window_s", "wait_s", "spans": {name: {"count", "host_s",
    "launches"}}} of the ranges that start in the window; ``wait_s`` is
    the union of the ``mw/wait/*`` ranges' host time.  None without a
    window."""
    w = window(events)
    if w is None:
        return None
    w0, w1 = w
    calls = {_corr(e): e["ts"] for e in events
             if e.get("cat") in RUNTIME_CATS and _corr(e) is not None}
    launched = sorted(calls[_corr(e)] for e in events
                      if e.get("ph") == "X" and e.get("cat") in KERNEL_CATS
                      and w0 <= e["ts"] < w1 and _corr(e) in calls)
    spans, waits = {}, []
    for e in _ranges(events):
        if not w0 <= e["ts"] < w1:
            continue
        a, b = e["ts"], min(w1, e["ts"] + e["dur"])
        n = (bisect.bisect_right(launched, e["ts"] + e["dur"])
             - bisect.bisect_left(launched, a))
        row = spans.setdefault(e["name"], {"count": 0, "host_s": 0.0,
                                           "launches": 0})
        row["count"] += 1
        row["host_s"] += (b - a) * 1e-6
        row["launches"] += n
        if e["name"].startswith(WAIT):
            waits.append((a, b))
    wait_us, end = 0.0, None
    for a, b in sorted(waits):
        if end is not None and a < end:
            a = end
        if b > a:
            wait_us += b - a
            end = b
    return {"window_s": (w1 - w0) * 1e-6, "wait_s": wait_us * 1e-6,
            "spans": spans}


def host_syncs(events):
    """[(call, innermost range open at it, inside a mw/wait/* range)] of
    the blocking runtime calls in the window."""
    w = window(events)
    if w is None:
        return []
    w0, w1 = w
    ranges = sorted(_ranges(events), key=lambda e: (e["ts"], -e["dur"]))
    out = []
    for e in events:
        if e.get("cat") not in RUNTIME_CATS or e.get("name") not in \
                SYNC_CALLS or not w0 <= e["ts"] < w1:
            continue
        open_ = [r for r in ranges
                 if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        inner = open_[-1]["name"] if open_ else None
        out.append((e["name"], inner,
                    any(r["name"].startswith(WAIT) for r in open_)))
    return out


def quantities(reading, snapshot):
    """The per-layer numbers of the program's spans: host seconds in
    ``mw/wait/*`` ranges over the window's (%), launches a volume move
    and a sub-step, and the set-up's seconds (``mw/setup`` of
    ``tracing.snapshot()``); a number with nothing to read is left
    out."""
    out = {}
    if reading and reading["window_s"] > 0:
        out["host_wait_share"] = 100.0 * reading["wait_s"] / \
            reading["window_s"]
        for key, name in (("vol_move_launches", "mw/volume_move"),
                          ("substep_launches", "mw/substep")):
            row = reading["spans"].get(name)
            if row and row["count"]:
                out[key] = row["launches"] / row["count"]
    setup = ((snapshot or {}).get("spans") or {}).get("mw/setup")
    if setup:
        out["app_setup_s"] = setup["total_ns"] * 1e-9
    return out


def traced_run(cell, seed, seconds, trace=True, on=True, timed=True,
               t_start=None, **kw):
    """One run of ``cell`` through ``harness.run`` (``kw`` its other
    arguments) with the program's tracing on (``on``) or not: the result
    line of ``main``."""
    from mc_water_ls_mw_tpu_torch import tracing
    from portbench import harness
    from portbench import trace as tr

    seen = {}
    read_trace, start = tr.read_trace, tr.Tracer.start

    def at_start(tracer):
        # the counters as the window opens
        seen["before"] = tracing.snapshot()["counters"]
        start(tracer)

    def keep(events, top=10):
        # the window's events, and the launch counters while the
        # program's kernels are alive
        seen["events"] = events
        seen["snapshot"] = tracing.snapshot()
        return read_trace(events, top)

    if not timed:
        kw["resize"] = {**kw.get("resize", {}), "timed_ranges": []}
    tr.read_trace, tr.Tracer.start = keep, at_start
    try:
        with tracing.recording(on):
            res = harness.run(cell, seed, seconds, trace, t_start=t_start,
                              **kw)
            snap = seen.get("snapshot") or tracing.snapshot()
    finally:
        tr.read_trace, tr.Tracer.start = read_trace, start
    before = seen.get("before", {})
    line = {"correct": res.correct,
            "metrics": {k: v for k, (v, _) in res.metrics.items()},
            "device": res.device, "tracing": int(on),
            "counters": snap["counters"],
            "window_counters": {k: v - before.get(k, 0)
                                for k, v in snap["counters"].items()},
            "breakdown": res.breakdown}
    events = seen.get("events")
    if events is not None:
        reading = read_spans(events)
        line["spans"] = quantities(reading, snap)
        line["top_spans"] = sorted(
            ([k, round(v["host_s"], 6), v["count"], v["launches"]]
             for k, v in reading["spans"].items()),
            key=lambda x: -x[1])[:40]
        syncs = host_syncs(events)
        line["syncs"] = len(syncs)
        stray = {}
        for call, inner, ok in syncs:
            if not ok:
                key = f"{call} in {inner}"
                stray[key] = stray.get(key, 0) + 1
        line["stray_syncs"] = stray
    if snap["spans"].get("mw/setup"):
        line["setup_spans"] = {
            k: v["total_ns"] * 1e-9 for k, v in snap["spans"].items()
            if k.startswith("mw/setup")}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--timed", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import _env

    _env()
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    line = traced_run(args.workload, args.seed, args.seconds,
                      bool(args.trace), bool(args.tracing), bool(args.timed),
                      t_start=T_START)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
