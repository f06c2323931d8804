"""The traced run: host ranges put around the program's layers from the
benchmark's own code, torch.profiler over the window, and the reading
of its trace.

Ranges (``record_function``, innermost wins when an idle gap is
labelled): ``run_cycles`` (the engine's cycle loop), ``volume_moves``
(the scheduled volume moves), ``therm``, ``wl_monitor`` (the interval
events), ``checkpoint``.  A range the cell names in ``timed`` is
synchronised at both ends, so that its wall time is its own (the
synchronisation costs the device some idle time, so only cells that
read that time ask for it).  The window runs from the first
``run_cycles`` to the final checkpoint, which lies outside it.
"""

from __future__ import annotations

import json
import os
import time

import torch

KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


FRONT_END = ("therm", "wl_monitor", "checkpoint")


class Tracer:
    def __init__(self, app, timed=()):
        self.timed_s = {label: 0.0 for label in timed}
        self.prof = None
        self._cuda = app.device.type == "cuda"
        eng = app.engine
        self._wrap(eng, "run_cycles", "run_cycles")
        self._wrap(eng, "_scheduled_volume_moves", "volume_moves")
        self._wrap(app, "_write_therm", "therm")
        self._wrap(app, "_events", "wl_monitor")
        self._wrap(app, "_checkpoint", "checkpoint")

    def _wrap(self, obj, attr, label):
        orig = getattr(obj, attr)
        timed = label in self.timed_s
        sync = torch.cuda.synchronize if self._cuda else (lambda: None)

        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                if not timed:
                    return orig(*a, **k)
                sync()
                t0 = time.monotonic()
                try:
                    return orig(*a, **k)
                finally:
                    sync()
                    self.timed_s[label] += time.monotonic() - t0

        setattr(obj, attr, wrapped)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self, path):
        self.prof.stop()
        self.prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        return read_trace(events)


def _short(name, n=120):
    """A kernel's name without PyTorch's namespaces, cut to n letters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:n]


def _union(iv):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges):
    """[(start, end, name)] in time order: the innermost open range of
    each stretch (the ranges nest on the one host thread)."""
    marks = sorted([(e["ts"] + e["dur"], 0, i) for i, e in enumerate(ranges)]
                   + [(e["ts"], 1, i) for i, e in enumerate(ranges)])
    segs, stack, t = [], [], None
    for when, start, i in marks:
        if stack and t is not None and when > t:
            segs.append((t, when, ranges[stack[-1]]["name"]))
        if start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        t = when
    return segs


def read_trace(events, top=10):
    """The window's device reading from chrome-trace events (times in
    microseconds): busy and window seconds, launches, the device
    operations that took most time and the idle gaps by what the host
    was doing, and the host seconds of the front end's ranges."""
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    loops = [e for e in ranges if e["name"] == "run_cycles"]
    if not loops:
        return None
    w0 = min(e["ts"] for e in loops)
    ckpt = [e["ts"] for e in ranges if e["name"] == "checkpoint"]
    w1 = max(ckpt) if ckpt else max(e["ts"] + e["dur"] for e in ranges)
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in KERNEL_CATS
            and w0 <= e["ts"] < w1]
    busy = _union([(e["ts"], min(w1, e["ts"] + e["dur"])) for e in kern])
    busy_us = sum(b - a for a, b in busy)
    ops = {}
    for e in kern:
        name = _short(e["name"])
        ops[name] = ops.get(name, 0.0) + e["dur"] * 1e-6
    # idle gaps, each split by the innermost host range open in it
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    segs = _innermost(ranges)
    idle, k = {}, 0
    for a, b in zip(edges[0::2], edges[1::2]):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while a < b:
            if j < len(segs) and segs[j][0] <= a:
                end, label = min(b, segs[j][1]), segs[j][2]
                j += 1
            else:
                end = min(b, segs[j][0]) if j < len(segs) else b
                label = "other"
            idle[label] = idle.get(label, 0.0) + (end - a) * 1e-6
            a = end
    front = sum(min(w1, e["ts"] + e["dur"]) - e["ts"] for e in ranges
                if e["name"] in FRONT_END and w0 <= e["ts"] < w1)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "frontend_s": front * 1e-6,
        "busy_s": busy_us * 1e-6,
        "launches": len(kern),
        "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:top],
    }
