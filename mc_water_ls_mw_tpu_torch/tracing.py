"""Spans and counters of the program's layers, off unless enabled.

``span(name)`` marks a stretch of host time (a context manager);
``traced(name)`` does the same for every call of a function;
``wait(site)`` is the span ``mw/wait/<site>`` around a place where the
host blocks on the card (a synchronise, or a copy that waits for the
stream); ``count(name, n)`` adds to a counter.  ``enable()``,
``disable()``, ``reset()`` and ``snapshot()`` control and read the
recorder, which is one per process: spans are recorded on each rank for
that rank, on the thread that runs the cycles.

Off (the default): ``span`` and ``wait`` return one shared no-op
context and ``count`` returns after one flag test.  No clock is read
and nothing is added to the card's stream.

On: every span enters ``torch.profiler.record_function(name)``, so that
under a running profiler it lies in the chrome trace on the profiler's
clock, nested under its parent and beside the kernels it launched; and
it adds to in-memory aggregates per name: the count, the total, the
self time (the span less the time its child spans cover) and the
longest, in nanoseconds of ``time.perf_counter_ns``.  No span
synchronises or touches a tensor, so a run's state is bit for bit the
same with tracing on or off.

``snapshot()`` also reports the kernels' own launch counters (the
``launches`` attribute of each kernel object passed to ``register``)
as ``launches.<kernel>``: the launches since the last ``reset()`` of
the kernel objects still alive.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref

import torch

_on = False


class _Null:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Recorder:
    def __init__(self):
        self.spans = {}         # name -> [count, total, self, max] (ns)
        self.counters = {}
        self.stack = []         # the open spans, innermost last


_rec = _Recorder()
# kernel object -> [name, its launches at the last reset]
_kernels = weakref.WeakKeyDictionary()


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child = 0
        _rec.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        stack = _rec.stack
        if stack and stack[-1] is self:
            stack.pop()
            if stack:
                stack[-1].child += dur
        agg = _rec.spans.get(self.name)
        if agg is None:
            agg = _rec.spans[self.name] = [0, 0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child
        agg[3] = max(agg[3], dur)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` while tracing is on."""
    return _Span(name) if _on else NULL


def wait(site: str):
    """The span ``mw/wait/<site>``: the host blocks on the card here."""
    return _Span("mw/wait/" + site) if _on else NULL


def traced(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    _rec.counters[name] = _rec.counters.get(name, 0) + n


def register(kernel, name: str):
    """Report ``kernel.launches`` (a kernel wrapper's own counter) in
    snapshots as ``launches.<name>``."""
    _kernels[kernel] = [name, kernel.launches]


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


@contextlib.contextmanager
def recording(on: bool = True):
    """Tracing on inside the block where ``on`` (a recorder that was
    off starts empty), and as it was after."""
    was = _on
    if on and not was:
        reset()
        enable()
    try:
        yield
    finally:
        if on and not was:
            disable()


def reset():
    """Forget every span and counter; launches count from here."""
    global _rec
    _rec = _Recorder()
    for k, entry in _kernels.items():
        entry[1] = k.launches


def snapshot() -> dict:
    """{"spans": {name: {count, total_ns, self_ns, max_ns}},
    "counters": {name: n}}, the counters with the kernels' launches
    since the last reset (those of none are left out)."""
    counters = dict(_rec.counters)
    for k, (name, base) in list(_kernels.items()):
        n = k.launches - base
        if n:
            key = "launches." + name
            counters[key] = counters.get(key, 0) + n
    return {
        "spans": {name: dict(zip(("count", "total_ns", "self_ns", "max_ns"),
                                 agg))
                  for name, agg in _rec.spans.items()},
        "counters": counters,
    }
