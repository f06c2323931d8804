"""Trials per second of the window: the cell engine's trials of a cycle
x walkers x cycles over the seconds of the app's blocks."""


def read(ctx):
    b = ctx["blocks"]
    return ctx["moves"] / b.total_s if b.total_s > 0 else None
