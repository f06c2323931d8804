"""Move attempts per second of the window: walkers x molecules x cycles
over the seconds of the app's blocks (translations, volume moves and
lattice-switch attempts alike: a cycle is N moves of every walker)."""


def read(ctx):
    b = ctx["blocks"]
    return ctx["moves"] / b.total_s if b.total_s > 0 else None
