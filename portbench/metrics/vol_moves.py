"""Volume moves in the traced window: the growth of the state's own
counter att[1] (every walker shares the cycle's schedule)."""


def read(ctx):
    return ctx["vol_moves"] if ctx["trace"] else None
