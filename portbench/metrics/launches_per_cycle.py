"""Device launches (kernels, copies, fills) of the traced window over
its cycles (torch.profiler)."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / ctx["cycles"] if t and ctx["cycles"] else None
