"""Share of the traced window in which no operation ran on the device:
1 - the union of the kernels', copies' and fills' intervals over the
window's length (torch.profiler)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
