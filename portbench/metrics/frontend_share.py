"""Share of the traced window the host spends in the front end's ranges
outside the cycle loop: therm samples, the interval events (monitor,
flatness, Delta G) and checkpoints (the harness's ranges around the
app's methods; the app's '# block' lines split the same seconds, but
to 0.1 s)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * t["frontend_s"] / t["window_s"]
