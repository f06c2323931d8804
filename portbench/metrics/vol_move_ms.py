"""Milliseconds of wall time a scheduled volume move takes: the traced
window's time inside the engine's scheduled volume moves (a range
synchronised at both ends: the cell's ``timed_ranges``) over the volume
moves it made."""


def read(ctx):
    t, n = ctx["timed_s"].get("volume_moves"), ctx["vol_moves"]
    if t is None or n <= 0:
        return None
    return 1000.0 * t / n
