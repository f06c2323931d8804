"""Seconds from the start of the process to the first timed cycle:
imports, kernel loads (and builds, on a checkout's first run), the
structure, the state and its first energies, and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
