"""The window's least time over the device's busy time, in percent.

The least time is the slower of the moves' operations at the card's
float32 peak and the walker state's bytes at its memory bandwidth,
counted from the physics (portbench/work.py, from the reference's own
neighbour search of the walkers' positions), so that the count does not
change with the kernel or branch that does the work.  No reading without
a trace, a busy device or a card in the table of peaks."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench.work import least_seconds  # noqa: E402


def read(ctx):
    t, pk = ctx["trace"], ctx["peak"]
    if not t or t["busy_s"] <= 0 or pk is None:
        return None
    return 100.0 * least_seconds(ctx["ops"], ctx["bytes"], pk) / t["busy_s"]
