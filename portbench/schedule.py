"""The same work for every seed: the volume moves of a cell engine run.

The cell engine draws each cycle's move types, shared by all walkers,
from a CPU ``torch.Generator`` seeded with the run's ``seed``
(``PhiloxStream.sched``): on every ``list_update_int``-th cycle three
uniforms for the rebin's grid origin, then one uniform a trial, a trial
being a volume move where ``trans_p <= u < vol_p``
(``RunParams.normalised_probs``).  So the count of volume moves in a
window is a binomial draw of the seed.  At N=8064 each volume move is a
from-scratch energy of every walker's two cells, most of a cycle's
time, and that count would spread the rate over seeds by ~7% (IQR).

``program_seed`` gives the program, instead of ``--seed`` itself, the
first seed of a sequence drawn from ``--seed`` whose schedule holds the
expected count, rounded, both in the warm-up's cycles and in the
window's: every seed does the same work, in another order.  The
schedule is replicated here from the seed alone; the run reports the
volume moves the window planned beside those the program's counters
show it ran.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_TRIES = 1_000_000


def volume_counts(seed, probs, trials, list_update_int, first, last,
                  dtype=torch.float32):
    """Volume moves of cycles 1..``last`` (one count a cycle) that the
    schedule of ``seed`` draws; ``None`` once cycles 1..``first`` miss
    (``first`` = (cycle, count wanted))."""
    trans_p, vol_p = probs[0], probs[1]
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    counts = []
    for c in range(1, last + 1):
        if c % list_update_int == 0:
            torch.rand((3,), generator=g, dtype=dtype)
        u = torch.rand((trials,), generator=g, dtype=dtype)
        counts.append(int(((u >= trans_p) & (u < vol_p)).sum()))
        if first is not None and c == first[0] and sum(counts) != first[1]:
            return None
    return counts


def program_seed(seed, prm, trials, warm, cycles):
    """(the program's seed, volume moves of the window) for a run of
    ``warm`` warm-up cycles and then ``cycles`` window cycles of
    ``trials`` trials each, under ``prm`` (the run's parameters)."""
    probs = prm.normalised_probs()
    p_vol = probs[1] - probs[0]
    want_warm = round(warm * trials * p_vol)
    want = round(cycles * trials * p_vol)
    dtype = getattr(torch, prm.dtype)
    for k in range(MAX_TRIES):
        cand = int(np.random.SeedSequence([int(seed), k])
                   .generate_state(1)[0])
        counts = volume_counts(cand, probs, trials, prm.list_update_int,
                               (warm, want_warm) if warm else None,
                               warm + cycles, dtype)
        if counts is not None and sum(counts[warm:]) == want:
            return cand, want
    raise RuntimeError(f"no schedule with {want} volume moves in "
                       f"{MAX_TRIES} seeds")
