"""mu-window stitching for the 'dd' order-parameter decomposition.

Counterpart of ``mc_water_ls_mw_tpu/parallel/windows.py``: the host-side
rebuild of the reference's overlap-matched window joins (comms_join_eta,
comms_mpi.f90:381-459; comms_join_uhist, comms_mpi.f90:299-379).
Windows are consecutive ranges of the bin grid with ``overlap`` shared
bins on each side; curves of adjacent windows are joined by matching
their means over the 2*overlap+1 shared bins: additively for
log-weights, multiplicatively (in log space) for histograms.  numpy
only, O(nbins), run at monitor and Delta G points.
"""

from __future__ import annotations

import numpy as np


def join_eta(window_curves: np.ndarray, nbins: int, overlap: int):
    """Join per-window weight curves [nwin, B] -> [B]: additive overlap
    matching, then the central bin re-zeroed (comms_join_eta,
    comms_mpi.f90:404-450)."""
    curves = np.asarray(window_curves, dtype=np.float64)
    nwin = curves.shape[0]
    bpw = nbins // nwin
    joined = curves[0].copy()
    for w in range(1, nwin):
        end = w * bpw - 1            # 0-based last bin of the windows so far
        sl = slice(end - overlap, end + overlap + 1)
        shift = joined[sl].mean() - curves[w][sl].mean()
        joined[end + 1:] = curves[w][end + 1:] + shift
    joined -= joined[nbins // 2]
    return joined


def join_uhist(window_curves: np.ndarray, nbins: int, overlap: int):
    """Join per-window unbiased histograms [nwin, B] -> [B]: log-space
    mean matching, a multiplicative shift; a non-finite shift (empty
    overlap bins) falls back to no scaling (comms_join_uhist,
    comms_mpi.f90:342-369)."""
    curves = np.asarray(window_curves, dtype=np.float64)
    nwin = curves.shape[0]
    bpw = nbins // nwin
    joined = curves[0].copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        for w in range(1, nwin):
            end = w * bpw - 1
            sl = slice(end - overlap, end + overlap + 1)
            shift = np.log(joined[sl]).mean() - np.log(curves[w][sl]).mean()
            if not np.isfinite(shift):
                shift = 0.0
            joined[end + 1:] = curves[w][end + 1:] * np.exp(shift)
    return joined


def per_window_curves(values: np.ndarray, window_id: np.ndarray, nwin: int):
    """Per-walker arrays [W, B] -> one curve per window [nwin, B]: the
    first walker of each window (after a delta-sync all walkers of a
    window hold the same arrays; the reference has one rank per
    window)."""
    values = np.asarray(values)
    wid = np.asarray(window_id)
    out = np.zeros((nwin, values.shape[1]), dtype=values.dtype)
    for w in range(nwin):
        out[w] = values[np.nonzero(wid == w)[0][0]]
    return out
