"""How ``correct`` is decided: what the window produced, against the plain
reference, once the window has closed and the program is freed.

The program hands over (``Outputs``) each walker's positions and cells
of both lattices, its tracked energies (the cell engine's compensated
pair summed), volumes and order parameter, its move counters and the WL
and histogram arrays, before and after the window.  The reference
recomputes from the positions and cells alone, in float64:

* ``e_gap_ev``: the largest gap, over walkers and lattices, between the
  tracked energy and the reference's (eV).  It covers the step kernels'
  energy deltas and the whole-cell energies of the volume moves, whose
  accepted values the later translations carry on.
* ``mu_gap``: the largest gap between the tracked mu and mu from the
  reference's energies and volumes.
* ``vol_gap``: the largest relative gap between a tracked volume and
  |det h| of its cell.
* ``bin_moved``: walkers whose mu bin (the reference's grid) differs
  from that of the reference's mu, of those farther than the mu limit
  from a bin edge (exact: 0).
* ``moves_short``: walkers that did not attempt every move of every
  cycle of the window: translations and volume moves together, against
  the cycles the window ran times the moves of a cycle (exact: 0).
* ``hist_gap``: the histogram's growth over the window, each bin's
  count times its width over the mean width (one count a move), against
  the moves attempted; relative.
* ``eta_gap`` (Wang-Landau runs): each walker's weight growth since the
  last merge against its factor f times its histogram growth; the
  largest relative gap.
* ``stuck``: walkers whose configuration (positions and cell of every
  lattice) is the one they started the window with (exact: 0).
* ``acc_trans``, ``acc_vol``, ``acc_switch``: the window's accepted over
  attempted moves of each kind, summed over walkers; each held inside a
  [low, high] range between what sound runs read and what a chain reads
  that rejects every move (0) or accepts every move its walls let
  through (``portbench/faults.py``).

The control puts the reference in the program's place, computed in
bfloat16 (the nearest precision below the float32 the configurations
state), and is judged by the same numbers: its energies, volumes and mu
of the final configurations, and the window's histogram and weight
growth accumulated one visit at a time in bfloat16 (the visits of each
bin as the program's histogram counts them; the weight against the
program's histogram, the histogram against the move counters).  The
move counters and the bins of walkers far from an edge are exact
comparisons (limit 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference.mc import (EV_PER_HARTREE, BinEdges, order_parameter,
                           volume)
from .reference.sw import sw_terms


@dataclasses.dataclass
class Outputs:
    r: torch.Tensor          # [L, W, N, 3] cartesian
    h: torch.Tensor          # [L, W, 3, 3]
    r0: torch.Tensor         # [L, W, N, 3] before the window (host)
    h0: torch.Tensor         # [L, W, 3, 3] before the window (host)
    energy: torch.Tensor     # [L, W] tracked
    volume: torch.Tensor     # [L, W] tracked
    mu: torch.Tensor         # [W] tracked
    att0: torch.Tensor       # [3, W] before the window
    att1: torch.Tensor       # [3, W] after
    acc0: torch.Tensor       # [3, W] accepted, before the window
    acc1: torch.Tensor       # [3, W] after
    hist0: torch.Tensor      # [B] float64 total histogram before
    hist1: torch.Tensor      # [B] after
    weight: torch.Tensor     # [B, W] weight growth since the last merge
    hist: torch.Tensor       # [B, W] histogram growth since the last merge
    f: torch.Tensor          # [W] WL factor
    cycles: int              # cycles the window ran
    moves_per_cycle: int     # move attempts of a walker in a cycle


@dataclasses.dataclass
class Reference:
    energy: torch.Tensor     # [L, W] float64
    volume: torch.Tensor     # [L, W]
    mu: torch.Tensor         # [W]
    pairs: torch.Tensor      # [L, W]
    triplets: torch.Tensor   # [L, W]


def reference(out: Outputs, run, dtype=torch.float64) -> Reference:
    """The reference's energies, volumes and mu of the program's final
    configurations, lattice by lattice, in ``dtype``."""
    L = out.r.shape[0]
    terms = [sw_terms(out.r[l], out.h[l], dtype=dtype) for l in range(L)]
    e = torch.stack([t.energy.to(dtype) for t in terms])
    v = torch.stack([volume(out.h[l].to(dtype)) for l in range(L)])
    mu = order_parameter(e, v, out.r.shape[2], run["temperature"],
                         run["pressure_au"])
    return Reference(e.double(), v.double(), mu.double(),
                     torch.stack([t.pairs for t in terms]),
                     torch.stack([t.triplets for t in terms]))


def accumulate(count, x, dtype):
    """The sum of ``count`` additions of ``x`` (tensors of one shape),
    one at a time in ``dtype``, returned in float64.  In a low precision
    a sum stops growing once x falls under half its spacing; the loop
    ends there."""
    count = torch.round(count.double())
    x = x.to(dtype)
    s = torch.zeros_like(x)
    k = torch.zeros_like(count)
    while True:
        live = k < count
        if not bool(live.any()):
            return s.double()
        nxt = torch.where(live, s + x, s)
        if bool((nxt == s)[live].all()):
            return s.double()
        s = nxt
        k = k + live.double()


def numbers(out: Outputs, ref: Reference, run, limits,
            energy=None, vol=None, mu=None, held=None):
    """Every number of the comparison and the per-walker failures [W]
    bool.  ``energy``, ``vol``, ``mu``: the values judged, the
    program's by default, the control's in its place.  ``held``: a
    precision to accumulate the window's histogram and weight growth in,
    one visit at a time, in place of the program's (the control)."""
    energy = out.energy.double() if energy is None else energy
    vol = out.volume.double() if vol is None else vol
    mu = out.mu.double() if mu is None else mu
    vdet = torch.stack([volume(out.h[l].double())
                        for l in range(out.h.shape[0])])
    e_w = (energy - ref.energy).abs().amax(0) * EV_PER_HARTREE
    mu_w = (mu - ref.mu).abs()
    v_w = ((vol - vdet).abs() / vdet).amax(0)
    grid = BinEdges(run["nbins"], run["mu_min"], run["mu_max"])
    mu_ref = ref.mu.cpu().numpy()
    far = grid.edge_distance(mu_ref) > limits.get("mu_gap", 0.0)
    moved = far & (grid.index(mu.cpu().numpy()) != grid.index(mu_ref))
    d_att = (out.att1 - out.att0).long()
    d_acc = (out.acc1 - out.acc0).long()
    same = ((out.r == out.r0.to(out.r.device)).flatten(2).all(2)
            & (out.h == out.h0.to(out.h.device)).flatten(2).all(2)).all(0)
    tried = d_att[0] + d_att[1]
    short = tried != out.cycles * out.moves_per_cycle
    widths = torch.as_tensor(grid.widths / grid.widths.mean(),
                             device=out.hist1.device)
    incr = 1.0 / widths                        # a visit's count in a bin
    growth = out.hist1 - out.hist0
    weight, hist = out.weight.double(), out.hist.double()
    if held is not None:
        growth = accumulate(growth / incr, incr, held)
        weight = accumulate(hist / incr[:, None],
                            out.f.double()[None, :] * incr[:, None], held)
    counted = float((growth * widths).sum())
    n_tried = float(tried.sum())
    vals = {
        "e_gap_ev": float(e_w.max()),
        "mu_gap": float(mu_w.max()),
        "vol_gap": float(v_w.max()),
        "bin_moved": int(moved.sum()),
        "moves_short": int(short.sum()),
        "hist_gap": abs(counted - n_tried) / max(n_tried, 1.0),
        "stuck": int(same.sum()),
    }
    for i, kind in enumerate(("acc_trans", "acc_vol", "acc_switch")):
        n = int(d_att[i].sum())
        vals[kind] = int(d_acc[i].sum()) / n if n else None
    grown = out.f.double() * hist.sum(0)
    if bool((grown > 0).any()):
        gap = (weight.sum(0) - grown).abs()
        vals["eta_gap"] = float((gap / grown.clamp(min=1e-300))
                                [grown > 0].max())
    bad = short.cpu() | same.cpu() | torch.as_tensor(moved)
    for name, per in (("e_gap_ev", e_w), ("mu_gap", mu_w),
                      ("vol_gap", v_w)):
        if name in limits:
            bad |= (per > limits[name]).cpu()
    return vals, bad


def within(v, lim):
    """``v`` under its bound, or inside its [low, high] range."""
    if v is None or not np.isfinite(v):
        return False
    if isinstance(lim, (list, tuple)):
        return lim[0] <= v <= lim[1]
    return v <= lim


def judge(vals, limits):
    """(correct, [(name, value, limit)]) over the numbers the cell
    limits; a limited number that the run could not read fails."""
    rows = [(k, vals.get(k), lim) for k, lim in limits.items()]
    return all(within(v, lim) for _, v, lim in rows), rows


def control(out: Outputs, ref: Reference, run, limits):
    """The reference in the program's place, in bfloat16: its energies,
    volumes and mu, and the window's histogram and weight growth
    accumulated visit by visit in bfloat16."""
    low = reference(out, run, dtype=torch.bfloat16)
    return numbers(out, ref, run, limits, energy=low.energy,
                   vol=low.volume, mu=low.mu, held=torch.bfloat16)
