"""Host-side Wang-Landau events: monitoring, flatness, Delta G.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/wanglandau.py`` (the
reference's interval-driven bookkeeping: mc_monitor_stats,
mc_check_flatness, mc_compute_deltaG_from_hist, mc_moves.F90:1691-2621)
for either parallel strategy: one window shared by all walkers ('mw'),
or a master row per mu window ('dd'), whose curves are written per
window and stitched with the overlap matching of comms_join_eta/uhist
(parallel/windows.py).  They run at block boundaries on the host: file
IO and O(nbins) scalar work on pulled arrays, in float64.  The 1/t and
Swetnam schedules of the flatness check are not ported: the engine
refuses ``wl_useinvt`` and ``wl_swetnam``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..constants import BOHR_TO_ANG, HART_TO_EV, HART_TO_KJPM, KB
from ..io import writers
from ..ops.dsfloat import ds_from64, ds_value64
from ..parallel.windows import join_eta, join_uhist
from .bins import BinGrid
from .config import RunParams
from .engine import SWITCH, TRANS, VOL


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _window_bounds(state, nwin: int):
    """Per-window (start_bin [nwin], end_bin [nwin], first walker
    [nwin]): the bounds of each window's first walker (all walkers of a
    window share them)."""
    wid = _np(state.window_id)
    first = np.array([np.nonzero(wid == w)[0][0] for w in range(nwin)])
    return _np(state.start_bin)[first], _np(state.end_bin)[first], first


def monitor_stats(eng, state, logs, aux, write_files=True):
    """Acceptance report, step-size adaptation, energy and mu drift
    audit, curve dumps (mc_monitor_stats, mc_moves.F90:1691-1934)."""
    prm, grid = eng.prm, eng.grid
    cycle = int(state.cycle)
    att = _np(state.att).astype(np.float64)              # [3,W]
    acc = _np(state.acc).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratios = acc / att                   # [3,W], NaN where untried

    # step-size adaptation toward the target acceptance ratio
    # (mc_monitor_stats:1729-1732), per walker
    if prm.eq_adjust_mc and cycle < prm.eq_mc_cycles:
        atr = np.nan_to_num(ratios[TRANS], nan=1.0)
        avr = np.nan_to_num(ratios[VOL], nan=1.0)
        max_trans = np.maximum(
            _np(state.max_trans) * atr / prm.mc_target_ratio, 0.1)
        dv_max = np.maximum(
            _np(state.dv_max) * avr / prm.mc_target_ratio, 0.0001)
        state.max_trans = torch.as_tensor(
            max_trans, dtype=state.max_trans.dtype,
            device=state.max_trans.device)
        state.dv_max = torch.as_tensor(
            dv_max, dtype=state.dv_max.dtype, device=state.dv_max.device)

    def pct(i):
        return 100.0 * np.nansum(acc[i]) / max(np.nansum(att[i]), 1)

    logs.my("#")
    logs.my(f"# Monte-Carlo statistics at cycle {cycle:10d}")
    logs.my("# " + "-" * 60)
    if prm.allow_trans:
        logs.my(f"# Accepted {pct(TRANS):8.2f} % of "
                f"{int(att[TRANS].sum()):10d} translation moves")
        tpm = _np(state.trans_per_mol)
        logs.my(f"# Translations per molecule: avg "
                f"{tpm.mean():10.1f} min {tpm.min():6d} max {tpm.max():6d}")
    if prm.mc_ensemble == "npt":
        logs.my(f"# Accepted {pct(VOL):8.2f} % of "
                f"{int(att[VOL].sum()):10d} box moves")
    if prm.allow_switch or prm.mc_always_switch:
        logs.my(f"# Accepted {pct(SWITCH):8.2f} % of "
                f"{int(att[SWITCH].sum()):10d} lattice switches")
    if prm.eq_adjust_mc and cycle < prm.eq_mc_cycles:
        logs.my(f"# Max molecule translation: "
                f"{_np(state.max_trans).mean() * BOHR_TO_ANG:12.6f} Ang")
        logs.my(f"# Max cell displacement  : "
                f"{_np(state.dv_max).mean() * BOHR_TO_ANG:12.6f} Ang")

    # average excitation energy per degree of freedom
    # (mc_monitor_stats:1766-1772)
    avg_e = _np(state.avg_energy) / prm.monitor_int          # [L,W]
    ref_h = _np(aux.ref_enthalpy)
    for l in range(prm.num_lattices):
        exc = (avg_e[l].mean() - ref_h[l]) / (
            KB * prm.temperature * 3 * prm.nwater)
        logs.my(f"# lattice {l + 1} = {exc:15.6f} kT per D.O.F.")

    # overlap bins spanned per move (mc_monitor_stats:1776-1777)
    span = grid.nbins / (prm.mu_max - prm.mu_min)
    mn = _np(state.min_dmu)
    mx = _np(state.max_dmu)
    mn = mn[np.isfinite(mn)]
    if mn.size:
        logs.my(f"# Overlap bins spanned per move: min "
                f"{mn.min() * span:12.6f} max {mx.max() * span:12.6f}")

    # delta-sync health: entries zeroed by the non-finite guard
    n_drop = int(state.dropped)
    if n_drop > 0:
        logs.my(f"# WARNING: delta-sync dropped {n_drop} non-finite "
                "weight/histogram entries (poisoned walker?)")

    # energy drift audit + heal (mc_monitor_stats:1781-1792)
    state, drift = eng.audit_energy(state)
    drift = _np(drift) * HART_TO_EV                           # [L,W]
    e_now = _np(state.energy) * HART_TO_EV
    for l in range(prm.num_lattices):
        logs.my(f"#  latt {l + 1}  stored "
                f"{e_now[l].mean() + drift[l].mean():12.6f} eV"
                f"  computed {e_now[l].mean():12.6f} eV"
                f"  max drift {np.abs(drift[l]).max():12.3e} eV")

    # mu drift audit + heal: mu is the binning variable, so a
    # differential energy error walks the histogram assignment between
    # resyncs; reported in bin units and healed at monitor cadence
    mu_fresh = eng._mu_scratch(state.energy, state.volume)
    dmu = _np(state.mu).astype(np.float64) - _np(mu_fresh)
    mub = np.asarray(grid.mu_bin)
    binw = float(mub[1] - mub[0])
    logs.my(f"#  mu   drift {np.abs(dmu).max():12.3e} kT max "
            f"({np.abs(dmu).max() / binw:8.4f} bins); healed")
    state.mu = mu_fresh.to(state.mu.dtype)

    # per-window statistics ('dd'): the reference's per-rank nodeNNN.log
    # blocks (io.f90:1105-1144) as one row per window
    nwin = state.master_eta.hi.shape[0]
    if prm.parallel_strategy == "dd" and nwin > 1:
        wid = _np(state.window_id)
        inw = _np(state.in_window)
        mu_w = _np(state.mu).astype(np.float64)
        f_all = _np(state.f).astype(np.float64)
        logs.my("# window  walkers in-win acc-tr%  acc-sw%"
                "            f  max|drift|eV           mu range")
        for w in range(nwin):
            m = wid == w
            if not m.any():
                continue
            at = 100.0 * acc[TRANS][m].sum() / max(att[TRANS][m].sum(), 1.0)
            asw = 100.0 * acc[SWITCH][m].sum() / max(att[SWITCH][m].sum(),
                                                     1.0)
            logs.my(
                f"# win{w:4d} {int(m.sum()):8d} {int(inw[m].sum()):6d}"
                f" {at:7.2f} {asw:8.2f} {f_all[m].max():12.3e}"
                f" {float(np.abs(drift[:, m]).max()):13.3e}"
                f" [{mu_w[m].min():9.1f},{mu_w[m].max():9.1f}]")

    # reset accumulators (mc_monitor_stats:1797-1810)
    state.att = torch.zeros_like(state.att)
    state.acc = torch.zeros_like(state.acc)
    state.trans_per_mol = torch.zeros_like(state.trans_per_mol)
    state.avg_energy = torch.zeros_like(state.avg_energy)
    state.min_dmu = torch.full_like(state.min_dmu, float("inf"))
    state.max_dmu = torch.zeros_like(state.max_dmu)

    # curve dumps (mc_monitor_stats:1813-1929): after the delta-sync the
    # double-single master rows hold the exact merged curves, one row per
    # window (the reference's per-rank curves)
    if write_files:
        state = eng.merged_histogram(state)
        f_all = _np(state.f)
        w_cur = ds_value64(state.master_eta)                 # [nwin, B]
        h_cur = ds_value64(state.master_hist)
        u_cur = ds_value64(state.master_uhist)
        if prm.parallel_strategy == "mw" or nwin == 1:
            wl_f = float(f_all.max())
            if not prm.samplerun:
                writers.write_curve("eta_weights.dat", mub, w_cur[0], wl_f)
            writers.write_curve("histogram.dat", mub, h_cur[0], wl_f)
            writers.write_curve("unbiased_histogram.dat", mub, u_cur[0],
                                wl_f)
        else:
            wid = _np(state.window_id)
            sbw, ebw, _ = _window_bounds(state, nwin)
            for w in range(nwin):
                s, e = sbw[w], ebw[w] + 1
                fv = float(f_all[wid == w].max())
                writers.write_curve(f"eta_weights_{w:03d}.dat", mub[s:e],
                                    w_cur[w][s:e], fv)
                writers.write_curve(f"histogram_{w:03d}.dat", mub[s:e],
                                    h_cur[w][s:e], fv)
                writers.write_curve(f"unbiased_histogram_{w:03d}.dat",
                                    mub[s:e], u_cur[w][s:e], fv)
            # the stitched global weight curve with the largest f of the
            # windows (mc_monitor_stats:1881-1900)
            writers.write_curve(
                "eta_weights.dat", mub,
                join_eta(w_cur, grid.nbins, prm.window_overlap),
                float(f_all.max()))
            if prm.samplerun:
                writers.write_curve(
                    "unbiased_histogram.dat", mub,
                    join_uhist(u_cur, grid.nbins, prm.window_overlap), 0.0)
    return state


def check_flatness(eng, state, logs):
    """Histogram flatness check and the f schedule (mc_check_flatness,
    mc_moves.F90:1936-2185).  All growth is folded into the
    double-single master rows first; the decision is made per window on
    the exact float64 view of its row, over its own bins, and broadcast
    to the window's walkers (first-pass reset, f halving, firstcycle).
    One window ('mw') also shifts the weights by the central bin and
    writes the f-tagged curves; several ('dd') record the largest f of
    the windows before and after the event's halvings in wlf.dat."""
    prm, grid = eng.prm, eng.grid
    B = grid.nbins
    cycle = int(state.cycle)
    if prm.samplerun:
        return state

    state = eng.merged_histogram(state)   # (mc_check_flatness:1965-1967)
    hist_w = ds_value64(state.master_hist)                  # [nwin, B]
    weight_w = ds_value64(state.master_eta)
    if hist_w.sum() < 1e-300:
        return state
    nwin = hist_w.shape[0]
    one = prm.parallel_strategy == "mw" or nwin == 1

    wid = _np(state.window_id)
    f = _np(state.f).astype(np.float64)
    firstcycle = _np(state.firstcycle).copy()
    hreset = _np(state.histogram_reset).copy()
    sbw, ebw, first = _window_bounds(state, nwin)
    bins = np.arange(B)[None, :]
    winmask = (bins >= sbw[:, None]) & (bins <= ebw[:, None])  # [nwin, B]
    hw = np.where(winmask, hist_w, np.nan)
    mini = np.nanmin(hw, axis=1)                             # [nwin]
    maxi = np.nanmax(hw, axis=1)
    av = np.nanmean(hw, axis=1)

    # first-pass histogram reset once every bin of the window has
    # wl_minhist visits (mc_check_flatness:1969-1980)
    fp = (firstcycle[first] & ~hreset[first]
          & (np.rint(mini) > prm.wl_minhist))                # [nwin]
    reset_w = fp.copy()
    hreset |= fp[wid]

    logs.g(f"# Checking flatness of histogram at cycle {cycle:10d}")
    with np.errstate(invalid="ignore", divide="ignore"):
        logs.g(f"# Most  populated bin = "
               f"{np.nanmean(100 * maxi / av):10.4f} % of mean")
        logs.g(f"# Least populated bin = "
               f"{np.nanmean(100 * mini / av):10.4f} % of mean")

    # flatness criteria by schedule (mc_check_flatness:2024-2052); a
    # window without visits is not flat (its NaN compares false)
    with np.errstate(invalid="ignore", divide="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if prm.wl_schedule == 0:
            flat = np.nanmax(np.abs(hw - av[:, None]) / av[:, None],
                             axis=1) <= prm.wl_flattol
        elif prm.wl_schedule == 1:
            flat = np.rint(mini) >= prm.wl_minhist
        elif prm.wl_schedule == 2:
            flat = mini >= (1 - prm.wl_flattol) * av
        else:
            raise ValueError("unknown wl_schedule value")
    flat &= ~fp

    halve = np.zeros(len(wid), dtype=bool)
    mub = np.asarray(grid.mu_bin)
    for w in np.nonzero(flat)[0]:
        sel = wid == w
        if one:
            # shift the weights down by the central-bin value
            # (mc_check_flatness:2062-2066), record and halve f
            weight_w[w] -= weight_w[w, B // 2]
            fv = float(f[sel].max())
            writers.append_wlf("wlf.dat", cycle, fv, 0.5 * fv)
            tag = f"{fv:.12f}"
            writers.write_curve(f"eta_weights.dat_{tag}", mub, weight_w[w],
                                fv)
            writers.write_curve(f"histogram.dat_{tag}", mub, hist_w[w], fv)
            logs.g("# Flatness criterion satisfied - updating wl_factor")
        else:
            logs.my(f"# window {w}: flatness satisfied - halving f")
        reset_w[w] = True
        halve |= sel
        firstcycle[sel] = False
    if flat.any() and not one:
        # the reference's rank-0 wlf.dat records the largest f of the
        # ranks (mc_check_flatness:2068-2082)
        writers.append_wlf("wlf.dat", cycle, float(f.max()),
                           float(np.where(halve, 0.5 * f, f).max()))
    f = np.where(halve, 0.5 * f, f)

    dev = state.f.device
    dtype = state.master_hist.hi.dtype
    state.f = torch.as_tensor(f, dtype=state.f.dtype, device=dev)
    state.firstcycle = torch.as_tensor(firstcycle, device=dev)
    state.histogram_reset = torch.as_tensor(hreset, device=dev)
    if reset_w.any():
        # (comms_set_histogram, mc_check_flatness:1977, 2106)
        hist_w[reset_w] = 0.0
        state.master_hist = ds_from64(hist_w, dtype, dev)
    if one and flat.any():
        state.master_eta = ds_from64(weight_w, dtype, dev)
    return state


def deltaG_from_uhist(prm: RunParams, grid: BinGrid, uhist) -> dict | None:
    """Delta G = G(lattice 2) - G(lattice 1) from the merged unbiased
    histogram ``uhist`` [B] (float64): the histogram normalised over the
    bin widths, the probability mass below mu = 0 against the mass above
    it (mc_compute_deltaG_from_hist, mc_moves.F90:2498-2621).

    Returns {"kT", "kT_per_mol", "J_per_mol", "meV_per_mol", "normP"},
    or None when the histogram is empty."""
    if prm.leshift:
        raise NotImplementedError("leshift is not ported yet")
    B = grid.nbins
    joined = np.asarray(uhist, np.float64)
    bw = np.asarray(grid.binwidth)
    norm = (joined * bw).sum()
    if norm <= 0:
        return None
    normP = joined / norm
    pA = (normP[: B // 2] * bw[: B // 2]).sum()
    pB = (normP[B // 2:] * bw[B // 2:]).sum()
    deltaG = float(np.log(pA / pB))
    kT = KB * prm.temperature
    per_mol = deltaG / prm.nwater
    return {
        "kT": deltaG,
        "kT_per_mol": per_mol,
        "J_per_mol": kT * HART_TO_KJPM * 1000.0 * per_mol,
        "meV_per_mol": kT * HART_TO_EV * 1000.0 * per_mol,
        "normP": normP,
    }


def compute_deltaG(eng, state, logs, aux):
    """The logged Delta G estimate and the cycle-tagged dump of the
    normalised unbiased histogram, with a third, raw cumulative column
    (as the JAX package writes it).  With several windows the histogram
    is the stitched one (join_uhist), and the per-window raw cumulative
    histograms ``uhist_windows_<cycle>.dat`` and visit counts with the
    frozen weights ``hist_windows_<cycle>.dat`` are dumped too, for
    scripts/deltag_error.py --dd (a stitched dump cannot be
    block-differenced: the matching constants change as the histograms
    grow)."""
    prm, grid = eng.prm, eng.grid
    B = grid.nbins
    cycle = int(state.cycle)
    state = eng.merged_histogram(state)
    u_cur = ds_value64(state.master_uhist)                   # [nwin, B]
    nwin = u_cur.shape[0]
    one = prm.parallel_strategy == "mw" or nwin == 1
    joined = u_cur[0] if one else join_uhist(u_cur, B, prm.window_overlap)
    dg = deltaG_from_uhist(prm, grid, joined)
    if dg is None:
        logs.g(f"# deltaG at cycle {cycle}: histogram empty, skipped")
        return state
    logs.g(f"# Estimate of delta G from histogram at cycle {cycle:10d}")
    logs.g(f"# G(lattice2) - G(lattice1) = {dg['kT_per_mol']:15.8f} "
           "kT/molecule")
    logs.g(f"# G(lattice2) - G(lattice1) = {dg['J_per_mol']:15.8f} J/mole")
    logs.g(f"# G(lattice2) - G(lattice1) = {dg['meV_per_mol']:15.8f} "
           "meV/molecule")
    mub = np.asarray(grid.mu_bin)
    with open(f"unbiased_histogram_{cycle:010d}.dat", "w") as fh:
        fh.write("#Current energy increment =  0.000000000000E+00\n")
        for m, v, rw in zip(mub, dg["normP"], joined):
            fh.write(f"  {m: .14E}  {v: .14E}  {rw: .14E}\n")
    if one:
        return state
    h_cur = ds_value64(state.master_hist)
    e_cur = ds_value64(state.master_eta)
    with open(f"uhist_windows_{cycle:010d}.dat", "w") as fh:
        fh.write(f"# mu then {nwin} per-window raw cumulative "
                 "unbiased-histogram columns "
                 f"(window_overlap={prm.window_overlap})\n")
        for k in range(B):
            fh.write(f"  {mub[k]: .14E}"
                     + "".join(f"  {u_cur[w, k]: .14E}" for w in range(nwin))
                     + "\n")
    with open(f"hist_windows_{cycle:010d}.dat", "w") as fh:
        fh.write(f"# mu then {nwin} per-window cumulative visit-count "
                 f"columns then {nwin} frozen eta columns "
                 f"(window_overlap={prm.window_overlap})\n")
        for k in range(B):
            fh.write(f"  {mub[k]: .14E}"
                     + "".join(f"  {h_cur[w, k]: .14E}" for w in range(nwin))
                     + "".join(f"  {e_cur[w, k]: .14E}" for w in range(nwin))
                     + "\n")
    return state
