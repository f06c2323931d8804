"""Host-side Wang-Landau events: monitoring, flatness, Delta G.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/wanglandau.py`` (the
reference's interval-driven bookkeeping: mc_monitor_stats,
mc_check_flatness, mc_compute_deltaG_from_hist, mc_moves.F90:1691-2621)
for one mu window (the 'mw' strategy; 'dd' windows are refused by the
engine, ROADMAP.md).  They run at block boundaries on the host: file IO
and O(nbins) scalar work on pulled arrays, in float64.  The 1/t and
Swetnam schedules of the flatness check are not ported: the engine
refuses ``wl_useinvt`` and ``wl_swetnam``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BOHR_TO_ANG, HART_TO_EV, HART_TO_KJPM, KB
from ..io import writers
from ..ops.dsfloat import ds_from64, ds_value64
from .bins import BinGrid
from .config import RunParams
from .engine import SWITCH, TRANS, VOL


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


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

    # reset accumulators (mc_monitor_stats:1797-1810)
    state.att = torch.zeros_like(state.att)
    state.acc = torch.zeros_like(state.acc)
    state.trans_per_mol = torch.zeros_like(state.trans_per_mol)
    state.avg_energy = torch.zeros_like(state.avg_energy)
    state.min_dmu = torch.full_like(state.min_dmu, float("inf"))
    state.max_dmu = torch.zeros_like(state.max_dmu)

    # curve dumps (mc_monitor_stats:1813-1929): after the delta-sync the
    # double-single master rows hold the exact merged curves
    if write_files:
        state = eng.merged_histogram(state)
        wl_f = float(_np(state.f).max())
        if not prm.samplerun:
            writers.write_curve("eta_weights.dat", mub,
                                ds_value64(state.master_eta)[0], wl_f)
        writers.write_curve("histogram.dat", mub,
                            ds_value64(state.master_hist)[0], wl_f)
        writers.write_curve("unbiased_histogram.dat", mub,
                            ds_value64(state.master_uhist)[0], wl_f)
    return state


def check_flatness(eng, state, logs):
    """Histogram flatness check and the f schedule (mc_check_flatness,
    mc_moves.F90:1936-2185), one window: all growth is folded into the
    double-single master rows first, the decision is made on their
    exact float64 view and broadcast to every walker."""
    prm, grid = eng.prm, eng.grid
    B = grid.nbins
    cycle = int(state.cycle)
    if prm.samplerun:
        return state

    state = eng.merged_histogram(state)   # (mc_check_flatness:1965-1967)
    hist = ds_value64(state.master_hist)[0]                 # [B] exact
    weight = ds_value64(state.master_eta)[0]
    if hist.sum() < 1e-300:
        return state

    f = _np(state.f).astype(np.float64)
    firstcycle = bool(_np(state.firstcycle)[0])
    hreset = bool(_np(state.histogram_reset)[0])
    mini, maxi, av = hist.min(), hist.max(), hist.mean()

    # first-pass histogram reset once every bin has wl_minhist visits
    # (mc_check_flatness:1969-1980)
    first_pass = firstcycle and not hreset and np.rint(mini) > prm.wl_minhist
    reset = first_pass
    hreset = hreset or first_pass

    logs.g(f"# Checking flatness of histogram at cycle {cycle:10d}")
    with np.errstate(invalid="ignore", divide="ignore"):
        logs.g(f"# Most  populated bin = {100 * maxi / av:10.4f} % of mean")
        logs.g(f"# Least populated bin = {100 * mini / av:10.4f} % of mean")

    # flatness criteria by schedule (mc_check_flatness:2024-2052)
    if prm.wl_schedule == 0:
        flat = np.max(np.abs(hist - av) / av) <= prm.wl_flattol
    elif prm.wl_schedule == 1:
        flat = np.rint(mini) >= prm.wl_minhist
    elif prm.wl_schedule == 2:
        flat = mini >= (1 - prm.wl_flattol) * av
    else:
        raise ValueError("unknown wl_schedule value")
    flat = bool(flat) and not first_pass

    if flat:
        # shift the weights down by the central-bin value
        # (mc_check_flatness:2062-2066), record and halve f
        weight = weight - weight[B // 2]
        fv = float(f.max())
        writers.append_wlf("wlf.dat", cycle, fv, 0.5 * fv)
        tag = f"{fv:.12f}"
        mub = np.asarray(grid.mu_bin)
        writers.write_curve(f"eta_weights.dat_{tag}", mub, weight, fv)
        writers.write_curve(f"histogram.dat_{tag}", mub, hist, fv)
        logs.g("# Flatness criterion satisfied - updating wl_factor")
        reset = True
        f = 0.5 * f
        firstcycle = False

    dev = state.f.device
    dtype = state.master_hist.hi.dtype
    state.f = torch.as_tensor(f, dtype=state.f.dtype, device=dev)
    state.firstcycle = torch.full_like(state.firstcycle, firstcycle)
    state.histogram_reset = torch.full_like(state.histogram_reset, hreset)
    if reset:
        # (comms_set_histogram, mc_check_flatness:1977, 2106)
        state.master_hist = ds_from64(np.zeros((1, B)), dtype, dev)
    if flat:
        state.master_eta = ds_from64(weight[None], dtype, dev)
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
    (as the JAX package writes it)."""
    prm, grid = eng.prm, eng.grid
    cycle = int(state.cycle)
    state = eng.merged_histogram(state)
    joined = ds_value64(state.master_uhist)[0]
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
    with open(f"unbiased_histogram_{cycle:010d}.dat", "w") as fh:
        fh.write("#Current energy increment =  0.000000000000E+00\n")
        for m, v, rw in zip(np.asarray(grid.mu_bin), dg["normP"], joined):
            fh.write(f"  {m: .14E}  {v: .14E}  {rw: .14E}\n")
    return state
