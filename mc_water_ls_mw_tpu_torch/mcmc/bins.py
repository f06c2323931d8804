"""Non-uniform mu-bin grid and multicanonical weight lookup.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/bins.py``:

* geometric-progression bin grid solved by fixed-point iteration at
  setup (host-side fp64 numpy; reference mc_init, mc_moves.F90:553-656);
* analytic bin lookup ``mu_to_bin`` via logs, on tensors
  (mc_moves.F90:2187-2215);
* piecewise-linear interpolated weight lookup ``eta_weight`` with the
  reference's window walls and special-cased end bins
  (mc_moves.F90:893-964).

The grid arrays stay float64 numpy here; the engine casts them once to
its state dtype and device (as the JAX package builds them in the run's
dtype).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Finite stand-in for the reference's huge(1.0_dp) window wall
# (mc_moves.F90:915-922): finite, so eta_new - eta_old is 0 (not NaN)
# when both ends lie outside the window.
ETA_WALL = 1.0e30


class BinGrid(NamedTuple):
    """Static bin-grid description (host-built)."""

    mu_bin: np.ndarray      # [B] mid-bin mu values (float64)
    binwidth: np.ndarray    # [B]
    av_binwidth: float
    r_pos: float            # common ratio, positive side
    r_neg: float
    a_pos: float            # first bin width each side (== 1)
    a_neg: float
    mu_min: float
    mu_max: float

    @property
    def nbins(self) -> int:
        return self.mu_bin.shape[0]


def _solve_ratio(s: float, ns: int) -> float:
    """Fixed-point solve for the GP common ratio (mc_moves.F90:584-594)."""
    a = 1.0
    r = 1.1
    for _ in range(1_000_000):
        tmpsum = a * (1.0 - r**ns) / (1.0 - r)
        r_new = r * (s / tmpsum) ** (1.0 / ns)
        if abs(r_new - r) <= 2.0 * np.finfo(np.float64).eps:
            break
        r = r_new
    return r


def build_bin_grid(nbins: int, mu_min: float, mu_max: float) -> BinGrid:
    """Construct the GP bin grid (mc_moves.F90:553-656); ``nbins`` is
    forced odd exactly as the reference does (mc_moves.F90:557)."""
    if nbins % 2 == 0:
        nbins += 1
    s_pos = abs(mu_max) - 0.5
    s_neg = abs(mu_min) - 0.5
    ns = nbins // 2
    r_pos = _solve_ratio(s_pos, ns)
    r_neg = _solve_ratio(s_neg, ns)

    mu_bin = np.zeros(nbins)
    binwidth = np.zeros(nbins)

    # negative side, filled downward from the central bin
    mu_u = -0.5
    k = 0
    for ibin in range(nbins // 2 - 1, -1, -1):
        mu_l = mu_u - 1.0 * r_neg**k
        mu_bin[ibin] = 0.5 * (mu_u + mu_l)
        binwidth[ibin] = mu_u - mu_l
        mu_u = mu_l
        k += 1

    # central bin
    mu_bin[nbins // 2] = 0.0
    binwidth[nbins // 2] = 1.0

    # positive side
    mu_l = 0.5
    k = 0
    for ibin in range(nbins // 2 + 1, nbins):
        mu_u = mu_l + 1.0 * r_pos**k
        mu_bin[ibin] = 0.5 * (mu_u + mu_l)
        binwidth[ibin] = mu_u - mu_l
        mu_l = mu_u
        k += 1

    return BinGrid(
        mu_bin=mu_bin,
        binwidth=binwidth,
        av_binwidth=float(binwidth.mean()),
        r_pos=float(r_pos),
        r_neg=float(r_neg),
        a_pos=1.0,
        a_neg=1.0,
        mu_min=float(mu_min),
        mu_max=float(mu_max),
    )


def mu_to_bin(grid: BinGrid, mu):
    """0-based bin index of ``mu`` (int64 tensor; mc_moves.F90:2187-2215).

    May return indices outside [0, B-1] for mu beyond the grid - the
    reference relies on this to skip histogram updates
    (mc_moves.F90:1619); callers must mask."""
    B = grid.nbins
    centre = B // 2
    # positive branch
    arg_p = 1.0 - (mu - 0.5) * (1.0 - grid.r_pos) / grid.a_pos
    k_pos = centre + 1 + _trunc(
        torch.log(torch.clamp(arg_p, min=1e-300))
        / np.log(grid.r_pos)
    )
    # negative branch
    arg_n = 1.0 - (torch.abs(mu) - 0.5) * (1.0 - grid.r_neg) / grid.a_neg
    k_neg = centre - 1 - _trunc(
        torch.log(torch.clamp(arg_n, min=1e-300))
        / np.log(grid.r_neg)
    )
    k = torch.where(mu > 0.0, k_pos, k_neg)
    return torch.where(torch.abs(mu) <= 0.5, centre, k)


def _trunc(x):
    """Round toward zero to int64, saturating at the int32 range with
    NaN -> 0 (the float-to-int conversion of XLA and of the CUDA
    kernels; torch's own conversion of inf/NaN is undefined)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**31 - 1, neginf=-2.0**31)
    return torch.clamp(x, -2.0**31, 2.0**31 - 1).to(torch.int64)


def eta_weight(grid: BinGrid, weight, mu, my_mu_min, my_mu_max,
               start_bin, end_bin, in_window, interp: bool):
    """Multicanonical weight eta(mu) for one walker (weight [B] float64
    numpy or tensor, mu a 0-d tensor); ETA_WALL outside the window
    (mc_moves.F90:915-922), no bias before the walker first reaches its
    window (mc_moves.F90:913)."""
    B = grid.nbins
    weight = torch.as_tensor(weight, dtype=mu.dtype)
    bw = torch.as_tensor(grid.binwidth, dtype=mu.dtype)
    mub = torch.as_tensor(grid.mu_bin, dtype=mu.dtype)
    k = torch.clamp(mu_to_bin(grid, mu), 0, B - 1)
    if not interp:
        eta = weight[k]
    else:
        km = torch.clamp(k - 1, 0, B - 1)
        kp = torch.clamp(k + 1, 0, B - 1)
        w_k, w_km, w_kp = weight[k], weight[km], weight[kp]
        grad_up = 2.0 * (w_kp - w_k) / (bw[k] + bw[kp])
        grad_dn = 2.0 * (w_k - w_km) / (bw[k] + bw[km])
        eta_first = w_k + (mu - mub[k]) * grad_up
        eta_last = w_k + (mu - mub[k]) * grad_dn
        eta_mid_up = w_k + (mu - mub[k]) * grad_up
        eta_mid_dn = w_km + (mu - mub[km]) * grad_dn
        eta = torch.where(
            k == start_bin, eta_first,
            torch.where(k == end_bin, eta_last,
                        torch.where(mu > mub[k], eta_mid_up, eta_mid_dn)),
        )
    wall = (mu < my_mu_min) | (mu > my_mu_max)
    eta = torch.where(wall, ETA_WALL, eta)
    return torch.where(torch.as_tensor(in_window), eta, 0.0)


def eta_lookup(grid: BinGrid, weight, mu, binw, mub, start_bin, end_bin,
               my_mu_min, my_mu_max, in_window, interp: bool,
               seeding: bool = True):
    """eta(mu) per walker against a TOTAL weight view (batched
    eta_weight; mc_moves.F90:893-964), shared by the engines and the
    plain version of the chain kernel.

    weight [B, W]; mu [W] (or [n, W]: n points of every walker at once)
    and the window arguments [W]; binw / mub [B] tensors.  Walkers
    before their window see the wall-less curve (``seeding``) or no bias
    at all."""
    B = grid.nbins
    k = torch.clamp(mu_to_bin(grid, mu), 0, B - 1)

    def at(idx):
        return torch.take_along_dim(
            weight, idx.view(-1, idx.shape[-1]), dim=0).view(idx.shape)

    if not interp:
        eta = at(k)
    else:
        km = torch.clamp(k - 1, 0, B - 1)
        kp = torch.clamp(k + 1, 0, B - 1)
        w_k, w_km, w_kp = at(k), at(km), at(kp)
        bw_k, bw_km, bw_kp = binw[k], binw[km], binw[kp]
        mub_k, mub_km = mub[k], mub[km]
        grad_up = 2.0 * (w_kp - w_k) / (bw_k + bw_kp)
        grad_dn = 2.0 * (w_k - w_km) / (bw_k + bw_km)
        eta_first = w_k + (mu - mub_k) * grad_up
        eta_last = w_k + (mu - mub_k) * grad_dn
        eta_mid_up = w_k + (mu - mub_k) * grad_up
        eta_mid_dn = w_km + (mu - mub_km) * grad_dn
        eta = torch.where(
            k == start_bin, eta_first,
            torch.where(k == end_bin, eta_last,
                        torch.where(mu > mub_k, eta_mid_up, eta_mid_dn)),
        )
    wall = (mu < my_mu_min) | (mu > my_mu_max)
    walled = torch.where(wall, ETA_WALL, eta)
    pre = eta if seeding else torch.zeros_like(eta)
    return torch.where(in_window, walled, pre)


class FSchedule(NamedTuple):
    """The f schedule of a WL generation run other than the plain
    factor (mc_update_wl_bins, mc_moves.F90:1636-1658), with its inputs
    at one update: Swetnam's f from the RMS deviation of the total
    histogram from flat (``swetnam``), else the 1/t cap of the walkers
    whose ``invt_on`` is set."""

    swetnam: bool
    alpha: float                  # wl_alpha
    wl_factor: float              # the cap of Swetnam's f
    binfrac: torch.Tensor         # [B] binwidth / (mu_max - mu_min - 1)
    base_hist: torch.Tensor | None  # [B, W] master histogram view
    sumhist: torch.Tensor         # [W] Swetnam's count of updates
    invt_on: torch.Tensor | None  # [W] bool: the walker runs 1/t
    invt_cap: float               # B / (cycle * nwater), working type


# the f schedules of a WL generation run (SCHED_* of csrc/wl_common.cuh)
SCHED_PLAIN, SCHED_SWETNAM, SCHED_INVT = 0, 1, 2


def schedule_kind(prm) -> int:
    """The f schedule a run's per-move WL updates follow: the plain
    factor (also every sample run, whose f is frozen), Swetnam's (which
    takes precedence, as in the JAX engine), or 1/t."""
    if prm.samplerun:
        return SCHED_PLAIN
    if prm.wl_swetnam:
        return SCHED_SWETNAM
    return SCHED_INVT if prm.wl_useinvt else SCHED_PLAIN


def f_schedule(prm, grid: BinGrid, binfrac, dtype, sumhist, base_hist,
               invt_on, cycle: int) -> FSchedule | None:
    """The run's FSchedule at one update, or None for the plain factor:
    ``base_hist`` [B, W] the master histogram view (Swetnam), ``invt_on``
    [W] bool (1/t), ``cycle`` the cycle number (1/t)."""
    kind = schedule_kind(prm)
    if kind == SCHED_PLAIN:
        return None
    cap = (invt_cap(grid.nbins, cycle, prm.nwater, dtype)
           if kind == SCHED_INVT else 0.0)
    return FSchedule(kind == SCHED_SWETNAM, prm.wl_alpha, prm.wl_factor,
                     binfrac, base_hist, sumhist, invt_on, cap)


def invt_cap(B: int, cycle: int, nwater: int, dtype) -> float:
    """The 1/t schedule's f at ``cycle``, B / (cycle * nwater), rounded
    as the working type rounds it (the JAX package forms it in that
    type); a Python float that the type holds exactly."""
    t = np.float32 if dtype == torch.float32 else np.float64
    return float(t(B) / (t(cycle) * t(nwater)))


def swetnam_binfrac(grid: BinGrid, mu_min: float, mu_max: float):
    """Swetnam's flat target per bin, binwidth / (mu_max - mu_min - 1),
    in float64 (numpy), as the JAX engine forms it."""
    return np.asarray(grid.binwidth) / (mu_max - mu_min - 1.0)


def wl_move_update(grid: BinGrid, samplerun: bool, log_norm: float, binw,
                   weight, hist, uhist, eta_fn, mu, f, active, healthy,
                   sched: FSchedule | None = None):
    """Per-move Wang-Landau / unbiased-histogram update of a performed
    move at mu [W] (mc_update_wl_bins, mc_moves.F90:1597-1689), shared by
    the engines and the plain version of the chain kernel.

    ``active`` (bool or [W] bool): the move was performed and the WL
    phase is live; ``healthy`` [W] bool: the walker may write into the
    shared arrays.  The f schedules follow ``active`` while the
    histogram writes also need ``healthy`` (the JAX engine's
    _wl_update).  ``eta_fn(mu)`` evaluates eta against the current
    weight view (sample runs only).  Returns the new (weight, hist,
    uhist, f, sumhist); the reference's per-update min-shift is
    deferred to the delta-sync (see the JAX engine's _wl_update note)."""
    B = grid.nbins
    k = mu_to_bin(grid, mu)
    in_grid = (k >= 0) & (k < B)
    kc = torch.clamp(k, 0, B - 1)
    upd = (in_grid & active & healthy).to(hist.dtype)        # [W]
    oh = (torch.arange(B, device=k.device)[:, None] == kc[None, :]
          ).to(hist.dtype) * upd[None, :]                    # [B, W]
    # a true division, as the kernels and the JAX package do it:
    # ``scalar / tensor`` would be reciprocal-then-multiply in PyTorch,
    # up to an ulp and a half off
    incr = torch.div(torch.full_like(mu, grid.av_binwidth), binw[kc])
    hist = hist + oh * incr[None, :]
    sumhist = None if sched is None else sched.sumhist
    if samplerun:
        # unbiased histogram, frozen weights (1625-1632): mask BEFORE the
        # exp (the eta wall would poison via exp(1e30) * 0) and gate
        # walled entries out entirely
        eta_val = eta_fn(mu)
        unwalled = eta_val < 1e29
        arg = torch.where((upd > 0) & unwalled, eta_val - log_norm, -1.0)
        u_incr = torch.where(
            unwalled, incr * torch.exp(torch.clamp(arg, max=60.0)), 0.0)
        return weight, hist, uhist + oh * u_incr[None, :], f, sumhist
    if sched is not None and sched.swetnam:
        # Swetnam's RMS-flatness f (1636-1653) from the TOTAL histogram
        # view (master + own growth, this update included)
        sumhist = sched.sumhist + upd
        dev = ((hist + sched.base_hist) * binw[:, None]
               / torch.clamp(sumhist, min=1.0)[None, :]
               - sched.binfrac[:, None])
        rms = torch.sqrt(torch.mean(dev * dev, dim=0))
        f_new = torch.log(torch.clamp(rms, min=1e-300)) * sched.alpha * B
        f_new = torch.clamp(f_new, max=sched.wl_factor)
        f = torch.where(upd > 0, f_new, f)
    elif sched is not None:
        # the 1/t schedule once the walker runs it (1655-1658)
        f = torch.where(sched.invt_on & active,
                        torch.clamp(f, max=sched.invt_cap), f)
    return weight + oh * (incr * f)[None, :], hist, uhist, f, sumhist
