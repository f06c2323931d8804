"""The Monte-Carlo engine: batched moves, WL updates, cycle loop.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/engine.py`` (the dense walker
engine; reference mc_moves.F90): one lattice (NPT sampling of one
polymorph, no mu, no switch, no WL) or two (the lattice switch), NPT
(with the volume wall ``mc_vol_wall``) or NVT, the reference's MINU
variant (a switch to the lower-enthalpy lattice folded into every
translation) and the reference-enthalpy shift ``leshift``, either
parallel strategy ('mw': one window shared by all walkers; 'dd':
walkers assigned round-robin to mu windows, each window with its own
master rows), Wang-Landau weight generation (the plain factor, the
Swetnam or the 1/t schedule) or a sample run, in either candidate mode
of the JAX package:

* static neighbour tables with their displacement wall (N >= 96 in a
  MIC-unique box): a molecule schedule shared by all walkers, one trial
  per move or ``dense_trials`` = T > 1 anchored-window trials per mover;
* dense candidates (no tables: N < 96, a box that is not MIC-unique, or
  ``nbr_table='off'``): each walker draws its own molecule and every
  molecule under every folded image shift is a candidate, with no wall
  (the reference's own move semantics).

One cycle (``_one_cycle``) tracks each walker's window membership
('dd'), draws a shared move schedule and per-walker
uniforms from the engine's random stream, runs every translation,
switch attempt and per-move WL update of the cycle through
``FusedCycle`` (one hand-written CUDA kernel per candidate mode on the
card, a plain step loop on the CPU), then the scheduled volume moves
(whose whole-cell energies go through ``FullEnergyKernel``), the
delta-sync of the WL arrays and the chain resync at their intervals.

Design notes that differ from the JAX engine:

* State is updated IN PLACE and returned (the kernels write the tensors
  they are given); per-cycle events are decided on the host from the
  host cycle counter, so a cycle needs no device-to-host sync.
* Randomness comes from an injectable stream object (``PhiloxStream``
  in production; the tests inject one that reproduces the JAX package's
  threefry draws).  Philox bits differ from threefry's, so only
  distributions can agree between the packages in production.
* Every 3x3 cell-matrix contraction is an explicit sum of products
  (ops/geometry.py), so no float32 contraction can go through TF32.
* The walkers may be sharded over ranks (``comm``, parallel/mesh.py):
  each rank runs its block of walkers through the same kernels, draws
  the whole ensemble's uniforms and keeps its block, and every
  reduction over walkers (the delta merge and its drop counts, the
  therm samples, the first walkers of an audit) gathers the walker axis
  from all ranks first (``_gw``) and then reduces as the serial run
  does, the window bounds as exact extrema over the ranks, so a sharded
  run is the serial run.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..models.sw import SWParams
from ..ops.dense import (
    Moments,
    _e3_closed_form,
    _h_components,
    _leg,
    _mic_fold,
    _pair,
    full_energy_batch,
    local_energies_batch,
    reduced_shift_set,
)
from ..ops.dsfloat import ds_add, ds_sub, ds_value, ds_where
from ..ops.full_energy import FullEnergyKernel
from ..ops.geometry import determinant3, from_frac, recip_matrix, to_frac
from ..ops.nbrtable import BREATHING, perp_widths
from .bins import (
    SCHED_SWETNAM,
    BinGrid,
    eta_lookup,
    f_schedule,
    schedule_kind,
    swetnam_binfrac,
    wl_move_update,
)
from .config import RunParams
from .fused import FusedCycle
from ..parallel.comm import SINGLE
from ..parallel.mesh import WalkerSlice, walker_block
from .state import _DTYPES, EngineAux, SamplerState, resolve_device

TRANS, VOL, SWITCH, NOOP = 0, 1, 2, 3


class PhiloxStream:
    """Production random stream.

    The small shared schedule (move codes, molecule schedule) is drawn
    on a CPU generator, so the host knows each cycle's volume-move count
    without a device sync; the per-walker uniforms are drawn on the
    engine's device (Philox on CUDA).  Draws happen in call order, so a
    run is reproducible from its seed."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.sched = torch.Generator(device="cpu")
        self.sched.manual_seed(self.seed)
        self.walk = torch.Generator(device=device)
        self.walk.manual_seed(self.seed + 1)
        self.device = device

    def get_state(self):
        """The two generators' states (CPU uint8 tensors), for a
        checkpoint."""
        return [self.sched.get_state(), self.walk.get_state()]

    def set_state(self, states):
        self.sched.set_state(states[0])
        self.walk.set_state(states[1])

    def reseed(self, cycle: int):
        """Seed both generators from (seed, cycle): the restart from a
        checkpoint that holds no state of these streams."""
        s0, s1 = np.random.SeedSequence(
            [self.seed, int(cycle)]).generate_state(2)
        self.sched.manual_seed(int(s0))
        self.walk.manual_seed(int(s1))

    def cycle_draws(self, cycle, probs, N, W, dtype, trials=1,
                    shared_mol=True):
        """(codes [N], sched_mol, cycle_u) of one cycle: the move codes
        of all N trials on the CPU; with ``shared_mol`` (table mode) the
        molecule schedule [N // trials] on the CPU, else None (each
        walker's molecule comes from slot 0 of its uniforms); the
        per-walker uniforms [N // trials, n_u, W], n_u = 7 at one trial
        per move and 4 + 5T at T = ``trials`` (mcmc/fused.py)."""
        xi = torch.rand((N,), generator=self.sched, dtype=dtype)
        transP, volP, swP = probs
        codes = torch.where(
            xi < transP, TRANS,
            torch.where(xi < volP, VOL,
                        torch.where(xi < swP, SWITCH, NOOP)))
        n_steps = N // trials
        sched = None
        if shared_mol:
            sched = torch.randint(0, N, (N,), generator=self.sched)[:n_steps]
        n_u = 7 if trials == 1 else 4 + 5 * trials
        cycle_u = torch.rand((n_steps, n_u, W), generator=self.walk,
                             dtype=dtype, device=self.device)
        return codes, sched, cycle_u

    def volume_draws(self, cycle, k, W, dtype):
        """(u_vol [W,4], zeta2 [W]) for volume move ``k`` of a cycle."""
        u = torch.rand((W, 5), generator=self.walk, dtype=dtype,
                       device=self.device)
        return u[:, :4], u[:, 4]

    # the cell engine's draws (mcmc/cellengine.py)

    def rebin_origin(self, cycle, dtype):
        """The shared fractional grid origin [3] of a rebin."""
        return torch.rand((3,), generator=self.sched, dtype=dtype).to(
            self.device)

    def cell_cycle_draws(self, cycle, probs, n_trials, n_sub, K, n_u, W,
                         dtype):
        """(codes [n_trials] on the CPU, u_all [n_sub, K, n_u, W]): the
        shared move-type schedule over a cycle's trials and, per sub-step
        and mover, the ``n_u`` uniforms of every walker (7 with one trial
        per mover, 4 + 5T with T trials: mcmc/cellengine.py)."""
        xi = torch.rand((n_trials,), generator=self.sched, dtype=dtype)
        transP, volP, swP = probs
        codes = torch.where(
            xi < transP, TRANS,
            torch.where(xi < volP, VOL,
                        torch.where(xi < swP, SWITCH, NOOP)))
        u_all = torch.rand((n_sub, K, n_u, W), generator=self.walk,
                           dtype=dtype, device=self.device)
        return codes, u_all


def _take_lat(arr, ls):
    """arr [L, ..., W] selected per walker by ls [W] -> [..., W] (the
    one lattice where L = 1)."""
    if arr.shape[0] == 1:
        return arr[0]
    return torch.where(ls == 0, arr[0], arr[1])


class Engine:
    """Sampler over a fixed (params, model, grid) on one device."""

    def __init__(self, prm: RunParams, model: SWParams, grid: BinGrid,
                 aux: EngineAux, device="cuda", stream=None, comm=None):
        self._check_scope(prm, aux)
        self.prm = prm
        self.model = model
        self.grid = grid
        self.aux = aux
        self.device = resolve_device(device)
        self.dtype = _DTYPES[prm.dtype]
        self.probs = prm.normalised_probs()
        self.ref_h = torch.as_tensor(aux.ref_h, dtype=self.dtype,
                                     device=self.device)     # [L,3,3]
        self.binw = torch.as_tensor(grid.binwidth, dtype=self.dtype,
                                    device=self.device)
        self.mub = torch.as_tensor(grid.mu_bin, dtype=self.dtype,
                                   device=self.device)
        # Swetnam's flat target per bin (_f_schedule)
        self.binfrac = torch.as_tensor(
            swetnam_binfrac(grid, prm.mu_min, prm.mu_max), dtype=self.dtype,
            device=self.device)
        # the walker axis (parallel/comm.py): this rank's walkers are the
        # block [lo, hi) of the ensemble (parallel/mesh.py)
        self.comm = SINGLE if comm is None else comm
        if isinstance(stream, WalkerSlice):
            stream = stream.inner
        if stream is None:
            stream = PhiloxStream(prm.seed, self.device)
        if self.comm.sharded:
            stream = WalkerSlice(stream, self.comm, prm.n_walkers)
        self.stream = stream
        # the rank that writes a sharded run's files
        self.is_root = self.comm.rank == 0
        self._init_layout()

    def _check_scope(self, prm: RunParams, aux: EngineAux) -> None:
        """Raise ValueError for settings outside the JAX engine's
        envelope."""
        _check_scope(prm, aux)

    def _init_layout(self):
        """The configurational layout's tables and kernels (the dense
        walker engine: static neighbour tables where ``init_state`` built
        them, dense candidates otherwise, and the two N <= ~10^3 kernels;
        the cell engine overrides this)."""
        prm, model, aux = self.prm, self.model, self.aux
        # MIC-folded residual shift set (a single null shift in table
        # mode: the box is MIC-unique; up to a few in dense mode)
        self.fold_shifts = reduced_shift_set(aux.ref_h, model)
        self.wall = float(aux.wall)
        # anchored-window trials per mover (table mode only; validated
        # by _check_scope)
        self.dT = max(1, int(prm.dense_trials))
        self.dense = aux.nbr_tbl is None
        self.tbl = self._partners = self.frac0 = self.min_perp_w = None
        if not self.dense:
            self.tbl = np.asarray(aux.nbr_tbl, np.int32)     # [L,N,M]
            N = prm.nwater
            # each molecule's valid table partners (sentinel N dropped)
            self._partners = [
                [torch.as_tensor(row[row < N].astype(np.int64),
                                 device=self.device) for row in self.tbl[l]]
                for l in range(self.tbl.shape[0])
            ]
            self.frac0 = torch.as_tensor(aux.frac0, dtype=self.dtype,
                                         device=self.device)  # [L,3,N]
            # runtime guard for the tables' breathing margin (see
            # _vol_extra_ok)
            self.min_perp_w = np.stack([
                perp_widths(aux.ref_h[l]) for l in range(aux.ref_h.shape[0])
            ]) / BREATHING                                   # [L,3]
        self.full_energy = FullEnergyKernel(model, self.fold_shifts)
        self.fused_cycle = FusedCycle(self)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _gw(self, x):
        """x [..., W_local] -> [..., W]: every rank's walkers in order
        (the identity unsharded; collective)."""
        return self.comm.cat(x, dim=-1)

    def _first_local(self, n_walkers, W):
        """How many of the ensemble's first ``n_walkers`` walkers (all of
        them for None) this rank holds: a prefix of its ``W`` walkers."""
        if n_walkers is None:
            return W
        lo, _ = walker_block(self.comm, W * self.comm.size)
        return max(0, min(n_walkers - lo, W))

    def _mu_scratch(self, energy, volume):
        """Order parameter from scratch (mc_moves.F90:856-862), shifted
        by the reference enthalpies under leshift; energy/volume [L, W]
        -> [W]."""
        prm = self.prm
        mu = (
            energy[0] + prm.pressure * volume[0]
            - energy[1] - prm.pressure * volume[1]
        )
        if prm.leshift:
            rh = self.aux.ref_enthalpy
            mu = mu - rh[0] + rh[1]
        return mu * prm.beta - prm.nwater * torch.log(volume[0] / volume[1])

    def _weight_total(self, s: SamplerState):
        """Per-walker view of the current weight curve: merged master +
        this walker's growth since the last sync.  [B, W]."""
        base = ds_value(s.master_eta)                       # [nwin, B]
        return s.weight + base[s.window_id.long()].T

    def _eta(self, s: SamplerState, mu):
        """Multicanonical weight eta(mu) per walker (batched
        bins.eta_weight; mc_moves.F90:893-964).  Pre-window walkers
        sample the wall-less global curve (window seeding) or, with
        dd_seeding=False, no bias at all."""
        return self._eta_from_weight(s, self._weight_total(s), mu)

    def _eta_from_weight(self, s: SamplerState, weight, mu):
        """eta(mu) against an explicit total weight view [B, W] (the cell
        engine's unfused chains evaluate it against a curve they hold
        themselves)."""
        prm = self.prm
        return eta_lookup(
            self.grid, weight, mu, self.binw, self.mub, s.start_bin,
            s.end_bin, s.my_mu_min, s.my_mu_max, s.in_window,
            prm.eta_interp, prm.dd_seeding)

    @tracing.traced("mw/dd_track")
    def _dd_track_window(self, s: SamplerState, cycle: int):
        """'dd' window membership at the top of cycle ``cycle``
        (mc_cycle:181-210), decided on the host from the cycle counter.

        dd_seeding=True: the flag mirrors the walker's current position
        during equilibration, is frozen at the boundary cycle and is
        all-true after it (the eta wall then pulls strays into their
        windows).  dd_seeding=False: the reference's reach-once flag,
        latched on first entry, all-true after the boundary."""
        prm = self.prm
        eq = prm.eq_mc_cycles
        if cycle > eq:
            s.in_window = torch.ones_like(s.in_window)
            return
        now_in = (s.mu > s.my_mu_min) & (s.mu < s.my_mu_max)
        if not prm.dd_seeding:
            s.in_window = s.in_window | now_in
        elif cycle < eq:
            s.in_window = now_in

    def _switch_ok(self, cycle: int) -> bool:
        """Lattice switches are suppressed during a 'dd' run's
        equilibration (mc_cycle:237-249)."""
        return (self.prm.parallel_strategy != "dd"
                or cycle >= self.prm.eq_mc_cycles)

    # ------------------------------------------------------------------
    # Wang-Landau per-move update (mc_update_wl_bins,
    # mc_moves.F90:1597-1689)
    # ------------------------------------------------------------------

    def _e_tot(self, s):
        """The accurate total energy view.  The dense engine's plain
        accumulator is exact enough (a move's dE >> ulp(total) at
        N <= ~10^3); the cell engine overrides it with its compensated
        (energy + energy_err) pair."""
        return s.energy

    def _wl_healthy(self, s):
        """[W] bool gate for writes into the SHARED WL arrays: walkers
        with non-finite energies never write.  Engine layouts extend it
        (the cell engine adds its slab-overflow audit)."""
        return torch.all(torch.isfinite(s.energy), dim=0)

    def _f_schedule(self, s, sumhist, base_hist=None):
        """The run's f schedule at one update (bins.f_schedule), or None
        for the plain factor.  ``base_hist``: the master histogram view
        [B, W] (Swetnam), built here where not given."""
        if base_hist is None and schedule_kind(self.prm) == SCHED_SWETNAM:
            base_hist = ds_value(s.master_hist)[s.window_id.long()].T
        return f_schedule(self.prm, self.grid, self.binfrac, self.dtype,
                          sumhist, base_hist, s.invt_active, s.cycle)

    def _wl_update(self, s: SamplerState, active: bool):
        """``active``: the move was performed and the WL phase is live
        (cycle >= eq_mc_cycles).  One lattice keeps no WL arrays."""
        if not active or self.prm.num_lattices != 2:
            return
        sched = self._f_schedule(s, s.sumhist)
        s.weight, s.hist, s.uhist, f, sumhist = wl_move_update(
            self.grid, self.prm.samplerun, self.aux.log_unbiased_norm,
            self.binw, s.weight, s.hist, s.uhist,
            lambda mu: self._eta(s, mu), s.mu, s.f, True,
            self._wl_healthy(s), sched)
        if sched is not None:
            s.f, s.sumhist = f, sumhist

    # ------------------------------------------------------------------
    # moves
    # ------------------------------------------------------------------

    def _trial_vectors(self, s: SamplerState, u):
        """Random displacement in the active lattice and the same
        FRACTIONAL displacement in the partner (mc_moves.F90:1021-1067).
        u [>=6, W] -> transvec [L, 3, W]."""
        d0 = 2.0 * u[1] - 1.0
        d1 = 2.0 * u[2] - 1.0
        d2 = 2.0 * u[3] - 1.0
        # guard the zero direction vector against rsqrt(0) = inf
        inv_norm = torch.rsqrt(
            torch.clamp(d0 * d0 + d1 * d1 + d2 * d2, min=1e-30))
        rmag = (2.0 * u[4] - 1.0) * s.max_trans * inv_norm
        return self._map_disp(s, torch.stack([d0 * rmag, d1 * rmag,
                                              d2 * rmag]))

    def _map_disp(self, s: SamplerState, v):
        """Active-lattice displacement v [3, W] -> per-lattice trial
        vectors [L, 3, W]: the same fractional displacement in the
        partner lattice (mc_moves.F90:1042-1067)."""
        sfrac = to_frac(_take_lat(s.recip, s.ls), v)
        return torch.stack([
            torch.where(s.ls == l, v, from_frac(s.h[l], sfrac))
            for l in range(s.h.shape[0])
        ])

    def _cand_tbl(self, cand_r, Hc, p):
        """Candidate terms of the centre at ``p`` [3,W] over its gathered
        table partners cand_r [3,M,W] (single MIC image)."""
        m = self.model
        dx, dy, dz = _mic_fold(cand_r[0] - p[0], cand_r[1] - p[1],
                               cand_r[2] - p[2], Hc)
        r2 = dx * dx + dy * dy + dz * dz
        in_rc = (r2 < m.rc2) & (r2 > 1e-8)
        r2s = torch.where(in_rc, r2, 1.0)
        inv = torch.rsqrt(r2s)
        rij = r2s * inv
        pair_sum = torch.sum(_pair(r2s, rij, in_rc, m), dim=0)
        w = _leg(rij, in_rc, m)
        ux, uy, uz = dx * inv, dy * inv, dz * inv
        wux, wuy, wuz = w * ux, w * uy, w * uz
        # per-candidate delta for partner j (m* sign from j's view)
        delta = Moments(w, -wux, -wuy, -wuz, wux * ux, wuy * uy,
                        wuz * uz, wux * uy, wux * uz, wuy * uz)
        own = Moments(w.sum(0), wux.sum(0), wuy.sum(0), wuz.sum(0),
                      *(f.sum(0) for f in delta[4:]))
        e3i = _e3_closed_form(own, (w * w).sum(0), m.cos0)
        return pair_sum, (w, ux, uy, uz), delta, own, e3i

    def _jcent_rows(self, leg, mm: Moments):
        """Wing-angle sums i-j-k with candidate moments mm [M,W]."""
        c0 = self.model.cos0
        w, ux, uy, uz = leg
        quad = (
            ux * ux * mm.mxx + uy * uy * mm.myy + uz * uz * mm.mzz
            + 2.0 * (ux * uy * mm.mxy + ux * uz * mm.mxz
                     + uy * uz * mm.myz)
        )
        lin = ux * mm.mx + uy * mm.my + uz * mm.mz
        per = (quad + 2.0 * c0 * lin + c0 * c0 * mm.s1
               - (1.0 - c0) ** 2 * w)
        return torch.sum(w * per, dim=0)

    def _translation_tbl(self, s: SamplerState, u, imol: int,
                         wl_active: bool):
        """One table-mode translation of the shared molecule ``imol`` in
        both replicas (mc_water_translation, mc_moves.F90:966-1213):
        candidates are the static table partners, proposals beyond the
        displacement wall are rejected (ops/nbrtable.py).  u [7, W].
        The plain counterpart of one step of the fused kernel; callers
        skip steps whose scheduled move is not a translation (the
        masked step is a no-op)."""
        prm, model = self.prm, self.model
        L = s.r.shape[0]
        lam_eps = model.lam * model.epsilon
        transvec = self._trial_vectors(s, u)                 # [L,3,W]

        e_olds, e_news, p_olds, p_news = [], [], [], []
        cands, effs, owns, in_wall = [], [], [], None
        for l in range(L):
            js = self._partners[l][imol]
            Hc = _h_components(s.h[l])
            p_old = s.r[l, :, imol, :].clone()
            p_new = p_old + transvec[l]
            cand_r = s.r[l][:, js, :]                        # [3,M,W]
            mm_cand = Moments(*s.moments[:, l][:, js, :])
            pair_o, leg_o, del_o, _, e3i_o = self._cand_tbl(cand_r, Hc,
                                                            p_old)
            e_old = pair_o + lam_eps * (
                e3i_o + self._jcent_rows(leg_o, mm_cand))
            pair_n, leg_n, del_n, own_n, e3i_n = self._cand_tbl(
                cand_r, Hc, p_new)
            mm_eff = Moments(*(st - do + dn for st, do, dn in
                               zip(mm_cand, del_o, del_n)))
            e_new = pair_n + lam_eps * (
                e3i_n + self._jcent_rows(leg_n, mm_eff))
            # displacement wall: reference site = H . frac0 (reference
            # positions hold their fractional coordinates through
            # volume moves, mc_volume:1284-1350)
            ref_i = from_frac(s.h[l], self.frac0[l, :, imol, None])
            dw = p_new - ref_i
            ok_l = torch.sum(dw * dw, dim=0) <= self.wall ** 2
            in_wall = ok_l if in_wall is None else in_wall & ok_l
            e_olds.append(e_old)
            e_news.append(e_new)
            p_olds.append(p_old)
            p_news.append(p_new)
            cands.append(torch.stack(list(mm_cand)))
            effs.append(torch.stack(list(mm_eff)))
            owns.append(torch.stack(list(own_n)))
        dE = torch.stack(e_news) - torch.stack(e_olds)       # [L,W]
        accept, mu_new, dmu, ls_next = self._trans_decision(s, dE, u[5],
                                                            in_wall)

        for l in range(L):
            js = self._partners[l][imol]
            s.r[l, :, imol, :] = torch.where(accept, p_news[l], p_olds[l])
            s.moments[:, l, imol, :] = torch.where(
                accept, owns[l], s.moments[:, l, imol, :])
            s.moments[:, l, js, :] = torch.where(accept, effs[l], cands[l])
        s.trans_per_mol[imol] += 1
        self._trans_bookkeeping(s, accept, mu_new, dmu, ls_next, dE,
                                wl_active)

    def _trans_decision(self, s: SamplerState, dE, u_acc, extra_ok=None):
        """Acceptance of a translation with per-lattice energy changes
        dE [L, W] (mc_moves.F90:1113-1146) -> (accept, mu_new, dmu,
        ls_next), all [W].  ``extra_ok``: the displacement wall of table
        mode.  One lattice: the Boltzmann factor of the move alone, mu
        unchanged.  MINU: the move carries the walker to the lattice of
        the lower trial enthalpy (ls_next)."""
        prm = self.prm
        if prm.num_lattices == 1:
            dmu = torch.zeros_like(s.mu)
            diffkT = prm.beta * dE[0]
            ok = torch.isfinite(diffkT)
            if extra_ok is not None:
                ok = ok & extra_ok
            accept = ok & (u_acc < torch.exp(-diffkT))
            return accept, s.mu, dmu, s.ls
        dmu = (dE[0] - dE[1]) * prm.beta
        mu_new = s.mu + dmu                                  # (1113)
        eta_old = self._eta(s, s.mu)
        eta_new = self._eta(s, mu_new)
        diffkT = prm.beta * _take_lat(dE, s.ls) + eta_new - eta_old
        ls_next = s.ls
        if prm.minu:
            diffkT, ls_next = self._minu(s, s.energy, dE, diffkT, eta_old,
                                         eta_new)
        # finite-state guard: never accept non-finite deltas (a
        # poisoned walker would pump WL weight at its stale bin)
        ok = torch.isfinite(diffkT) & torch.isfinite(mu_new)
        if extra_ok is not None:
            ok = ok & extra_ok
        accept = ok & (u_acc < torch.exp(-diffkT))           # (1146)
        return accept, mu_new, dmu, ls_next

    def _minu(self, s: SamplerState, energy, dE, diffkT, eta_old, eta_new):
        """The reference's #ifdef MINU variant (mc_moves.F90:1119-1140):
        the translation carries the walker to the lattice of the lower
        trial enthalpy (the first on a tie, Fortran's minloc), with the
        switch's own terms where that lattice is not the current one.
        energy [L, W] the walker's energies before the move.  Returns
        (diffkT, ls_next)."""
        prm = self.prm
        et = energy + dE                                     # [L,W]
        enth = et
        if prm.mc_ensemble == "npt":
            enth = enth + prm.pressure * s.volume
        rh = self.aux.ref_enthalpy
        if prm.leshift:
            enth = enth - rh[:, None]
        lsn = torch.where(enth[1] < enth[0], 1, 0).to(s.ls.dtype)
        alt = (prm.beta * (_take_lat(et, lsn) - _take_lat(energy, s.ls))
               + eta_new - eta_old)
        if prm.mc_ensemble == "npt":
            V_lsn = _take_lat(s.volume, lsn)
            V_ls = _take_lat(s.volume, s.ls)
            alt = (alt + prm.beta * prm.pressure * (V_lsn - V_ls)
                   - prm.nwater * torch.log(V_lsn / V_ls))
        if prm.leshift:
            alt = alt - prm.beta * (rh[lsn.long()] - rh[s.ls.long()])
        return torch.where(lsn != s.ls, alt, diffkT), lsn

    def _trans_bookkeeping(self, s: SamplerState, accept, mu_new, dmu,
                           ls_next, dE, wl_active: bool):
        """Energies, mu, the lattice (MINU), counters and the per-move WL
        update after a performed translation (mc_moves.F90:1113,
        1156-1159)."""
        # where-based: a rejected overlap proposal can carry non-finite dE
        s.energy = torch.where(accept, s.energy + dE, s.energy)
        s.mu = torch.where(accept, mu_new, s.mu)
        if self.prm.minu:
            s.ls = torch.where(accept, ls_next, s.ls)
        s.att[TRANS] += 1
        s.acc[TRANS] += accept.to(torch.int32)
        admu = torch.abs(dmu)
        s.min_dmu = torch.where(accept & (admu < s.min_dmu), admu,
                                s.min_dmu)
        s.max_dmu = torch.where(accept & (admu > s.max_dmu), admu,
                                s.max_dmu)
        self._wl_update(s, wl_active)

    def _translation(self, s: SamplerState, u, wl_active: bool):
        """One dense-candidate translation (mc_water_translation,
        mc_moves.F90:966-1213): each walker moves its own molecule
        ``min(int(u[0] N), N-1)``, every molecule under every folded
        image shift is a candidate (ops/dense.local_energies_batch), and
        there is no displacement wall.  u [7, W].  The plain counterpart
        of one step of the dense fused kernel; callers skip steps whose
        scheduled move is not a translation."""
        L, _, N, W = s.r.shape
        imol = torch.clamp((u[0] * N).to(torch.int32), max=N - 1)
        transvec = self._trial_vectors(s, u)                 # [L,3,W]
        walker = torch.arange(W, device=s.r.device)
        idx = imol.long()
        e_olds, e_news, effs, p_news = [], [], [], []
        for l in range(L):
            p_new = s.r[l, :, idx, walker] + transvec[l]     # [3,W]
            e_old, e_new, eff = local_energies_batch(
                s.r[l], s.h[l], imol, p_new, Moments(*s.moments[:, l]),
                self.fold_shifts, self.model, True)
            e_olds.append(e_old)
            e_news.append(e_new)
            effs.append(torch.stack(list(eff)))
            p_news.append(p_new)
        dE = torch.stack(e_news) - torch.stack(e_olds)       # [L,W]
        accept, mu_new, dmu, ls_next = self._trans_decision(s, dE, u[5])

        for l in range(L):
            s.r[l, :, idx, walker] = torch.where(
                accept, p_news[l], s.r[l, :, idx, walker])
            s.moments[:, l] = torch.where(accept, effs[l], s.moments[:, l])
        s.trans_per_mol[idx, walker] += 1
        self._trans_bookkeeping(s, accept, mu_new, dmu, ls_next, dE,
                                wl_active)

    def _translation_tbl_multi(self, s: SamplerState, ut, codes, imol: int,
                               wl_active: bool, switch_ok: bool):
        """T = dense_trials anchored-window trials of the shared mover
        ``imol`` on one fetch of its table rows (the JAX package's
        fused._do_translation_tbl_multi; the proposal law is the cell
        engine's multi-trial sub-step).  ut [4 + 5T, W]: slots 1:4 the
        anchor a, 4:4+3T the trial offsets b_t (v_t = (a + b_t) *
        max_trans), then T accept and T switch uniforms; trial t is
        performed if ``codes[t]`` is a translation and followed by a
        switch attempt as a one-trial step is.  Every trial is evaluated
        against the mover's ORIGINAL rows and point 0; the rows of the
        last accepted point are stored once at the end."""
        prm, model = self.prm, self.model
        L, T = s.r.shape[0], self.dT
        lam_eps = model.lam * model.epsilon
        do_switch = self.switches_on()

        js, p0, cand_r, mm_cand, del0, refs = [], [], [], [], [], []
        e_cur, eff_cur, own_cur, p_cur = [], [], [], []
        for l in range(L):
            js.append(self._partners[l][imol])
            p = s.r[l, :, imol, :].clone()
            cr = s.r[l][:, js[l], :]                         # [3,M,W]
            mm = Moments(*s.moments[:, l][:, js[l], :])
            pair0, leg0, d0, _, e3i0 = self._cand_tbl(cr, _h_components(
                s.h[l]), p)
            e_cur.append(pair0 + lam_eps * (e3i0 + self._jcent_rows(leg0,
                                                                    mm)))
            refs.append(from_frac(s.h[l], self.frac0[l, :, imol, None]))
            p0.append(p)
            cand_r.append(cr)
            mm_cand.append(mm)
            del0.append(d0)
            eff_cur.append(torch.stack(list(mm)))
            own_cur.append(s.moments[:, l, imol, :].clone())
            p_cur.append(p)

        anc = 2.0 * ut[1:4] - 1.0                            # [3,W]
        n_en = 0
        for t in range(T):
            code = int(codes[t])
            if code == TRANS:
                n_en += 1
                v = (anc + (2.0 * ut[4 + 3 * t:7 + 3 * t] - 1.0)) \
                    * s.max_trans
                transvec = self._map_disp(s, v)
                e_t, dE, effs, owns, p_ts, in_wall = [], [], [], [], [], None
                for l in range(L):
                    p_t = p0[l] + transvec[l]
                    pair_t, leg_t, del_t, own_t, e3i_t = self._cand_tbl(
                        cand_r[l], _h_components(s.h[l]), p_t)
                    eff = Moments(*(st - d0 + dt for st, d0, dt in
                                    zip(mm_cand[l], del0[l], del_t)))
                    et = pair_t + lam_eps * (e3i_t
                                             + self._jcent_rows(leg_t, eff))
                    e_t.append(et)
                    dE.append(et - e_cur[l])
                    effs.append(torch.stack(list(eff)))
                    owns.append(torch.stack(list(own_t)))
                    p_ts.append(p_t)
                    # displacement wall on the candidate point
                    dw = p_t - refs[l]
                    ok_l = torch.sum(dw * dw, dim=0) <= self.wall * self.wall
                    in_wall = ok_l if in_wall is None else in_wall & ok_l
                dE = torch.stack(dE)
                accept, mu_new, dmu, ls_next = self._trans_decision(
                    s, dE, ut[4 + 3 * T + t], in_wall)
                self._trans_bookkeeping(s, accept, mu_new, dmu, ls_next,
                                        dE, wl_active)
                # fold the accepted point into the running selection
                for l in range(L):
                    e_cur[l] = torch.where(accept, e_t[l], e_cur[l])
                    p_cur[l] = torch.where(accept, p_ts[l], p_cur[l])
                    eff_cur[l] = torch.where(accept, effs[l], eff_cur[l])
                    own_cur[l] = torch.where(accept, owns[l], own_cur[l])
            if do_switch and switch_ok and (
                    code == SWITCH or (prm.mc_always_switch and code == TRANS)):
                self._switch(s, ut[4 + 4 * T + t])

        # one store per T trials
        for l in range(L):
            s.r[l, :, imol, :] = p_cur[l]
            s.moments[:, l, imol, :] = own_cur[l]
            s.moments[:, l, js[l], :] = eff_cur[l]
        s.trans_per_mol[imol] += n_en

    def switches_on(self) -> bool:
        """Lattice switches are attempted at all: two lattices, and
        always-switch or scheduled switches."""
        prm = self.prm
        return prm.num_lattices == 2 and (prm.mc_always_switch
                                          or prm.allow_switch)

    def _switch(self, s: SamplerState, zeta):
        """Lattice switch attempt of every walker (mc_lattice_switch,
        mc_moves.F90:1536-1594); eta cancels since mu is unchanged.  The
        PV and volume-entropy terms only under NPT; leshift subtracts the
        reference enthalpies."""
        prm = self.prm
        lsn = 1 - s.ls
        e_tot = self._e_tot(s)
        E_ls = _take_lat(e_tot, s.ls)
        E_lsn = _take_lat(e_tot, lsn)
        diffkT = prm.beta * (E_lsn - E_ls)
        if prm.mc_ensemble == "npt":
            V_ls = _take_lat(s.volume, s.ls)
            V_lsn = _take_lat(s.volume, lsn)
            diffkT = (diffkT + prm.beta * prm.pressure * (V_lsn - V_ls)
                      - prm.nwater * torch.log(V_lsn / V_ls))
        if prm.leshift:
            rh = self.aux.ref_enthalpy
            diffkT = diffkT - prm.beta * (rh[lsn.long()] - rh[s.ls.long()])
        accept = torch.isfinite(diffkT) & (zeta < torch.exp(-diffkT))
        s.ls = torch.where(accept, lsn, s.ls).to(torch.int32)
        s.mu = torch.where(accept, self._mu_scratch(e_tot, s.volume),
                           s.mu)
        s.att[SWITCH] += 1
        s.acc[SWITCH] += accept.to(torch.int32)

    def _volume(self, s: SamplerState, u):
        """Anisotropic cell move, same strain in both replicas
        (mc_volume, mc_moves.F90:1216-1534); u [W, 4]."""
        prm = self.prm
        L = s.r.shape[0]
        dtype = s.r.dtype
        idim = torch.clamp((u[:, 0] * 3).to(torch.int64), max=2)
        jdim = torch.clamp((u[:, 1] * 3).to(torch.int64), max=2)
        delta = (2.0 * u[:, 2] - 1.0) * s.dv_max
        ar = torch.arange(3, device=u.device)[:, None]
        ei = (ar == idim[None, :]).to(dtype)
        ej = (ar == jdim[None, :]).to(dtype)
        outer = ei[:, None, :] * ej[None, :, :]              # [3,3,W]
        outer_t = outer.transpose(0, 1)
        sym = outer + outer_t - outer * outer_t              # (1276-82)
        h_new = s.h + (sym * delta[None, None, :])[None]     # [L,3,3,W]

        r_new, ref_new = self._vol_rescale(s, h_new)   # ref_new or None
        recip_new = torch.stack([recip_matrix(h_new[l]) for l in range(L)])
        vol_new = torch.abs(
            torch.stack([determinant3(h_new[l]) for l in range(L)]))
        e_new, mom_new = self._vol_energy(s, r_new, h_new)
        e_tot = self._e_tot(s)
        dE = e_new - e_tot

        vol_ls_old = _take_lat(s.volume, s.ls)
        vol_ls_new = _take_lat(vol_new, s.ls)
        two = prm.num_lattices == 2
        if two:
            mu_new = self._mu_scratch(e_new, vol_new)        # (1366-75)
            deta = self._eta(s, mu_new) - self._eta(s, s.mu)
            mu_reject = self._mu_scratch(e_tot, s.volume)    # (1524-28)
        else:
            # one lattice: no order parameter
            mu_new = mu_reject = s.mu
            deta = torch.zeros_like(s.mu)
        diffkT = (                                           # (1380-81)
            prm.beta * _take_lat(dE, s.ls)
            + deta
            + prm.beta * prm.pressure * (vol_ls_new - vol_ls_old)
            - prm.nwater * torch.log(vol_ls_new / vol_ls_old)
        )
        # finite-state + cell-collapse guards, the layout's own guard
        # (table breathing / grid validity), the displacement wall on the
        # RESCALED state where the layout keeps reference positions
        ok = torch.isfinite(diffkT) & (torch.min(vol_new, dim=0).values
                                       > 0.0)
        extra_ok = self._vol_extra_ok(h_new, s)
        if extra_ok is not None:
            ok = ok & extra_ok
        if ref_new is not None and self.wall > 0.0:
            dsp = r_new - ref_new
            d2 = torch.sum(dsp * dsp, dim=1)                 # [L,N,W]
            ok = ok & (torch.amax(d2, dim=(0, 1)) <= self.wall ** 2)
        if prm.mc_vol_wall > 0.0:
            # NPT volume wall: each replica's volume within
            # +-mc_vol_wall (fractional) of its reference lattice volume,
            # a hard wall on the PROPOSED state.  As in the JAX engine the
            # inward clause is not gated on the old state being outside:
            # a proposal outside the wall that moves closer to the
            # reference volumes is legal from anywhere.
            vref = torch.abs(torch.stack([
                determinant3(self.ref_h[l][:, :, None])[0]
                for l in range(L)]))                         # [L]
            ratio_new = vol_new / vref[:, None]              # [L,W]
            inside = torch.all((ratio_new >= 1.0 - prm.mc_vol_wall)
                               & (ratio_new <= 1.0 + prm.mc_vol_wall),
                               dim=0)
            dist_new = torch.sum(torch.abs(torch.log(ratio_new)), dim=0)
            dist_old = torch.sum(
                torch.abs(torch.log(s.volume / vref[:, None])), dim=0)
            ok = ok & (inside | (dist_new < dist_old))
        if two:
            ok = ok & torch.isfinite(mu_new)
        accept = ok & (u[:, 3] < torch.exp(-diffkT))

        if two:
            admu = torch.abs(mu_new - s.mu)
            s.min_dmu = torch.where(accept & (admu < s.min_dmu), admu,
                                    s.min_dmu)
            s.max_dmu = torch.where(accept & (admu > s.max_dmu), admu,
                                    s.max_dmu)
            s.mu = torch.where(accept, mu_new, mu_reject)
        s.r = torch.where(accept, r_new, s.r)
        if ref_new is not None:
            s.ref_r = torch.where(accept, ref_new, s.ref_r)
        s.h = torch.where(accept, h_new, s.h)
        s.recip = torch.where(accept, recip_new, s.recip)
        s.volume = torch.where(accept, vol_new, s.volume)
        s.energy = torch.where(accept, e_new, s.energy)
        s.moments = torch.where(accept, mom_new, s.moments)
        s.att[VOL] += 1
        s.acc[VOL] += accept.to(torch.int32)
        self._post_volume_energy(s, accept)
        self._wl_update(s, s.cycle >= prm.eq_mc_cycles)

    def _post_volume_energy(self, s, accept):
        """Hook after a volume move's from-scratch energy set (the cell
        engine zeroes its compensation residual on accept)."""

    def _vol_rescale(self, s: SamplerState, h_new):
        """Positions and reference positions rescaled at fixed
        fractional coordinates (mc_moves.F90:1284-1350)."""
        out = []
        for pos in (s.r, s.ref_r):
            out.append(torch.stack([
                from_frac(h_new[l][:, :, None, :],
                          to_frac(s.recip[l][:, :, None, :], pos[l]))
                for l in range(pos.shape[0])
            ]))
        return out[0], out[1]

    @tracing.traced("mw/full_energy")
    def _vol_energy(self, s, r, h):
        """Whole-cell energies [L,W] and moments [10,L,N,W] of both
        lattices at positions r, cells h (FullEnergyKernel)."""
        per = [self.full_energy(r[l], h[l]) for l in range(r.shape[0])]
        return (torch.stack([p[0] for p in per]),
                torch.stack([torch.stack(list(p[1])) for p in per], dim=1))

    def _vol_extra_ok(self, h_new, s):
        """The layout's guards on a proposed box ``h_new`` from state
        ``s``, [W] bool, or None where there are none.  Here the
        geometry guard (``s`` is not read; dense candidates have none):
        reject boxes of which a perpendicular width falls to
        ``min_perp_w`` [L,3] or below.  The dense engine's tables could
        miss in-range pairs below 1/BREATHING of the reference widths
        (ops/nbrtable.table_radius), the cell engine's coverage tables
        below 1/guard of the initial ones (ops/cells.build_grid).
        Depends only on the proposed state, so detailed balance
        holds."""
        if self.min_perp_w is None:
            return None
        ok = None
        for l in range(h_new.shape[0]):
            H = h_new[l]                                     # [3,3,W]
            vol = torch.abs(determinant3(H))
            for a in range(3):
                b, c = (a + 1) % 3, (a + 2) % 3
                cx = H[1, b] * H[2, c] - H[2, b] * H[1, c]
                cy = H[2, b] * H[0, c] - H[0, b] * H[2, c]
                cz = H[0, b] * H[1, c] - H[1, b] * H[0, c]
                w = vol * torch.rsqrt(cx * cx + cy * cy + cz * cz)
                cond = w > float(self.min_perp_w[l, a])
                ok = cond if ok is None else ok & cond
        return ok

    def _scheduled_volume_moves(self, s: SamplerState, codes, cycle,
                                switch_ok: bool):
        """This cycle's scheduled volume moves, back to back, each
        followed by a switch attempt under mc_always_switch where
        switches are allowed (hoisted out of the per-move loop as in the
        JAX engine)."""
        nvol = int((codes == VOL).sum())
        tracing.count("volume_moves", nvol)
        W = s.r.shape[-1]
        for k in range(nvol):
            with tracing.span("mw/volume_move"):
                u, zeta2 = self.stream.volume_draws(cycle, k, W, s.r.dtype)
                self._volume(s, u)
                if self.prm.num_lattices == 2 and \
                        self.prm.mc_always_switch and switch_ok:
                    self._switch(s, zeta2)

    # ------------------------------------------------------------------
    # delta-sync (comms_mpi.f90:244-530)
    # ------------------------------------------------------------------

    def _delta_merge(self, delta, master, window_id):
        """Fold every walker's growth [B, W] into its window's
        double-single master row (master [nwin, B]).  Non-finite growth
        is dropped and counted.  Each window's row is a plain sum over
        the walker axis of the growth masked to that window's walkers
        (at most a few tens of windows, one merge every mpi_sync_int
        cycles): deterministic on the card, with no atomics.  Sharded,
        the growth of all walkers is gathered first and summed as in the
        serial run, so the masters are bitwise the serial run's and the
        same on every rank."""
        d = self._gw(delta).T                                # [W, B]
        window_id = self._gw(window_id)
        finite = torch.isfinite(d)
        n_bad = torch.sum(~finite).to(torch.int32)
        d = torch.where(finite, d, 0.0)
        wid = window_id.long()[:, None]                      # [W, 1]
        tot = torch.stack([torch.sum(torch.where(wid == w, d, 0.0), dim=0)
                           for w in range(master.hi.shape[0])])
        return ds_add(master, tot), n_bad

    def _window_mask(self, s: SamplerState):
        """The [nwin, B] in-window bin mask, from the per-walker window
        bounds (all walkers of a window share them; a window without
        walkers masks no bin)."""
        nwin = s.master_eta.hi.shape[0]
        B = self.grid.nbins
        wid = s.window_id.long()
        # this rank's walkers, then the extrema over the ranks
        sbw = self.comm.min(torch.full(
            (nwin,), B, dtype=s.start_bin.dtype, device=wid.device
        ).scatter_reduce(0, wid, s.start_bin, "amin"))
        ebw = self.comm.max(torch.full(
            (nwin,), -1, dtype=s.end_bin.dtype, device=wid.device
        ).scatter_reduce(0, wid, s.end_bin, "amax"))
        bins = torch.arange(B, device=wid.device)[None, :]
        return (bins >= sbw[:, None]) & (bins <= ebw[:, None])

    @tracing.traced("mw/delta_sync")
    def _sync_all(self, s: SamplerState):
        """Merge weights and histograms across the walkers of each window
        (mc_cycle:258-278) and re-zero the per-walker deltas (one lattice
        keeps no WL arrays)."""
        prm = self.prm
        if prm.num_lattices != 2:
            return s
        wid = s.window_id
        m_eta, bad_w = self._delta_merge(s.weight, s.master_eta, wid)
        if not prm.samplerun:
            # re-zero each window's merged in-window minimum (uniform
            # shift, mc_moves.F90:1680-1685, deferred to syncs); exact in
            # DS; the bins outside a window (the warm-start seeding
            # curve) stay untouched
            winmask = self._window_mask(s)                   # [nwin, B]
            val = ds_value(m_eta)
            minv = torch.amin(torch.where(winmask, val, float("inf")),
                              dim=1, keepdim=True)
            minv = torch.where(torch.isfinite(minv), minv, 0.0)
            m_eta = ds_where(winmask, ds_sub(m_eta, minv), m_eta)
        m_hist, bad_h = self._delta_merge(s.hist, s.master_hist, wid)
        s.weight = torch.zeros_like(s.weight)
        s.hist = torch.zeros_like(s.hist)
        s.master_eta, s.master_hist = m_eta, m_hist
        s.dropped = s.dropped + bad_w + bad_h
        if prm.samplerun:
            s.master_uhist, bad_u = self._delta_merge(s.uhist,
                                                      s.master_uhist, wid)
            s.uhist = torch.zeros_like(s.uhist)
            s.dropped = s.dropped + bad_u
        return s

    # ------------------------------------------------------------------
    # chain synchronisation (mc_check_chain_synchronisation,
    # mc_moves.F90:2217-2416)
    # ------------------------------------------------------------------

    @tracing.traced("mw/chain_resync")
    def _resync_chains(self, s: SamplerState):
        """Force lattice 2's cell displacement and every molecule's
        fractional displacement from its reference site to equal
        lattice 1's, then recompute energies from scratch (nothing to
        do with one lattice)."""
        L = s.r.shape[0]
        if L != 2:
            return s
        h = s.h.clone()
        h[1] = self.ref_h[1][:, :, None] + (
            s.h[0] - self.ref_h[0][:, :, None])
        recip = torch.stack([recip_matrix(h[l]) for l in range(L)])
        frac = [to_frac(recip[l][:, :, None, :], s.r[l]) for l in range(L)]
        frac_ref = [to_frac(recip[l][:, :, None, :], s.ref_r[l])
                    for l in range(L)]
        s2 = frac_ref[1] + (frac[0] - frac_ref[0])
        r = s.r.clone()
        r[1] = from_frac(h[1][:, :, None, :], s2)
        vol = torch.abs(torch.stack([determinant3(h[l]) for l in range(L)]))
        energy, moments = self._vol_energy(s, r, h)
        s.r, s.h, s.recip, s.volume = r, h, recip, vol
        s.energy, s.moments = energy, moments
        s.mu = self._mu_scratch(energy, vol)
        return s

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def audit_energy(self, s: SamplerState, n_walkers: int | None = None):
        """Recompute energies + moments of the first ``n_walkers``
        walkers (all by default) from scratch over the full image
        enumeration (no MIC folding, so a box shrunk below the MIC bound
        shows as drift), overwrite them, and return drift [L, n]
        (mc_monitor_stats:1781-1792).  Sharded, ``n_walkers`` counts from
        the ensemble's first walker and the drift is this rank's part."""
        n = self._first_local(n_walkers, s.r.shape[-1])
        L = s.r.shape[0]
        per = [full_energy_batch(s.r[l, ..., :n], s.h[l, ..., :n],
                                 self.aux.shifts, self.model, False)
               for l in range(L)]
        fresh = torch.stack([p[0] for p in per])
        drift = s.energy[:, :n] - fresh
        s.energy[:, :n] = fresh
        s.moments[..., :n] = torch.stack(
            [torch.stack(list(p[1])) for p in per], dim=1)
        return s, drift

    # ------------------------------------------------------------------
    # cycle loop
    # ------------------------------------------------------------------

    def _one_cycle(self, s: SamplerState):
        prm = self.prm
        L, _, N, W = s.r.shape
        s.cycle += 1
        cycle = s.cycle
        if prm.parallel_strategy == "dd" and L == 2:
            self._dd_track_window(s, cycle)
        switch_ok = self._switch_ok(cycle)
        codes, sched_mol, cycle_u = self.stream.cycle_draws(
            cycle, self.probs, N, W, s.r.dtype, trials=self.dT,
            shared_mol=not self.dense)
        # every translation, switch attempt and per-move WL update of
        # the cycle (mc_cycle's hot loop, mc_moves.F90:224-250)
        self.fused_cycle(s, codes, sched_mol, cycle_u,
                         wl_active=cycle >= prm.eq_mc_cycles,
                         switch_ok=switch_ok)
        # the rare volume moves, hoisted after the step loop
        if prm.mc_ensemble == "npt" and prm.allow_vol:
            self._scheduled_volume_moves(s, codes, cycle, switch_ok)
        # block-average energy accumulation (mc_cycle:252-255), an
        # enthalpy under NPT
        s.avg_energy = s.avg_energy + s.energy
        if prm.mc_ensemble == "npt":
            s.avg_energy = s.avg_energy + prm.pressure * s.volume
        if cycle % prm.mpi_sync_int == 0:
            self._sync_all(s)
        if cycle % prm.latt_sync_int == 0:
            self._resync_chains(s)
        T = min(prm.therm_walkers, W)
        return {
            "cycle": cycle,
            "E_ls": _take_lat(s.energy, s.ls)[:T],
            "mu": s.mu[:T],
            "vol": s.volume[:, :T],
            "ls": s.ls[:T],
        }

    def run_cycles(self, s: SamplerState, n_cycles: int):
        """Advance the state ``n_cycles`` cycles IN PLACE; returns
        (state, samples) with the per-cycle therm samples of the first
        therm_walkers walkers stacked along a leading cycle axis
        (main.f90:200-223).  Each cycle keeps the first therm_walkers of
        this rank's walkers; sharded, one gather at the end brings the
        ensemble's first therm_walkers to every rank."""
        rows = []
        for _ in range(n_cycles):
            with tracing.span("mw/cycle"):
                rows.append(self._one_cycle(s))
            tracing.count("cycles")
        T = min(self.prm.therm_walkers, s.r.shape[-1] * self.comm.size)
        samples = {"cycle": torch.as_tensor([r["cycle"] for r in rows])}
        for k in ("E_ls", "mu", "vol", "ls"):
            samples[k] = self._gw(torch.stack([r[k] for r in rows]))[..., :T]
        return s, samples

    def merged_histogram(self, s: SamplerState):
        """Fully merged weights and histograms (the delta-sync, run
        now)."""
        return self._sync_all(s)

    def resync_chains(self, s: SamplerState):
        """The chain resync, run now (a restart from a checkpoint)."""
        return self._resync_chains(s)


def _check_scope(prm: RunParams, aux: EngineAux) -> None:
    # the multi-trial envelope, with the JAX engine's messages
    # (engine.py:139-162 of the JAX package; the port always runs the
    # fused cycle, so it has no counterpart of the "fused" check)
    dT = max(1, int(prm.dense_trials))
    if dT > 1:
        if prm.num_lattices != 2:
            raise ValueError("dense_trials > 1 requires num_lattices = 2")
        if aux.nbr_tbl is None:
            raise ValueError(
                "dense_trials > 1 requires the candidate-reduction table "
                "mode (nbr_table; MIC-unique box)")
        if prm.nwater % dT:
            raise ValueError(
                f"dense_trials={dT} must divide nwater={prm.nwater} "
                "(trials per cycle stay nwater)")
