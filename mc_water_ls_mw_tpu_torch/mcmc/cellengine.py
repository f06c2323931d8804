"""Large-N parallel cell-sweep MC engine, on tensors.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/cellengine.py`` (whose
docstring derives the construction): one trial per scheduled mover
(``cell_trials=1``) or T anchored-window trials per mover
(``cell_trials=T > 1``, ``_substep_multi``), with every combination of
the JAX engine's modes:

* the sub-step's energies from the mover kernels (``cell_pallas`` 'on'
  or 'apply') or from the unfused tensor code of ops/cell_energy.py
  (``'off'``, the JAX engine's XLA sub-step);
* the movers applied by the in-place apply kernel (``'apply'``, disjoint
  same-colour stencils) or by a scatter of per-candidate deltas (the
  mover kernel's delta output with 'on' at one trial per mover, the
  unfused candidate stores with 'off');
* the acceptance chain in the chain + WL kernel (``cell_chain`` 'on')
  or in the JAX engine's XLA chains (``'off'``): at one trial per mover
  the micro-batched chain (eta frozen for the sub-step, its WL
  increments in one batched update after it), at T > 1 the per-move
  chain over the K x T trials.

* Space is partitioned by the two-level mid-frame cell grid of
  ops/cells.py.  One sub-step picks ONE random molecule in every coarse
  cell of the active colour (in the scheduled fine block) and proposes
  translations for all K of them at once; same-colour movers are > 2*rc
  apart in both replicas, so their energy changes and moment updates are
  exactly independent.
* The accept/reject chain stays EXACT: energies are evaluated in
  parallel, acceptance runs sequentially over the movers because mu,
  eta(mu) and the WL weights couple all moves, then the accepted movers
  are applied in parallel (at T > 1 once, at each mover's final point).
* A move that would cross the mover's stored FINE-cell boundary is
  rejected (a state-only-dependent hard wall), which keeps the static
  coverage tables exact between rebins; the grid origin is re-drawn and
  the molecules re-binned every ``list_update_int`` cycles.  With
  ``cell_trans_wall > 0`` a proposal farther than the wall from the
  mover's lattice-1 reference site (``CellAux.fref0``) is rejected too,
  and so is a volume move that would rescale a molecule past it.
* Volume moves (with the ``mc_vol_wall`` volume wall), lattice switches
  outside the chain, the delta-sync, the eta lookups and the 'dd' window
  tracking and switch gating are inherited from the dense ``Engine``;
  ``CellState`` carries the same multicanonical fields.

On CUDA tensors the wrappers launch their hand-written kernels; on
CPU tensors they run their plain versions, so what is computed does not
depend on the device.  Differences from the JAX engine:

* the sub-step loop is a Python loop (the JAX package traces one
  sub-step into a ``lax.scan``); inside it the packed slabs and the
  chain's cf/ci rows are the truth and are updated IN PLACE, packed once
  and unpacked once per cycle; the XLA chains are Python loops over the
  trials, branching on the shared move codes on the host;
* the state is a dataclass updated in place, ``cycle`` is a host int
  and randomness comes from the engine's stream (mcmc/engine.py);
* ``cell_pallas='auto'`` and ``cell_chain='auto'`` resolve on every
  device as the JAX engine resolves them on an accelerator: 'apply' where
  same-colour stencils are disjoint, else 'on' at one trial per mover
  and the unfused sub-step at T > 1, and the chain kernel wherever the
  mover kernels run (the JAX package's 'auto' picks its unfused
  sub-step and micro-batched chain on a CPU).

One lattice (the single-box NPT run: no mu, no switch, no WL) runs the
mover kernels at L = 1 with the XLA chains, as the JAX engine does
(the chain kernel takes two lattices); NVT, MINU, leshift and the
Swetnam and 1/t schedules run in every mode.  Padded coverage tables
(which no caller of either package builds) are refused with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..models.sw import SWParams
from ..ops.cell_energy import mover_energies, mover_point_energies
from ..ops.cell_kernels import (
    MoverApplyKernel,
    MoverEnergiesKernel,
    MoverPointsKernel,
)
from ..ops.cells import (
    PK_R0,
    PK_ROWS,
    PK_VALID,
    CellGrid,
    bin_molecules,
    cell_of_frac,
    gather_from_slab,
    scatter_to_slab,
)
from ..ops.dense import Moments
from ..ops.dsfloat import DS, _two_sum, ds_value, ds_zeros
from ..ops.geometry import determinant3, from_frac, recip_matrix, to_frac
from ..ops.slab_energy import SlabEnergyKernel
from .bins import (
    SCHED_INVT,
    SCHED_SWETNAM,
    BinGrid,
    invt_cap,
    mu_to_bin,
    schedule_kind,
    wl_move_update,
)
from .chain_kernel import (
    CF_CMU,
    CF_E0,
    CF_E0E,
    CF_F,
    CF_MAX_DMU,
    CF_MIN_DMU,
    CF_MINUC,
    CF_MU,
    CF_MU_MAX,
    CF_MU_MIN,
    CF_ROWS,
    CF_SUMHIST,
    CF_SWC,
    CI_END,
    CI_INVT,
    CI_INWIN,
    CI_LS,
    CI_OCCOK,
    CI_ROWS,
    CI_START,
    CI_SWOK,
    CN_ACC,
    CN_EN,
    CN_FIXED,
    CN_SWACC,
    CN_SWEN,
    ChainWLKernel,
)
from .config import RunParams
from .engine import SWITCH, TRANS, Engine, _take_lat
from .state import (
    _DTYPES,
    EngineAux,
    aux_from_numpy,
    clone_state,
    compute_log_unbiased_norm,
    fields_from_numpy,
    resolve_device,
    state_to_numpy,
    warm_start_rows,
    window_layout,
)

@dataclasses.dataclass
class CellState:
    """Sampler state in slab layout; field names shadow SamplerState so
    that the inherited Engine methods (eta/WL/switch/volume/sync) work
    unchanged.  Trailing axis = walker everywhere."""

    # configurational state, slab layout (nslot = nfine*cap >= N)
    r: torch.Tensor              # [L,3,nslot,W] positions (slab slots)
    h: torch.Tensor              # [L,3,3,W]
    recip: torch.Tensor          # [L,3,3,W]
    volume: torch.Tensor         # [L,W]
    energy: torch.Tensor         # [L,W]
    # compensated-summation residual of the incremental energy: true
    # energy = energy + energy_err.  At N ~ 10^4 a move's dE (~1e-5 Ha)
    # is of the size of the f32 ulp of the total (~152 Ha * 2^-23), so a
    # plain accumulation quantises and drifts.  Every chain update
    # two-sums into (energy, energy_err); every from-scratch refresh
    # (volume accepts, resync, audits) zeroes the residual.
    energy_err: torch.Tensor     # [L,W]
    mu: torch.Tensor             # [W]
    ls: torch.Tensor             # [W] int32
    moments: torch.Tensor        # [10,L,nslot,W] (Moments field order)

    # slab bookkeeping
    slot2mol: torch.Tensor       # [nslot,W] int32, -1 = empty
    mol2slot: torch.Tensor       # [N,W] int32
    origin: torch.Tensor         # [3] fractional grid origin (shared)
    occ_overflow: torch.Tensor   # [W] int32 max(occupancy-cap) observed

    # multicanonical state (as SamplerState: per-walker growth since
    # the last sync + double-single master totals)
    weight: torch.Tensor
    hist: torch.Tensor
    uhist: torch.Tensor
    f: torch.Tensor
    sumhist: torch.Tensor
    invt_active: torch.Tensor
    firstcycle: torch.Tensor
    histogram_reset: torch.Tensor
    master_eta: DS
    master_hist: DS
    master_uhist: DS
    window_id: torch.Tensor
    my_mu_min: torch.Tensor
    my_mu_max: torch.Tensor
    start_bin: torch.Tensor
    end_bin: torch.Tensor
    in_window: torch.Tensor

    # counters / step sizes (as SamplerState)
    max_trans: torch.Tensor
    dv_max: torch.Tensor
    att: torch.Tensor
    acc: torch.Tensor
    trans_per_mol: torch.Tensor
    avg_energy: torch.Tensor
    min_dmu: torch.Tensor
    max_dmu: torch.Tensor

    cycle: int                   # host counter
    dropped: torch.Tensor        # int32 scalar (delta-merge drops)

    def clone(self) -> "CellState":
        return clone_state(self)


class CellAux(NamedTuple):
    """Static large-N extras alongside EngineAux.  (The JAX package's
    CellAux also carries the mismatch bound, which its engine never
    reads.)"""

    dfrac0: torch.Tensor      # [3,N] invariant correspondence mismatch
                              # f1 - f2 per molecule (models/stacking.py)
    fref0: torch.Tensor | None = None  # [3,N] lattice-1 reference
                              # fractional sites, the anchor of the
                              # displacement wall (cell_trans_wall)


def cell_state_from_numpy(fields: dict, aux_fields: dict, caux_fields: dict,
                          device="cuda"):
    """(CellState, EngineAux, CellAux) from plain numpy dicts, the
    counterpart of state.state_from_numpy: ``fields`` maps every
    CellState field name to an array (``moments`` [10,L,nslot,W]; the DS
    masters to (hi, lo) pairs); other keys of the three dicts are
    ignored, and so is a missing or None ``fref0``."""
    device = resolve_device(device)
    state = CellState(**fields_from_numpy(CellState, fields, device))
    dtype = state.r.dtype
    caux = CellAux(**{
        k: torch.as_tensor(np.array(caux_fields[k]), dtype=dtype,
                           device=device)
        for k in CellAux._fields if caux_fields.get(k) is not None})
    return state, aux_from_numpy(aux_fields, dtype, device), caux


def cell_state_to_numpy(state: CellState) -> dict:
    """Plain numpy dict of a CellState (the inverse of
    cell_state_from_numpy)."""
    return state_to_numpy(state)


class _LoopRows(NamedTuple):
    """What the sub-step loop carries besides the packed slabs: the
    chain kernel's rows (mcmc/chain_kernel.py), updated in place, and
    the mover-selection tables, constant between rebins."""

    cf: torch.Tensor        # [CF_ROWS, W]
    ci: torch.Tensor        # [CI_ROWS, W] int32
    basew: torch.Tensor     # [B, W] master weight view
    inc: torch.Tensor       # [K, 2, W] in-cell flags of the two points
                            # of a single-trial sub-step; point 0 (the
                            # current position) stays 1
    occ_f: torch.Tensor     # [n_tables, K, W] occupancy of each table's
                            # scheduled fine cells, as the float type
    rank_max: torch.Tensor  # [n_tables, K, W] int32 max(occupancy-1, 0)
    occupied: torch.Tensor  # [n_tables, K, W] bool occupancy > 0
    switch_ok: bool = True  # the chain's switch attempts are allowed
                            # (host copy of ci[CI_SWOK])
    baseh: torch.Tensor | None = None  # [B, W] master histogram view
                            # (the Swetnam schedule only)


class _Tab(NamedTuple):
    """One row of the stacked (colour, fine-block) tables as the sub-step
    phases read it.  The serial engine's rows address the whole slabs,
    where a mover's slab row is its fine id; the spatially sharded
    engine (parallel/spatial.py) builds rows over a rank's local slab
    [owned | lo halo | hi halo | dummy], where they differ."""

    t: int                  # the table row (index of the loop rows' tables)
    fc: torch.Tensor        # [K] int32 fine ids of the movers' cells
    row: torch.Tensor       # [K] int32 the movers' cells' slab rows
    cand: torch.Tensor      # [K, CF] int32 slab rows of the stencil cells
    off: torch.Tensor       # [K, CF, 3] int32 their box shifts
    cand_l: torch.Tensor    # [K, CF] int64 (cand for torch indexing)
    slot_base: torch.Tensor   # [K, 1] int64 first slab slot of each mover
    coord_base: torch.Tensor  # [3, K, 1] int64 offsets of the movers'
                              # coordinate rows in a packed slab viewed
                              # as [rows, W] (add the mover's rank)
    mom_base: torch.Tensor    # [10, K, 1] int64 likewise, moment rows


def make_tab(t: int, fc, row, cand, off, cap: int) -> _Tab:
    """The ``_Tab`` of table row ``t`` whose K movers have fine ids
    ``fc`` and slab rows ``row`` ([K] int32), stencil rows ``cand`` and
    shifts ``off`` (int32), in slabs of ``cap`` slots a cell."""
    r = row.long()
    first = lambda n: torch.arange(n, device=r.device)[:, None]  # noqa: E731
    return _Tab(t, fc, row, cand, off, cand.long(), (r * cap)[:, None],
                ((r[None] * PK_ROWS + PK_R0 + first(3)) * cap)[..., None],
                ((r[None] * PK_ROWS + first(10)) * cap)[..., None])


class _Trial(NamedTuple):
    """One sub-step's K proposals (``CellEngine._propose_t1``)."""

    rank: torch.Tensor      # [K, W] int32 slot rank of each mover
    slot: torch.Tensor      # [K, W] int64 slab slot of each mover
    p_old: torch.Tensor     # [L, 3, K, W]
    p_new: torch.Tensor     # [L, 3, K, W]
    e: torch.Tensor         # [L, K, 2, W] local energies (old, new)
    own_new: torch.Tensor   # [L, K, 10, W] the movers' new own moments
    hasm: torch.Tensor      # [K, W] float 0/1: the trial exists
    dlt: torch.Tensor | None = None  # [L, K, CF, 10, cap, W] per-candidate
                                     # moment deltas (the scatter path)


class _TrialTM(NamedTuple):
    """One multi-trial sub-step's proposals (``CellEngine._propose_tm``):
    P = T + 1 points per mover, point 0 its stored position."""

    rank: torch.Tensor      # [K, W] int32 slot rank of each mover
    slot: torch.Tensor      # [K, W] int64 slab slot of each mover
    pts: torch.Tensor       # [P, L, 3, K, W] evaluation points
    inc: torch.Tensor       # [K, P, W] float 0/1 in-cell flag per point
    e: torch.Tensor         # [L, K, P, W] local energies per point
    own: torch.Tensor       # [L, K, P, 10, W] own moments per point
    hasm: torch.Tensor      # [K, W] float 0/1: the trial exists
    cs: list | None = None  # per lattice, the P candidate stores of
                            # cell_energy.mover_point_energies (the
                            # unfused sub-step only)


class CellEngine(Engine):
    """Engine for large systems; inherits the multicanonical machinery
    from Engine and replaces the configurational layout."""

    def __init__(self, prm: RunParams, model: SWParams, grid: BinGrid,
                 aux: EngineAux, cellgrid: CellGrid, cellaux: CellAux,
                 device="cuda", stream=None, comm=None):
        self.cellgrid = cellgrid
        self.cellaux = cellaux
        super().__init__(prm, model, grid, aux, device=device,
                         stream=stream, comm=comm)

    def _check_scope(self, prm: RunParams, aux: EngineAux) -> None:
        """The cell engine's envelope is checked by _resolve_modes (the
        dense engine's multi-trial checks do not apply)."""

    def _init_layout(self):
        prm, cg = self.prm, self.cellgrid
        dev = self.device
        self.wall = 0.0
        # volume-move geometry guard: the static coverage tables were
        # built from the initial boxes with the shrink factor ``guard``
        # baked in; the volume move rejects any box whose perpendicular
        # widths shrink below 1/guard of the initial ones
        self.min_perp_w = np.asarray(cg.perp_w0) / cg.guard

        # static per-(colour, fine-block) tables.  A sub-step is
        # scheduled at a (colour, block) pair, so every mover's FINE
        # cell is static: its candidate set is the per-fine-cell
        # coverage stencil (cells.full_cells).  Same-colour movers'
        # stencils are DISJOINT where the stencil is the 27-cell cube
        # and m >= 2 (fine cells at least the coverage radius wide);
        # verified explicitly per table, since the in-place apply stage
        # relies on it.  Narrower fine cells need the 75-cell stencil,
        # and those of same-colour movers overlap.
        m3 = cg.m ** 3
        unpadded = bool(np.all(cg.full_mask))
        self.scatter_unique = unpadded
        fc_rows, cand_rows, off_rows = [], [], []
        for col in range(8):
            cells_c = np.asarray(cg.color_cells[col])
            for b in range(m3):
                fc = cg.block_cells[cells_c][:, b]          # [K]
                cand = cg.full_cells[fc]                    # [K, CF]
                if len(np.unique(cand)) != cand.size:
                    self.scatter_unique = False
                fc_rows.append(fc)
                cand_rows.append(cand)
                off_rows.append(cg.full_off[fc])            # [K, CF, 3]
        if not unpadded:
            raise NotImplementedError(
                "padded coverage tables (cells.build_grid full_mask not "
                "all True) are not ported yet (see ROADMAP.md)")
        # stacked (colour, block) tables, row t = colour*m^3 + block:
        # int32 for the kernels, and as int64 row offsets for torch
        # indexing: of the movers' slots in the [nslot, W] slabs and of
        # their coordinate rows in a packed slab viewed as [rows, W]
        i32 = lambda a: torch.as_tensor(                    # noqa: E731
            np.ascontiguousarray(np.stack(a), np.int32), device=dev)
        self.fc_stack = i32(fc_rows)                        # [8*m3,K]
        self.cand_stack = i32(cand_rows)                    # [8*m3,K,CF]
        self.off_stack = i32(off_rows)                      # [8*m3,K,CF,3]
        self.fc_stack_l = self.fc_stack.long()
        self.half_dfrac0 = 0.5 * self.cellaux.dfrac0        # [3,N]
        self.n_tables = 8 * m3
        self.tabs = [make_tab(t, self.fc_stack[t], self.fc_stack[t],
                              self.cand_stack[t], self.off_stack[t], cg.cap)
                     for t in range(self.n_tables)]
        self.K = cg.cells_per_color
        # one sweep = one trial per (coarse cell, fine block); the trial
        # count per cycle matches nwater to within rounding
        self.T = int(prm.cell_trials)
        if self.T < 1:
            raise ValueError(f"cell_trials must be >= 1, not {self.T}")
        self.sweeps_per_cycle = max(
            1, int(round(prm.nwater / (cg.ncoarse * m3 * self.T))))
        self.trials_per_cycle = (
            self.sweeps_per_cycle * cg.ncoarse * m3 * self.T)
        # uniforms per (sub-step, mover, walker): selection, direction
        # (3), magnitude, accept, switch at T = 1; selection, anchor (3),
        # T candidates (3 each), T accept and T switch uniforms at T > 1
        self.n_u = 7 if self.T == 1 else 4 + 5 * self.T

        self._resolve_modes()
        if self.use_cell_pallas and self.T == 1:
            self.mover_kernel = MoverEnergiesKernel(
                self.model, cg, with_deltas=not self.use_cell_apply)
        elif self.use_cell_pallas:
            self.points_kernel = MoverPointsKernel(self.model, cg,
                                                   self.T + 1)
        if self.use_cell_apply:
            self.apply_kernel = MoverApplyKernel(self.model, cg)
        if self.use_chain_kernel:
            self.chain_kernel = ChainWLKernel(
                prm, self.grid, self.K, self.T,
                float(self.aux.log_unbiased_norm))
        # the whole-cell energy of both lattices (volume moves, resyncs,
        # audits): one kernel launch a call on the card
        self.slab_energy = SlabEnergyKernel(self.model, cg, dev)

    def _resolve_modes(self):
        """``cell_pallas`` / ``cell_chain`` as the JAX engine resolves
        them on an accelerator (its CellEngine.__init__), on an unpadded
        grid; sets ``use_cell_pallas``, ``use_cell_apply`` and
        ``use_chain_kernel`` under the JAX names.  'apply' (or 'auto'
        where same-colour stencils are disjoint) applies the movers with
        the in-place apply kernel; 'on' (or 'auto' where they overlap, at
        one trial per mover) scatters the mover kernel's per-candidate
        deltas; 'off' (or 'auto' at T > 1 where they overlap: the
        multi-point kernel has no delta output) runs the unfused
        sub-step.  ``cell_chain`` 'on' runs the chain kernel, 'off' the
        XLA chains, 'auto' the kernel wherever the mover kernels run with
        two lattices (the kernel implements the two-replica rule; one
        lattice runs the XLA chains).  The modes depend on the settings
        and the grid only."""
        pallas, chain, T = self.prm.cell_pallas, self.prm.cell_chain, self.T
        if pallas in ("on", "apply"):
            if pallas == "apply" and not self.scatter_unique:
                raise ValueError(
                    "cell_pallas='apply' needs disjoint same-colour "
                    "coverage stencils (scatter_unique)")
            self.use_cell_pallas = True
            self.use_cell_apply = pallas == "apply"
        elif pallas == "auto":
            self.use_cell_apply = self.scatter_unique
            self.use_cell_pallas = T == 1 or self.use_cell_apply
        elif pallas == "off":
            self.use_cell_pallas = self.use_cell_apply = False
        else:
            raise ValueError(f"cell_pallas={pallas!r}")
        if T > 1 and self.use_cell_pallas and not self.use_cell_apply:
            raise ValueError(
                "cell_trials > 1 supports cell_pallas in ('off', "
                "'apply', 'auto'): the multi-point kernel has no "
                "per-candidate delta output for the 'on' scatter path")
        if chain not in ("auto", "on", "off"):
            raise ValueError(f"cell_chain={chain!r}")
        two = self.prm.num_lattices == 2
        if chain == "on" and not two:
            raise ValueError("cell_chain='on' requires num_lattices = 2")
        self.use_chain_kernel = chain == "on" or (
            chain == "auto" and two and self.use_cell_pallas)

    # ------------------------------------------------------------------
    # compensated energy accumulation (see CellState.energy_err)
    # ------------------------------------------------------------------

    def _e_tot(self, s):
        return s.energy + s.energy_err

    def _post_volume_energy(self, s, accept):
        # from-scratch energy on accept: zero the residual there
        s.energy_err = torch.where(accept[None, :], 0.0, s.energy_err)

    # ------------------------------------------------------------------
    # full-cell energy (slab)
    # ------------------------------------------------------------------

    def _slab_valid(self, s: CellState):
        return s.slot2mol >= 0

    @tracing.traced("mw/full_energy")
    def _full_both(self, s: CellState, r, h, n=None):
        """Energies [L,n] and moments [10,L,nslot,n] from scratch for the
        first ``n`` walkers (all by default) at positions r, cells h."""
        return self.slab_energy(r[..., :n], self._slab_valid(s)[:, :n],
                                h[..., :n])

    # ------------------------------------------------------------------
    # one colour sub-step: K parallel movers, exact sequential chain
    # ------------------------------------------------------------------

    def _pack(self, s: CellState):
        """Pack each lattice's slabs into ONE [nfine, PK_ROWS, cap, W]
        tensor (moment rows 0:10, coordinate rows PK_R0:PK_R0+3, validity
        row PK_VALID) for the sub-step loop: the layout the mover
        kernels take.  One copy per cycle; validity is static between
        rebins, which only happen outside the loop."""
        cg = self.cellgrid
        L, _, _, W = s.r.shape
        nfine, cap = cg.nfine, cg.cap
        valid = self._slab_valid(s).to(s.r.dtype).reshape(nfine, cap, W)
        pks = []
        for l in range(L):
            pk = torch.empty((nfine, PK_ROWS, cap, W), dtype=s.r.dtype,
                             device=s.r.device)
            pk[:, 0:10] = s.moments[:, l].reshape(
                10, nfine, cap, W).permute(1, 0, 2, 3)
            pk[:, PK_R0:PK_R0 + 3] = s.r[l].reshape(
                3, nfine, cap, W).permute(1, 0, 2, 3)
            pk[:, PK_VALID] = valid
            pks.append(pk)
        return pks

    def _unpack(self, s: CellState, pks) -> CellState:
        """Write the canonical r / moments slabs back out of the packed
        slabs (inside the sub-step loop s.r / s.moments are stale: the
        packed tensors are the truth there)."""
        nfine, _, cap, W = pks[0].shape
        for l, pk in enumerate(pks):
            s.moments[:, l] = pk[:, 0:10].permute(1, 0, 2, 3).reshape(
                10, nfine * cap, W)
            s.r[l] = pk[:, PK_R0:PK_R0 + 3].permute(1, 0, 2, 3).reshape(
                3, nfine * cap, W)
        return s

    def _loop_rows(self, s: CellState, switch_ok=True) -> _LoopRows:
        """The sub-step loop's rows from the state.  Of the chain rows
        everything but the chain state proper (mu, energies, residuals,
        dmu extrema, ls) is constant over a cycle's loop: volumes,
        windows and the masters only change outside it; so is the
        occupancy of the fine cells (molecules change cells only at a
        rebin)."""
        W = s.mu.shape[0]
        L = s.energy.shape[0]
        dtype, dev = s.mu.dtype, s.mu.device
        cf = torch.zeros((CF_ROWS, W), dtype=dtype, device=dev)
        cf[CF_E0:CF_E0 + L] = s.energy
        cf[CF_E0E:CF_E0E + L] = s.energy_err
        for row, val in (
                (CF_MU, s.mu), (CF_F, s.f), (CF_SUMHIST, s.sumhist),
                (CF_MIN_DMU, s.min_dmu), (CF_MAX_DMU, s.max_dmu),
                (CF_MU_MIN, s.my_mu_min), (CF_MU_MAX, s.my_mu_max)):
            cf[row] = val
        if L == 2:
            cf[CF_CMU], cf[CF_SWC], cf[CF_MINUC] = \
                self._hoisted_chain_terms(s)
        ci = torch.zeros((CI_ROWS, W), dtype=torch.int32, device=dev)
        for row, val in (
                (CI_LS, s.ls), (CI_START, s.start_bin), (CI_END, s.end_bin),
                (CI_INWIN, s.in_window), (CI_INVT, s.invt_active),
                (CI_OCCOK, s.occ_overflow == 0),
                (CI_SWOK, int(bool(switch_ok)))):
            ci[row] = val
        basew = ds_value(s.master_eta)[s.window_id.long()].T.contiguous()
        baseh = None
        if schedule_kind(self.prm) == SCHED_SWETNAM:
            baseh = ds_value(s.master_hist)[s.window_id.long()].T \
                .contiguous()
        occ = torch.sum(s.slot2mol.view(-1, self.cellgrid.cap, W) >= 0,
                        dim=1, dtype=torch.int32)[self.fc_stack_l]
        return _LoopRows(
            cf, ci, basew,
            inc=torch.ones((self.K, 2, W), dtype=dtype, device=dev),
            occ_f=occ.to(dtype), rank_max=torch.clamp(occ - 1, min=0),
            occupied=occ > 0, switch_ok=bool(switch_ok), baseh=baseh)

    def _chain_unrows(self, s: CellState, rows: _LoopRows) -> CellState:
        """The chain state (with the f schedule's f and sumhist) back
        into the state's fields."""
        cf, ci = rows.cf, rows.ci
        L = s.energy.shape[0]
        s.mu = cf[CF_MU].clone()
        s.energy = cf[CF_E0:CF_E0 + L].clone()
        s.energy_err = cf[CF_E0E:CF_E0E + L].clone()
        s.min_dmu, s.max_dmu = cf[CF_MIN_DMU].clone(), cf[CF_MAX_DMU].clone()
        s.f, s.sumhist = cf[CF_F].clone(), cf[CF_SUMHIST].clone()
        s.ls = ci[CI_LS].clone()
        return s

    def _tables(self, tbl: int):
        """Rows of the stacked (colour, block) tables for the kernels:
        (fc [K], cand [K,CF], off [K,CF,3]), int32."""
        return self.fc_stack[tbl], self.cand_stack[tbl], self.off_stack[tbl]

    def _as_tab(self, tbl) -> _Tab:
        """The sub-step phases take a table row as its index (the serial
        engine) or as a ``_Tab`` (rows of a rank's local slab)."""
        return tbl if isinstance(tbl, _Tab) else self.tabs[tbl]

    def _substep_canonical(self, s: CellState, tpm_slab, tbl: int, u,
                           codes_k, switch_ok=True):
        """One sub-step on the canonical (unpacked) state: pack,
        sub-step, unpack.  Test/diagnostic entry point - the cycle loop
        calls _substep on the packed slabs and rows it carries.
        ``u`` [K, n_u, W] as the random stream lays it out."""
        with tracing.wait("move_codes"):
            codes_k = codes_k.to(
                s.r.device if self.use_chain_kernel else "cpu", torch.int32)
        pks = self._pack(s)
        rows = self._loop_rows(s, switch_ok)
        if self.T == 1:
            cnt = self._substep(s, pks, tpm_slab, tbl,
                                u.permute(1, 0, 2).contiguous(), codes_k,
                                rows)
        else:
            u_mv, u_a, u_z = self._split_uniforms(u[None])
            cnt = self._substep_multi(s, pks, tpm_slab, tbl, u_mv[0],
                                      u_a[0], u_z[0], codes_k, rows)
        self._chain_unrows(s, rows)
        self._count(s, cnt[None])
        return self._unpack(s, pks), tpm_slab

    def _count(self, s: CellState, cnt_all):
        """Fold the chain's counters [n, CN_FIXED + K, W] into att/acc."""
        tot = cnt_all[:, :CN_FIXED].sum(dim=0, dtype=torch.int32)
        s.att[TRANS] += tot[CN_EN]
        s.att[SWITCH] += tot[CN_SWEN]
        s.acc[TRANS] += tot[CN_ACC]
        s.acc[SWITCH] += tot[CN_SWACC]

    def _select_movers(self, s: CellState, pks, tbl: int, u_sel,
                       rows: _LoopRows):
        """Mover selection, uniform over the STATIC fine cell's
        occupants (rank-packed slots are contiguous per fine cell and
        never move between rebins, so ranks [0, occ) are exactly the
        occupied slots).  The proposal is symmetric: the wall keeps an
        accepted mover inside its fine cell, so the reverse move faces
        the same occupancy.  u_sel [K, W].

        Returns (rank [K,W] int32, slot [K,W] int64, p_old [L,3,K,W],
        mover_mol [K,W], has_mover [K,W])."""
        K, W = u_sel.shape
        tab = self._as_tab(tbl)
        t = tab.t
        # truncation toward zero; in f32 u*occ can round up to exactly
        # occ, which the clamp keeps in range
        rank = torch.minimum((u_sel * rows.occ_f[t]).to(torch.int32),
                             rows.rank_max[t])               # [K,W]
        slot = tab.slot_base + rank                          # [K,W]
        coord = (tab.coord_base + rank).view(3 * K, W)
        p_old = torch.stack([
            torch.gather(pk.view(-1, W), 0, coord) for pk in pks
        ]).view(len(pks), 3, K, W)
        mover_mol = torch.gather(s.slot2mol, 0, slot)
        # a trial is only real if the scheduled fine cell is occupied
        # AND the selected rank holds a molecule: an empty cell must
        # never yield a phantom trial
        has_mover = rows.occupied[t] & (mover_mol >= 0)      # [K,W]
        return rank, slot, p_old, mover_mol, has_mover

    def _hoisted_chain_terms(self, s: CellState):
        """The volume/enthalpy algebra of the switch rule, the
        mu-from-scratch refresh and the MINU lattice pick of two
        lattices, FROZEN for the whole sub-step loop (volumes only
        change at volume moves, which run outside it; the JAX engine's
        _hoisted_chain_terms).

        Returns (cmu, sw_c, minu_c):
          * mu from scratch = beta*(E0 - E1) + cmu (mc_moves:856-862)
          * switch rule dsw = sgn(ls) * (beta*(E1 - E0) + sw_c)
            (mc_lattice_switch, mc_moves.F90:1558-1559)
          * MINU pick (mc_moves.F90:1119-1126): lattice 1 iff
            beta*(E'1 - E'0) + minu_c < 0 (the first minimum on a tie)
        The PV and volume-entropy terms only under NPT, the reference
        enthalpies under leshift."""
        prm = self.prm
        rh = self.aux.ref_enthalpy
        lv10 = torch.log(s.volume[1] / s.volume[0])          # [W]
        pterm = prm.beta * prm.pressure * (s.volume[1] - s.volume[0])
        cmu = -pterm + prm.nwater * lv10
        if prm.leshift:
            cmu = cmu + prm.beta * (rh[1] - rh[0])
        sw_c = torch.zeros_like(lv10)
        if prm.mc_ensemble == "npt":
            sw_c = pterm - prm.nwater * lv10
        if prm.leshift:
            sw_c = sw_c - prm.beta * (rh[1] - rh[0])
        minu_c = sw_c
        if prm.mc_ensemble == "npt":
            minu_c = sw_c + prm.nwater * lv10
        return cmu, sw_c, minu_c

    def _substep(self, s: CellState, pks, tpm_slab, tbl: int, u, codes_k,
                 rows: _LoopRows, cnt=None):
        """One (colour, fine-block) sub-step, in place on the packed
        slabs ``pks`` [L] x [nfine, PK_ROWS, cap, W], the chain rows,
        the WL slabs of ``s`` and the per-slot trial counter
        ``tpm_slab`` [nslot, W].  ``tbl``: row of the stacked tables;
        ``u`` [7, K, W]: this sub-step's uniforms (selection, 3
        direction, magnitude, accept, switch); ``codes_k`` [K] int32
        (on the state's device for the chain kernel; the XLA chain reads
        it on the host).  Returns the chain's counters [CN_FIXED + K,
        W]."""
        trial = self._propose_t1(s, pks, tbl, u, rows)
        accf, cnt = self._chain_one(s, rows, trial, codes_k, u[5], u[6], cnt)
        self._apply_t1(s, pks, tpm_slab, tbl, trial, accf, cnt[CN_FIXED:])
        return cnt

    def _chain_one(self, s: CellState, rows: _LoopRows, trial: _Trial,
                   codes_k, ua, uz, cnt=None):
        """Sub-step phase 2 at one trial per mover, in the chain kernel
        or the XLA chain: (accf [K, W] float 0/1, cnt [CN_FIXED + K, W]).
        Reads ``trial.e``, ``trial.hasm`` and ``rows.inc`` only."""
        if self.use_chain_kernel:
            joh, cnt = self._chain_kernel_substep(s, rows, trial, codes_k,
                                                  ua, uz, cnt)
            return joh.view(self.K, 2, -1)[:, 1], cnt
        return self._chain_t1(s, rows, trial, codes_k, ua, uz, cnt)

    def _in_trans_wall(self, s: CellState, p, mover_mol):
        """The displacement wall (cell_trans_wall): [..., K, W] bool,
        whether the lattice-1 points ``p`` [3, ..., K, W] lie within the
        wall of the movers' reference sites (minimum image)."""
        fref = self.cellaux.fref0[
            :, torch.clamp(mover_mol, min=0).long()]        # [3,K,W]
        extra = p.dim() - 3
        fref = fref.view(3, *([1] * extra), *fref.shape[1:])
        rc0 = s.recip[0].view(3, 3, *([1] * (extra + 1)), -1)
        h0 = s.h[0].view(3, 3, *([1] * (extra + 1)), -1)
        fd = to_frac(rc0, p) - fref
        fd = fd - torch.round(fd)
        dsp = from_frac(h0, fd)
        return torch.sum(dsp * dsp, dim=0) <= self.prm.cell_trans_wall ** 2

    def _propose_t1(self, s: CellState, pks, tbl: int, u,
                    rows: _LoopRows) -> _Trial:
        """Sub-step phase 1: mover selection, displacement proposal,
        fine-cell wall and displacement wall (into ``rows.inc``),
        energies of the movers at both positions in both lattices (the
        mover kernel, or the unfused ``cell_energy.mover_energies``)."""
        cg = self.cellgrid
        L = s.h.shape[0]
        tab = self._as_tab(tbl)
        ls = rows.ci[CI_LS]                  # the walkers' current lattice
        rank, slot, p_old, mover_mol, has_mover = self._select_movers(
            s, pks, tab, u[0], rows)

        # displacement: random direction x U(-1,1)*max_trans in the
        # active lattice, same fractional displacement in the partner
        # (mc_water_translation, mc_moves.F90:1021-1067)
        d = 2.0 * u[1:5] - 1.0               # [4,K,W]: direction, length
        sq = d[:3] * d[:3]
        inv_norm = torch.rsqrt(torch.clamp(sq[0] + sq[1] + sq[2],
                                           min=1e-30))
        rmag = d[3] * s.max_trans[None, :] * inv_norm
        v = d[:3] * rmag[None]                               # [3,K,W]
        sfrac = to_frac(_take_lat(s.recip, ls)[:, :, None, :], v)
        p_new = p_old + torch.stack([
            torch.where(ls == l, v,
                        from_frac(s.h[l][:, :, None, :], sfrac))
            for l in range(L)
        ])                                                   # [L,3,K,W]

        # FINE-cell-boundary wall in the MID frame: BOTH endpoints must
        # resolve to the mover's STORED fine cell (symmetric under the
        # reverse move, preserving balance even at rounding edges).
        # The coverage tables reach partners through their stored fine
        # slots, so every molecule has to stay inside the fine cube it
        # was binned into.
        dmid = self.half_dfrac0[
            :, torch.clamp(mover_mol, min=0).long()]         # [3,K,W]
        ends = torch.stack([p_old[0], p_new[0]], dim=1)      # [3,2,K,W]
        fmid = to_frac(s.recip[0][:, :, None, None, :], ends) \
            - dmid[:, None]
        inside = cell_of_frac(cg, fmid, s.origin,
                              level="fine") == tab.fc[:, None]  # [2,K,W]
        in_cell = inside[0] & inside[1]
        if self.prm.cell_trans_wall > 0.0:
            # displacement wall on the PROPOSED endpoint only: detailed
            # balance holds on the walled support, and a state outside
            # the wall keeps its inward moves legal
            in_cell = in_cell & self._in_trans_wall(s, p_new[0], mover_mol)
        rows.inc[:, 1] = in_cell

        # energies of all K movers in both lattices, against the
        # per-fine-cell coverage stencil (the wall keeps both endpoints
        # inside the stored fine cell, so the stencil's coverage of that
        # cube reaches every partner); on the scatter path also the
        # per-candidate moment deltas
        if self.use_cell_pallas:
            e, own_new, *dlt = self.mover_kernel(pks, s.h, tab.cand, tab.off,
                                                 tab.row, rank, p_old, p_new)
        else:
            e, own_new, dlt = self._mover_energies_unfused(
                s, pks, tab, slot, p_old, p_new)
            dlt = [dlt]
        return _Trial(rank, slot, p_old, p_new, e, own_new,
                      has_mover.to(e.dtype), *dlt)

    def _mover_energies_unfused(self, s: CellState, pks, tbl, slot,
                                p_old, p_new):
        """The unfused counterpart of the mover kernel with its delta
        output (the JAX engine's XLA sub-step): ``cell_energy.
        mover_energies`` per lattice on the packed slabs' rows.  Returns
        (e [L,K,2,W], own_new [L,K,10,W], dlt [L,K,CF,10,cap,W])."""
        cg = self.cellgrid
        K, W = slot.shape
        tab = self._as_tab(tbl)
        valid = pks[0][:, PK_VALID] > 0.5          # the slabs' own rows
        e, own, dlt = [], [], []
        for l, pk in enumerate(pks):
            eo, en, co, cn = mover_energies(
                [pk[:, PK_R0 + a] for a in range(3)],
                Moments(*(pk[:, i] for i in range(10))), valid, s.h[l],
                tab.cand_l, tab.off, cg.full_mask, cg.cap, slot,
                p_old[l], p_new[l], self.model)
            e.append(torch.stack([eo, en], dim=1))           # [K,2,W]
            own.append(torch.stack(list(cn.own), dim=1))     # [K,10,W]
            dlt.append(torch.stack([
                (fn - fo).view(K, -1, cg.cap, W)
                for fo, fn in zip(co.delta(), cn.delta())
            ], dim=2))                                       # [K,CF,10,cap,W]
        return torch.stack(e), torch.stack(own), torch.stack(dlt)

    def _chain_kernel_substep(self, s: CellState, rows: _LoopRows,
                              trial: _Trial, codes_k, ua, uz, cnt=None):
        """Sub-step phase 2: the exact sequential accept/reject chain
        over the K movers with PER-MOVE WL updates, through the chain
        kernel in its point-table form (P = 2: point 0 = current, point
        1 = the proposal; the mover kernel's energies and ``rows.inc``
        are laid out as its tables).  The fine-cell wall is the
        proposal's in-cell flag; point 0 is trivially in its cell.
        Returns (joh [K*P, W], cnt [CN_FIXED + K, W])."""
        W = rows.cf.shape[1]
        return self.chain_kernel(
            codes_k, s.cycle >= self.prm.eq_mc_cycles, rows.cf, rows.ci,
            s.weight, s.hist, s.uhist, rows.basew, trial.e.view(-1, W),
            rows.inc.view(-1, W), trial.hasm, ua, uz, cnt=cnt,
            baseh=rows.baseh, cycle=s.cycle)

    def _chain_rows(self, rows: _LoopRows, L: int):
        """The chain state (mu, energies [L,W], residuals [L,W], ls,
        dmu extrema) copied out of the chain rows, for the XLA chains."""
        cf = rows.cf
        return (cf[CF_MU].clone(), cf[CF_E0:CF_E0 + L].clone(),
                cf[CF_E0E:CF_E0E + L].clone(),
                rows.ci[CI_LS].clone(), cf[CF_MIN_DMU].clone(),
                cf[CF_MAX_DMU].clone())

    @staticmethod
    def _chain_unload(rows: _LoopRows, mu, energy, e_err, ls, min_dmu,
                      max_dmu):
        """The XLA chains' final chain state back into the chain rows."""
        cf = rows.cf
        L = energy.shape[0]
        cf[CF_E0:CF_E0 + L] = energy
        cf[CF_E0E:CF_E0E + L] = e_err
        for row, val in ((CF_MU, mu), (CF_MIN_DMU, min_dmu),
                         (CF_MAX_DMU, max_dmu)):
            cf[row] = val
        rows.ci[CI_LS] = ls

    def _trial_step(self, weight, s: CellState, rows: _LoopRows, mu, ls,
                    energy, e_err, dE, enabled, gate, u_acc):
        """One translation trial of an XLA chain (mc_moves.F90:1113-1146):
        the acceptance against the total weight view ``weight`` [B, W]
        (one lattice: the move's Boltzmann factor alone, mu unchanged),
        the MINU fold-in with the chain's hoisted terms, the compensated
        two-sum of the accepted energy change dE [L, W].  Returns
        (accept, mu, ls, energy, e_err, dmu)."""
        prm = self.prm
        beta = prm.beta
        if energy.shape[0] == 1:
            dmu = torch.zeros_like(mu)
            mu_new = mu
            diffkT = beta * dE[0]
            ok = torch.isfinite(diffkT)
        else:
            dmu = (dE[0] - dE[1]) * beta
            mu_new = mu + dmu
            eta = self._eta_from_weight(s, weight, torch.stack([mu, mu_new]))
            diffkT = beta * _take_lat(dE, ls) + eta[1] - eta[0]
            if prm.minu:
                # #ifdef MINU fold-in (mc_moves.F90:1119-1140) on the
                # compensated energies, with the hoisted terms
                sw_c, minu_c = rows.cf[CF_SWC], rows.cf[CF_MINUC]
                e_new = energy + e_err + dE
                g10 = beta * (e_new[1] - e_new[0]) + minu_c
                lsn = torch.where(g10 < 0, 1, 0).to(ls.dtype)
                e_cur = energy + e_err
                alt = (beta * (_take_lat(e_new, lsn) - _take_lat(e_cur, ls))
                       + eta[1] - eta[0]
                       + torch.where(ls == 0, sw_c, -sw_c))
                diffkT = torch.where(lsn != ls, alt, diffkT)
            ok = torch.isfinite(diffkT) & torch.isfinite(mu_new)
        accept = enabled & gate & ok & (u_acc < torch.exp(-diffkT))
        if prm.minu and energy.shape[0] == 2:
            ls = torch.where(accept, lsn, ls)
        # compensated accumulation (CellState.energy_err)
        e_hi, e_rnd = _two_sum(energy, dE)
        e_hi2, e_lo2 = _two_sum(e_hi, e_err + e_rnd)
        energy = torch.where(accept[None, :], e_hi2, energy)
        e_err = torch.where(accept[None, :], e_lo2, e_err)
        return (accept, torch.where(accept, mu_new, mu), ls, energy, e_err,
                dmu)

    def _switch_step(self, rows: _LoopRows, mu, ls, energy, e_err, u_sw):
        """The switch attempt after a trial (mc_lattice_switch,
        mc_moves.F90:1536-1594) with the chain's hoisted volume terms;
        mu from scratch on accept.  Returns (sw_acc, mu, ls)."""
        beta = self.prm.beta
        cmu, sw_c = rows.cf[CF_CMU], rows.cf[CF_SWC]
        de10 = beta * ((energy[1] - energy[0]) + (e_err[1] - e_err[0]))
        dsw = torch.where(ls == 0, de10 + sw_c, -(de10 + sw_c))
        sw_acc = torch.isfinite(dsw) & (u_sw < torch.exp(-dsw))
        return (sw_acc, torch.where(sw_acc, cmu - de10, mu),
                torch.where(sw_acc, 1 - ls, ls))

    def _chain_t1(self, s: CellState, rows: _LoopRows, trial: _Trial,
                  codes_k, u_acc, u_sw, cnt=None):
        """Sub-step phase 2, the XLA chain at one trial per mover (the
        JAX engine's _chain_t1): the exact sequential accept/reject chain
        over the K movers with "micro-batched" WL: eta is looked up on
        the weight curve FROZEN at the sub-step's start, and the WL
        increments of the sub-step's trials land in one batched update
        after the chain (_wl_update_batch).  In a sample run the weights
        are frozen anyway, so there the chain is the serial one.
        Returns (accf [K, W] float 0/1, cnt [CN_FIXED + K, W])."""
        prm = self.prm
        K = self.K
        W = rows.cf.shape[1]
        dev = rows.cf.device
        do_switch = self.switches_on()
        codes = codes_k.tolist()
        weight0 = s.weight + rows.basew
        dE = trial.e[:, :, 1] - trial.e[:, :, 0]              # [L,K,W]
        in_cell = rows.inc[:, 1] > 0.5
        has = trial.hasm > 0.5
        mu, energy, e_err, ls, min_dmu, max_dmu = self._chain_rows(
            rows, dE.shape[0])
        if cnt is None:
            cnt = torch.zeros((CN_FIXED + K, W), dtype=torch.int32,
                              device=dev)
        else:
            cnt.zero_()
        accf = torch.zeros((K, W), dtype=dE.dtype, device=dev)
        mu_t, gate_t = [], []
        for k in range(K):
            tt, swt = codes[k] == TRANS, codes[k] == SWITCH
            if tt:
                # a trial exists where the scheduled cell holds a
                # molecule; the walls only veto acceptance
                accept, mu, ls, energy, e_err, dmu = self._trial_step(
                    weight0, s, rows, mu, ls, energy, e_err, dE[:, k],
                    has[k], in_cell[k], u_acc[k])
                accf[k] = accept
                mu_t.append(mu)
                gate_t.append(has[k] & torch.all(torch.isfinite(energy),
                                                 dim=0))
                cnt[CN_EN] += has[k]
                cnt[CN_FIXED + k] = has[k]
                cnt[CN_ACC] += accept
                admu = torch.abs(dmu)
                min_dmu = torch.minimum(
                    min_dmu, torch.where(accept, admu, float("inf")))
                max_dmu = torch.maximum(max_dmu,
                                        torch.where(accept, admu, 0.0))
            if do_switch and rows.switch_ok and (
                    swt or (tt and prm.mc_always_switch)):
                sw_acc, mu, ls = self._switch_step(rows, mu, ls, energy,
                                                   e_err, u_sw[k])
                cnt[CN_SWEN] += 1
                cnt[CN_SWACC] += sw_acc
        self._chain_unload(rows, mu, energy, e_err, ls, min_dmu, max_dmu)
        if mu_t:
            self._wl_update_batch(s, rows, torch.stack(mu_t),
                                  torch.stack(gate_t), weight0)
        return accf, cnt

    def _wl_update_batch(self, s: CellState, rows: _LoopRows, mu_t, gate_t,
                         weight):
        """mc_update_wl_bins (mc_moves.F90:1597-1689) applied to the n
        translation trials of one sub-step at once (the JAX engine's
        _wl_update_batch): ``mu_t`` [n, W] mu after each trial in chain
        order, ``gate_t`` [n, W] the trial was performed on a healthy
        walker, ``weight`` [B, W] the total weight view the chain read.
        The histogram sums equal the per-move updates' (the bin grid is
        static); the weight increment uses the sub-step's f, which the
        Swetnam and 1/t schedules recompute once per sub-step (f and
        sumhist live in the chain rows during the loop).  The sums over
        the trials are dense sums over a one-hot [n, B, W] tensor: no two
        trials' addends meet in a scatter, so the result is
        deterministic on the card.  In place on the WL slabs of ``s``
        (one lattice keeps none)."""
        prm, grid = self.prm, self.grid
        if s.cycle < prm.eq_mc_cycles or prm.num_lattices != 2:
            return
        B = grid.nbins
        dtype = s.hist.dtype
        # a walker whose slab overflowed capacity is corrupt: keep it out
        # of the SHARED WL arrays
        active = gate_t & (s.occ_overflow == 0)[None, :]
        k = mu_to_bin(grid, mu_t)                             # [n,W]
        kc = torch.clamp(k, 0, B - 1)
        upd = ((k >= 0) & (k < B) & active).to(dtype)
        oh = (torch.arange(B, device=k.device)[None, :, None]
              == kc[:, None, :]).to(dtype) * upd[:, None, :]  # [n,B,W]
        incr = torch.div(torch.full_like(mu_t, grid.av_binwidth),
                         self.binw[kc])                       # [n,W]
        d_hist = torch.sum(oh * incr[:, None, :], dim=0)      # [B,W]
        s.hist.add_(d_hist)
        if prm.samplerun:
            # frozen weights: eta at the recorded mu's is the serial
            # chain's; walled entries gated out (Engine._wl_update)
            eta_val = self._eta_from_weight(s, weight, mu_t)
            unwalled = eta_val < 1e29
            arg = torch.where((upd > 0) & unwalled,
                              eta_val - self.aux.log_unbiased_norm, -1.0)
            u_incr = torch.where(
                unwalled, incr * torch.exp(torch.clamp(arg, max=60.0)), 0.0)
            s.uhist.add_(torch.sum(oh * u_incr[:, None, :], dim=0))
            return
        f = rows.cf[CF_F]
        any_upd = torch.any(upd > 0, dim=0)
        kind = schedule_kind(prm)
        if kind == SCHED_SWETNAM:
            # Swetnam's f once per sub-step from the post-batch TOTAL
            # histogram (delta + master base; mc_moves.F90:1636-1653)
            sumh = rows.cf[CF_SUMHIST] + torch.sum(upd, dim=0)
            dev = ((s.hist + rows.baseh) * self.binw[:, None]
                   / torch.clamp(sumh, min=1.0)[None, :]
                   - self.binfrac[:, None])
            rms = torch.sqrt(torch.mean(dev * dev, dim=0))
            f_new = torch.log(torch.clamp(rms, min=1e-300)) \
                * prm.wl_alpha * B
            f = torch.where(any_upd, torch.clamp(f_new, max=prm.wl_factor),
                            f)
            rows.cf[CF_SUMHIST] = sumh
        elif kind == SCHED_INVT:
            cap = invt_cap(B, s.cycle, prm.nwater, dtype)
            f = torch.where(s.invt_active & any_upd,
                            torch.clamp(f, max=cap), f)
        rows.cf[CF_F] = f
        s.weight.add_(d_hist * f[None, :])

    def _apply_t1(self, s: CellState, pks, tpm_slab, tbl: int,
                  trial: _Trial, accf, en_per_mover):
        """Sub-step phase 3: apply the accepted movers to the packed
        slabs in place (independent, so parallel application equals the
        sequential composition) and count the trials per slot.
        ``accf`` [K, W]: the accepted flags (> 0.5)."""
        tab = self._as_tab(tbl)
        if self.use_cell_apply:
            self.apply_kernel(pks, s.h, tab.cand, tab.off, tab.row,
                              trial.rank, accf, trial.p_old, trial.p_new,
                              trial.own_new)
        else:
            self._scatter_moments(pks, tab, trial, accf)
        # per-slot trial counter (gathered to molecule order once per
        # cycle); the movers' slots are distinct
        tpm_slab.scatter_add_(0, trial.slot, en_per_mover)

    def _scatter_moments(self, pks, tbl, trial: _Trial, accf):
        """The scatter path of phase 3 ('on'), in the JAX engine's order
        and arithmetic (its _apply_t1 non-apply branch): the accepted
        movers' coordinate rows := p_old + (p_new - p_old), then per
        lattice the acceptance-masked per-candidate deltas scatter-added
        into the stencil cells' moment rows and the movers' own slots
        set to their new moments (``_scatter_moments_one``).  The deltas
        do not depend on the movers' coordinate rows (each mover is
        masked out of its own stencil and more than 2 rc from every
        other same-colour mover), so the order of the steps is free."""
        K, W = accf.shape
        tab = self._as_tab(tbl)
        acc = accf > 0.5
        coord = (tab.coord_base + trial.rank).view(3 * K, W)
        mom = (tab.mom_base + trial.rank).view(10 * K, W)
        cand_flat = tab.cand_l.reshape(-1)                   # [K*CF]
        dp = torch.where(acc, trial.p_new - trial.p_old, 0.0)
        for l, pk in enumerate(pks):
            pk.view(-1, W).scatter_(
                0, coord, (trial.p_old[l] + dp[l]).view(3 * K, W))
        for l, pk in enumerate(pks):
            self._scatter_moments_one(pk, trial.dlt[l], trial.own_new[l],
                                      cand_flat, acc, mom)

    @staticmethod
    def _scatter_moments_one(pk, dlt, own, cand_flat, acc, mom):
        """One lattice's moment update of the scatter path, in place:
        ``dlt`` [K, CF, 10, cap, W] (masked by ``acc`` [K, W] in place)
        added to the moment rows of the packed slab ``pk`` at the stencil
        cells ``cand_flat`` [K*CF], whose entries repeat where stencils
        overlap; then the accepted movers' own slots (rows ``mom``
        [10*K, W] of ``pk`` viewed as [rows, W]) := ``own`` [K, 10, W].
        At most one of the movers that reach a cell has a nonzero delta
        at any of its slots (same-colour movers are more than 2 rc apart
        in both replicas); every other addend is an exact zero, so the
        sum does not depend on the order of the additions (atomics on
        CUDA)."""
        K, CF, _, cap, W = dlt.shape
        dlt.masked_fill_(~acc[:, None, None, None, :], 0.0)
        pk[:, 0:10].index_add_(0, cand_flat, dlt.view(K * CF, 10, cap, W))
        flat = pk.view(-1, W)
        flat.scatter_(0, mom, torch.where(
            acc.repeat(10, 1), own.transpose(0, 1).reshape(10 * K, W),
            torch.gather(flat, 0, mom)))

    # ------------------------------------------------------------------
    # the multi-trial sub-step (cell_trials = T > 1)
    # ------------------------------------------------------------------

    def _split_uniforms(self, u_all):
        """A cycle's uniforms [n, K, 4 + 5T, W] as the multi-trial
        sub-step reads them: (u_mv [n, 4 + 3T, K, W] selection, anchor
        and candidates with each uniform's [K, W] block contiguous, u_a
        and u_z [n, K*T, W] the accept and switch uniforms of trial
        (k, t) at row k*T + t, the chain kernel's layout).  One copy per
        cycle."""
        n, K, _, W = u_all.shape
        T = self.T
        u_mv = u_all[:, :, :4 + 3 * T].permute(0, 2, 1, 3).contiguous()
        u_a = u_all[:, :, 4 + 3 * T:4 + 4 * T].reshape(n, K * T, W)
        u_z = u_all[:, :, 4 + 4 * T:4 + 5 * T].reshape(n, K * T, W)
        return u_mv, u_a, u_z

    def _substep_multi(self, s: CellState, pks, tpm_slab, tbl: int, u, ua,
                       uz, codes_kt, rows: _LoopRows, cnt=None):
        """One multi-trial (colour, fine-block) sub-step: T Metropolis
        trials per scheduled mover under the anchored-window proposal
        (the JAX package's CellEngine._substep_multi derives its
        exactness), in place as :meth:`_substep`.  ``u`` [4 + 3T, K, W]
        selection, anchor and candidate uniforms, ``ua`` / ``uz``
        [K*T, W] accept / switch uniforms, ``codes_kt`` [K*T] int32 move
        codes of trial (k, t) at k*T + t.  Returns the chain's counters
        [CN_FIXED + K, W]."""
        trial = self._propose_tm(s, pks, tbl, u, rows)
        joh, cnt = self._chain_multi(s, rows, trial, codes_kt, ua, uz, cnt)
        self._apply_tm(s, pks, tbl, trial, joh)
        # per-slot trial counter: all enabled translation trials of a
        # mover land on its slot
        tpm_slab.scatter_add_(0, trial.slot, cnt[CN_FIXED:])
        return cnt

    def _chain_multi(self, s: CellState, rows: _LoopRows, trial: _TrialTM,
                     codes_kt, ua, uz, cnt=None):
        """Multi-trial phase 2, in the chain kernel or the XLA chain:
        (joh [K, P, W] one-hot of each mover's accepted point, cnt
        [CN_FIXED + K, W]).  Reads ``trial.e``, ``trial.inc`` and
        ``trial.hasm`` only."""
        if not self.use_chain_kernel:
            return self._chain_xla_substep(s, rows, trial, codes_kt, ua, uz,
                                           cnt)
        W = rows.cf.shape[1]
        joh, cnt = self.chain_kernel(
            codes_kt, s.cycle >= self.prm.eq_mc_cycles, rows.cf, rows.ci,
            s.weight, s.hist, s.uhist, rows.basew, trial.e.view(-1, W),
            trial.inc.view(-1, W), trial.hasm, ua, uz, cnt=cnt,
            baseh=rows.baseh, cycle=s.cycle)
        return joh.view(self.K, self.T + 1, W), cnt

    def _propose_tm(self, s: CellState, pks, tbl: int, u,
                    rows: _LoopRows) -> _TrialTM:
        """Multi-trial phase 1: mover selection, the anchored-window
        points (v_t = (a + b_t) * max_trans from the stored position in
        the active lattice, the same fractional displacement in the
        partner), the fine-cell wall and the displacement wall of every
        point and the P-point energy table of both lattices (one
        launch of the points kernel, or the unfused
        ``cell_energy.mover_point_energies`` with its candidate
        stores)."""
        cg = self.cellgrid
        L = s.h.shape[0]
        T = self.T
        K, W = u.shape[-2:]
        tab = self._as_tab(tbl)
        ls = rows.ci[CI_LS]
        rank, slot, p_old, mover_mol, has_mover = self._select_movers(
            s, pks, tab, u[0], rows)

        anc = 2.0 * u[1:4] - 1.0                             # [3,K,W]
        b = (2.0 * u[4:4 + 3 * T] - 1.0).view(T, 3, K, W)
        v = (anc[None] + b) * s.max_trans                    # [T,3,K,W]
        v = v.transpose(0, 1)                                # [3,T,K,W]
        recip_ls = _take_lat(s.recip, ls)[:, :, None, None, :]
        sfrac = to_frac(recip_ls, v)
        tv = torch.stack([
            torch.where(ls == l, v,
                        from_frac(s.h[l][:, :, None, None, :], sfrac))
            for l in range(L)
        ])                                                   # [L,3,T,K,W]
        pts = torch.cat([
            p_old[None], p_old[None] + tv.permute(2, 0, 1, 3, 4)
        ]).contiguous()                                      # [P,L,3,K,W]

        # fine-cell wall per point (see _propose_t1); the chain's gate
        # is in-cell(current) & in-cell(proposal)
        dmid = self.half_dfrac0[
            :, torch.clamp(mover_mol, min=0).long()]         # [3,K,W]
        pts1 = pts[:, 0].transpose(0, 1)                     # [3,P,K,W]
        fmid = to_frac(s.recip[0][:, :, None, None, :], pts1) \
            - dmid[:, None]
        inc = cell_of_frac(cg, fmid, s.origin, level="fine") \
            == tab.fc[None, :, None]                         # [P,K,W]
        if self.prm.cell_trans_wall > 0.0:
            # displacement wall on the TRIAL points; point 0, the
            # current position, is exempt (a state outside the wall
            # keeps its inward moves legal)
            wall = self._in_trans_wall(s, pts1, mover_mol)   # [P,K,W]
            wall[0] = True
            inc = inc & wall

        cs = None
        if self.use_cell_pallas:
            e, own = self.points_kernel(pks, s.h, tab.cand, tab.off, tab.row,
                                        rank, pts)
        else:
            e, own, cs = self._point_energies_unfused(s, pks, tab, slot,
                                                      pts)
        return _TrialTM(rank, slot, pts,
                        inc.transpose(0, 1).to(e.dtype).contiguous(), e,
                        own, has_mover.to(e.dtype), cs)

    def _point_energies_unfused(self, s: CellState, pks, tbl, slot, pts):
        """The unfused counterpart of the points kernel (the JAX
        engine's XLA sub-step): ``cell_energy.mover_point_energies`` per
        lattice on the packed slabs' rows.  Returns (e [L,K,P,W], own
        [L,K,P,10,W], the P candidate stores of each lattice)."""
        cg = self.cellgrid
        tab = self._as_tab(tbl)
        valid = pks[0][:, PK_VALID] > 0.5          # the slabs' own rows
        e, own, cs = [], [], []
        for l, pk in enumerate(pks):
            el, owns, cl = mover_point_energies(
                [pk[:, PK_R0 + a] for a in range(3)],
                Moments(*(pk[:, i] for i in range(10))), valid, s.h[l],
                tab.cand_l, tab.off, cg.full_mask, cg.cap, slot,
                pts[:, l], self.model)
            e.append(el.transpose(0, 1))                     # [K,P,W]
            own.append(torch.stack(
                [torch.stack(list(m), dim=1) for m in owns], dim=1))
            cs.append(cl)
        return torch.stack(e).contiguous(), torch.stack(own), cs

    def _chain_xla_substep(self, s: CellState, rows: _LoopRows,
                           trial: _TrialTM, codes_kt, u_acc, u_sw,
                           cnt=None):
        """Multi-trial phase 2, the XLA chain (the JAX engine's
        _chain_xla_substep): the K x T trials in order with PER-MOVE WL,
        every trial's eta lookup on the current weight view and its WL
        update right after it (bins.wl_move_update, as Engine._wl_update
        runs it), then the switch attempt.  A mover's current point
        energies and in-cell flag are the one-hot sums over its P
        points.  Returns (joh [K, P, W] float one-hot of each mover's
        accepted point, cnt [CN_FIXED + K, W])."""
        prm, grid = self.prm, self.grid
        K, T = self.K, self.T
        P = T + 1
        W = rows.cf.shape[1]
        dtype, dev = rows.cf.dtype, rows.cf.device
        do_switch = self.switches_on()
        # one lattice keeps no WL arrays (Engine._wl_update)
        wl_active = (s.cycle >= prm.eq_mc_cycles
                     and prm.num_lattices == 2)
        codes = codes_kt.tolist()
        occ_ok = s.occ_overflow == 0
        f, sumh = rows.cf[CF_F], rows.cf[CF_SUMHIST]
        wgt, hist, uh = s.weight, s.hist, s.uhist
        inc = trial.inc > 0.5                                # [K,P,W]
        has = trial.hasm > 0.5
        iota_p = torch.arange(P, device=dev)[:, None]        # [P,1]
        mu, energy, e_err, ls, min_dmu, max_dmu = self._chain_rows(
            rows, trial.e.shape[0])
        if cnt is None:
            cnt = torch.zeros((CN_FIXED + K, W), dtype=torch.int32,
                              device=dev)
        else:
            cnt.zero_()
        joh = torch.empty((K, P, W), dtype=dtype, device=dev)
        for k in range(K):
            e_k = trial.e[:, k]                              # [L,P,W]
            j_oh = (iota_p == 0).expand(P, W)
            n_tt = 0
            for t in range(1, P):
                i = k * T + t - 1
                tt, swt = codes[i] == TRANS, codes[i] == SWITCH
                if tt:
                    n_tt += 1
                    e_cur = torch.sum(e_k * j_oh.to(dtype)[None], dim=1)
                    gate = torch.any(j_oh & inc[k], dim=0) & inc[k, t]
                    wtot = wgt + rows.basew      # the CURRENT weight view
                    accept, mu, ls, energy, e_err, dmu = self._trial_step(
                        wtot, s, rows, mu, ls, energy, e_err,
                        e_k[:, t] - e_cur, has[k], gate, u_acc[i])
                    j_oh = torch.where(accept[None, :], iota_p == t, j_oh)
                    cnt[CN_ACC] += accept
                    admu = torch.abs(dmu)
                    min_dmu = torch.minimum(
                        min_dmu, torch.where(accept, admu, float("inf")))
                    max_dmu = torch.maximum(
                        max_dmu, torch.where(accept, admu, 0.0))
                    if wl_active:
                        # per-move WL at mu after the trial, healthy
                        # walkers only (CellEngine._wl_healthy)
                        healthy = torch.all(torch.isfinite(energy),
                                            dim=0) & occ_ok
                        sched = self._f_schedule(s, sumh, rows.baseh)
                        wgt, hist, uh, f_n, sumh_n = wl_move_update(
                            grid, prm.samplerun, self.aux.log_unbiased_norm,
                            self.binw, wgt, hist, uh,
                            lambda m, w=wtot: self._eta_from_weight(s, w, m),
                            mu, f, has[k], healthy, sched)
                        if sched is not None:
                            f, sumh = f_n, sumh_n
                if do_switch and rows.switch_ok and (
                        swt or (tt and prm.mc_always_switch)):
                    sw_acc, mu, ls = self._switch_step(rows, mu, ls, energy,
                                                       e_err, u_sw[i])
                    cnt[CN_SWEN] += 1
                    cnt[CN_SWACC] += sw_acc
            # the mover's translation trials, each performed where it
            # holds a molecule
            cnt[CN_FIXED + k] = has[k] * n_tt
            cnt[CN_EN] += cnt[CN_FIXED + k]
            joh[k] = j_oh
        self._chain_unload(rows, mu, energy, e_err, ls, min_dmu, max_dmu)
        rows.cf[CF_F], rows.cf[CF_SUMHIST] = f, sumh
        s.weight, s.hist, s.uhist = wgt, hist, uh
        return joh, cnt

    def _apply_tm(self, s: CellState, pks, tbl, trial: _TrialTM,
                  joh):
        """Multi-trial phase 3: apply each mover's FINAL point once (the
        net moment update of the accepted point equals the point-0 ->
        point-j delta, whatever the path).  ``joh`` [K, P, W]: one-hot
        of each mover's accepted point.  The final point and its own
        moments are the one-hot mixtures over the P points; the
        unfused sub-step scatters the mixture of the per-point deltas
        (minus point 0's) of its candidate stores."""
        tab = self._as_tab(tbl)
        jf_p = joh.transpose(0, 1)                           # [P,K,W]
        p_fin = torch.sum(trial.pts * jf_p[:, None, None],
                          dim=0)                             # [L,3,K,W]
        own_fin = torch.sum(trial.own * joh[None, :, :, None], dim=2)
        accf = joh[:, 0] < 0.5
        if self.use_cell_apply:
            self.apply_kernel(pks, s.h, tab.cand, tab.off, tab.row,
                              trial.rank, accf, trial.pts[0], p_fin, own_fin)
            return
        K, P, W = joh.shape
        cap = self.cellgrid.cap
        p_old = trial.pts[0]
        coord = (tab.coord_base + trial.rank).view(3 * K, W)
        mom = (tab.mom_base + trial.rank).view(10 * K, W)
        cand_flat = tab.cand_l.reshape(-1)
        dp = torch.where(accf, p_fin - p_old, 0.0)
        for l, pk in enumerate(pks):
            pk.view(-1, W).scatter_(
                0, coord, (p_old[l] + dp[l]).view(3 * K, W))
        for l, pk in enumerate(pks):
            cs = trial.cs[l]
            d0 = cs[0].delta()
            fields = []
            for i in range(10):
                d_i = None
                for t in range(1, P):
                    term = (cs[t].delta()[i] - d0[i]) * jf_p[t][:, None, :]
                    d_i = term if d_i is None else d_i + term
                fields.append(d_i.view(K, -1, cap, W))
            self._scatter_moments_one(pk, torch.stack(fields, dim=2),
                                      own_fin[l], cand_flat, accf, mom)

    # ------------------------------------------------------------------
    # Wang-Landau health gate
    # ------------------------------------------------------------------

    def _wl_healthy(self, s):
        """Volume moves run the inherited Engine._wl_update; extend its
        health gate with the slab-overflow audit, so that a corrupt
        walker (two molecules sharing a slot after an overflowing rebin)
        never contributes to the SHARED WL arrays."""
        return torch.all(torch.isfinite(s.energy), dim=0) & (
            s.occ_overflow == 0)

    # ------------------------------------------------------------------
    # volume-move hooks (Engine._volume supplies the shared logic)
    # ------------------------------------------------------------------

    def _vol_rescale(self, s: CellState, h_new):
        """Slab layout: rescale slot positions at fixed fractional
        coordinates (slots and the fractional grid are untouched by
        construction; there are no stored reference positions)."""
        r_new = torch.stack([
            from_frac(h_new[l][:, :, None, :],
                      to_frac(s.recip[l][:, :, None, :], s.r[l]))
            for l in range(s.r.shape[0])
        ])
        return r_new, None

    def _vol_energy(self, s: CellState, r_new, h_new):
        return self._full_both(s, r_new, h_new)

    def _vol_extra_ok(self, h_new, s: CellState):
        """The grid-validity guard (perpendicular widths within the
        coverage tables' shrink guard) and, with ``cell_trans_wall``, the
        displacement wall on the RESCALED state: a volume move scales
        every displacement from the reference sites (fractional
        coordinates held fixed), so an expansion must not carry a
        molecule past the wall."""
        ok = super()._vol_extra_ok(h_new, s)
        if self.prm.cell_trans_wall > 0.0:
            mol = torch.clamp(s.slot2mol, min=0).long()      # [nslot,W]
            fd = to_frac(s.recip[0][:, :, None, :], s.r[0]) \
                - self.cellaux.fref0[:, mol]
            fd = fd - torch.round(fd)
            dsp = from_frac(h_new[0][:, :, None, :], fd)     # [3,nslot,W]
            d2 = torch.where(self._slab_valid(s),
                             torch.sum(dsp * dsp, dim=0), 0.0)
            ok = ok & (torch.amax(d2, dim=0)
                       <= self.prm.cell_trans_wall ** 2)
        return ok

    # ------------------------------------------------------------------
    # rebin: new random grid origin (ergodicity across cells)
    # ------------------------------------------------------------------

    @tracing.traced("mw/rebin")
    def _rebin(self, s: CellState) -> CellState:
        cg = self.cellgrid
        N, W = s.mol2slot.shape
        dtype, dev = s.r.dtype, s.r.device

        # gather slabs back to molecule order
        r_mol = gather_from_slab(s.r, s.mol2slot)            # [L,3,N,W]
        mom_mol = gather_from_slab(s.moments, s.mol2slot)    # [10,L,N,W]

        with tracing.wait("rebin_origin"):
            origin = self.stream.rebin_origin(s.cycle, dtype).to(dev)

        # wrap so that the MID fractional position lands in
        # [origin, origin+1): the grid is periodic in g = f_mid - origin,
        # and stored images must wrap at the GRID boundary for the
        # coverage tables' +-1 box shifts to be the true periodic
        # offsets; re-image lattice 2 to within the (invariant)
        # correspondence mismatch of lattice 1.  All shifts are lattice
        # vectors, leaving energies unchanged.
        dmid = self.half_dfrac0[:, :, None]                  # [3,N,1]
        f1 = to_frac(s.recip[0][:, :, None, :], r_mol[0])
        f1 = f1 - torch.floor(f1 - dmid - origin[:, None, None])
        r1 = from_frac(s.h[0][:, :, None, :], f1)
        if r_mol.shape[0] == 2:
            f2 = to_frac(s.recip[1][:, :, None, :], r_mol[1])
            dmic = f1 - f2
            dmic = dmic - torch.round(dmic)
            r2 = from_frac(s.h[1][:, :, None, :], f1 - dmic)
            r_mol = torch.stack([r1, r2])
        else:
            r_mol = r1[None]

        cid = cell_of_frac(cg, f1 - dmid, origin, level="fine")
        slot, max_occ = bin_molecules(cg, cid)
        s.occ_overflow = torch.maximum(
            s.occ_overflow, max_occ - cg.cap).to(torch.int32)

        s.r = scatter_to_slab(r_mol, slot, cg.nslot)
        s.moments = scatter_to_slab(mom_mol, slot, cg.nslot)
        mols = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
        s.slot2mol = torch.full((cg.nslot, W), -1, dtype=torch.int32,
                                device=dev).scatter_(
            0, slot.long(), mols.expand(N, W).contiguous())
        s.mol2slot = slot
        s.origin = origin
        return s

    # ------------------------------------------------------------------
    # chain resynchronisation (slab variant of Engine._resync_chains)
    # ------------------------------------------------------------------

    @tracing.traced("mw/chain_resync")
    def _resync_chains(self, s: CellState) -> CellState:
        L = s.r.shape[0]
        if L != 2:
            return s
        # lattice 2's cell displacement := lattice 1's
        # (mc_moves.F90:2276-2277)
        h = s.h.clone()
        h[1] = self.ref_h[1][:, :, None] + (
            s.h[0] - self.ref_h[0][:, :, None])
        recip = torch.stack([recip_matrix(h[l]) for l in range(L)])

        # every molecule's fractional displacement from its reference
        # := lattice 1's, i.e. f2 = f1 - dfrac0 (mc_moves.F90:2289-2333)
        f1 = to_frac(recip[0][:, :, None, :], s.r[0])        # [3,nslot,W]
        mol = torch.clamp(s.slot2mol, min=0).long()          # [nslot,W]
        dfrac = self.cellaux.dfrac0[:, mol]                  # [3,nslot,W]
        r2 = from_frac(h[1][:, :, None, :], f1 - dfrac)
        s.r[1] = torch.where(self._slab_valid(s)[None], r2, 0.0)

        vol = torch.abs(torch.stack([determinant3(h[l]) for l in range(L)]))
        s.h, s.recip, s.volume = h, recip, vol
        s.energy, s.moments = self._full_both(s, s.r, h)
        s.energy_err = torch.zeros_like(s.energy)
        s.mu = self._mu_scratch(s.energy, vol)
        return s

    # ------------------------------------------------------------------
    # audit (slab variant)
    # ------------------------------------------------------------------

    def audit_energy(self, s: CellState, n_walkers: int | None = None):
        """Recompute energies + moments of the first ``n_walkers``
        walkers (all by default) from scratch, overwrite them, zero
        their residuals and return the drift [L, n] of the tracked
        (energy + energy_err) against the fresh values
        (mc_monitor_stats:1781-1792)."""
        n = self._first_local(n_walkers, s.r.shape[-1])
        fresh, moments = self._full_both(s, s.r, s.h, n)
        drift = self._e_tot(s)[:, :n] - fresh
        s.energy[:, :n] = fresh
        s.energy_err[:, :n] = 0.0
        s.moments[..., :n] = moments
        return s, drift

    # ------------------------------------------------------------------
    # the cycle
    # ------------------------------------------------------------------

    def _substep_scan(self, s: CellState, codes, u_all, n_sub,
                      switch_ok=True):
        """All sub-steps of the cycle, in order: sub-step ``sid`` runs
        table row sid % n_tables (colours outer, blocks inner, repeating
        every sweep) on trials sid*K .. sid*K+K-1 of the schedule.  The
        packed slabs, the chain rows, the WL slabs and the per-slot
        trial counts are updated in place; pack and unpack happen once.
        ``switch_ok``: the chain's switch attempts are allowed (false
        during a 'dd' run's equilibration).
        Returns (s, tpm_slab)."""
        W = s.r.shape[-1]
        K, T = self.K, self.T
        dev = s.r.device
        tpm_slab = torch.zeros((self.cellgrid.nslot, W), dtype=torch.int32,
                               device=dev)
        cnt_all = torch.empty((n_sub, CN_FIXED + K, W), dtype=torch.int32,
                              device=dev)
        # the chain kernel reads the codes on the device, the XLA chains
        # on the host
        with tracing.wait("move_codes"):
            codes_d = codes.to(device=dev if self.use_chain_kernel
                               else "cpu", dtype=torch.int32)
        pks = self._pack(s)
        rows = self._loop_rows(s, switch_ok)
        if T == 1:
            # [n_sub, 7, K, W]: each uniform's [K, W] block contiguous
            u_all = u_all.permute(0, 2, 1, 3).contiguous()
            for sid in range(n_sub):
                with tracing.span("mw/substep"):
                    self._substep(s, pks, tpm_slab, sid % self.n_tables,
                                  u_all[sid], codes_d[sid * K:(sid + 1) * K],
                                  rows, cnt_all[sid])
        else:
            u_mv, u_a, u_z = self._split_uniforms(u_all)
            for sid in range(n_sub):
                with tracing.span("mw/substep"):
                    self._substep_multi(
                        s, pks, tpm_slab, sid % self.n_tables, u_mv[sid],
                        u_a[sid], u_z[sid],
                        codes_d[sid * K * T:(sid + 1) * K * T], rows,
                        cnt_all[sid])
        tracing.count("substeps", n_sub)
        self._chain_unrows(s, rows)
        self._count(s, cnt_all)
        return self._unpack(s, pks), tpm_slab

    def _one_cycle(self, s: CellState):
        return self._cycle_with(s, self._substep_scan)

    def _cycle_with(self, s: CellState, scan_fn):
        """The cycle skeleton: 'dd' window tracking, rebin cadence, the
        move-type schedule, the sub-step loop (``scan_fn(s, codes, u_all,
        n_sub, switch_ok)``), scheduled volume moves, delta-sync /
        chain-resync cadences and the therm sample."""
        prm = self.prm
        W = s.r.shape[-1]
        L = s.r.shape[0]
        s.cycle += 1
        cycle = s.cycle
        if prm.parallel_strategy == "dd" and L == 2:
            self._dd_track_window(s, cycle)
        switch_ok = self._switch_ok(cycle)

        # re-draw the grid origin + rebin on the reference's
        # Verlet-rebuild cadence (mc_cycle:218-222)
        if cycle % prm.list_update_int == 0:
            self._rebin(s)

        # shared move-type schedule over this cycle's trials and the
        # whole cycle's sub-step uniforms [n_sub, K, n_u, W]
        n_sub = self.sweeps_per_cycle * self.n_tables
        codes, u_all = self.stream.cell_cycle_draws(
            cycle, self.probs, self.trials_per_cycle, n_sub, self.K,
            self.n_u, W, s.r.dtype)

        with tracing.span("mw/substeps"):
            s, tpm_slab = scan_fn(s, codes, u_all, n_sub, switch_ok)
        s.trans_per_mol += gather_from_slab(tpm_slab, s.mol2slot)

        # scheduled volume moves, back to back (Engine._volume with the
        # slab hooks above)
        if prm.mc_ensemble == "npt" and prm.allow_vol:
            self._scheduled_volume_moves(s, codes, cycle, switch_ok)

        s.avg_energy = s.avg_energy + self._e_tot(s)
        if prm.mc_ensemble == "npt":
            s.avg_energy = s.avg_energy + prm.pressure * s.volume
        if cycle % prm.mpi_sync_int == 0:
            self._sync_all(s)
        if cycle % prm.latt_sync_int == 0:
            self._resync_chains(s)
        T_w = min(prm.therm_walkers, W)
        return {
            "cycle": cycle,
            "E_ls": _take_lat(self._e_tot(s), s.ls)[:T_w],
            "mu": s.mu[:T_w],
            "vol": s.volume[:, :T_w],
            "ls": s.ls[:T_w],
        }


# ----------------------------------------------------------------------
# state initialisation
# ----------------------------------------------------------------------

def init_cell_state(prm: RunParams, model: SWParams, r0: np.ndarray,
                    H0: np.ndarray, grid: BinGrid, cellgrid: CellGrid,
                    weight0: np.ndarray | None = None, n_windows: int = 1,
                    device="cuda") -> tuple[CellState, EngineAux, CellAux]:
    """Build the initial slab-layout walker ensemble (the large-N
    sibling of state.init_state, same init order as main.f90:98-175).
    r0 [L,N,3], H0 [L,3,3] in Bohr."""
    device = resolve_device(device)
    dtype = _DTYPES[prm.dtype]
    W, L, N, B = prm.n_walkers, prm.num_lattices, prm.nwater, grid.nbins

    r0 = np.asarray(r0, dtype=np.float64)
    H0 = np.asarray(H0, dtype=np.float64)

    # invariant correspondence mismatch (models/stacking.py); none with
    # one lattice
    f1_0 = r0[0] @ np.linalg.inv(H0[0]).T
    if L == 2:
        f2_0 = r0[1] @ np.linalg.inv(H0[1]).T
        dfrac0 = f1_0 - f2_0
        dfrac0 -= np.round(dfrac0)
    else:
        dfrac0 = np.zeros_like(f1_0)

    # initial binning (origin 0) by the MID fractional position
    # f_mid = f1 - dfrac0/2 on the FINE grid, host-side
    fmid0 = f1_0 - 0.5 * dfrac0
    nshift = np.floor(fmid0)
    f1 = f1_0 - nshift
    fmid = fmid0 - nshift                              # in [0,1)
    r_use = [f1 @ H0[0].T]
    if L == 2:
        r_use.append((f1 - dfrac0) @ H0[1].T)
    r_use = np.stack(r_use)                            # [L,N,3]

    n1, n2, n3 = cellgrid.nf
    c1 = np.minimum((fmid[:, 0] * n1).astype(np.int32), n1 - 1)
    c2 = np.minimum((fmid[:, 1] * n2).astype(np.int32), n2 - 1)
    c3 = np.minimum((fmid[:, 2] * n3).astype(np.int32), n3 - 1)
    cid = (c1 * n2 + c2) * n3 + c3                     # [N]
    order = np.argsort(cid, kind="stable")
    rank = np.empty(N, dtype=np.int32)
    occ_count = np.zeros(cellgrid.nfine, dtype=np.int32)
    for i in order:
        rank[i] = occ_count[cid[i]]
        occ_count[cid[i]] += 1
    max_occ = int(occ_count.max())
    if max_occ > cellgrid.cap:
        raise ValueError(
            f"cell occupancy {max_occ} exceeds capacity "
            f"{cellgrid.cap}; increase cap"
        )
    slot_np = (cid * cellgrid.cap + rank).astype(np.int32)

    nslot = cellgrid.nslot
    r_slab0 = np.zeros((L, 3, nslot), dtype=np.float64)
    s2m0 = np.full(nslot, -1, dtype=np.int32)
    for l in range(L):
        r_slab0[l][:, slot_np] = r_use[l].T
    s2m0[slot_np] = np.arange(N, dtype=np.int32)

    # windows, as state.init_state assigns them
    wid, sb, eb, lo, hi, in_window, ls0, wins = window_layout(
        prm, grid, n_windows)
    nwin = len(wins)

    weight0_np = (np.zeros(B) if weight0 is None
                  else np.asarray(weight0, dtype=np.float64))
    log_norm = compute_log_unbiased_norm(prm, grid, weight0_np, W)

    # all walkers start identical: compute one copy, broadcast
    r1 = torch.as_tensor(r_slab0, dtype=dtype, device=device)[..., None]
    h1 = torch.as_tensor(H0, dtype=dtype, device=device)[..., None]
    valid1 = torch.as_tensor(s2m0 >= 0, device=device)[:, None]
    e1, mom1 = SlabEnergyKernel(model, cellgrid, device)(r1, valid1, h1)
    energy1 = e1[:, 0]                                       # [L]
    h = h1.expand(L, 3, 3, W).contiguous()
    recip = torch.stack([recip_matrix(h[l]) for l in range(L)])
    vol = torch.abs(torch.stack([determinant3(h[l]) for l in range(L)]))
    vol1 = vol[:, 0]
    ref_enth = energy1
    if prm.mc_ensemble == "npt":
        ref_enth = ref_enth + prm.pressure * vol1
    if any(abs(x) > 1e-300 for x in prm.input_ref_enthalpy[:L]):
        ref_enth = torch.as_tensor(prm.input_ref_enthalpy[:L], dtype=dtype,
                                   device=device)
    if L == 2:
        mu0_s = (energy1[0] + prm.pressure * vol1[0]
                 - energy1[1] - prm.pressure * vol1[1])
        if prm.leshift:
            mu0_s = mu0_s - ref_enth[0] + ref_enth[1]
        mu0_s = mu0_s * prm.beta - N * torch.log(vol1[0] / vol1[1])
    else:
        mu0_s = torch.zeros((), dtype=dtype, device=device)

    # warm-start weights load into the master rows (see
    # state.warm_start_rows); per-walker arrays hold only growth since
    # the last sync
    master_eta = DS(
        torch.as_tensor(warm_start_rows(prm, weight0_np, wins), dtype=dtype,
                        device=device),
        torch.zeros((nwin, B), dtype=dtype, device=device),
    )

    def full(shape, val, dt=dtype):
        return torch.full(shape, val, dtype=dt, device=device)

    def tens(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    state = CellState(
        r=r1.expand(L, 3, nslot, W).contiguous(), h=h, recip=recip,
        volume=vol, energy=energy1[:, None].expand(L, W).contiguous(),
        energy_err=full((L, W), 0.0),
        mu=mu0_s.to(dtype).expand(W).contiguous(),
        ls=tens(ls0, torch.int32),
        moments=mom1.expand(10, L, nslot, W).contiguous(),
        slot2mol=tens(s2m0)[:, None].expand(nslot, W).contiguous(),
        mol2slot=tens(slot_np)[:, None].expand(N, W).contiguous(),
        origin=full((3,), 0.0),
        occ_overflow=full((W,), 0, torch.int32),
        weight=full((B, W), 0.0), hist=full((B, W), 0.0),
        uhist=full((B, W), 0.0),
        f=full((W,), prm.wl_factor), sumhist=full((W,), 0.0),
        invt_active=full((W,), False, torch.bool),
        firstcycle=full((W,), True, torch.bool),
        histogram_reset=full((W,), False, torch.bool),
        master_eta=master_eta,
        master_hist=ds_zeros((nwin, B), dtype, device),
        master_uhist=ds_zeros((nwin, B), dtype, device),
        window_id=tens(wid, torch.int32),
        my_mu_min=tens(lo, dtype), my_mu_max=tens(hi, dtype),
        start_bin=tens(sb, torch.int32), end_bin=tens(eb, torch.int32),
        in_window=tens(in_window, torch.bool),
        max_trans=full((W,), prm.mc_max_trans),
        dv_max=full((W,), prm.mc_dv_max),
        att=full((3, W), 0, torch.int32), acc=full((3, W), 0, torch.int32),
        trans_per_mol=full((N, W), 0, torch.int32),
        avg_energy=full((L, W), 0.0),
        min_dmu=full((W,), float("inf")), max_dmu=full((W,), 0.0),
        cycle=0,
        dropped=full((), 0, torch.int32),
    )
    aux = EngineAux(
        # shifts unused by the cell engine (audits run on the slab
        # path); minimal placeholder for structural parity
        shifts=np.zeros((1, 3), dtype=np.int32),
        ref_h=tens(H0, dtype).double().cpu().numpy(),
        ref_enthalpy=ref_enth.to(dtype),
        log_unbiased_norm=log_norm,
    )
    caux = CellAux(dfrac0=tens(np.ascontiguousarray(dfrac0.T), dtype),
                   fref0=tens(np.ascontiguousarray(f1_0.T), dtype))
    return state, aux, caux
