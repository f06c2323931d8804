"""Spatial sharding of one large system's cell grid over ranks.

Counterpart of ``mc_water_ls_mw_tpu/parallel/spatial.py`` (a capability
beyond the reference, whose neighbour machinery is single-process,
molint.F90:501-559; SURVEY.md section 7 step 8b names spatial
decomposition with a halo exchange as the large-N north star).

The static half (``stencil_reach``, ``SpatialPlan``,
``build_spatial_plan``) is the JAX package's numpy code: the fine grid is
sliced along its slowest axis x, rank d of D owns the contiguous slab
rows of fine layers [d, d+1) * nfx / D (D must divide the coarse count
along x), and carries a halo of 2 * reach fine layers per side, where
``reach`` is the coverage stencil's reach along x.  Local row order is
[owned | lo halo | hi halo | dummy]; each (table row, rank) has a
padded mover schedule in local rows whose padding addresses the
all-invalid dummy row.

``SpatialCellEngine`` runs the cell engine's sub-step loop on local
slabs (the JAX package's argument, with ``shard_map`` replaced by ranks
of a ``torch.distributed`` group):

* every rank keeps the whole state of its walkers at cycle rank: the
  rebin, the volume moves, the delta-sync and the chain resync run on
  it exactly as in the serial engine (``CellEngine._cycle_with``);
* in the loop, before each sub-step's reads, the halo rows are refreshed
  from the neighbours' owned rows by the +-1 ring shift
  (``Comm.ring_shift``);
* a rank proposes every mover with at least one stencil cell in its
  owned rows (boundary movers on two ranks, from identical inputs), the
  chain's [.., K, W] tables are assembled by a sum over ranks of
  one-owner tables (exact in any order: each entry has one nonzero
  addend) and the chain runs replicated on every rank;
* each rank applies the accepted movers to its local slab, padding
  landing on the dummy row, halo rows going stale until the next
  refresh, and only owned movers counting their trials.  The in-place
  apply kernel visits every real row at most once (same-colour stencils
  are disjoint and the local row map is injective).  Without it (T = 1:
  'off', or 'auto' on a grid whose stencils overlap) the serial scatter
  ADDs the stencil deltas and SETs only the movers' own slots, which are
  distinct real rows (distinct fine cells), so the JAX package's
  duplicate-safe ADD form of those SETs (its ``_apply_spatial``) is not
  needed; tests/test_torch_spatial_engine_unfused.py holds both cases
  against the JAX engine;
* after the loop the owned rows are gathered back into the global slab.

The result is the serial engine's, bit for bit where the backend's
arithmetic is (the tests hold it at f64 round-off).  A ``space`` x
``walkers`` rank grid composes it with walker sharding
(``make_spatial_mesh``): the sub-step collectives run over the space
axis, the cycle-rank reductions over the walker axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..mcmc.cellengine import (
    CN_FIXED,
    CellEngine,
    _Trial,
    _TrialTM,
    make_tab,
)
from ..ops.cells import CellGrid
from .comm import SINGLE, Comm, new_subgroups


def _fine_coords(cg: CellGrid, ids: np.ndarray) -> np.ndarray:
    """Decode fine ids -> [.., 3] integer fine coords."""
    _, nf2, nf3 = cg.nf
    f1, rem = np.divmod(ids, nf2 * nf3)
    f2, f3 = np.divmod(rem, nf3)
    return np.stack([f1, f2, f3], axis=-1)


def stencil_reach(cg: CellGrid) -> np.ndarray:
    """Per-axis fine-layer reach of the per-fine-cell coverage table,
    recovered from the materialised ids + wrap offsets (the unwrapped
    offset along axis a is coords[cell] + wrap_a * nf_a - coords[base];
    see ops/cells._materialise wrap convention)."""
    nf = np.asarray(cg.nf)
    base = _fine_coords(cg, np.arange(cg.nfine, dtype=np.int64))
    cells = _fine_coords(cg, cg.full_cells.astype(np.int64))
    unwrapped = cells + cg.full_off.astype(np.int64) * nf - base[:, None, :]
    unwrapped = unwrapped[:, cg.full_mask, :]
    # offsets span [-reach, reach] around the base cell (cube [0,1))
    return np.maximum(unwrapped.max(axis=(0, 1)),
                      -unwrapped.min(axis=(0, 1))).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """Host-side static plan for D-way spatial sharding (numpy)."""

    ndev: int
    reach: int              # stencil reach, fine layers
    halo_layers: int        # halo depth per side (= 2*reach layers)
    layers_owned: int       # owned fine x-layers per rank
    rows_owned: int         # owned slab rows (= layers_owned*nf2*nf3)
    rows_halo: int          # halo rows per side (= halo_layers*nf2*nf3)
    K_loc: int              # padded movers per (table, rank)
    dummy_row: int          # local row id of the all-invalid DUMMY row
                            # appended after the owned (+ halo) rows;
                            # schedule padding points here, so in-place
                            # kernels never revisit a REAL row

    # [D, nfine] int32: local row of each global fine id, -1 if the id
    # is neither owned by nor in the halo of rank d
    loc_of_global: np.ndarray
    # [D, rows_halo] global fine ids of the lo/hi halo rows, in local
    # row order (matching the neighbours' owned-row send slices)
    halo_lo_src: np.ndarray
    halo_hi_src: np.ndarray

    # per-(table row t, rank d) schedules, padded with -1 to K_loc:
    # mover_idx[t, d, j] = index into the table row's K movers
    mover_idx: np.ndarray       # [T, D, K_loc] int32
    fc_local: np.ndarray        # [T, D, K_loc] int32 local mover rows
    cand_local: np.ndarray      # [T, D, K_loc, CF] int32 local rows
    own_fc: np.ndarray          # [T, D, K_loc] bool: d owns mover cell
    own_cand: np.ndarray        # [T, D, K_loc, CF] bool: d owns cell

    @property
    def rows_local(self) -> int:
        return self.rows_owned + 2 * self.rows_halo


def build_spatial_plan(cg: CellGrid, fc_stack: np.ndarray,
                       ndev: int) -> SpatialPlan:
    """Build the D-way partition of a cell grid and its stacked
    (colour, fine-block) sub-step schedule (CellEngine.fc_stack).

    Requires ndev to divide the coarse count along the sharded axis
    (whole coarse cells per rank) and the owned span to cover the halo
    depth (the +-1 ring shift sources each halo from ONE neighbour's
    owned rows)."""
    nfx, nf2, nf3 = cg.nf
    if cg.n[0] % ndev:
        raise ValueError(
            f"spatial ndev={ndev} must divide the coarse x count "
            f"{cg.n[0]} (ownership aligns to whole coarse cells)"
        )
    layers_owned = nfx // ndev
    rows_per_layer = nf2 * nf3
    reach_vec = stencil_reach(cg)
    reach = int(reach_vec[0])
    halo_layers = 2 * reach
    if ndev > 1 and layers_owned < halo_layers:
        raise ValueError(
            f"owned span {layers_owned} fine layers must cover the "
            f"halo depth {halo_layers} (2x stencil reach {reach}): "
            "use fewer devices or more coarse cells along x"
        )
    rows_owned = layers_owned * rows_per_layer
    rows_halo = halo_layers * rows_per_layer

    fid = np.arange(cg.nfine, dtype=np.int64)
    fx = fid // rows_per_layer
    owner = (fx // layers_owned).astype(np.int32)          # [nfine]

    loc_of_global = np.full((ndev, cg.nfine), -1, dtype=np.int32)
    halo_lo_src = np.empty((ndev, rows_halo), dtype=np.int32)
    halo_hi_src = np.empty((ndev, rows_halo), dtype=np.int32)
    for d in range(ndev):
        x0 = d * layers_owned
        own_ids = fid[(fx >= x0) & (fx < x0 + layers_owned)]
        loc_of_global[d, own_ids] = np.arange(rows_owned)
        lo_layers = np.arange(x0 - halo_layers, x0) % nfx
        hi_layers = np.arange(x0 + layers_owned,
                              x0 + layers_owned + halo_layers) % nfx
        lo_ids = (lo_layers[:, None] * rows_per_layer
                  + np.arange(rows_per_layer)[None, :]).ravel()
        hi_ids = (hi_layers[:, None] * rows_per_layer
                  + np.arange(rows_per_layer)[None, :]).ravel()
        # halo overwrites owned only in the degenerate ndev=1 case
        if ndev > 1:
            loc_of_global[d, lo_ids] = rows_owned + np.arange(rows_halo)
            loc_of_global[d, hi_ids] = (
                rows_owned + rows_halo + np.arange(rows_halo))
        halo_lo_src[d] = lo_ids
        halo_hi_src[d] = hi_ids

    # ---- per-(table, rank) mover schedules
    T, K = fc_stack.shape
    CF = cg.full_cells.shape[1]
    sched: list[list[np.ndarray]] = [[] for _ in range(ndev)]
    for t in range(T):
        row_fc = fc_stack[t].astype(np.int64)              # [K]
        cand = cg.full_cells[row_fc].astype(np.int64)      # [K, CF]
        cand_own = np.where(cg.full_mask[None, :], owner[cand], -1)
        for d in range(ndev):
            # a rank computes every mover with at least one OWNED
            # stencil cell (movers it must apply writes for)
            take = np.any(cand_own == d, axis=1)
            idx = np.nonzero(take)[0].astype(np.int32)
            # every such mover MUST resolve fully in owned+halo rows;
            # the halo depth above guarantees it - assert, never
            # silently drop an owned write
            loc = loc_of_global[d]
            if not (np.all(loc[row_fc[idx]] >= 0)
                    and np.all(loc[cand[idx]][:, cg.full_mask] >= 0)):
                raise AssertionError(
                    "stencil of a scheduled mover escapes the halo "
                    f"(table {t}, device {d})"
                )
            sched[d].append(idx)
    K_loc = max((len(s) for rows in sched for s in rows), default=0)

    # local slab layout: [owned | lo halo | hi halo | DUMMY] (halos only
    # for ndev > 1); padding entries and out-of-halo masked candidates
    # point at the dummy row, which is all-invalid: its energies are
    # zero, in-place kernel writes to it are garbage by design, and it
    # is dropped with the halos
    dummy_row = rows_owned + (2 * rows_halo if ndev > 1 else 0)
    mover_idx = np.full((T, ndev, K_loc), -1, dtype=np.int32)
    fc_local = np.full((T, ndev, K_loc), dummy_row, dtype=np.int32)
    cand_local = np.full((T, ndev, K_loc, CF), dummy_row, dtype=np.int32)
    own_fc = np.zeros((T, ndev, K_loc), dtype=bool)
    own_cand = np.zeros((T, ndev, K_loc, CF), dtype=bool)
    for t in range(T):
        row_fc = fc_stack[t].astype(np.int64)
        cand = cg.full_cells[row_fc].astype(np.int64)      # [K, CF]
        for d in range(ndev):
            idx = sched[d][t]
            k = len(idx)
            loc = loc_of_global[d]
            mover_idx[t, d, :k] = idx
            fc_local[t, d, :k] = loc[row_fc[idx]]
            cl = loc[cand[idx]]
            cand_local[t, d, :k] = np.where(cl >= 0, cl, dummy_row)
            own_fc[t, d, :k] = owner[row_fc[idx]] == d
            own_cand[t, d, :k] = (
                (owner[cand[idx]] == d) & cg.full_mask[None, :])

    return SpatialPlan(
        ndev=ndev, reach=reach, halo_layers=halo_layers,
        layers_owned=layers_owned,
        rows_owned=rows_owned, rows_halo=rows_halo, K_loc=K_loc,
        dummy_row=dummy_row,
        loc_of_global=loc_of_global,
        halo_lo_src=halo_lo_src, halo_hi_src=halo_hi_src,
        mover_idx=mover_idx, fc_local=fc_local,
        cand_local=cand_local, own_fc=own_fc, own_cand=own_cand,
    )


# ----------------------------------------------------------------------
# runtime: the spatially sharded cell engine
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A rank's two axes: ``space`` (the slab partition) and ``walkers``
    (the walker ensemble)."""

    space: Comm
    walkers: Comm


def make_spatial_mesh(comm: Comm, walkers: int = 1) -> SpatialMesh:
    """The ``space`` x ``walkers`` rank grid of a world ``comm`` (the
    JAX package's 2-D mesh: world rank = space index * walkers + walker
    index; the reference's every-rank-is-both analog,
    comms_mpi.f90:244-530).  Collective: every rank of the world calls
    it, and it creates a subgroup per row and per column."""
    if comm.size % walkers:
        raise ValueError(f"{comm.size} ranks do not factor into "
                         f"(space, walkers={walkers})")
    if walkers <= 1:
        return SpatialMesh(comm, SINGLE)
    nsp = comm.size // walkers
    space = new_subgroups([[i * walkers + w for i in range(nsp)]
                           for w in range(walkers)])
    wk = new_subgroups([[i * walkers + w for w in range(walkers)]
                        for i in range(nsp)])
    return SpatialMesh(space, wk)


class SpatialCellEngine(CellEngine):
    """The cell engine with the fine grid sharded over the ranks of
    ``mesh.space`` (see the module docstring): the sub-step loop runs on
    local slabs, everything at cycle rank on the whole state of this
    rank's walkers.  Modes: ``cell_pallas`` in ('off', 'apply',
    'auto'; the 'on' scatter of per-candidate deltas is refused, as in
    the JAX package), any ``cell_chain`` (the chain runs replicated on
    the assembled tables), ``cell_trials`` >= 1 (T > 1 needs the
    in-place apply kernel)."""

    def __init__(self, prm, model, grid, aux, cellgrid, cellaux,
                 mesh: SpatialMesh | None = None, device="cuda",
                 stream=None):
        if prm.cell_pallas == "on":
            raise ValueError(
                "spatial sharding supports cell_pallas in ('off', "
                "'apply', 'auto'): the 'on' per-candidate-delta "
                "scatter path has no duplicate-safe spatial apply")
        mesh = SpatialMesh(SINGLE, SINGLE) if mesh is None else mesh
        super().__init__(prm, model, grid, aux, cellgrid, cellaux,
                         device=device, stream=stream, comm=mesh.walkers)
        if self.T > 1 and not self.use_cell_apply:
            raise ValueError(
                "cell_trials > 1 under spatial sharding requires the "
                "in-place apply kernel: set cell_pallas='apply' (needs "
                "a disjoint-stencil grid)")
        self.space = mesh.space
        self.is_root = self.is_root and self.space.rank == 0
        self.plan = build_spatial_plan(
            cellgrid, self.fc_stack.cpu().numpy(), self.space.size)
        self._init_local_tables()

    def _init_local_tables(self):
        """This rank's schedules as ``_Tab`` rows over the local slab,
        with the index maps between its K_loc movers and the table's
        K (``mvc``: the mover each entry computes, 0 for padding)."""
        p, d, dev = self.plan, self.space.rank, self.device
        cap = self.cellgrid.cap

        def tens(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        mv = p.mover_idx[:, d]                               # [T,K_loc]
        self.vj = tens(mv >= 0)                              # [T,K_loc]
        self.mvc = tens(np.maximum(mv, 0), torch.int64)
        self.ownf = tens(p.own_fc[:, d] & (mv >= 0))
        self.ltabs = [
            make_tab(t, self.fc_stack[t][self.mvc[t]].contiguous(),
                     tens(p.fc_local[t, d]), tens(p.cand_local[t, d]),
                     self.off_stack[t][self.mvc[t]].contiguous(), cap)
            for t in range(self.n_tables)]
        # the owned movers of each table: their entries and indices
        self.own_idx = [torch.nonzero(self.ownf[t])[:, 0]
                        for t in range(self.n_tables)]
        self.own_mvc = [self.mvc[t][self.own_idx[t]]
                        for t in range(self.n_tables)]
        self.halo_lo = tens(p.halo_lo_src[d], torch.int64)
        self.halo_hi = tens(p.halo_hi_src[d], torch.int64)

    # ------------------------------------------------------------------
    # local slabs
    # ------------------------------------------------------------------

    def _localise(self, x, fill):
        """Global rows [nfine, ...] -> this rank's local slab [owned | lo
        halo | hi halo (D > 1) | dummy], the dummy row filled with
        ``fill`` (invalid occupancy / zero packed data).  The whole state
        is at hand, so the halos are copied from it directly."""
        p = self.plan
        ro, d = p.rows_owned, self.space.rank
        parts = [x[d * ro:(d + 1) * ro]]
        if p.ndev > 1:
            parts += [x[self.halo_lo], x[self.halo_hi]]
        parts.append(torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                                device=x.device))
        return torch.cat(parts)

    def halo_bytes(self, pks_loc) -> int:
        """The halo rows one refresh sends from this rank (both sides,
        all lattices); the all-gather of ``Comm.ring_shift`` delivers
        the blocks of all D ranks to every rank."""
        rh = self.plan.rows_halo
        return 2 * sum(pk[:rh].numel() * pk.element_size() for pk in pks_loc)

    def _refresh_halo(self, pks_loc):
        """The +-1 ring shift of the owned edge rows into the halo rows
        of the local slabs, in place (the lo halo is the down
        neighbour's last owned rows, the hi halo the up neighbour's
        first).  The dummy row needs none: its validity row stays zero,
        so what padded movers write there is never read as data."""
        p = self.plan
        ro, rh = p.rows_owned, p.rows_halo
        lo, hi = self.space.ring_shift(
            torch.stack([pk[ro - rh:ro] for pk in pks_loc]),
            torch.stack([pk[:rh] for pk in pks_loc]))
        for l, pk in enumerate(pks_loc):
            pk[ro:ro + rh] = lo[l]
            pk[ro + rh:ro + 2 * rh] = hi[l]

    def _local_view(self, s, switch_ok=True):
        """(pks_loc, st_loc, rows, rows_loc) of the sub-step loop: the
        local packed slabs, the state with the local slab's occupancy
        (which the proposals read; the chain and its WL writes take the
        state itself), the loop rows of the whole tables and their
        local form (occupancy of this rank's movers, padding empty)."""
        cg = self.cellgrid
        W = s.r.shape[-1]
        dev = s.r.device
        pks_loc = [self._localise(pk, 0.0) for pk in self._pack(s)]
        s2m_loc = self._localise(s.slot2mol.view(cg.nfine, cg.cap, W), -1)
        st_loc = dataclasses.replace(s, slot2mol=s2m_loc.view(-1, W))
        rows = self._loop_rows(s, switch_ok)
        tt = torch.arange(self.mvc.shape[0], device=dev)[:, None]
        vjw = self.vj[..., None]
        rows_loc = rows._replace(
            inc=torch.ones((self.plan.K_loc, 2, W), dtype=s.r.dtype,
                           device=dev),
            occ_f=rows.occ_f[tt, self.mvc] * vjw,
            rank_max=rows.rank_max[tt, self.mvc] * vjw,
            occupied=rows.occupied[tt, self.mvc] & vjw)
        return pks_loc, st_loc, rows, rows_loc

    def _to_global(self, t, x):
        """[F, K_loc, W] local per-mover values -> [F, K, W] of the
        table's K movers on every rank: the owner of each mover
        contributes it, the others zero, summed over the space ranks
        (exact: one nonzero addend per entry)."""
        F, _, W = x.shape
        z = torch.zeros((F, self.K, W), dtype=x.dtype, device=x.device)
        z[:, self.own_mvc[t]] = x[:, self.own_idx[t]]
        return self.space.sum(z)

    # ------------------------------------------------------------------
    # the sharded sub-step loop
    # ------------------------------------------------------------------

    def _one_cycle(self, s):
        return self._cycle_with(s, self._sharded_scan)

    def _sharded_scan(self, s, codes, u_all, n_sub, switch_ok=True, t0=0):
        """The sub-step loop of ``CellEngine._substep_scan`` on local
        slabs (sub-step ``sid`` at table row (t0 + sid) % n_tables).
        Returns (s, tpm_slab) as it does."""
        plan = self.plan
        W = s.r.shape[-1]
        K, T, cap = self.K, self.T, self.cellgrid.cap
        dev = s.r.device
        with tracing.wait("move_codes"):
            codes_d = codes.to(device=dev if self.use_chain_kernel
                               else "cpu", dtype=torch.int32)
        pks_loc, st_loc, rows, rows_loc = self._local_view(s, switch_ok)
        tpm_loc = torch.zeros((pks_loc[0].shape[0] * cap, W),
                              dtype=torch.int32, device=dev)
        cnt_all = torch.empty((n_sub, CN_FIXED + K, W), dtype=torch.int32,
                              device=dev)
        if T == 1:
            u_all = u_all.permute(0, 2, 1, 3).contiguous()   # [n,7,K,W]
            for sid in range(n_sub):
                with tracing.span("mw/substep"):
                    self._local_substep(
                        s, st_loc, pks_loc, tpm_loc,
                        (t0 + sid) % self.n_tables, u_all[sid],
                        codes_d[sid * K:(sid + 1) * K], rows, rows_loc,
                        cnt_all[sid])
        else:
            u_mv, u_a, u_z = self._split_uniforms(u_all)
            for sid in range(n_sub):
                with tracing.span("mw/substep"):
                    self._local_substep_multi(
                        s, st_loc, pks_loc, tpm_loc,
                        (t0 + sid) % self.n_tables, u_mv[sid], u_a[sid],
                        u_z[sid], codes_d[sid * K * T:(sid + 1) * K * T],
                        rows, rows_loc, cnt_all[sid])
        tracing.count("substeps", n_sub)
        self._chain_unrows(s, rows)
        self._count(s, cnt_all)
        # owned rows back into the global slabs (the halo and dummy rows
        # go; the trial counts of the halo rows are zero)
        ro = plan.rows_owned
        pks = [self.space.cat(pk[:ro], dim=0) for pk in pks_loc]
        tpm = self.space.cat(tpm_loc.view(-1, cap, W)[:ro], dim=0)
        return self._unpack(s, pks), tpm.view(-1, W)

    def _local_substep(self, s, st_loc, pks_loc, tpm_loc, t, u, codes_k,
                       rows, rows_loc, cnt):
        """One sub-step at one trial per mover: local proposals, the
        replicated chain on the assembled tables, the local apply."""
        if self.plan.ndev > 1:
            self._refresh_halo(pks_loc)
        tab, mvc = self.ltabs[t], self.mvc[t]
        trial = self._propose_t1(st_loc, pks_loc, tab, u[:, mvc], rows_loc)
        L, Kl, _, W = trial.e.shape
        g = self._to_global(t, torch.cat([
            trial.e.transpose(1, 2).reshape(2 * L, Kl, W),
            rows_loc.inc[:, 1][None], trial.hasm[None]]))
        rows.inc[:, 1] = g[2 * L]
        e_g = g[:2 * L].view(L, 2, self.K, W).transpose(1, 2).contiguous()
        trial_g = _Trial(None, None, None, None, e_g, None, g[2 * L + 1])
        accf, cnt = self._chain_one(s, rows, trial_g, codes_k, u[5], u[6],
                                    cnt)
        acc_l = accf[mvc] * self.vj[t][:, None]
        en_l = cnt[CN_FIXED:][mvc] * self.ownf[t][:, None]
        self._apply_t1(st_loc, pks_loc, tpm_loc, tab, trial,
                       acc_l.contiguous(), en_l)

    def _local_substep_multi(self, s, st_loc, pks_loc, tpm_loc, t, u, ua,
                             uz, codes_kt, rows, rows_loc, cnt):
        """One multi-trial sub-step: local P-point tables, the
        replicated chain on the assembled tables, the local apply of
        each mover's final point."""
        if self.plan.ndev > 1:
            self._refresh_halo(pks_loc)
        tab, mvc = self.ltabs[t], self.mvc[t]
        trial = self._propose_tm(st_loc, pks_loc, tab, u[:, mvc], rows_loc)
        L, Kl, P, W = trial.e.shape
        g = self._to_global(t, torch.cat([
            trial.e.permute(0, 2, 1, 3).reshape(L * P, Kl, W),
            trial.inc.transpose(0, 1), trial.hasm[None]]))
        trial_g = _TrialTM(
            None, None, None,
            g[L * P:L * P + P].transpose(0, 1).contiguous(),
            g[:L * P].view(L, P, self.K, W).transpose(1, 2).contiguous(),
            None, g[-1])
        joh, cnt = self._chain_multi(s, rows, trial_g, codes_kt, ua, uz, cnt)
        j_loc = torch.where(
            self.vj[t][:, None, None], joh[mvc],
            (torch.arange(P, device=joh.device) == 0).to(joh.dtype)
            [None, :, None])
        self._apply_tm(st_loc, pks_loc, tab, trial, j_loc)
        tpm_loc.scatter_add_(0, trial.slot,
                             cnt[CN_FIXED:][mvc] * self.ownf[t][:, None])
