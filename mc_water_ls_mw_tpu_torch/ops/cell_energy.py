"""Slab-based SW energies for the large-N cell engine, on tensors.

Counterpart of ``mc_water_ls_mw_tpu/ops/cell_energy.py`` (same
moment-tensor algebra as ops/dense.py, same Hamiltonian -
molint.F90:220-499): candidates come from the static coverage tables of
the two-level fine grid (ops/cells.py) instead of a dense [S, N, W] set.
All slab accesses gather whole fine cells ([cap, W] blocks) at table
indices shared by every walker.

Periodic images: a candidate cell that wraps the box contributes its
occupants shifted by H @ off, with off the static wrap offset
(cells.build_grid).  The coverage tables contain every interaction
partner in both replicas exactly once, so there is no minimum-image
fold.

``mover_energies`` is the plain version the mover-energies and
mover-apply kernels are held against, ``mover_point_energies`` (the
multi-trial sub-step, cell_trials > 1) that of the mover-points kernel
(ops/cell_kernels.py), and ``slab_full_energy`` that of the whole-cell
energy kernel (ops/slab_energy.py, csrc/slab_energy.cu), which serves the
volume moves, resyncs and audits of both lattices in one launch on the
card.  In the JAX package ``slab_full_energy`` is plain jnp that XLA
fuses; here, unfused, it was some hundred launches a centre chunk and
blocking table copies, hence the hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.sw import SWParams
from .cells import CellGrid
from .dense import Moments, _e3_closed_form, _leg, _pair


def _cells_view(arr, cap):
    """A slab as [nfine, cap, W]: either given so (a row of the packed
    slab) or as [nslot, W]."""
    return arr if arr.dim() == 3 else arr.reshape(-1, cap, arr.shape[-1])


def _cell_take(arr, cells, cap):
    """Gather candidate fine cells at CELL granularity.

    arr [nslot, W] (or [nfine, cap, W]); cells [K, C] int64 tensor
    shared across walkers -> [K, C*cap, W]."""
    a = _cells_view(arr, cap)
    K = cells.shape[0]
    return a.index_select(0, cells.reshape(-1)).reshape(K, -1, a.shape[-1])


class _SlabCand:
    """Candidate data of one mover batch against its coverage set.

    All arrays [K, C, W] with C = CF*cap (or [K, W] reductions)."""

    __slots__ = ("pair_sum", "w", "ux", "uy", "uz", "e3i", "own", "dlt")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def delta(self) -> Moments:
        return self.dlt


def _shift_vectors(H, off):
    """H [3,3,W] x off [K,CC,3] -> three [K,CC,W] shift components."""
    off = off.to(H.dtype)
    return [
        off[:, :, 0, None] * H[a, 0] + off[:, :, 1, None] * H[a, 1]
        + off[:, :, 2, None] * H[a, 2]
        for a in range(3)
    ]


def _gather_candidates(rx, ry, rz, valid, H, cand_cells, cand_off,
                       cand_mask, cap, mover_slot):
    """Shared candidate gather for the old/new mover positions.

    Returns (cx, cy, cz image-shifted coordinates [K,C,W],
    mask [K,C,W]) - identical for both evaluation points of a trial
    move, so gathered ONCE per lattice per sub-step."""
    cx, cy, cz = (_cell_take(a, cand_cells, cap) for a in (rx, ry, rz))
    cval = _cell_take(valid, cand_cells, cap)
    mask_slots = torch.as_tensor(
        np.repeat(np.asarray(cand_mask), cap), device=cval.device)
    cval = cval & mask_slots[None, :, None]

    shx, shy, shz = _shift_vectors(H, cand_off)             # [K,CC,W]
    cx = cx + shx.repeat_interleave(cap, dim=1)
    cy = cy + shy.repeat_interleave(cap, dim=1)
    cz = cz + shz.repeat_interleave(cap, dim=1)

    K = cand_cells.shape[0]
    slot_ids = (
        cand_cells[:, :, None] * cap
        + torch.arange(cap, device=cand_cells.device)
    ).reshape(K, -1)                                        # [K,C]
    not_self = slot_ids[:, :, None] != mover_slot[:, None, :]
    return cx, cy, cz, cval & not_self


def _slab_candidates(cand, p, prm: SWParams) -> _SlabCand:
    """Candidate energies/legs of movers at positions ``p``.

    cand: output of _gather_candidates; p: (px,py,pz) each [K, W]."""
    cx, cy, cz, mask = cand
    px, py, pz = p
    dx = cx - px[:, None, :]
    dy = cy - py[:, None, :]
    dz = cz - pz[:, None, :]
    r2 = dx * dx + dy * dy + dz * dz
    in_rc = (r2 < prm.rc2) & mask
    r2s = torch.where(in_rc, r2, 1.0)
    inv = torch.rsqrt(r2s)
    rij = r2s * inv

    pair_sum = torch.sum(_pair(r2s, rij, in_rc, prm), dim=1)  # [K,W]
    w = _leg(rij, in_rc, prm)
    ux, uy, uz = dx * inv, dy * inv, dz * inv

    wux, wuy, wuz = w * ux, w * uy, w * uz
    second = (wux * ux, wuy * uy, wuz * uz, wux * uy, wux * uz, wuy * uz)
    own = Moments(*(t.sum(dim=1) for t in (w, wux, wuy, wuz) + second))
    e3i = _e3_closed_form(own, torch.sum(w * w, dim=1), prm.cos0)

    # per-candidate contributions to each j's moments (from j's view,
    # the leg direction is -u; ops/dense.py delta convention)
    return _SlabCand(
        pair_sum=pair_sum, w=w, ux=ux, uy=uy, uz=uz, e3i=e3i, own=own,
        dlt=Moments(w, -wux, -wuy, -wuz, *second),
    )


def _slab_jcentred(c: _SlabCand, m: Moments, prm: SWParams):
    """Wing-angle sums i-j-k over slab candidates -> [K, W].

    ``m``: gathered coverage-set moments, fields [K, C, W]
    (ops/dense._jcentred with the slab candidate axis)."""
    c0 = prm.cos0
    ux, uy, uz = c.ux, c.uy, c.uz
    quad = (
        ux * ux * m.mxx + uy * uy * m.myy + uz * uz * m.mzz
        + 2.0 * (ux * uy * m.mxy + ux * uz * m.mxz + uy * uz * m.myz)
    )
    lin = ux * m.mx + uy * m.my + uz * m.mz
    per = (
        quad + 2.0 * c0 * lin + (c0 * c0) * m.s1
        - (1.0 - c0) ** 2 * c.w
    )
    return torch.sum(c.w * per, dim=1)


def mover_energies(slab_r, slab_mom: Moments, valid, H, cand_cells,
                   cand_off, cand_mask, cap, mover_slot, p_old, p_new,
                   prm: SWParams):
    """One lattice: old/new local energies of a batch of K movers.

    slab_r: three [nslot, W] (or [nfine, cap, W]) coordinate slabs;
    slab_mom fields likewise; valid: bool slab; H: [3,3,W]; cand_cells
    [K,CF] int64 / cand_off [K,CF,3] the movers' coverage-table rows;
    mover_slot: [K, W]; p_old/p_new: [3, K, W].

    Returns (e_old [K,W], e_new [K,W], cand_old, cand_new) - the
    candidate objects carry the leg data needed for post-accept
    moment updates.  Slab counterpart of dense.local_energies_batch
    (itself 2x compute_local_real_energy, molint.F90:220-404)."""
    lam_eps = prm.lam * prm.epsilon
    cand = _gather_candidates(slab_r[0], slab_r[1], slab_r[2], valid, H,
                              cand_cells, cand_off, cand_mask, cap,
                              mover_slot)
    co = _slab_candidates(cand, (p_old[0], p_old[1], p_old[2]), prm)
    mom_nb = Moments(*(_cell_take(f, cand_cells, cap) for f in slab_mom))
    e3j_old = _slab_jcentred(co, mom_nb, prm)
    e_old = co.pair_sum + lam_eps * (co.e3i + e3j_old)

    cn = _slab_candidates(cand, (p_new[0], p_new[1], p_new[2]), prm)
    # world with the mover at p_new: every neighbour's moments
    # corrected by the mover's old/new leg contributions
    eff = Moments(*(
        m - do + dn for m, do, dn in zip(mom_nb, co.delta(), cn.delta())
    ))
    e3j_new = _slab_jcentred(cn, eff, prm)
    e_new = cn.pair_sum + lam_eps * (cn.e3i + e3j_new)
    return e_old, e_new, co, cn


def mover_point_energies(slab_r, slab_mom: Moments, valid, H, cand_cells,
                         cand_off, cand_mask, cap, mover_slot, pts,
                         prm: SWParams):
    """One lattice: local energies of K movers at P evaluation points
    each (the multi-trial sub-step, cell_trials > 1).

    pts: [P, 3, K, W]; point 0 MUST be the mover's stored position - the
    slab moments carry the mover's own leg contributions from there, so
    the world with the mover at point t uses neighbour moments
    ``mom - delta(point 0) + delta(point t)``.  e(t) is the mover's full
    local energy in world(t), so dE(j -> t) = e(t) - e(j) for any pair
    of points and the chain composes trials from one table.  Other
    arguments as :func:`mover_energies`.

    Returns (e [P, K, W], owns: list of P Moments ([K, W] fields), cands:
    list of P candidate stores, whose deltas feed the unfused sub-step's
    moment scatter).  The candidates are gathered ONCE (they do not
    depend on the point)."""
    lam_eps = prm.lam * prm.epsilon
    cand = _gather_candidates(slab_r[0], slab_r[1], slab_r[2], valid, H,
                              cand_cells, cand_off, cand_mask, cap,
                              mover_slot)
    mom_nb = Moments(*(_cell_take(f, cand_cells, cap) for f in slab_mom))
    P = pts.shape[0]
    cs = [_slab_candidates(cand, (pts[t, 0], pts[t, 1], pts[t, 2]), prm)
          for t in range(P)]
    d0 = cs[0].delta()
    es, owns = [], []
    for t in range(P):
        eff = mom_nb if t == 0 else Moments(*(
            m - a + b for m, a, b in zip(mom_nb, d0, cs[t].delta())))
        e3j = _slab_jcentred(cs[t], eff, prm)
        es.append(cs[t].pair_sum + lam_eps * (cs[t].e3i + e3j))
        owns.append(cs[t].own)
    return torch.stack(es), owns, cs


# per-intermediate element budget of slab_full_energy: the
# [cc, cap, ng*cap, W] candidate tensors (~10 live arrays of this size)
_FULL_ENERGY_MAX_ELEMS = 1 << 24


def _pick_chunking(nfine: int, CF: int, cap: int, W: int,
                   max_elems: int) -> tuple:
    """(cell_chunk, ngroup): candidate-cell group size ngroup <= CF
    and centre-cell count cc | nfine keeping the candidate
    intermediate cc*cap*(ngroup*cap)*W under the element budget."""
    per_cell = cap * cap * W
    ngroup = max(1, min(CF, max_elems // max(per_cell, 1)))
    cc = 1
    for c in range(min(nfine, 64), 0, -1):
        if nfine % c == 0 and c * ngroup * per_cell <= max_elems:
            cc = c
            break
    return cc, ngroup


def slab_full_energy(slab_r, valid, H, grid: CellGrid, prm: SWParams,
                     cell_chunk: int | None = None,
                     max_elems: int = _FULL_ENERGY_MAX_ELEMS):
    """One lattice: total energy + fresh per-slot moments.

    Slab counterpart of dense.full_energy_batch (compute_model_energy,
    molint.F90:407-499): per slot i, half the pair sum plus the
    centre-angle moment formula.  Centres are FINE cells, candidates
    their static coverage lists; chunked over centre cells and over
    candidate-cell groups, bounding every intermediate by ``max_elems``
    elements regardless of cap/W.

    slab_r [3, nslot, W]; valid [nslot, W] bool; H [3,3,W].
    Returns (energy [W], moments [10, nslot, W])."""
    nfine, cap = grid.nfine, grid.cap
    CF = grid.full_cells.shape[1]
    rx, ry, rz = slab_r[0], slab_r[1], slab_r[2]
    W = rx.shape[-1]
    dtype, dev = rx.dtype, rx.device
    lam_eps = prm.lam * prm.epsilon

    if cell_chunk is None:
        cell_chunk, ngroup = _pick_chunking(nfine, CF, cap, W, max_elems)
    else:
        ngroup = CF
    assert nfine % cell_chunk == 0

    # pad the candidate axis to a multiple of ngroup (mask kills pads)
    ngr = -(-CF // ngroup)
    CFp = ngr * ngroup
    fc = np.zeros((nfine, CFp), dtype=np.int64)
    fo = np.zeros((nfine, CFp, 3), dtype=np.int64)
    fm = np.zeros(CFp, dtype=bool)
    fc[:, :CF] = grid.full_cells
    fo[:, :CF] = grid.full_off
    fm[:CF] = grid.full_mask
    cells_all = torch.as_tensor(fc, device=dev)
    off_all = torch.as_tensor(fo, device=dev)
    mask_g = fm.reshape(ngr, ngroup)
    arange_cap = torch.arange(cap, device=dev)

    rxc, ryc, rzc, vc = (_cells_view(a, cap) for a in (rx, ry, rz, valid))
    energy = torch.zeros((W,), dtype=dtype, device=dev)
    moments = torch.empty((10, nfine, cap, W), dtype=dtype, device=dev)
    for c0 in range(0, nfine, cell_chunk):
        c1 = c0 + cell_chunk
        cells27, off27 = cells_all[c0:c1], off_all[c0:c1]
        pxr, pyr, pzr = rxc[c0:c1], ryc[c0:c1], rzc[c0:c1]  # [cc,cap,W]
        ctr_ids = (torch.arange(c0, c1, device=dev)[:, None] * cap
                   + arange_cap).reshape(cell_chunk, cap, 1, 1)
        cvalr = vc[c0:c1][:, :, None, :]
        shx27, shy27, shz27 = _shift_vectors(H, off27)      # [cc,CFp,W]

        pair_half = torch.zeros((cell_chunk, cap, W), dtype=dtype,
                                device=dev)
        sumw2 = torch.zeros_like(pair_half)
        acc = None
        for gi in range(ngr):
            if not mask_g[gi].any():
                continue
            g0 = gi * ngroup
            nbc = cells27[:, g0:g0 + ngroup]                # [cc, ng]
            cx, cy, cz = (_cell_take(a, nbc, cap)
                          for a in (rxc, ryc, rzc))         # [cc,C,W]
            cval = _cell_take(vc, nbc, cap)
            gmask = torch.as_tensor(np.repeat(mask_g[gi], cap), device=dev)
            cval = cval & gmask[None, :, None]
            cx = cx + shx27[:, g0:g0 + ngroup].repeat_interleave(cap, 1)
            cy = cy + shy27[:, g0:g0 + ngroup].repeat_interleave(cap, 1)
            cz = cz + shz27[:, g0:g0 + ngroup].repeat_interleave(cap, 1)

            dx = cx[:, None, :, :] - pxr[:, :, None, :]  # [cc,cap,C,W]
            dy = cy[:, None, :, :] - pyr[:, :, None, :]
            dz = cz[:, None, :, :] - pzr[:, :, None, :]
            slot_ids = (nbc[:, :, None] * cap + arange_cap).reshape(
                cell_chunk, 1, -1, 1)
            mask = cval[:, None, :, :] & (slot_ids != ctr_ids) & cvalr
            r2 = dx * dx + dy * dy + dz * dz
            in_rc = (r2 < prm.rc2) & mask
            r2s = torch.where(in_rc, r2, 1.0)
            inv = torch.rsqrt(r2s)
            rij = r2s * inv

            pair_half = pair_half + 0.5 * torch.sum(
                _pair(r2s, rij, in_rc, prm), dim=2)         # [cc,cap,W]
            w = _leg(rij, in_rc, prm)
            ux, uy, uz = dx * inv, dy * inv, dz * inv
            wux, wuy, wuz = w * ux, w * uy, w * uz
            part = [t.sum(dim=2) for t in (
                w, wux, wuy, wuz, wux * ux, wuy * uy, wuz * uz,
                wux * uy, wux * uz, wuy * uz)]
            acc = part if acc is None else [a + p for a, p in
                                            zip(acc, part)]
            sumw2 = sumw2 + torch.sum(w * w, dim=2)

        e3 = _e3_closed_form(Moments(*acc), sumw2, prm.cos0)
        energy = energy + torch.sum(pair_half + lam_eps * e3, dim=(0, 1))
        for i in range(10):
            moments[i, c0:c1] = acc[i]
    return energy, moments.reshape(10, grid.nslot, W)
