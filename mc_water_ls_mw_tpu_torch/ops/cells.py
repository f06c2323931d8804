"""Two-level fractional cell grid for the large-N parallel-sweep engine.

Counterpart of ``mc_water_ls_mw_tpu/ops/cells.py``, whose docstring
derives the geometry: molecules are binned in the MID-replica fractional
frame f_mid = f1 - dfrac0/2 into FINE cells (the slab-storage and
candidate-search unit, ``cap`` slots each), m x m x m of which make one
8-coloured COARSE cell (the checkerboard unit: one mover per same-colour
coarse cell and sub-step, > 2*rc apart in both replicas).  Static tables
list every fine cell's coverage stencil with its periodic wrap offsets,
built from the initial boxes with a shrink guard.

The grid functions are host-side numpy, as in the JAX package (the
tables are closed over as constants).  ``cell_of_frac``,
``bin_molecules``, ``scatter_to_slab`` and ``gather_from_slab`` work on
tensors of any device; slot and cell ids are int32 in the state and are
widened to int64 where torch indexes with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# packed-slab row layout ([nfine, PK_ROWS, cap, W] per lattice): the
# sub-step loop carries ONE packed tensor per lattice, the layout the
# mover kernels read and write.  Rows 0:10 = the moment fields in
# ops/dense.Moments order; PK_R0:PK_R0+3 = x, y, z; PK_VALID =
# slot-occupied flag as 1.0/0.0 (static between rebins).
PK_R0 = 10
PK_VALID = 13
PK_ROWS = 14


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static two-level cell-grid topology (host numpy)."""

    n: tuple              # coarse cells per axis, each even >= 4
    m: int                # fine subdivisions per coarse axis
    cap: int              # slot capacity per FINE cell
    guard: float          # shrink-guard factor baked into the tables
    perp_w0: np.ndarray   # [L,3] initial per-lattice box perp widths
    block_cells: np.ndarray   # [ncoarse, m^3] fine ids per coarse cell
    cand_cells: np.ndarray    # [ncoarse, CC] candidate fine ids
    cand_off: np.ndarray      # [ncoarse, CC, 3] periodic wrap offsets
    cand_mask: np.ndarray     # [CC] valid-entry mask (list padding)
    full_cells: np.ndarray    # [nfine, CF] per-fine-cell coverage ids
    full_off: np.ndarray      # [nfine, CF, 3]
    full_mask: np.ndarray     # [CF]
    color_cells: np.ndarray   # [8, ncoarse/8] coarse ids per colour

    @property
    def nf(self) -> tuple:
        return tuple(self.m * x for x in self.n)

    @property
    def ncoarse(self) -> int:
        return int(np.prod(self.n))

    @property
    def nfine(self) -> int:
        return int(np.prod(self.nf))

    # legacy aliases used by the engine
    @property
    def ncell(self) -> int:
        return self.ncoarse

    @property
    def nslot(self) -> int:
        return self.nfine * self.cap

    @property
    def cells_per_color(self) -> int:
        return self.ncoarse // 8


def perp_widths(H) -> np.ndarray:
    """Perpendicular widths of the cell H along its three axes."""
    H = np.asarray(H, dtype=np.float64)
    vol = abs(np.linalg.det(H))
    w = np.empty(3)
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        w[a] = vol / np.linalg.norm(np.cross(H[:, b], H[:, c]))
    return w


def coverage_radius(model, mismatch: float) -> float:
    """Interaction-coverage radius in the mid frame: a partner within
    rc of a molecule in EITHER replica lies within rc + mismatch of
    its mid position (each replica's Cartesian position is within
    mismatch/2 of mid)."""
    return model.rc + mismatch


def min_coarse_side(model, mismatch: float, margin: float) -> float:
    """Checkerboard-independence bound in the mid frame: same-colour
    movers one coarse cell apart are > 2*rc apart in both replicas
    when the side exceeds 2*rc + mismatch."""
    return margin * (2.0 * model.rc + mismatch)


def choose_grid_shape(H_list, model, mismatch: float,
                      margin: float = 1.13,
                      prefer_disjoint: bool = False) -> tuple:
    """Largest even coarse counts (>= 4) satisfying the independence
    bound for every lattice's box.  ``margin`` must cover the volume
    shrink guard (build_grid guard default 1.08).  Raises if the box
    is too small (use the dense engine instead).

    prefer_disjoint: additionally clamp the counts so every FINE cell
    side stays >= r_cov = rc + mismatch (under the same margin) - the
    coverage stencil then collapses to the 27-cell cube and
    same-colour stencils become pairwise disjoint, enabling
    cell_pallas='apply' (in-place aliased moment updates).  Costs
    mover parallelism (fewer, larger coarse cells); raises if the
    disjoint bound cannot reach 4 cells per axis.
    """
    s_min = min_coarse_side(model, mismatch, margin)
    w = np.min([perp_widths(H) for H in np.asarray(H_list)], axis=0)
    n = []
    for a in range(3):
        na = int(np.floor(w[a] / s_min))
        if prefer_disjoint:
            # fine side = coarse/2 must stay >= margin * r_cov
            r_cov = model.rc + mismatch
            na = min(na, int(np.floor(w[a] / (2.0 * margin * r_cov))))
        na -= na % 2
        if na < 4:
            raise ValueError(
                f"box axis {a}: width {w[a]:.2f} Bohr supports only "
                f"{na} cells of side >= {s_min:.2f} Bohr"
                + (" under the disjoint-stencil bound"
                   if prefer_disjoint else "")
                + "; the parallel cell engine needs >= 4 (use the "
                "dense engine for this system size)"
            )
        n.append(na)
    return tuple(n)


def _offset_sets(n, m, w_fine, r_cov):
    """Fine-cell offset stencils (shared by every cell, by
    translational symmetry).

    Returns (block_offs [m^3,3], cand_offs [CC0,3], full_offs [CF0,3]):
    fine-cell index offsets whose cube lies within r_cov of the coarse
    cube [0,m)^3 (cand) or of the fine cube [0,1)^3 (full).

    A cell is EXCLUDED only when its max-norm per-axis gap exceeds
    r_cov: the Cartesian distance between the cubes is >= gap_a * w_a
    along EVERY axis for ANY cell matrix whose perpendicular widths
    satisfy the runtime guard - including the sheared boxes the
    anisotropic NPT volume move produces, where a per-axis Euclidean
    combination would NOT be a valid lower bound.  (Slightly larger
    tables than a Euclidean trim; rigor over corner-trimming.)
    """
    nf = [m * x for x in n]
    reach = [
        min(int(np.ceil(r_cov / w_fine[a])) + 1, nf[a] // 2)
        for a in range(3)
    ]

    def covers(off, hi):
        # per-axis Cartesian gap between fine cube [off, off+1) and
        # the base cube [0, hi)
        g = np.empty(3)
        for a in range(3):
            ga = max(0, off[a] - hi, -off[a] - 1)
            g[a] = ga * w_fine[a]
        return float(g.max()) <= r_cov

    block_offs = np.array(
        [[i, j, k] for i in range(m) for j in range(m)
         for k in range(m)],
        dtype=np.int32,
    )
    cand, full = [], []
    for i in range(-reach[0], m + reach[0]):
        for j in range(-reach[1], m + reach[1]):
            for k in range(-reach[2], m + reach[2]):
                off = (i, j, k)
                if covers(off, m):
                    cand.append(off)
                if covers(off, 1):
                    full.append(off)
    return (
        block_offs,
        np.asarray(cand, dtype=np.int32),
        np.asarray(full, dtype=np.int32),
    )


def _materialise(base_coords, offs, nf, pad_to=None):
    """Turn per-cell offset stencils into id + wrap-offset tables.

    base_coords: [M,3] fine coords of each base cell; offs: [C0,3].
    Returns (cells [M,C] int32, wrap [M,C,3] int32, mask [C] bool)
    with C = pad_to or C0 (padding uses cell 0, mask False).
    """
    n1, n2, n3 = nf
    q = base_coords[:, None, :] + offs[None, :, :]       # [M,C0,3]
    wrap = np.zeros_like(q)
    for a, na in enumerate((n1, n2, n3)):
        wrap[..., a] = np.where(
            q[..., a] < 0, 1, np.where(q[..., a] >= na, -1, 0)
        )
    cells = (
        (q[..., 0] % n1) * n2 + (q[..., 1] % n2)
    ) * n3 + (q[..., 2] % n3)
    # image convention: a neighbour stored past the far face
    # contributes at r_stored - H (see nb wrap convention notes)
    wrap = -wrap
    C0 = offs.shape[0]
    C = pad_to or C0
    mask = np.zeros(C, dtype=bool)
    mask[:C0] = True
    if C > C0:
        pad = np.zeros((cells.shape[0], C - C0), dtype=np.int32)
        cells = np.concatenate([cells.astype(np.int32), pad], axis=1)
        wrap = np.concatenate(
            [wrap, np.zeros((wrap.shape[0], C - C0, 3), wrap.dtype)],
            axis=1,
        )
    return cells.astype(np.int32), wrap.astype(np.int32), mask


def build_grid(n: tuple, cap: int, H_list, model, mismatch: float,
               m: int = 2, guard: float = 1.08) -> CellGrid:
    """Build the two-level grid + static coverage tables.

    n: coarse cell counts (even, >= 4); cap: slots per FINE cell;
    H_list: [L,3,3] initial cell matrices (columns = box vectors);
    guard: shrink-guard factor baked into the coverage radii (the
    volume move must reject boxes shrunk below 1/guard).
    """
    n = tuple(int(x) for x in n)
    for na in n:
        if na < 4 or na % 2:
            raise ValueError(f"coarse counts must be even >= 4, got {n}")
    H_arr = np.asarray(H_list, dtype=np.float64)
    if H_arr.ndim == 2:
        H_arr = H_arr[None]
    perp_w0 = np.stack([perp_widths(H) for H in H_arr])   # [L,3]
    nf = tuple(m * x for x in n)
    # worst-case (smallest) fine sides over lattices, deflated by the
    # shrink guard so tables remain valid for any admissible box
    w_fine = perp_w0.min(axis=0) / np.asarray(nf) / guard
    r_cov = coverage_radius(model, mismatch)
    block_offs, cand_offs, full_offs = _offset_sets(
        n, m, w_fine, r_cov
    )

    n1, n2, n3 = n
    ids_c = np.arange(n1 * n2 * n3, dtype=np.int32)
    c1, rem = np.divmod(ids_c, n2 * n3)
    c2, c3 = np.divmod(rem, n3)
    base_c = np.stack([c1, c2, c3], axis=1) * m          # fine coords

    block_cells, _, _ = _materialise(base_c, block_offs, nf)
    cand_cells, cand_off, cand_mask = _materialise(
        base_c, cand_offs, nf
    )

    nf1, nf2, nf3 = nf
    ids_f = np.arange(nf1 * nf2 * nf3, dtype=np.int32)
    f1c, remf = np.divmod(ids_f, nf2 * nf3)
    f2c, f3c = np.divmod(remf, nf3)
    base_f = np.stack([f1c, f2c, f3c], axis=1)
    full_cells, full_off, full_mask = _materialise(
        base_f, full_offs, nf
    )

    color = ((c1 % 2) * 4 + (c2 % 2) * 2 + (c3 % 2)).astype(np.int32)
    color_cells = np.stack(
        [ids_c[color == col] for col in range(8)]
    ).astype(np.int32)

    return CellGrid(
        n=n, m=int(m), cap=int(cap), guard=float(guard),
        perp_w0=perp_w0,
        block_cells=block_cells,
        cand_cells=cand_cells, cand_off=cand_off, cand_mask=cand_mask,
        full_cells=full_cells, full_off=full_off, full_mask=full_mask,
        color_cells=color_cells,
    )


def cap_for_positions(r0, H0, n: tuple, m: int = 2,
                      samples: int = 32, margin: float = 1.3) -> int:
    """Slot capacity from the ACTUAL initial configuration: worst
    fine-cell occupancy over sampled random grid origins (crystals
    bin far less uniformly than the mean - lattice planes align with
    cell boundaries), times a fluctuation margin, rounded up to a
    multiple of 4.  r0 [L,N,3], H0 [L,3,3]; binning uses the
    mid-replica fractional frame (f1 - dfrac0/2)."""
    r0 = np.asarray(r0, dtype=np.float64)
    H0 = np.asarray(H0, dtype=np.float64)
    if r0.ndim == 2:
        r0, H0 = r0[None], H0[None]
    f1 = r0[0] @ np.linalg.inv(H0[0]).T
    if r0.shape[0] == 2:
        f2 = r0[1] @ np.linalg.inv(H0[1]).T
        d = f1 - f2
        d -= np.round(d)
        fmid = f1 - 0.5 * d
    else:
        fmid = f1
    fmid = fmid - np.floor(fmid)
    nf = np.asarray([m * x for x in n])
    rng = np.random.default_rng(0)
    mx = 0
    for si in range(samples):
        origin = np.zeros(3) if si == 0 else rng.uniform(0, 1, 3)
        g = fmid - origin
        g -= np.floor(g)
        c = [
            np.minimum((g[:, a] * nf[a]).astype(np.int64), nf[a] - 1)
            for a in range(3)
        ]
        cid = (c[0] * nf[1] + c[1]) * nf[2] + c[2]
        mx = max(mx, int(np.bincount(
            cid, minlength=int(nf.prod())
        ).max()))
    # next multiple of 4 STRICTLY above margin*max_occ + 1: a long run
    # with thermal disorder plus an unlucky rebin origin must degrade
    # gracefully (occupancy drifts above the crystal's) rather than
    # kill a multi-day run at the overflow audit; cell_cap in the &tpu
    # namelist remains the explicit recovery knob
    need = int(np.floor(mx * margin)) + 2
    return max(4, -(-need // 4) * 4)


def cell_of_frac(grid: CellGrid, f, origin, level: str = "coarse"):
    """Cell id (int32) of mid-frame fractional coordinates f [3, ...]
    with grid origin ``origin`` [3].  level: 'coarse' or 'fine'."""
    n1, n2, n3 = grid.n if level == "coarse" else grid.nf
    g = f - origin.reshape((3,) + (1,) * (f.dim() - 1))
    g = g - torch.floor(g)
    # float -> int conversion truncates toward zero (g >= 0 here)
    c1 = torch.clamp((g[0] * n1).to(torch.int32), max=n1 - 1)
    c2 = torch.clamp((g[1] * n2).to(torch.int32), max=n2 - 1)
    c3 = torch.clamp((g[2] * n3).to(torch.int32), max=n3 - 1)
    return (c1 * n2 + c2) * n3 + c3


def bin_molecules(grid: CellGrid, cell_id):
    """Assign slab slots from per-molecule FINE cell ids.

    cell_id: [N, W] int32.  Returns (slot [N, W] int32 slab slot of
    each molecule, max_occ [W] int32 worst-case cell occupancy).  The
    assignment is a per-walker STABLE sort by cell id, so molecules of
    one cell are ranked by molecule index - run only at rebin epochs.
    """
    N, W = cell_id.shape
    sorted_cells, order = torch.sort(cell_id, dim=0, stable=True)
    first = torch.cat([
        torch.ones((1, W), dtype=torch.bool, device=cell_id.device),
        sorted_cells[1:] != sorted_cells[:-1],
    ], dim=0)
    pos = torch.arange(N, dtype=torch.int32,
                       device=cell_id.device)[:, None]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - start                                       # [N,W]
    # clamp on overflow so slots stay in-bounds; the caller MUST check
    # max_occ <= cap (an overflowing walker is corrupt - two molecules
    # share a slot - and the engine surfaces it via occ_overflow)
    slot_sorted = sorted_cells * grid.cap + torch.clamp(
        rank, max=grid.cap - 1)
    # back to molecule order: order[i] is the molecule at sorted place i
    slot = torch.empty_like(slot_sorted)
    slot.scatter_(0, order, slot_sorted)
    max_occ = torch.amax(rank, dim=0) + 1
    return slot.to(torch.int32), max_occ.to(torch.int32)


def scatter_to_slab(values, slot, nslot):
    """values [..., N, W] + slot [N, W] -> slab [..., nslot, W].

    Empty slots are zero.  Used only at rebin epochs."""
    W = slot.shape[-1]
    lead = values.shape[:-2]
    out = torch.zeros(lead + (nslot, W), dtype=values.dtype,
                      device=values.device)
    idx = slot.long().expand(lead + tuple(slot.shape))
    return out.scatter_(-2, idx, values)


def gather_from_slab(slab, slot):
    """slab [..., nslot, W] + slot [N, W] -> [..., N, W]."""
    lead = slab.shape[:-2]
    idx = slot.long().expand(lead + tuple(slot.shape))
    return torch.gather(slab, -2, idx)
