"""The grids of the port's mover-apply, mover-points and whole-cell
energy kernels, from their Python mirrors:

* ops/cell_kernels apply_geometry and the slot split of
  csrc/cell_movers.cu mover_apply_kernel: every (lattice, mover,
  candidate cell, slot, walker) is taken by exactly one thread, so the
  kernel needs no atomics;
* ops/cell_kernels points_geometry and mover_points_kernel's loops:
  every (lattice, mover, candidate cell, slot, walker) is staged once
  and every point owned by one warp, the groups added in index order;
* ops/full_energy full_energy_plan and full_energy_kernel's loops:
  every (centre, walker) is taken by exactly one thread, every staged
  row copied once.

Each plan fits one block's shared memory.  CPU only: the geometry is
computed in Python."""

import numpy as np
import pytest

from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
    APPLY_SLOTS_PER_WARP,
    APPLY_WARPS_MAX,
    POINTS_WARPS_MAX,
    POINTS_SMEM_TARGET,
    POINTS_WARPS_MIN,
    SMEM_BLOCK_MAX,
    apply_geometry,
    points_geometry,
    points_smem_bytes,
)
from mc_water_ls_mw_tpu_torch.ops.full_energy import full_energy_plan

# (K, CF, cap, W): the N=8064 main path (phase 7: 512 walkers) and the
# front-end path (phase 9: 128 walkers) of chip_smoke.py, then a ragged
# walker count, a cap that is not a multiple of the slots a warp takes,
# and a cap beyond one pass of the block's warps
SHAPES = [(8, 27, 32, 512), (8, 27, 32, 128), (8, 27, 32, 37),
          (4, 75, 27, 64), (2, 27, 70, 33)]


def _slot_counts(cap, nw):
    """How often the warps of one block take each slot of a cell, by the
    kernel's loops (j0 = wy, wy + nw*SPW, ...; j = j0 + q*nw), and how
    often each slot passes the kernel's own-slot test."""
    spw = APPLY_SLOTS_PER_WARP
    taken = np.zeros(cap, np.int64)
    own = np.zeros(cap, np.int64)
    for wy in range(nw):
        for j0 in range(wy, cap, nw * spw):
            for q in range(spw):
                if j0 + q * nw < cap:
                    taken[j0 + q * nw] += 1
            for rank in range(cap):
                own[rank] += ((rank - j0) % nw == 0 and j0 <= rank
                              < j0 + nw * spw)
    return taken, own


@pytest.mark.parametrize("K,CF,cap,W", SHAPES)
def test_apply_grid_covers_every_slot_once(K, CF, cap, W):
    L = 2
    (gx, gy, gz), (bx, nw) = apply_geometry(L, K, CF, cap, W)
    assert bx == 32 and 1 <= nw <= APPLY_WARPS_MAX and (gy, gz) == (K * CF, L)
    # walkers: lane + 32 x below W, once each
    w = (np.arange(gx)[:, None] * 32 + np.arange(32)[None]).ravel()
    assert np.array_equal(np.bincount(w[w < W], minlength=W), np.ones(W))
    # (mover, candidate cell) of block row y: (y // CF, y % CF), once each
    kc = np.array([divmod(y, CF) for y in range(gy)])
    assert np.array_equal(np.bincount(kc[:, 0] * CF + kc[:, 1]),
                          np.ones(K * CF))
    # slots of a cell over the block's warps; the own slot is written by
    # exactly one of them
    taken, own = _slot_counts(cap, nw)
    assert np.array_equal(taken, np.ones(cap))
    assert np.array_equal(own, np.ones(cap))


@pytest.mark.parametrize("K,CF,cap,W", SHAPES[:2])
def test_apply_grid_fills_the_card(K, CF, cap, W):
    """At the main paths' shapes the grid holds several blocks for each
    of the H100's 132 SMs (the first design had K*L*W/32: 256 and 64),
    and each warp takes APPLY_SLOTS_PER_WARP slots in one pass."""
    (gx, gy, gz), (_, nw) = apply_geometry(2, K, CF, cap, W)
    assert gx * gy * gz >= 10 * 132
    assert nw * APPLY_SLOTS_PER_WARP == cap


# ---- mover_points: (K, CF, cap, W) of the front-end path (phase 9: 128
# walkers), a ragged walker count, 75-cell stencils, a cap that keeps
# fewer cells a group, a last group of fewer cells, a stencil of fewer
# cells than a group and a single slot
POINT_SHAPES = [(8, 27, 32, 128), (8, 27, 32, 37), (4, 75, 27, 64),
                (2, 27, 70, 33), (3, 8, 5, 40), (3, 2, 5, 40), (1, 1, 1, 1)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [2, 3, 5, 9])
@pytest.mark.parametrize("K,CF,cap,W", POINT_SHAPES)
def test_points_grid_covers_every_slot_once(K, CF, cap, W, P, itemsize):
    L = 2
    plan = points_geometry(L, K, CF, cap, W, P, itemsize)
    (gx, gy, gz), nw, cpg, ng = plan.grid, plan.nw, plan.cpg, plan.ng
    assert (gx, gy, gz) == (-(-W // 32), K * ng, L)
    assert 1 <= nw <= POINTS_WARPS_MAX and cpg * ng >= CF > cpg * (ng - 1)
    # walkers: lane + 32 x below W, once each
    w = (np.arange(gx)[:, None] * 32 + np.arange(32)[None]).ravel()
    assert np.array_equal(np.bincount(w[w < W], minlength=W), np.ones(W))
    # (mover, group) of block row y: (y // ng, y % ng), once each
    kg = np.array([divmod(y, ng) for y in range(gy)])
    assert np.array_equal(np.bincount(kg[:, 0] * ng + kg[:, 1]),
                          np.ones(K * ng))
    # a mover's (cell, slot): staged by exactly one thread of one group,
    # whose list of near slots has room for all it stages; a point's
    # warp walks the lists of every thread of its lane once
    staged = np.zeros((CF, cap), np.int64)
    qmax = -(-cpg * cap // nw)
    for g in range(ng):
        c0, nc = g * cpg, min(cpg, CF - g * cpg)
        walked = []
        for wy in range(nw):
            mine = list(range(wy, nc * cap, nw))
            assert len(mine) <= qmax
            for s in mine:
                staged[c0 + s // cap, s % cap] += 1
            walked += mine
        assert sorted(walked) == list(range(nc * cap))
    assert np.array_equal(staged, np.ones((CF, cap)))
    # every point owned by one warp (t = wy + nw q), the warps sharing
    # them evenly; at least POINTS_WARPS_MIN warps stage the slots
    owner = np.concatenate([np.arange(wy, P, nw) for wy in range(nw)])
    assert np.array_equal(np.sort(owner), np.arange(P))
    per = [len(range(wy, P, nw)) for wy in range(min(nw, P))]
    assert max(per) - min(per) <= 1 and min(per) >= 1
    assert nw == max(POINTS_WARPS_MIN, P) or nw == POINTS_WARPS_MAX > P


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [2, 3, 5, 9])
@pytest.mark.parametrize("cap", [27, 32, 70])
def test_points_plan_fits_shared_memory(cap, P, itemsize):
    """The staged slots (flag and three coordinates of 32 walkers) of a
    group and the threads' lists of near slots fit one block; groups of
    three cells where two blocks still share an SM."""
    plan = points_geometry(2, 8, 27, cap, 128, P, itemsize)
    assert plan.smem == points_smem_bytes(plan.cpg, cap, plan.nw, itemsize)
    assert plan.smem <= SMEM_BLOCK_MAX
    assert (plan.cpg == 3 or points_smem_bytes(plan.cpg + 1, cap, plan.nw,
                                               itemsize)
                                > POINTS_SMEM_TARGET)


def test_points_grid_at_the_front_end_path():
    """Phase 9's shape (K=8, CF=27, cap=32, T=8, W=128, f32): groups of 3
    cells, 576 blocks of 9 warps (the first design: 64 blocks of 7)."""
    plan = points_geometry(2, 8, 27, 32, 128, 9, 4)
    assert (plan.grid, plan.nw, plan.cpg, plan.ng) == ((4, 72, 2), 9, 3, 9)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == 576
    assert plan.smem == points_smem_bytes(3, 32, 9, 4) == 58944


# ---- full_energy: (N, W)


def _fe_counts(plan, N, W):
    """How often the kernel's threads take each (centre, walker), and how
    often each block's threads copy each staged (row, column)."""
    tiles, groups = plan.grid
    tid = np.arange(32 * plan.warps)
    wl, slot = tid % plan.tw, tid // plan.tw
    taken = np.zeros((N, W), np.int64)
    for x in range(tiles):
        w = x * plan.tw + wl
        for y in range(groups):
            i1 = min(N, (y + 1) * plan.cpg)
            for q in range(-(-plan.cpg // plan.slots)):
                i = y * plan.cpg + slot + plan.slots * q
                keep = (i < i1) & (w < W)
                np.add.at(taken, (i[keep], w[keep]), 1)
    staged = np.zeros((3 * N, plan.tw), np.int64)
    for q in range(-(-3 * N // plan.slots)):
        e = slot + plan.slots * q
        keep = e < 3 * N
        np.add.at(staged, (e[keep], wl[keep]), 1)
    return taken, staged


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N,S,W", [(216, 1, 4096), (216, 1, 200),
                                   (48, 3, 4096), (48, 3, 37), (48, 3, 1),
                                   (7, 1, 33), (1000, 1, 70)])
def test_full_energy_plan_covers_every_centre_once(N, S, W, itemsize):
    plan = full_energy_plan(itemsize, N, W, S)
    assert plan.grid == (-(-W // plan.tw), plan.groups)
    assert plan.slots * plan.tw == 32 * plan.warps
    assert plan.cpg % plan.slots == 0
    assert plan.groups * plan.cpg >= N > (plan.groups - 1) * plan.cpg
    taken, staged = _fe_counts(plan, N, W)
    assert np.array_equal(taken, np.ones((N, W)))
    assert np.array_equal(staged, np.ones((3 * N, plan.tw)))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N,S", [(48, 3), (216, 1), (1000, 1)])
def test_full_energy_plan_fits_shared_memory(N, S, itemsize):
    """A tile is one 128-byte line of a row (32 walkers in f32, 16 in
    f64) while its 3 (N + S) rows (coordinates and image vectors) let
    two blocks share an SM, fewer walkers beyond; they fit one block."""
    plan = full_energy_plan(itemsize, N, 4096, S)
    assert plan.smem == 3 * (N + S) * plan.tw * itemsize <= SMEM_BLOCK_MAX
    if N <= 216:
        assert plan.tw * itemsize == 128 and 2 * plan.smem <= SMEM_BLOCK_MAX


def test_full_energy_plan_at_the_main_path():
    """N=216, S=1, W=4096, f32: 128 tiles of 32 walkers x 5 groups of 48
    centres (16 slots of 3 centres; 640 blocks, two an SM), 83 KB
    staged; N=48, S=3: 3 groups of 16 centres."""
    plan = full_energy_plan(4, 216, 4096)
    assert (plan.tw, plan.warps, plan.slots) == (32, 16, 16)
    assert (plan.cpg, plan.groups, plan.grid) == (48, 5, (128, 5))
    assert plan.smem == 3 * 217 * 32 * 4 == 83328
    plan = full_energy_plan(4, 48, 4096, 3)
    assert (plan.cpg, plan.groups, plan.grid) == (16, 3, (128, 3))
