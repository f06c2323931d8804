"""The cell engine's whole-cell energy kernel (ops/slab_energy.py,
csrc/slab_energy.cu) on the CPU: its launch plan from the Python mirror,
and the wrapper and ``CellEngine._full_both`` on CPU tensors, where they
run the plain version (ops/cell_energy.slab_full_energy) as before.

* slab_energy_plan and the kernel's loops: every (lattice, cell, slot,
  walker) gets its moments from exactly one thread (a listed centre of
  one warp, or the zero fill of a slot no walker of the tile occupies),
  and every occupied (coverage cell, slot, walker) is staged once;
* the wrapper on CPU tensors equals slab_full_energy lattice by lattice,
  with slots emptied for some walkers only, and refuses inputs the
  kernel does not take;
* _full_both on the CPU gives what the per-lattice plain calls gave,
  for all walkers and for the first n.

The card's checks are in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.models.stacking import (
    correspondence_mismatch,
    stacking_switch_pair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.ops.cell_energy import slab_full_energy
from mc_water_ls_mw_tpu_torch.ops.cells import (
    build_grid,
    cap_for_positions,
    choose_grid_shape,
)
from mc_water_ls_mw_tpu_torch.ops.slab_energy import (
    SMEM_BLOCK_MAX,
    SlabEnergyKernel,
    SlabEnergyPlan,
    slab_energy_plan,
    slab_energy_smem,
)

# (nfine, CF, cap, W, itemsize): the N=8064 grid at the benchmark's and
# the front end's widths, a ragged tile, one walker (init_cell_state),
# the 75-cell stencils of the (12,7,18) grid (cap 28) and the flagship's
# (cap 32), float64, and a cap beyond one pass of the block's warps
PLANS = [(6, 27, 32, 32, 4), (6, 27, 32, 128, 4), (6, 27, 32, 33, 4),
         (6, 27, 32, 1, 4), (5, 75, 28, 32, 4), (5, 75, 32, 128, 8),
         (6, 27, 32, 33, 8), (4, 8, 70, 37, 4)]


def block_centres(plan: SlabEnergyPlan, nocc: int):
    """(pass, warp, s, i) for each of a block's ``nocc`` listed centre
    slots: list entry i is held by warp ``warp`` in its register slot s
    in pass ``pass`` (the kernel's deal, csrc/slab_energy.cu)."""
    per = plan.warps * plan.spw
    return [(i // per, (i % per) // plan.spw, i % plan.spw, i)
            for i in range(nocc)]


@pytest.mark.parametrize("itemsize,warps,spw,depth", [(4, 8, 4, 4),
                                                      (8, 16, 2, 2)])
def test_slab_energy_plan_at_n8064(itemsize, warps, spw, depth):
    """The N=8064 grid (512 fine cells of 32 slots, CF=27) at W=32."""
    plan = slab_energy_plan(2, 512, 27, 32, 32, itemsize)
    assert plan.grid == (1, 512, 2)
    assert (plan.warps, plan.spw, plan.depth) == (warps, spw, depth)
    assert plan.smem == slab_energy_smem(27, 32, warps, depth, itemsize)
    assert slab_energy_plan(2, 2048, 75, 32, 128, itemsize).grid == \
        (4, 2048, 2)


@pytest.mark.parametrize("nfine,CF,cap,W,itemsize", PLANS)
def test_slab_energy_plan_covers_each_slot_once(nfine, CF, cap, W,
                                                itemsize):
    L = 2
    plan = slab_energy_plan(L, nfine, CF, cap, W, itemsize)
    tiles = plan.grid[0]
    assert plan.grid == (-(-W // 32), nfine, L)
    assert 32 * plan.warps <= 512 and 2 <= plan.depth <= 4
    assert plan.smem <= SMEM_BLOCK_MAX
    rng = np.random.default_rng(nfine * cap + W)
    # about half the slots occupied, some by no walker of a tile
    valid = rng.random((nfine * cap, W)) < 0.5
    valid[rng.random(nfine * cap) < 0.2] = False
    cells = rng.integers(0, nfine, (nfine, CF))
    written = np.zeros((L, nfine, cap, W), np.int64)
    staged = np.zeros((L, nfine, CF, cap, W), np.int64)
    for l in range(L):
        for c in range(nfine):
            for tile in range(tiles):
                w = np.arange(tile * 32, min(W, tile * 32 + 32))
                occ = [b for b in range(cap) if valid[c * cap + b, w].any()]
                deal = block_centres(plan, len(occ))
                assert all(q < plan.warps and s < plan.spw
                           for _, q, s, _ in deal)
                assert len({(p, q, s) for p, q, s, _ in deal}) == len(occ)
                for _, _, _, i in deal:
                    written[l, c, occ[i], w] += 1
                # the zero fill: warp q takes the slots q, q + warps, ...
                for q in range(plan.warps):
                    for b in range(q, cap, plan.warps):
                        if b not in occ:
                            written[l, c, b, w] += 1
                # the staging: thread (warp q, lane) copies the slots q,
                # q + warps, ... of each coverage cell its walker holds
                for k in range(CF):
                    rows = cells[c, k] * cap
                    for q in range(plan.warps):
                        for b in range(q, cap, plan.warps):
                            staged[l, c, k, b, w] += valid[rows + b, w]
    assert (written == 1).all()
    held = valid.reshape(nfine, cap, W)[cells]            # [nfine,CF,cap,W]
    assert np.array_equal(staged, np.broadcast_to(held, staged.shape))


def test_slab_energy_plan_refuses_a_block_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        slab_energy_plan(2, 8, 2000, 64, 32, 8)


@pytest.fixture(scope="module")
def cell_system():
    """The N=8064 stacking pair on its (4,4,4) x 2^3 grid (CF=27), float64,
    three walkers whose occupied slots are jittered and some of which are
    emptied for one walker only."""
    r0, H0 = stacking_switch_pair(14, 8, 18)
    mx, _ = correspondence_mismatch(r0, H0)
    shape = choose_grid_shape(H0, MW, mx)
    cg = build_grid(shape, cap_for_positions(r0, H0, shape), H0, MW, mx)
    prm = RunParams(nwater=8064, num_lattices=2, temperature=200.0,
                    pressure=1.0 / AUP_TO_ATM,
                    mc_max_trans=0.25 * ANG_TO_BOHR,
                    mc_dv_max=0.2 * ANG_TO_BOHR, nbins=201, mu_min=-1200.0,
                    mu_max=1200.0, mc_vol_prob=1.0 / 8064, eq_mc_cycles=0,
                    n_walkers=3, dtype="float64")
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg, device="cpu")
    eng = CellEngine(prm, MW, grid, aux, cg, caux, device="cpu")
    gen = torch.Generator().manual_seed(5)
    valid = s.slot2mol >= 0
    s.r = s.r + torch.where(
        valid, 0.05 * torch.randn(s.r.shape, generator=gen,
                                  dtype=s.r.dtype), 0.0)
    s.h = s.h * (1.0 + 0.01 * torch.rand((1, 1, 1, 3), generator=gen,
                                         dtype=s.h.dtype))
    occupied = torch.nonzero(valid[:, 1]).reshape(-1)
    drop = occupied[torch.randperm(len(occupied), generator=gen)[:300]]
    s.slot2mol[drop, 1] = -1
    return eng, s


def test_slab_energy_wrapper_on_cpu_is_the_plain_version(cell_system):
    eng, s = cell_system
    kern = SlabEnergyKernel(eng.model, eng.cellgrid)
    valid = s.slot2mol >= 0
    assert bool((~valid[:, 1] & valid[:, 0]).any())
    E, mom = kern(s.r, valid, s.h)
    assert E.shape == (2, 3) and mom.shape == (10, 2, s.r.shape[2], 3)
    for l in range(2):
        e_l, m_l = slab_full_energy(s.r[l], valid, s.h[l], eng.cellgrid,
                                    eng.model)
        assert torch.equal(E[l], e_l) and torch.equal(mom[:, l], m_l)
    # an emptied slot has zero moments; its walker's energy changed
    assert float(mom[:, :, ~valid[:, 1], 1].abs().max()) == 0.0
    assert kern.launches == 0


def test_full_both_on_cpu_is_unchanged(cell_system):
    eng, s = cell_system
    valid = s.slot2mol >= 0
    E, mom = eng._full_both(s, s.r, s.h)
    # what _full_both computed before the kernel: slab_full_energy of
    # each lattice, stacked
    plain = eng.slab_energy.plain
    pe, pmom = plain(s.r, valid, s.h)
    assert torch.equal(E, pe) and torch.equal(mom, pmom)
    E2, mom2 = eng._full_both(s, s.r, s.h, 2)
    pe2, pmom2 = plain(s.r[..., :2], valid[:, :2], s.h[..., :2])
    assert torch.equal(E2, pe2) and torch.equal(mom2, pmom2)
    assert torch.equal(E2, E[:, :2])
    assert eng.slab_energy.launches == 0


@pytest.mark.parametrize("case", ["dtype", "valid_dtype", "shape", "lattices",
                                  "h_dtype"])
def test_slab_energy_wrapper_refuses(cell_system, case):
    eng, s = cell_system
    kern = SlabEnergyKernel(eng.model, eng.cellgrid)
    r, valid, h = s.r, s.slot2mol >= 0, s.h
    if case == "dtype":
        r = r.to(torch.float16)
    elif case == "valid_dtype":
        valid = valid.to(torch.int32)
    elif case == "shape":
        r = r[:, :, :-1]
    elif case == "lattices":
        r, h = torch.cat([r, r[:1]]), torch.cat([h, h[:1]])
    else:
        h = h.to(torch.float32)
    with pytest.raises(ValueError, match="slab_energy"):
        kern.launch_args(r, valid, h)
