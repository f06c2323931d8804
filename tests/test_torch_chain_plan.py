"""The launch geometry of the port's chain + WL kernel and of its
mover-energies kernel, and the synthetic inputs of a chain pass.

* ``mcmc/chain_kernel.chain_plan``: the walkers per block whose WL
  columns and tables fit one block's shared memory, the in-place branch
  where one walker's do not, the ragged edge;
* ``ops/cell_kernels.energies_geometry`` and the loops of
  csrc/cell_movers.cu ``mover_energies_kernel``: every (lattice, mover,
  candidate cell, slot, walker) is taken by exactly one thread.

CPU only: the geometry is computed in Python.  ``chain_inputs`` and
``poison_point`` (numpy only) build the chain passes that
tests/test_torch_cell_kernels.py holds against the JAX kernel and
tests/test_torch_kernels_cuda.py holds the CUDA kernel to on the card.
"""

import numpy as np
import pytest

from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck
from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import (
    CHAIN_WPB,
    CHAIN_WPB_MAX,
    INPLACE_WPB,
    SMEM_BLOCK_MAX,
    chain_plan,
    chain_smem_bytes,
    in_place_plan,
    staged_rows,
)
from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
    ENERGIES_SLOTS_PER_WARP,
    ENERGIES_WARPS_MAX,
    energies_geometry,
)


def chain_inputs(K, T, W, B, seed):
    """Random but plausible inputs of one chain pass (numpy dict)."""
    rng = np.random.default_rng(seed)
    P = T + 1
    beta = 1.0 / (3.1668114e-6 * 200.0)
    cf = np.zeros((ck.CF_ROWS, W))
    cf[ck.CF_MU] = rng.normal(0, 8.0, W)
    cf[ck.CF_E0] = -159.0 + rng.normal(0, 0.01, W)
    cf[ck.CF_E1] = -159.0 + rng.normal(0, 0.01, W)
    cf[ck.CF_E0E] = rng.normal(0, 1e-9, W)
    cf[ck.CF_E1E] = rng.normal(0, 1e-9, W)
    cf[ck.CF_F] = 0.05
    cf[ck.CF_MIN_DMU] = np.inf
    cf[ck.CF_MU_MIN], cf[ck.CF_MU_MAX] = -1200.0, 1200.0
    cf[ck.CF_CMU] = rng.normal(0, 1.0, W)
    cf[ck.CF_SWC] = -cf[ck.CF_CMU]
    ci = np.zeros((ck.CI_ROWS, W), np.int32)
    ci[ck.CI_LS] = rng.integers(0, 2, W)
    ci[ck.CI_END] = B - 1
    ci[ck.CI_INWIN] = 1
    ci[ck.CI_OCCOK] = 1
    ci[ck.CI_OCCOK, -1] = 0           # one walker with an overflowed slab
    ci[ck.CI_SWOK] = 1
    e = -0.05 + rng.normal(0, 1.0 / beta, (2, K, P, W))
    if T == 1:
        # an overlap proposal: never accepted (with more points per mover
        # a non-finite point poisons all of the mover's trials:
        # test_chain_nonfinite_point_matches_pallas)
        e[0, 0, 1, 0] = np.inf
    codes = rng.choice([0, 0, 0, 0, 2, 1, 3], K * T).astype(np.int32)
    codes[:2] = (0, 2)
    return dict(
        codes=codes, cf=cf, ci=ci,
        wgt=rng.uniform(0, 0.3, (B, W)), hist=rng.uniform(0, 5, (B, W)),
        uh=rng.uniform(0, 5, (B, W)),
        basew=np.repeat(2e-4 * (np.arange(B) - B // 2.0)[:, None] ** 2, W, 1),
        baseh=np.zeros((B, W)),
        e=e.reshape(2 * K * P, W),
        inc=(rng.uniform(size=(K * P, W)) < 0.9).astype(float),
        hasm=(rng.uniform(size=(K, W)) < 0.9).astype(float),
        ua=rng.uniform(size=(K * T, W)), uz=rng.uniform(size=(K * T, W)))


def poison_point(x, K, T):
    """Give point 2 of mover 1 of walker 0 an infinite energy in the
    chain inputs ``x`` (T >= 2), with both of that mover's trials
    enabled translations inside the cell and its first accept uniform 0:
    a direct read of the current point's energy would accept that first
    trial, the JAX kernel's one-hot sum over the points poisons it."""
    P = T + 1
    x["e"].reshape(2, K, P, -1)[0, 1, 2, 0] = np.inf
    x["codes"][T:2 * T] = 0                           # mover 1: translations
    x["inc"].reshape(K, P, -1)[1, :, 0] = 1.0
    x["hasm"][1, 0] = 1.0
    x["ua"][1 * T, 0] = 0.0


# ---------------------------------------------------------------------
# the chain's launch plan
# ---------------------------------------------------------------------

# (K, T): the N=8064 main path (8 movers, one trial), the flagship (32
# movers) and the front-end path (8 movers, eight trials)
SHAPES = [(8, 1), (32, 1), (8, 8)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B", [101, 201])
@pytest.mark.parametrize("samplerun", [False, True])
@pytest.mark.parametrize("K,T", SHAPES)
def test_chain_plan_stages_the_columns(itemsize, B, samplerun, K, T):
    """At the bins of runs/n216_sample (101) and of the cell engine's
    runs (201), in float32 and float64, with and without a sample run,
    the walkers' columns fit one block: 4 walkers (one for each of an
    SM's warp schedulers), a warp each, in a third of 227 KB."""
    W = 512
    plan = chain_plan(itemsize, B, K, T, W, samplerun)
    assert plan.staged and plan.threads == 32 * plan.wpb
    assert plan.wpb == CHAIN_WPB == 4 and plan.wpb <= CHAIN_WPB_MAX
    assert plan.smem == chain_smem_bytes(itemsize, B, K, T, samplerun,
                                         plan.wpb, True)
    assert plan.smem <= SMEM_BLOCK_MAX // 3     # three blocks an SM
    assert plan.blocks == W // plan.wpb
    # the layout: the bins' widths and centres, then wpb columns of the
    # slabs (uhist in a sample run) and of every table the chain reads,
    # then the codes
    P = T + 1
    rows = (4 if samplerun else 3) * B + 2 * K * P + K * P + K + 2 * K * T
    assert staged_rows(B, K, T, samplerun) == rows
    assert plan.smem == itemsize * (2 * B + plan.wpb * rows) + 4 * K * T


def test_chain_plan_fewer_walkers_before_in_place():
    """Where wpb columns do not fit, fewer walkers per block do: the
    most that fit."""
    # float64: one walker's columns (~3 or 4 x 8 x B bytes) and the bins
    # fit, two walkers' do not
    for samplerun, B in ((False, 4500), (True, 4000)):
        plan = chain_plan(8, B, 8, 1, 512, samplerun)
        assert plan.staged and plan.wpb == 1
        assert chain_smem_bytes(8, B, 8, 1, samplerun, 2, True) \
            > SMEM_BLOCK_MAX
    plan = chain_plan(4, 3800, 8, 1, 512, True)
    assert plan.staged and plan.wpb == 3
    assert chain_smem_bytes(4, 3800, 8, 1, True, 4, True) > SMEM_BLOCK_MAX


@pytest.mark.parametrize("itemsize,B", [(8, 8001), (4, 16001)])
def test_chain_plan_in_place_at_a_large_B(itemsize, B):
    """Where one walker's columns do not fit, the plan reads them in
    place: a warp per walker, 8 walkers a block, only the bin grid and
    the codes in shared memory; beyond that it raises."""
    plan = chain_plan(itemsize, B, 8, 1, 512, True)
    assert chain_smem_bytes(itemsize, B, 8, 1, True, 1, True) \
        > SMEM_BLOCK_MAX
    assert not plan.staged
    assert plan == in_place_plan(itemsize, B, 8, 1, 512, True)
    assert (plan.wpb, plan.threads, plan.blocks) == (INPLACE_WPB,
                                                     32 * INPLACE_WPB, 64)
    assert plan.smem == itemsize * 2 * B + 4 * 8
    with pytest.raises(ValueError, match="shared memory"):
        chain_plan(itemsize, 20 * B, 8, 1, 512, True)


@pytest.mark.parametrize("W,itemsize,wpb,blocks", [
    (517, 4, 4, 130), (517, 8, 4, 130), (1, 4, 1, 1), (3, 8, 3, 1),
    (9, 4, 4, 3), (128, 4, 4, 32)])
def test_chain_plan_ragged_edge(W, itemsize, wpb, blocks):
    """The last block holds the W mod wpb walkers left (the kernel
    copies and runs only the columns below W); fewer walkers than wpb
    make one block of W."""
    plan = chain_plan(itemsize, 201, 8, 1, W, False)
    assert (plan.wpb, plan.blocks) == (wpb, blocks)
    assert (plan.blocks - 1) * plan.wpb < W <= plan.blocks * plan.wpb
    cols = [min(plan.wpb, W - b * plan.wpb) for b in range(plan.blocks)]
    assert sum(cols) == W and min(cols) >= 1


# ---------------------------------------------------------------------
# the mover-energies kernel's grid
# ---------------------------------------------------------------------

# (K, CF, cap, W): the N=8064 main path (phase 7), a ragged walker
# count, 75-cell stencils, a cap beyond one pass of a block's warps, a
# small cap, the flagship's stencils (K=32, CF=75) and a single slot
GRIDS = [(8, 27, 32, 512), (8, 27, 32, 37), (4, 75, 27, 64),
         (2, 27, 70, 33), (3, 8, 5, 40), (32, 75, 32, 128), (1, 1, 1, 1)]


def _items(CF, cap, nw):
    """(cell, slot) of every item each warp of a block takes, by the
    kernel's loops (cells c in turn, passes p below ceil(cap /
    (nw*SPW)), slots p*nw*SPW + wy + q*nw below cap)."""
    spw = ENERGIES_SLOTS_PER_WARP
    span = nw * spw
    out = []
    for wy in range(nw):
        for c in range(CF):
            for p in range(-(-cap // span)):
                for q in range(spw):
                    j = p * span + wy + q * nw
                    if j < cap:
                        out.append((c, j))
    return out


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("K,CF,cap,W", GRIDS)
def test_energies_grid_covers_every_slot_once(K, CF, cap, W, L):
    (gx, gy, gz), (bx, nw) = energies_geometry(L, K, CF, cap, W)
    assert bx == 32 and 1 <= nw <= ENERGIES_WARPS_MAX
    assert (gy, gz) == (K, L) and gx == -(-W // 32)
    # walkers: lane + 32 x below W, once each
    w = (np.arange(gx)[:, None] * 32 + np.arange(32)[None]).ravel()
    assert np.array_equal(np.bincount(w[w < W], minlength=W), np.ones(W))
    # every (cell, slot) of a block's mover once: the same in every block
    seen = np.zeros((CF, cap), np.int64)
    for c, j in _items(CF, cap, nw):
        seen[c, j] += 1
    assert np.array_equal(seen, np.ones((CF, cap)))


@pytest.mark.parametrize("cap,nw", [(1, 1), (4, 1), (5, 2), (16, 4),
                                    (32, 8), (33, 8), (70, 8)])
def test_energies_warps_from_the_cap(cap, nw):
    """Warps enough for a cell's slots in one pass of ENERGIES_SLOTS_PER_
    WARP slots each, at most ENERGIES_WARPS_MAX (more passes beyond);
    the walkers, movers and lattices do not change them."""
    for L, K, CF, W in ((1, 1, 1, 1), (2, 8, 27, 512), (2, 32, 75, 128)):
        assert energies_geometry(L, K, CF, cap, W)[1] == (32, nw)
    passes = -(-cap // (nw * ENERGIES_SLOTS_PER_WARP))
    assert passes == 1 or nw == ENERGIES_WARPS_MAX


def test_energies_grid_at_the_main_path():
    """At the N=8064 main path's shape a block takes one (tile, mover,
    lattice), 8 warps of 4 slots a cell (one pass a cell): 256 blocks."""
    L, K, CF, cap, W = 2, 8, 27, 32, 512
    (gx, gy, gz), (_, nw) = energies_geometry(L, K, CF, cap, W)
    assert (gx, gy, gz, nw) == (16, 8, 2, 8) and gx * gy * gz == 256
    assert nw * ENERGIES_SLOTS_PER_WARP == cap
