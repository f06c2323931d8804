"""The launch plan of the port's warp-per-walker fused-cycle kernels
(mcmc/fused.launch_plan): walkers per block from one block's shared
memory, the in-place layout where a walker's state does not fit, and an
error where neither fits.  CPU only: the plan is computed in Python."""

import ctypes

import pytest
import torch

from mc_water_ls_mw_tpu_torch import cuda_build
from mc_water_ls_mw_tpu_torch.mcmc import fused
from mc_water_ls_mw_tpu_torch.mcmc.fused import (
    SMEM_BLOCK_MAX,
    WARP_CAP,
    launch_plan,
    smem_bytes,
)

B = 101          # the bins of runs/n216_sample
KERNELS = ("fused_cycle", "fused_cycle_dense")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("N,S", [(216, 1), (48, 3)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_fits_one_block(kernel, N, S, itemsize):
    W = 4096
    plan = launch_plan(kernel, itemsize, N, B, S, W)
    assert plan.state_smem                  # these states fit: staged
    assert 1 <= plan.wpb <= WARP_CAP[itemsize]
    assert plan.smem == smem_bytes(kernel, itemsize, N, B, S, plan.wpb, True)
    assert plan.smem <= SMEM_BLOCK_MAX
    # the most walkers that fit: one more would not (or the cap binds)
    assert (plan.wpb == WARP_CAP[itemsize]
            or smem_bytes(kernel, itemsize, N, B, S, plan.wpb + 1, True)
            > SMEM_BLOCK_MAX)
    assert plan.blocks == -(-W // plan.wpb)


def test_plan_at_the_main_path_shapes():
    """N=216, 101 bins: 8 walkers per block in float32 (the register
    bound; 10 would fit in shared memory), 5 in float64 (shared memory),
    for both kernels (a walker's state is 26*216 values)."""
    for kernel in KERNELS:
        assert launch_plan(kernel, 4, 216, B, 1, 4096).wpb == 8
        assert smem_bytes(kernel, 4, 216, B, 1, 10, True) <= SMEM_BLOCK_MAX
        assert launch_plan(kernel, 8, 216, B, 1, 4096).wpb == 5
        assert smem_bytes(kernel, 8, 216, B, 1, 6, True) > SMEM_BLOCK_MAX
        assert launch_plan(kernel, 4, 216, B, 1, 4096).blocks == 512


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("W,wpb,blocks", [(37, 8, 5), (1, 1, 1),
                                          (8, 8, 1), (9, 8, 2)])
def test_plan_ragged_edge(kernel, W, wpb, blocks):
    plan = launch_plan(kernel, 4, 216, B, 1, W)
    assert (plan.wpb, plan.blocks) == (wpb, blocks)
    assert (plan.blocks - 1) * plan.wpb < W <= plan.blocks * plan.wpb


@pytest.mark.parametrize("kernel", KERNELS)
def test_plan_reads_in_place_where_the_state_does_not_fit(kernel):
    # float64 at N=1200: one walker's state is 8*26*1200 = 249,600 bytes
    N = 1200
    assert smem_bytes(kernel, 8, N, B, 1, 1, True) > SMEM_BLOCK_MAX
    plan = launch_plan(kernel, 8, N, B, 1, 4096)
    assert not plan.state_smem
    assert plan.wpb == WARP_CAP[8]
    assert plan.smem == smem_bytes(kernel, 8, N, B, 1, plan.wpb, False)
    assert plan.smem <= SMEM_BLOCK_MAX


@pytest.mark.parametrize("kernel,N", [("fused_cycle", 40000),
                                      ("fused_cycle_dense", 70000)])
def test_plan_raises_where_nothing_fits(kernel, N):
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(kernel, 4, N, B, 1, 4096)


def test_plan_is_for_the_warp_kernels_only():
    with pytest.raises(ValueError):
        launch_plan("fused_cycle_multi", 4, 216, B, 1, 4096)


def test_fused_args_extends_the_earlier_layout():
    """The launch plan's two ints follow the model constants at the end
    of the structure the kernels read (csrc/fused_cycle.cu FusedArgs)."""
    A = fused.FusedArgs
    assert A.wpb.offset == A.sw.offset + ctypes.sizeof(cuda_build.SWConsts)
    assert A.state_smem.offset == A.wpb.offset + 4
    assert ctypes.sizeof(A) == A.state_smem.offset + 4


def test_wrapper_plans_its_engine():
    """FusedCycle.plan on the N=216 sample-run engine (table mode) and
    on its nbr_table='off' twin (dense mode), on the CPU."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
    from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine
    from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW

    r0, H0 = stacking_switch_pair(3, 3, 6)
    for nbr_table, kernel in (("auto", "fused_cycle"),
                              ("off", "fused_cycle_dense")):
        prm = RunParams(nwater=216, num_lattices=2, temperature=200.0,
                        pressure=1.0 / AUP_TO_ATM,
                        mc_max_trans=1.1 * ANG_TO_BOHR, nbins=B,
                        mu_min=-700.0, mu_max=700.0, n_walkers=2,
                        dtype="float32", nbr_table=nbr_table)
        grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
        _, aux = init_state(prm, MW, r0, H0, grid, device="cpu")
        fc = Engine(prm, MW, grid, aux, device="cpu").fused_cycle
        assert fc.kernel == kernel
        for dtype, wpb in ((torch.float32, 8), (torch.float64, 5)):
            plan = fc.plan(dtype, 37)
            assert plan == launch_plan(kernel, dtype.itemsize, 216, B, 1, 37)
            assert plan.wpb == wpb and plan.state_smem
            args = fc._shape_args(dtype, 37)
            assert (args.wpb, args.state_smem, args.W) == (wpb, 1, 37)
