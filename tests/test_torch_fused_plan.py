"""The launch plan of the port's warp-per-walker fused-cycle kernels
(mcmc/fused.launch_plan): walkers per block from one block's shared
memory, the in-place layout where a walker's state does not fit, and an
error where neither fits.  CPU only: the plan is computed in Python."""

import ctypes

import numpy as np
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


@pytest.mark.parametrize("kernel,itemsize,N,T,wpb,staged", [
    ("fused_cycle_scan", 4, 216, 1, None, None),
    ("fused_cycle_multi", 4, 216, 8, 8, True),
    ("fused_cycle_multi", 8, 216, 8, 5, True),
    ("fused_cycle_multi", 4, 216, 2, 8, True),
    ("fused_cycle_multi", 8, 1200, 8, 5, False),
    ("fused_cycle_multi", 4, 2400, 4, 8, False),
])
def test_plan_is_for_the_warp_kernels_only(kernel, itemsize, N, T, wpb,
                                           staged):
    """The three fused-cycle kernels are warp kernels, the multi-trial
    one too: its walkers per block come from the same shared-memory
    budget (its schedule holds the N codes and N/T movers), at N=216 8
    in float32 and 5 in float64 with the states staged, and the state is
    read in place where one walker's does not fit (N=1200 in float64,
    N=2400 in float32).  Any other kernel has no plan."""
    W = 4096
    if wpb is None:
        with pytest.raises(ValueError):
            launch_plan(kernel, itemsize, N, B, 1, W, T)
        return
    plan = launch_plan(kernel, itemsize, N, B, 1, W, T)
    assert (plan.wpb, plan.state_smem) == (wpb, staged)
    assert plan.smem == smem_bytes(kernel, itemsize, N, B, 1, wpb, staged, T)
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks == -(-W // wpb)
    # the schedule: N codes and N/T movers in place of the table
    # kernel's N codes and N molecules
    assert plan.smem == smem_bytes("fused_cycle", itemsize, N, B, 1, wpb,
                                   staged) - 4 * (N - N // T)
    if staged:
        assert (wpb == WARP_CAP[itemsize]
                or smem_bytes(kernel, itemsize, N, B, 1, wpb + 1, True, T)
                > SMEM_BLOCK_MAX)
    else:
        assert smem_bytes(kernel, itemsize, N, B, 1, 1, True, T) \
            > SMEM_BLOCK_MAX


@pytest.mark.parametrize("kernel,base", [
    ("fused_cycle_1l", "fused_cycle"),
    ("fused_cycle_dense_1l", "fused_cycle_dense"),
    ("fused_cycle_ext", "fused_cycle"),
    ("fused_cycle_dense_ext", "fused_cycle_dense"),
    ("fused_cycle_multi_ext", "fused_cycle_multi"),
])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_variant_plans(kernel, base, itemsize):
    """Kernel 1's other instantiations stage their branch's layout: the
    extended ones exactly their two-lattice branch's bytes, the
    one-lattice ones the state of one lattice (13 N values a walker in
    place of 26 N), which doubles the float64 walkers a block can stage
    at N=216 up to the register bound."""
    N, T, W = 216, 8, 4096
    plan = launch_plan(kernel, itemsize, N, B, 1, W, T)
    ref = launch_plan(base, itemsize, N, B, 1, W, T)
    assert plan.state_smem and plan.smem <= SMEM_BLOCK_MAX
    if kernel.endswith("_ext"):
        assert plan == ref
        return
    half = fused.STATE_ROWS * N * itemsize
    assert plan.smem == smem_bytes(base, itemsize, N, B, 1, plan.wpb, True,
                                   T) - plan.wpb * half
    assert plan.wpb == WARP_CAP[itemsize]


@pytest.mark.parametrize("setting,kernel", [
    (dict(), "fused_cycle"),
    (dict(num_lattices=1), "fused_cycle_1l"),
    (dict(num_lattices=1, nbr_table="off"), "fused_cycle_dense_1l"),
    (dict(minu=True), "fused_cycle_ext"),
    (dict(leshift=True, nbr_table="off"), "fused_cycle_dense_ext"),
    (dict(mc_ensemble="nvt"), "fused_cycle_ext"),
    (dict(wl_swetnam=True), "fused_cycle"),        # a sample run: no f
    (dict(wl_swetnam=True, samplerun=False), "fused_cycle_ext"),
    (dict(wl_useinvt=True, samplerun=False, dense_trials=2),
     "fused_cycle_multi_ext"),
    (dict(dense_trials=8), "fused_cycle_multi"),
])
def test_kernel_name_picks_the_instantiation(setting, kernel):
    """The run's settings pick the kernel: its branch, one lattice, or
    the extended settings (a sample run's f schedule is off)."""
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams

    prm = RunParams(**{"samplerun": True, **setting})
    dense = prm.nbr_table == "off"
    assert fused.kernel_name(prm, dense) == kernel
    assert fused.KERNELS[kernel][1] == prm.num_lattices


def test_fused_args_extends_the_earlier_layout():
    """The launch plan's two ints follow the model constants, and the
    extended kernels' settings follow them at the end of the structure
    the kernels read (csrc/fused_warp.cuh FusedArgs): an earlier
    kernel's structure is a prefix of this one."""
    A = fused.FusedArgs
    assert A.wpb.offset == A.sw.offset + ctypes.sizeof(cuda_build.SWConsts)
    assert A.state_smem.offset == A.wpb.offset + 4
    assert A.minu.offset == A.state_smem.offset + 4
    assert A.f_sched.offset == A.minu.offset + 12
    assert A.rh0.offset == A.f_sched.offset + 4
    assert A.binfrac.offset == A.invt_f.offset + 8
    assert ctypes.sizeof(A) == A.baseh.offset + 8


@pytest.mark.parametrize("kernel", sorted(fused.KERNELS))
def test_kernel_exported_by_name(kernel):
    """Each kernel of KERNELS is one FUSED_ENTRIES line of its library's
    source (the launch and occupancy symbols the wrapper binds by name),
    with the branch and the lattice count that KERNELS gives it."""
    import re

    branch, nl, lib = fused.KERNELS[kernel]
    src = (cuda_build.CSRC / f"{lib}.cu").read_text()
    rows = re.findall(r"^FUSED_ENTRIES\((\w+), (\w+), (\d), (\w+)\)$", src,
                      re.M)
    assert [(b.lower(), int(n)) for k, b, n, _ in rows if k == kernel] \
        == [(branch, nl)]
    assert {k for k, *_ in rows} == {
        k for k, v in fused.KERNELS.items() if v[2] == lib}


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


def _multi_engine(dtype_name, W):
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
    from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine
    from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
    from mc_water_ls_mw_tpu_torch.models.lattices import switch_pair_216
    from mc_water_ls_mw_tpu_torch.models.sw import MW

    prm = RunParams(nwater=216, num_lattices=2, temperature=200.0,
                    pressure=1.0 / AUP_TO_ATM,
                    mc_max_trans=1.1 * ANG_TO_BOHR, nbins=201,
                    mu_min=-1800.0, mu_max=1800.0, n_walkers=W,
                    dtype=dtype_name, dense_trials=8)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    r0, H0 = switch_pair_216()
    _, aux = init_state(prm, MW, r0, H0, grid, device="cpu")
    return Engine(prm, MW, grid, aux, device="cpu")


def test_wrapper_plans_the_multi_trial_engine():
    """FusedCycle.plan on the N=216 engine at dense_trials=8 (the
    multi-trial kernel, path C's run), on the CPU: the plan of its T,
    and an error for a table wider than two slots a lane."""
    eng = _multi_engine("float32", 2)
    fc = eng.fused_cycle
    assert fc.kernel == "fused_cycle_multi" and eng.dT == 8
    for dtype, wpb in ((torch.float32, 8), (torch.float64, 5)):
        plan = fc.plan(dtype, 37)
        assert plan == launch_plan("fused_cycle_multi", dtype.itemsize, 216,
                                   201, 1, 37, 8)
        assert plan.wpb == wpb and plan.state_smem
        args = fc._shape_args(dtype, 37)
        assert (args.wpb, args.state_smem, args.T, args.M) == \
            (wpb, 1, 8, eng.tbl.shape[-1])
    assert eng.tbl.shape[-1] <= fused.MULTI_SLOTS_MAX
    eng.tbl = np.full((2, 216, fused.MULTI_SLOTS_MAX + 8), 216, np.int32)
    with pytest.raises(ValueError, match="table slots"):
        fc.plan(torch.float32, 37)
