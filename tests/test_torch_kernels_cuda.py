"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card (the checks of chip_smoke.py at a small walker
count that is a multiple of neither 128 nor 32, so the ragged edge is
masked).

These tests need a CUDA device and nvcc and skip without them.  They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda

W = 200


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mc_water_ls_mw_tpu_torch import cuda_build

    cuda_build.build_all()
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_energy_kernel(card, dtype):
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.dense import reduced_shift_set
    from mc_water_ls_mw_tpu_torch.ops.full_energy import FullEnergyKernel

    kern = FullEnergyKernel(
        MW, reduced_shift_set(stacking_switch_pair(3, 3, 6)[1], MW))
    for r3, H in chip_smoke.jittered_cells(W, dtype, seed=3):
        rel, merr, mscale = chip_smoke.full_energy_errors(kern, r3, H)
        if dtype == torch.float64:
            assert rel <= 1e-12 and merr <= 1e-12 * max(1.0, mscale)
        else:
            assert rel <= chip_smoke.F32_E_RTOL
            assert merr <= chip_smoke.F32_MOM_ATOL
    assert kern.launches == 2


@pytest.mark.parametrize("samplerun", [True, False])
def test_fused_cycle_kernel_fp64(card, samplerun):
    from mc_water_ls_mw_tpu_torch.mcmc.engine import PhiloxStream

    prm = chip_smoke.sample_params(
        W, "float64", samplerun=samplerun,
        wl_factor=0.0 if samplerun else 0.005, eq_mc_cycles=0)
    eng, s = chip_smoke.make_engine(prm)
    eng.run_cycles(s, 2)
    draws = PhiloxStream(11, chip_smoke.DEVICE).cycle_draws(
        s.cycle + 1, eng.probs, 216, W, torch.float64)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    assert not differ.any()
    assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
    assert int((sk.acc[0] - s.acc[0]).sum()) > 0
    assert eng.fused_cycle.launches == 3


def test_full_energy_kernel_three_shifts(card):
    """N=48, the (1,2,6) stacking pair: three folded image shifts."""
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.dense import reduced_shift_set
    from mc_water_ls_mw_tpu_torch.ops.full_energy import FullEnergyKernel

    shifts = reduced_shift_set(stacking_switch_pair(1, 2, 6)[1], MW)
    assert len(shifts) == 3
    kern = FullEnergyKernel(MW, shifts)
    for dtype in (torch.float64, torch.float32):
        for r3, H in chip_smoke.jittered_cells(W, dtype, seed=4,
                                               stack=(1, 2, 6)):
            rel, merr, mscale = chip_smoke.full_energy_errors(kern, r3, H)
            if dtype == torch.float64:
                assert rel <= 1e-12 and merr <= 1e-12 * max(1.0, mscale)
            else:
                assert rel <= chip_smoke.F32_E_RTOL
                assert merr <= chip_smoke.F32_MOM_ATOL


@pytest.mark.parametrize("case", list(chip_smoke.DENSE_CASES))
def test_fused_cycle_dense_kernel_fp64(card, case):
    prm = chip_smoke.dense_params(W, "float64", case, samplerun=False,
                                  wl_factor=0.005, eq_mc_cycles=0)
    eng, s = chip_smoke.make_engine(prm)
    assert eng.fused_cycle.kernel == "fused_cycle_dense"
    eng.run_cycles(s, 2)
    draws = chip_smoke.kernel_draws(eng, s, 12)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    assert not differ.any()
    assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
    assert int((sk.acc[0] - s.acc[0]).sum()) > 0
    assert eng.fused_cycle.launches == 3


def test_fused_cycle_multi_kernel_fp64(card):
    prm = chip_smoke.multi_params(W, "float64", 8, eq_mc_cycles=0)
    eng, s = chip_smoke.make_engine(prm, paper_pair=True)
    assert eng.fused_cycle.kernel == "fused_cycle_multi"
    eng.run_cycles(s, 2)
    draws = chip_smoke.kernel_draws(eng, s, 13)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    assert not differ.any()
    assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
    assert int((sk.acc[0] - s.acc[0]).sum()) > 0
    assert int((sk.acc[2] - s.acc[2]).sum()) > 0
    assert eng.fused_cycle.launches == 3


def test_engine_on_card_runs_both_kernels(card):
    prm = chip_smoke.sample_params(W, "float32", mpi_sync_int=2,
                                   latt_sync_int=3, eq_mc_cycles=1)
    eng, s = chip_smoke.make_engine(prm)
    s, samples = eng.run_cycles(s, 3)
    assert eng.fused_cycle.launches == 3
    assert eng.full_energy.launches >= 2          # the resync at cycle 3
    assert torch.isfinite(samples["E_ls"]).all()
    s, drift = eng.audit_energy(s, n_walkers=8)
    assert float(drift.abs().max()) < chip_smoke.AUDIT_MAX_DRIFT


@pytest.fixture(scope="module")
def cell_engine(card):
    """The N=8064 cell engine at W walkers in float64 after one cycle of
    sampling (a rebin at a random origin, WL slabs filled)."""
    prm = chip_smoke.cell_params(W, "float64", list_update_int=1,
                                 mpi_sync_int=1)
    eng, s = chip_smoke.make_cell_engine(prm)
    eng.run_cycles(s, 1)
    return eng, s


@pytest.mark.parametrize("tbl", [0, 37])
def test_mover_energies_kernel_fp64(cell_engine, tbl):
    eng, s = cell_engine
    me = chip_smoke.cell_substep_compare(eng, s, tbl, seed=tbl)[
        "mover_energies"]
    assert me["e_err"] <= 1e-10 and me["own_err"] <= 1e-10
    assert me["dE_max"] > 0 and me["n_in"] > 0


@pytest.mark.parametrize("tbl", [0, 37])
def test_chain_wl_kernel_fp64(cell_engine, tbl):
    eng, s = cell_engine
    ch = chip_smoke.cell_substep_compare(eng, s, tbl, seed=tbl)["chain_wl"]
    assert not ch["differ"].any()
    assert ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
    assert 0 < ch["n_acc"] < ch["n_enabled"] and ch["hist_grew"] > 0


@pytest.mark.parametrize("tbl", [0, 37])
def test_mover_apply_kernel_fp64(cell_engine, tbl):
    eng, s = cell_engine
    ma = chip_smoke.cell_substep_compare(eng, s, tbl, seed=tbl)[
        "mover_apply"]
    assert ma["mom_err"] <= 1e-10 and ma["rest_equal"]
    assert ma["changed"] > 0 and ma["n_acc"] > 0


def test_cell_engine_on_card_runs_its_kernels(card):
    prm = chip_smoke.cell_params(W, "float32", list_update_int=2,
                                 mpi_sync_int=1, latt_sync_int=2)
    eng, s = chip_smoke.make_cell_engine(prm)
    s, samples = eng.run_cycles(s, 3)
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    for kern in (eng.mover_kernel, eng.chain_kernel, eng.apply_kernel):
        assert kern.launches == 3 * n_sub
    assert torch.isfinite(samples["E_ls"]).all()
    assert int(s.occ_overflow.max()) == 0
    assert int(s.att[0].min()) > 0 and int(s.acc[0].min()) > 0
    s, drift = eng.audit_energy(s, n_walkers=8)
    assert float(drift.abs().max()) < chip_smoke.AUDIT_CELL_MAX_DRIFT


@pytest.fixture(scope="module")
def multitrial_engine(card):
    """The N=8064 cell engine at eight trials per mover, W walkers,
    float64, after one cycle of sampling."""
    prm = chip_smoke.cell_params(W, "float64",
                                 cell_trials=chip_smoke.MT_TRIALS,
                                 list_update_int=1, mpi_sync_int=1)
    eng, s = chip_smoke.make_cell_engine(prm)
    eng.run_cycles(s, 1)
    counts = [k.launches for k in (eng.points_kernel, eng.chain_kernel,
                                   eng.apply_kernel)]
    return eng, s, counts


@pytest.mark.parametrize("tbl", [0, 37])
def test_mover_points_and_chain_kernels_fp64(multitrial_engine, tbl):
    eng, s, _ = multitrial_engine
    cmp = chip_smoke.multitrial_compare(eng, s, tbl, seed=tbl)
    mp, ch = cmp["mover_points"], cmp["chain_wl"]
    assert mp["e_err"] <= 1e-10 and mp["own_err"] <= 1e-10
    assert mp["dE_max"] > 0 and mp["n_legs"] > 0
    assert not ch["differ"].any()
    assert ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
    assert 0 < ch["n_acc"] < ch["n_enabled"] and ch["hist_grew"] > 0


def test_multitrial_engine_on_card_runs_its_kernels(multitrial_engine):
    eng, s, counts = multitrial_engine
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    assert n_sub == 128 and counts == [n_sub] * 3
    assert int(s.occ_overflow.max()) == 0 and int(s.acc[0].min()) > 0
    s2, drift = eng.audit_energy(s.clone(), n_walkers=8)
    assert float(drift.abs().max()) < 1e-9
