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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stack", [(3, 3, 6), (1, 2, 6)])
@pytest.mark.parametrize("Wr", [1, 37, 4100])
def test_full_energy_kernel_ragged(card, Wr, stack, dtype):
    """W below one tile (1), not a multiple of the tile (37; 32 walkers
    a tile in f32, 16 in f64) and a ragged main-path width (4100), at one
    folded shift (N=216) and three (N=48): the gates of chip_smoke.py,
    and a second launch on the same scratch and tickets bitwise equal
    (the centres' terms are summed in a fixed order)."""
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.dense import reduced_shift_set
    from mc_water_ls_mw_tpu_torch.ops.full_energy import FullEnergyKernel

    kern = FullEnergyKernel(
        MW, reduced_shift_set(stacking_switch_pair(*stack)[1], MW))
    r3, H = chip_smoke.jittered_cells(Wr, dtype, seed=5, stack=stack)[0]
    plan = kern.plan(dtype, r3.shape[1], Wr)
    assert Wr % plan.tw != 0
    rel, merr, mscale = chip_smoke.full_energy_errors(kern, r3, H)
    if dtype == torch.float64:
        assert rel <= 1e-12 and merr <= 1e-12 * max(1.0, mscale)
    else:
        assert rel <= chip_smoke.F32_E_RTOL
        assert merr <= chip_smoke.F32_MOM_ATOL
    e1, m1 = kern(r3, H)
    e2, m2 = kern(r3, H)
    torch.cuda.synchronize()
    assert torch.equal(e1, e2)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert kern.launches == 3


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


@pytest.mark.parametrize("Wr", [37, 1])
@pytest.mark.parametrize("branch", ["table-sample", "table-wl", "dense-n48",
                                    "dense-n216", "multi-t8"])
def test_fused_cycle_warp_kernels_ragged_fp64(card, branch, Wr):
    """The warp-per-walker kernels (table, dense and multi-trial) at a
    walker count that is not a multiple of the walkers per block (37)
    and below one block (1): the last block's missing walkers are
    masked."""
    kind, case = branch.split("-")
    over = dict(samplerun=case == "sample",
                wl_factor=0.0 if case == "sample" else 0.005,
                eq_mc_cycles=0)
    if kind == "table":
        prm = chip_smoke.sample_params(Wr, "float64", **over)
    elif kind == "multi":
        prm = chip_smoke.multi_params(Wr, "float64", 8, eq_mc_cycles=0)
    else:
        prm = chip_smoke.dense_params(Wr, "float64", case, **over)
    eng, s = chip_smoke.make_engine(prm, paper_pair=kind == "multi")
    kernel = {"table": "fused_cycle", "dense": "fused_cycle_dense",
              "multi": "fused_cycle_multi"}[kind]
    assert eng.fused_cycle.kernel == kernel
    plan = eng.fused_cycle.plan(torch.float64, Wr)
    assert plan.state_smem and (Wr == 1) == (plan.blocks * plan.wpb == Wr)
    eng.run_cycles(s, 2)
    draws = chip_smoke.kernel_draws(eng, s, 14)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    assert not differ.any()
    assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
    assert int((sk.acc[0] - s.acc[0]).sum()) > 0
    assert eng.fused_cycle.launches == 3


@pytest.mark.parametrize("dtype,T", [("float64", 8), ("float64", 2),
                                     ("float32", 8)])
def test_fused_cycle_multi_kernel_fp64(card, dtype, T):
    """The multi-trial kernel against its plain version over one cycle:
    float64, identical integer outcomes and state within 1e-10; float32,
    at most F32_MAX_DIFF_FRAC of walkers with a differing integer
    outcome."""
    prm = chip_smoke.multi_params(W, dtype, T, eq_mc_cycles=0)
    eng, s = chip_smoke.make_engine(prm, paper_pair=True)
    assert eng.fused_cycle.kernel == "fused_cycle_multi"
    eng.run_cycles(s, 2)
    draws = chip_smoke.kernel_draws(eng, s, 13)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    if dtype == "float64":
        assert not differ.any()
        assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
    else:
        assert float(differ.float().mean()) <= chip_smoke.F32_MAX_DIFF_FRAC
    assert int((sk.acc[0] - s.acc[0]).sum()) > 0
    assert int((sk.acc[2] - s.acc[2]).sum()) > 0
    assert eng.fused_cycle.launches == 3


@pytest.mark.parametrize("Wr", [W, 37])
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.variant_cases()])
def test_fused_cycle_variant_kernels_fp64(card, case, Wr):
    """Kernel 1's instantiations beyond the two-lattice plain settings
    (one lattice, MINU, leshift, NVT, the Swetnam and 1/t schedules;
    chip_smoke.py phase 4e) against their plain versions over one cycle
    in float64, also at a ragged walker count: identical integer
    outcomes, state (f and sumhist among it) within 1e-10."""
    tag, kernel, params, prepare, weights, paper = next(
        c for c in chip_smoke.variant_cases() if c[0] == case)
    eng, s = chip_smoke.make_engine(params(Wr, "float64"),
                                    paper_pair=paper, weights=weights)
    assert eng.fused_cycle.kernel == kernel
    if prepare is not None:
        prepare(s)
    eng.run_cycles(s, 2)
    draws = chip_smoke.kernel_draws(eng, s, 15)
    sk, sp, differ = chip_smoke.fused_compare(eng, s, draws)
    assert not differ.any()
    assert chip_smoke.fused_max_err(sk, sp, ~differ) <= 1e-10
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


def test_cell_kernels_one_lattice_fp64(card):
    """The energies and apply kernels at one lattice (grid z = 1; the
    N=8064 single box of chip_smoke.py phase 7d) against their plain
    versions on one sub-step after a cycle of sampling, in float64."""
    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    prm = chip_smoke.cell_params(W, "float64", cell_chain="auto",
                                 **chip_smoke.SINGLE_BOX)
    eng, s = chip_smoke.make_cell_engine(prm)
    assert s.r.shape[0] == 1 and not eng.use_chain_kernel
    eng.run_cycles(s, 1)
    K = eng.K
    gen = torch.Generator(device=chip_smoke.DEVICE)
    gen.manual_seed(21)
    u = torch.rand((7, K, W), generator=gen, dtype=s.r.dtype,
                   device=chip_smoke.DEVICE)
    codes = torch.zeros((K,), dtype=torch.int32)
    codes[K // 2] = SWITCH
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    fc, cand, off = eng._tables(37)
    trial = eng._propose_t1(s, pks, 37, u, rows)
    pe, pown = eng.mover_kernel.plain(pks, s.h, cand, off, fc, trial.rank,
                                      trial.p_old, trial.p_new)
    assert chip_smoke._max_abs(trial.e, pe) <= 1e-10
    assert chip_smoke._max_abs(trial.own_new, pown) <= 1e-10
    accf, _ = eng._chain_t1(s.clone(), rows, trial, codes, u[5], u[6])
    n_occ, n_in = chip_smoke._occupancy_counts(eng, s, pks, trial, cand,
                                               off, fc)
    ma = chip_smoke.apply_compare(
        eng, pks, (s.h, cand, off, fc, trial.rank, accf, trial.p_old,
                   trial.p_new, trial.own_new), n_occ, n_in)
    assert ma["mom_err"] <= 1e-10 and ma["rest_equal"] and ma["changed"] > 0


@pytest.fixture(scope="module")
def multitrial_engine_w128(card):
    """The N=8064 cell engine at the front-end path's shape (128
    walkers, eight trials per mover), float64, after one cycle."""
    prm = chip_smoke.cell_params(chip_smoke.W_MT, "float64",
                                 cell_trials=chip_smoke.MT_TRIALS,
                                 list_update_int=1, mpi_sync_int=1)
    eng, s = chip_smoke.make_cell_engine(prm)
    eng.run_cycles(s, 1)
    return eng, s


@pytest.mark.parametrize("mode", ["chain", "all", "none"])
def test_mover_apply_kernel_multitrial_fp64(multitrial_engine_w128, mode):
    """The apply kernel at the T=8, W=128 shape with the chain's accepts,
    every mover accepted, and every mover rejected (the slab is left
    bitwise as it was)."""
    eng, s = multitrial_engine_w128
    ma = chip_smoke.multitrial_apply_compare(eng, s, 11, seed=5, mode=mode)
    assert ma["mom_err"] <= 1e-10 and ma["rest_equal"]
    if mode == "none":
        assert ma["changed"] == 0 and ma["n_acc"] == 0
    else:
        assert ma["changed"] > 0 and ma["n_acc"] > 0


def test_cell_engine_on_card_runs_its_kernels(card):
    prm = chip_smoke.cell_params(W, "float32", list_update_int=2,
                                 mpi_sync_int=1, latt_sync_int=2)
    eng, s = chip_smoke.make_cell_engine(prm)
    s, samples = eng.run_cycles(s, 3)
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    for kern in (eng.mover_kernel, eng.chain_kernel, eng.apply_kernel):
        assert kern.launches == 3 * n_sub
    assert eng.slab_energy.launches >= 1          # the resync at cycle 2
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
    assert mp["dE_max"] > 0 and mp["n_legs"] > 0 and mp["repeat_equal"]
    assert not ch["differ"].any()
    assert ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
    assert 0 < ch["n_acc"] < ch["n_enabled"] and ch["hist_grew"] > 0


@pytest.mark.parametrize("P", [3, 5, 9])
def test_mover_points_kernel_fp64(multitrial_engine, P):
    """The points kernel at T = P - 1 = 2, 4 and 8 on the first P points
    of the engine's own proposal, W=200 walkers (not a multiple of the
    32-walker tile): within 1e-10 of its plain version, and a second
    launch on the same scratch and tickets bitwise equal."""
    eng, s, _ = multitrial_engine
    assert s.r.shape[-1] % 32 != 0
    pc = chip_smoke.points_compare(eng, s, 11, seed=P, P=P)
    assert pc["e_err"] <= 1e-10 and pc["own_err"] <= 1e-10
    assert pc["repeat_equal"] and pc["plan"].ng > 1


def test_multitrial_engine_on_card_runs_its_kernels(multitrial_engine):
    eng, s, counts = multitrial_engine
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    assert n_sub == 128 and counts == [n_sub] * 3
    assert int(s.occ_overflow.max()) == 0 and int(s.acc[0].min()) > 0
    s2, drift = eng.audit_energy(s.clone(), n_walkers=8)
    assert float(drift.abs().max()) < 1e-9


@pytest.fixture(scope="module")
def scatter_engine(card):
    """The cell engine on the (12,7,18) pair (75-cell stencils that
    overlap: 'auto' resolves to the scatter path) at W walkers, float64,
    after one cycle of sampling."""
    prm = chip_smoke.cell_params(W, "float64",
                                 stack=chip_smoke.SCATTER_STACK,
                                 cell_pallas="auto", cell_chain="auto",
                                 list_update_int=1, mpi_sync_int=1)
    eng, s = chip_smoke.make_cell_engine(prm)
    chip_smoke.require_scatter_modes(eng)
    eng.run_cycles(s, 1)
    return eng, s


@pytest.mark.parametrize("tbl", [0, 37])
def test_mover_energies_deltas_kernel_fp64(scatter_engine, tbl):
    eng, s = scatter_engine
    cmp = chip_smoke.scatter_substep_compare(eng, s, tbl, seed=tbl)
    d, sub = cmp["mover_energies_deltas"], cmp["substep"]
    assert d["e_err"] <= 1e-10 and d["own_err"] <= 1e-10
    assert d["dlt_err"] <= 1e-10 and d["n_dlt"] > 0
    assert not sub["differ"].any()
    assert sub["mom_err"] <= 1e-10 and sub["coord_err"] <= 1e-10
    assert sub["cf_rel"] <= 1e-10 and sub["wl_rel"] <= 1e-10
    assert 0 < sub["n_acc"] < sub["n_enabled"]
    assert sub["repeat_equal"]                  # the scatter's determinism


# ---- the chain + WL kernel on synthetic point tables (chain_inputs of
# tests/test_torch_chain_plan.py), float64, at card width: a walker count
# that is a multiple of neither the staged plan's walkers per block (4)
# nor the in-place branch's (32), so both ragged edges are masked

W_CHAIN = 517


def _edge_walkers(x, B):
    """Walkers at the edges of the bin grid and of their windows in the
    chain inputs ``x``: mu beyond the bin range on both sides (inside
    and outside the walker's window), windows a few mu units wide that
    the trials cross, a walker outside its window, and one whose window
    ends at interior bins (eta's one-sided gradients there)."""
    from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck

    cf, ci = x["cf"], x["ci"]
    cf[ck.CF_MU, 1:5] = (1300.0, -1300.0, 1250.0, -1250.0)
    cf[ck.CF_MU_MAX, 3], cf[ck.CF_MU_MIN, 4] = 1400.0, -1400.0
    mu = cf[ck.CF_MU, 5:40]
    cf[ck.CF_MU_MIN, 5:40], cf[ck.CF_MU_MAX, 5:40] = mu - 1.5, mu + 1.5
    ci[ck.CI_INWIN, 40] = 0
    ci[ck.CI_START, 41:60], ci[ck.CI_END, 41:60] = B // 2 - 3, B // 2 + 3


# the chain kernel's rules beyond the plain factor (phase 6c's settings)
CHAIN_RULES = {"minu": dict(minu=True),
               "swetnam": dict(wl_swetnam=True, wl_alpha=1e-4),
               "invt": dict(wl_useinvt=True)}


def _chain_on_card(samplerun, T, K, in_place, rule=None):
    import numpy as np

    from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid

    from tests.test_torch_chain_plan import chain_inputs, poison_point

    B = 201
    x = chain_inputs(K, T, W_CHAIN, B, seed=31 + T + K)
    if T >= 2:
        poison_point(x, K, T)
    _edge_walkers(x, B)
    over = CHAIN_RULES[rule] if rule else {}
    if rule:
        # MINU's hoisted term, a master histogram and a count of
        # updates for Swetnam, 1/t on every other walker
        rng = np.random.default_rng(6)
        x["cf"][ck.CF_MINUC] = rng.normal(0, 1.0, W_CHAIN)
        x["cf"][ck.CF_SUMHIST] = 150.0
        x["baseh"] = rng.uniform(0, 20, (B, W_CHAIN))
        x["ci"][ck.CI_INVT] = np.arange(W_CHAIN) % 2
    prm = chip_smoke.cell_params(W_CHAIN, "float64", samplerun=samplerun,
                                 wl_factor=0.0 if samplerun else 0.05,
                                 cell_trials=T, **over)
    kern = ck.ChainWLKernel(prm, build_bin_grid(B, -1200.0, 1200.0), K, T,
                            3.0)
    plan = kern.plan(torch.float64, W_CHAIN)
    assert plan.staged and plan.wpb == 4
    if in_place:
        inplace = ck.in_place_plan(8, B, K, T, W_CHAIN, samplerun)
        kern.plan = lambda dtype, W_: inplace
    dev = chip_smoke.DEVICE
    t = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
         for k, v in x.items()}
    kk = {k: v.clone() for k, v in t.items()}
    pp = {k: v.clone() for k, v in t.items()}
    names = ("codes", "cf", "ci", "wgt", "hist", "uh", "basew", "e", "inc",
             "hasm", "ua", "uz")
    # at cycle 7 the 1/t cap B / (7 N) lies below f = 0.05
    joh_k, cnt_k = kern(kk["codes"], True, *(kk[n] for n in names[1:]),
                        baseh=kk["baseh"], cycle=7)
    joh_p, cnt_p = kern.plain(pp["codes"], True, *(pp[n] for n in names[1:]),
                              baseh=pp["baseh"], cycle=7)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert torch.equal(kk["ci"], pp["ci"])
    assert torch.equal(cnt_k, cnt_p) and torch.equal(joh_k, joh_p)
    for n in ("cf", "wgt", "hist", "uh"):
        assert chip_smoke._max_abs(kk[n], pp[n]) <= 1e-10, n
    # the pass did something of every kind
    c = cnt_p.cpu().numpy()
    assert c[ck.CN_EN].sum() > c[ck.CN_ACC].sum() > 0
    assert c[ck.CN_SWEN].sum() > 0
    grew = (kk["hist"] != t["hist"]).any(dim=0).cpu().numpy()
    assert not grew[-1]                        # the overflowed walker
    slab, still = ("uh", "wgt") if samplerun else ("wgt", "uh")
    assert not torch.equal(kk[slab], t[slab])
    assert torch.equal(kk[still], t[still])
    if T >= 2:                                 # the poisoned mover
        P = T + 1
        assert joh_k.view(K, P, -1)[1, :, 0].tolist() == [1.0] + [0.0] * T
    cf = kk["cf"].cpu().numpy()
    if rule == "minu":
        assert (kk["ci"][ck.CI_LS] != t["ci"][ck.CI_LS]).any()
    elif rule == "swetnam":
        assert (cf[ck.CF_F] != 0.05).any() and (cf[ck.CF_SUMHIST] > 150).any()
    elif rule == "invt":
        assert ((cf[ck.CF_F] < 0.05) == (x["ci"][ck.CI_INVT] == 1)).all()


@pytest.mark.parametrize("in_place", [False, True], ids=["staged",
                                                         "in_place"])
@pytest.mark.parametrize("samplerun,T,K", [
    (False, 1, 8), (True, 1, 8), (False, 1, 32), (False, 8, 8),
    (True, 8, 8)], ids=["wl_live", "samplerun", "k32", "t8",
                        "t8_samplerun"])
def test_chain_wl_kernel_synthetic_fp64(card, samplerun, T, K, in_place):
    _chain_on_card(samplerun, T, K, in_place)


@pytest.mark.parametrize("in_place", [False, True], ids=["staged",
                                                         "in_place"])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("rule", list(CHAIN_RULES))
def test_chain_wl_kernel_rules_fp64(card, rule, T, in_place):
    """MINU and the Swetnam and 1/t schedules (chip_smoke.py phase 6c)
    on the synthetic inputs, in both branches of the plan."""
    _chain_on_card(False, T, 8, in_place, rule)


def test_chain_wl_launch_after_a_smaller_plans_occupancy(card):
    """The dynamic shared-memory limit is an attribute of the kernel
    function, which the occupancy query sets to its own plan's bytes: a
    query at a small plan (21 bins, one mover) must not keep a later
    launch of a larger one (201 bins, 8 movers) from running right."""
    from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid

    small = ck.ChainWLKernel(chip_smoke.cell_params(4, "float64"),
                             build_bin_grid(21, -1200.0, 1200.0), 1, 1, 3.0)
    occ = small.occupancy(torch.float64, 4)
    assert occ["smem_bytes"] < ck.ChainWLKernel(
        chip_smoke.cell_params(W_CHAIN, "float64"),
        build_bin_grid(201, -1200.0, 1200.0), 8, 1, 3.0).plan(
            torch.float64, W_CHAIN).smem
    _chain_on_card(False, 1, 8, False)


@pytest.fixture(scope="module")
def slab_systems(card):
    """{grid: (engine, state)} in float64 at 128 walkers: the N=8064 pair
    (27 coverage cells a fine cell) and the (12,7,18) pair (75)."""
    return {name: chip_smoke.make_cell_engine(chip_smoke.cell_params(
        128, "float64", stack=stack, cell_pallas="auto", cell_chain="auto"))
        for name, stack in (("cf27", chip_smoke.CELL_STACK),
                            ("cf75", chip_smoke.SCATTER_STACK))}


@pytest.mark.parametrize("grid", ["cf27", "cf75"])
@pytest.mark.parametrize("Wr", [1, 32, 33, 128])
@pytest.mark.parametrize("L", [2, 1])
def test_slab_energy_kernel_fp64(slab_systems, grid, Wr, L):
    """The whole-cell energy kernel against its plain version on the
    first Wr walkers (jittered, some slots emptied for odd walkers only)
    of both lattices or of the first (the single box): E and every
    moment field within 1e-10 relative, empty slots zero, a second
    launch on the same scratch and tickets bitwise equal."""
    eng, s = slab_systems[grid]
    kern = eng.slab_energy
    assert kern.CF == int(grid[2:])
    n0 = kern.launches
    r, valid, h = chip_smoke.slab_inputs(s, Wr, seed=Wr)
    err = chip_smoke.slab_energy_errors(kern, r[:L], valid, h[:L])
    assert err["e_rel"] <= chip_smoke.SLAB_F64_RTOL
    assert err["mom_rel"] <= chip_smoke.SLAB_F64_RTOL
    assert err["repeat_equal"] and err["empty_zero"]
    assert kern.launches == n0 + 2


@pytest.fixture(scope="module")
def slab_f32(card):
    return chip_smoke.make_cell_engine(chip_smoke.cell_params(128,
                                                              "float32"))


@pytest.mark.parametrize("Wr", [1, 33, 128])
def test_slab_energy_kernel_f32(slab_f32, Wr):
    """float32 on the N=8064 grid: E within F32_E_RTOL relative and the
    moments within F32_MOM_ATOL (the plain version adds the candidates
    and the slots in another order), bitwise repeat."""
    eng, s = slab_f32
    err = chip_smoke.slab_energy_errors(
        eng.slab_energy, *chip_smoke.slab_inputs(s, Wr, seed=Wr))
    assert err["e_rel"] <= chip_smoke.F32_E_RTOL
    assert err["mom_err"] <= chip_smoke.F32_MOM_ATOL
    assert err["repeat_equal"] and err["empty_zero"]


def test_slab_energy_kernel_refuses(slab_systems):
    from mc_water_ls_mw_tpu_torch.ops.slab_energy import SlabEnergyKernel

    eng, s = slab_systems["cf27"]
    kern = eng.slab_energy
    r, valid, h = s.r, s.slot2mol >= 0, s.h
    n0 = kern.launches
    bad = [(r.float(), valid, h),                 # r and H of two types
           (r.to(torch.float16), valid, h.to(torch.float16)),
           (r, valid.to(torch.uint8), h),
           (r, valid.cpu(), h),                   # valid off the card
           (r[:, :, :-1], valid, h),              # one slot short
           (r, valid, h[..., :-1])]               # H of fewer walkers
    for args in bad:
        with pytest.raises(ValueError, match="slab_energy"):
            kern(*args)
    with pytest.raises(ValueError, match="slab_energy"):
        SlabEnergyKernel(eng.model, eng.cellgrid, "cpu")(r, valid, h)
    assert kern.launches == n0


def test_cell_engine_full_both_launches_the_kernel(slab_systems):
    """_full_both (volume moves, resyncs, audits) is one launch for both
    lattices, on all walkers and on the first n."""
    eng, s = slab_systems["cf27"]
    n0 = eng.slab_energy.launches
    E, mom = eng._full_both(s, s.r, s.h)
    E8, mom8 = eng._full_both(s, s.r, s.h, 8)
    assert eng.slab_energy.launches == n0 + 2
    assert torch.equal(E8, E[:, :8]) and torch.equal(mom8, mom[..., :8])
    assert float((E - s.energy).abs().max()) <= 1e-9
