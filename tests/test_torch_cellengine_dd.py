"""The PyTorch port's large-N cell engine in the 'dd' mu-window
decomposition, against the JAX CellEngine.

The N=8064 Ih/Ic stacking pair of test_torch_cellengine.py (coarse 4^3,
m = 2, 512 fine cells), float64, 4 walkers over 4 windows, a
non-trivial warm-start curve: the initial state of each package's
init_cell_state in dd, then three cycles of both engines from the same
state on the same random draws with eq_mc_cycles = 2, so that the run
crosses the equilibration boundary (window tracking and suppressed
switches in cycle 1, the walls live after it: mu stays near 0, so the
walkers of the outer windows are pre-window, then walled).  A rebin,
scheduled volume moves and a per-window delta-sync every cycle fall in
the run (the chain resync, which does not depend on the windows, is
left out: a from-scratch energy costs ~15 s on the CPU).  At one trial
per mover (Wang-Landau generation, window seeding) and at two (a sample
run, reach-once windows).

A cycle is cut to 4 sub-steps on both engine objects (the first 4
(colour, block) tables, 4 * K * T trials) because the JAX engine runs
its Pallas kernels in interpret mode on the CPU.
"""

import numpy as np
import pytest

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.cellengine import (
    init_cell_state as jinit_cell_state,
)
from mc_water_ls_mw_tpu.mcmc.config import RunParams

import jax.numpy as jnp

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_to_numpy,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS
from .test_torch_cells import (
    JaxCellStream,
    build_grids,
    cell_run_params,
    to_port,
)
from .test_torch_state import jax_state_fields

N_CYCLES = 3
N_WIN = 4
N_SUB = 4
W0 = 0.002 * (np.arange(201) - 100.0) ** 2
CASES = [(1, False, True), (2, True, False)]
IDS = ["T1-wl-seeding", "T2-samplerun-reach-once"]


@pytest.fixture(scope="module")
def grids():
    return build_grids()


def dd_kw(T, samplerun, seeding):
    return cell_run_params(
        n_walkers=4, parallel_strategy="dd", n_windows=N_WIN,
        dd_seeding=seeding, eq_mc_cycles=2, cell_trials=T,
        samplerun=samplerun, wl_factor=0.0 if samplerun else 0.05,
        list_update_int=2, mpi_sync_int=1, latt_sync_int=100000,
        mc_vol_prob=1.0 / 100)


def _states(grids, kw):
    r0, H0, _, jcg, tcg = grids
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"],
                                 dtype=jnp.float64)
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    j = jinit_cell_state(RunParams(**kw, fused="off"), MW, r0, H0, jgrid,
                         jcg, weight0=W0, n_windows=N_WIN)
    t = init_cell_state(TRunParams(**kw), TMW, r0, H0, tgrid, tcg,
                        weight0=W0, n_windows=N_WIN, device="cpu")
    return jgrid, tgrid, j, t


@pytest.mark.parametrize("seeding", [True, False],
                         ids=["seeding", "reach-once"])
def test_dd_init_cell_state_matches_jax(grids, seeding):
    kw = dd_kw(1, False, seeding)
    _, _, (jst, jaux, _), (ts, taux, _) = _states(grids, kw)
    jf, tf = jax_state_fields(jst), cell_state_to_numpy(ts)
    assert set(tf) == set(jf)
    for name in ("ls", "window_id", "start_bin", "end_bin", "in_window",
                 "slot2mol", "mol2slot"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("my_mu_min", "my_mu_max", "mu", "energy"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        for a, b in zip(tf[name], jf[name]):
            assert a.shape == (N_WIN, 201), name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert not tf["in_window"].any()
    assert tf["window_id"].tolist() == [0, 1, 2, 3]
    # the warm start: the whole curve in both rows (seeding), or each
    # row zero outside its window (reach-once)
    eta = tf["master_eta"][0].astype(np.float64) + tf["master_eta"][1]
    e0 = tf["end_bin"][0]
    np.testing.assert_allclose(eta[0, :e0 + 1], W0[:e0 + 1], rtol=1e-6)
    assert (eta[0, e0 + 1:] == 0).all() != seeding
    np.testing.assert_allclose(taux.log_unbiased_norm,
                               jaux.log_unbiased_norm, rtol=1e-14)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def cycles(request, grids):
    T, samplerun, seeding = request.param
    kw = dd_kw(T, samplerun, seeding)
    jgrid, tgrid, (jst, jaux, jcaux), _ = _states(grids, kw)
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux,
                       grids[3], jcaux)
    assert jeng.use_cell_apply and jeng.use_chain_kernel
    ts, taux, tcaux = to_port(jst, jaux, jcaux)
    teng = CellEngine(TRunParams(**kw), TMW, tgrid, taux, grids[4], tcaux,
                      device="cpu", stream=JaxCellStream(jst))
    for eng in (jeng, teng):
        eng.sweeps_per_cycle = 1
        eng.n_tables = N_SUB
        eng.trials_per_cycle = N_SUB * eng.K * eng.T
    js_hist, ts_hist, js = [], [], jst
    for _ in range(N_CYCLES):
        js, _ = jeng.run_cycles(js, 1)
        js_hist.append(js)
        teng.run_cycles(ts, 1)
        ts_hist.append(ts.clone())
    return dict(T=T, samplerun=samplerun, seeding=seeding, js_hist=js_hist,
                ts_hist=ts_hist)


def test_dd_cell_cycles_match_jax(cycles):
    for c, (ts, js) in enumerate(zip(cycles["ts_hist"], cycles["js_hist"]),
                                 1):
        jf, tf = jax_state_fields(js), cell_state_to_numpy(ts)
        assert int(tf["cycle"]) == int(jf["cycle"]) == c
        for name in INT_FIELDS + ("in_window", "window_id", "start_bin",
                                  "end_bin"):
            np.testing.assert_array_equal(tf[name], jf[name],
                                          err_msg=f"{name} cycle {c}")
        for name in FLOAT_FIELDS:
            np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                       atol=1e-9, err_msg=f"{name} cycle {c}")
        for name in ("master_eta", "master_hist", "master_uhist"):
            t64 = tf[name][0].astype(np.float64) + tf[name][1]
            j64 = jf[name][0].astype(np.float64) + jf[name][1]
            assert t64.shape == (N_WIN, 201)
            np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
            np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                       err_msg=f"{name} cycle {c}")
    tf = cell_state_to_numpy(cycles["ts_hist"][-1])
    att, acc = tf["att"], tf["acc"]
    # every part of the cycles ran: translations, volume moves, switch
    # attempts only after the boundary (fewer than translations under
    # mc_always_switch), a rebin
    assert (att[0] > 0).all() and (acc[0] > 0).all()
    assert (att[1] > 0).all()
    assert (att[2] > 0).all() and (att[2] < att[0]).all()
    assert np.abs(tf["origin"]).max() > 0
    assert (tf["occ_overflow"] == 0).all()
    # every window's master histogram was written; in the sample run the
    # unbiased histogram of the two windows around mu = 0 too
    hist = tf["master_hist"][0].astype(np.float64) + tf["master_hist"][1]
    assert (hist.sum(axis=1) > 0).all()
    if cycles["samplerun"]:
        uh = tf["master_uhist"][0].astype(np.float64) + \
            tf["master_uhist"][1]
        assert (uh.sum(axis=1)[1:3] > 0).all()
    inw = [cell_state_to_numpy(s)["in_window"] for s in cycles["ts_hist"]]
    assert inw[0].any() and not inw[0].all()
    assert inw[2].all()


def test_dd_cell_switches_suppressed_before_the_boundary(cycles):
    """No switch attempt in cycle 1, whatever the schedule."""
    tf = cell_state_to_numpy(cycles["ts_hist"][0])
    assert (tf["att"][2] == 0).all() and (tf["att"][0] > 0).all()
