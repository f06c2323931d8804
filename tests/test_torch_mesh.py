"""Walker sharding of the port's dense engine over gloo ranks, against
the JAX package's unsharded run.

The N=216 switch pair (static neighbour tables), 16 walkers, float64:
the JAX engine's scan path runs three cycles unsharded; the port runs
the same three cycles on 2 gloo CPU ranks of 8 walkers each
(``parallel/mesh.shard_state``, the engine's ``comm``), from the same
initial state and on the same draws (the JAX threefry draws of the
whole ensemble, replayed to every rank, each keeping its block), and
gathers the state after each cycle.  The cycles cross a delta-sync
(the walker reductions of ``_delta_merge`` and ``_window_mask``),
scheduled volume moves and a chain resync, in 'mw' (a Wang-Landau
generation: the merged minimum re-zeroed over the window mask) and in
'dd' (4 windows of 4 walkers, each rank holding two walkers of every
window, across the equilibration boundary, a sample run).  Integer
outcomes are identical; positions agree within 1e-12 Bohr and the rest
within the tolerances of tests/test_torch_engine_dd.py.  The therm
samples (the ensemble's first therm_walkers, gathered) and each rank's
shard are checked too, and the collectives of ``parallel/comm.py``.
"""

import time

import numpy as np
import pytest

from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.engine import Engine as JEngine
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine as TEngine
from mc_water_ls_mw_tpu_torch.mcmc.state import state_from_numpy
from mc_water_ls_mw_tpu_torch.parallel.comm import run_ranks

from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)
from .torch_ranks import (
    collectives,
    fail_on_rank_1,
    record_draws,
    walker_cases,
)

W = 16
N_CYCLES = 3
N_WIN = 4
W0 = 0.02 * (np.arange(21) - 10.0) ** 2
CASES = {
    "mw": dict(samplerun=False, wl_factor=0.05, mpi_sync_int=2,
               latt_sync_int=3),
    "dd": dict(samplerun=True, parallel_strategy="dd", n_windows=N_WIN,
               dd_seeding=True, eq_mc_cycles=2, mpi_sync_int=1,
               latt_sync_int=2),
}


def _case(name):
    """The JAX run of a case (the state after each cycle) and what the
    ranks need to run it."""
    kw = small_run_params(n_walkers=W, mc_vol_prob=0.02, therm_walkers=12,
                          **CASES[name])
    nwin = N_WIN if name == "dd" else 1
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=W0,
                            n_windows=nwin)
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    hist, js = [], js0
    for _ in range(N_CYCLES):
        js, _ = jeng.run_cycles(js, 1)
        hist.append(jax_state_fields(js))
    fields, aux = jax_state_fields(js0), jax_aux_fields(jaux)
    # the serial port engine of these settings, for the draws it takes
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    _, taux = state_from_numpy(fields, aux, device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu")
    draws = record_draws(JaxStream(js0), teng, N_CYCLES)
    return hist, dict(kw=kw, fields=fields, aux=aux, draws=draws,
                      n_cycles=N_CYCLES)


@pytest.fixture(scope="module")
def runs():
    ref, cases = {}, {}
    for name in CASES:
        ref[name], cases[name] = _case(name)
    out = run_ranks(walker_cases, 2, cases)
    return ref, cases, out


def _assert_match(tf, jf, nwin):
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped",
                 "in_window", "window_id", "start_bin", "end_bin"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "ref_r", "h"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-12,
                                   err_msg=name)
    for name in ("energy", "moments", "weight", "hist", "uhist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("mu", "min_dmu", "max_dmu", "avg_energy", "max_trans",
                 "dv_max", "f"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        assert t64.shape == (nwin, 21), name
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_dense_engine_matches_jax(runs, name):
    ref, cases, out = runs
    nwin = N_WIN if name == "dd" else 1
    for rank, res in enumerate(out):
        r = res[name]
        for c, (tf, jf) in enumerate(zip(r["hist"], ref[name]), 1):
            assert int(tf["cycle"]) == int(jf["cycle"]) == c
            _assert_match(tf, jf, nwin)
        # this rank's shard is its block of the ensemble
        lo = rank * W // 2
        np.testing.assert_array_equal(r["shard"]["mu"],
                                      r["hist"][-1]["mu"][lo:lo + W // 2])
        np.testing.assert_array_equal(r["shard"]["master_eta"][0],
                                      r["hist"][-1]["master_eta"][0])
        # the therm samples: the ensemble's first 12 walkers (4 of them
        # on rank 1), the same on both ranks
        for c, smp in enumerate(r["samples"]):
            assert smp["mu"].shape == (1, 12)
            np.testing.assert_array_equal(smp["mu"][0],
                                          r["hist"][c]["mu"][:12])
    tf = out[0][name]["hist"][-1]
    assert (tf["att"][1] > 0).all()              # volume moves ran
    hist = tf["master_hist"][0].astype(np.float64) + tf["master_hist"][1]
    assert (hist.sum(axis=1) > 0).all()          # every window merged
    if name == "dd":
        assert tf["window_id"].tolist() == [w % N_WIN for w in range(W)]


def test_collectives_in_rank_order():
    out = run_ranks(collectives, 3)
    x = [np.arange(3.0) + 10 * r for r in range(3)]
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res["cat"], np.stack(x))
        np.testing.assert_array_equal(res["sum"], (x[0] + x[1]) + x[2])
        np.testing.assert_array_equal(res["max"], x[2])
        np.testing.assert_array_equal(res["min"], x[0])
        np.testing.assert_array_equal(res["bcast"], x[1])
        # from the down neighbour what it sent up, from the up
        # neighbour what it sent down (periodic)
        np.testing.assert_array_equal(res["up"], x[(r - 1) % 3])
        np.testing.assert_array_equal(res["dn"], -x[(r + 1) % 3])
        assert res["flag"] is True
        assert res["gather_bool"] == [False, True, False]


def test_a_failing_rank_fails_the_group():
    """A rank that raises ends the group at once: the other rank's
    collective fails (its peer is gone) and run_ranks raises, well
    before the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="terminated with the following"):
        run_ranks(fail_on_rank_1, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60
