"""The PyTorch port's multi-trial table step (``dense_trials`` = T > 1)
against the JAX engine's fused kernel in interpret mode.

The only JAX implementation of the multi-trial branch is the Pallas
kernel (``fused._do_translation_tbl_multi``), which the CPU runs in
interpret mode at ~90 s per N=216 cycle at T=2 and two walkers, so the
tier-1 case is one such cycle (alone in this file, so that a
distributed run gives it a worker of its own); the T=8 cycle is marked
``slow``.  Both engines start from the same state and consume the same
draws (the port through a stream that reproduces JAX's threefry
draws), with Wang-Landau live, a delta-sync and no volume move; float64.
Also the envelope's errors against the JAX engine's.
"""

import dataclasses

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
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    init_state as tinit_state,
    state_from_numpy,
    state_to_numpy,
)

from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)


def _params(T, **over):
    return small_run_params(
        samplerun=False, wl_factor=0.005, dense_trials=T,
        mc_switch_prob=0.1, allow_vol=False, eq_mc_cycles=0,
        mpi_sync_int=1, latt_sync_int=10**6, **over)


def _run_both(T):
    kw = _params(T)
    r0, H0 = switch_pair_216()
    w0 = 0.02 * (np.arange(21) - 10.0) ** 2
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=w0)
    jeng = JEngine(RunParams(**kw, fused="on"), MW, jgrid, jaux)
    js, _ = jeng.run_cycles(js0, 1)

    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts0, taux = state_from_numpy(jax_state_fields(js0), jax_aux_fields(jaux),
                                 device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js0))
    assert teng.fused_cycle.kernel == "fused_cycle_multi" and teng.dT == T
    ts, _ = teng.run_cycles(ts0, 1)
    return jax_state_fields(js), state_to_numpy(ts)


def _check(jf, tf, N=216):
    att, acc = tf["att"], tf["acc"]
    # trials per cycle stay N: the translation trials of the N codes
    assert att[1].sum() == 0 and 0 < att[0, 0] <= N
    assert acc[0].sum() > 0 and acc[2].sum() > 0
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    np.testing.assert_array_equal(tf["trans_per_mol"].sum(axis=0), att[0])
    np.testing.assert_allclose(tf["r"], jf["r"], rtol=0, atol=1e-12)
    for name in ("energy", "moments"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("mu", "min_dmu", "max_dmu"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("weight", "hist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("master_eta", "master_hist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-10,
                                   err_msg=name)
    assert (jf["master_hist"][0] > 0).sum() > 0


def test_multitrial_cycle_matches_jax_t2():
    jf, tf = _run_both(2)
    _check(jf, tf)


@pytest.mark.slow
def test_multitrial_cycle_matches_jax_t8():
    jf, tf = _run_both(8)
    _check(jf, tf)


def _errors(eng_cls, tables, **over):
    """The exception of building an engine at ``over`` (None if none)."""
    kw = small_run_params(**over)
    r0, H0 = switch_pair_216()
    if eng_cls is JEngine:
        grid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
        prm = RunParams(**kw, fused="on")
        _, aux = jinit_state(dataclasses.replace(prm, dense_trials=1), MW,
                             r0, H0, grid)
        model = MW
    else:
        grid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
        prm = TRunParams(**kw)
        _, aux = tinit_state(dataclasses.replace(prm, dense_trials=1), TMW,
                            r0, H0, grid, device="cpu")
        model = TMW
    if not tables:
        aux = aux._replace(nbr_tbl=None, frac0=None, wall=0.0)
    try:
        if eng_cls is JEngine:
            eng_cls(prm, model, grid, aux)
        else:
            eng_cls(prm, model, grid, aux, device="cpu")
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", [
    (True, dict(dense_trials=5)),        # T must divide N
    (False, dict(dense_trials=2)),       # T > 1 needs the tables
    (True, dict(dense_trials=8)),        # valid
])
def test_envelope_validation(case):
    tables, over = case
    mine = _errors(TEngine, tables, **over)
    theirs = _errors(JEngine, tables, **over)
    assert mine == theirs
    assert (mine is None) == (over["dense_trials"] == 8)
