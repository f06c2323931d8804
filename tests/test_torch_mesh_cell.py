"""Walker sharding of the port's cell engine over gloo ranks, against the
JAX package's unsharded run.

The N=8064 Ih/Ic stacking pair of tests/test_torch_cellengine.py,
float64, 4 walkers: the JAX CellEngine (``cell_pallas='apply'``, the
chain kernel, in interpret mode as its own tests run it on the CPU) runs
one cycle unsharded; the port runs it on 2 gloo CPU ranks of 2 walkers
each, from the same initial state on the same draws (the JAX draws of
the whole ensemble replayed to every rank), and gathers the state.  A
cycle is cut to 4 sub-steps on both engines (the first 4 (colour,
block) tables), because the JAX engine interprets its kernels.

* T = 1: the cycle rebins first (a new grid origin for every rank),
  runs a scheduled volume move (a whole-slab energy per walker), the
  delta-sync (the walker reductions) and the chain resync;
* T = 2 (kernels 4, 5 and 6's multi-trial form): the rebin and the
  delta-sync.

Integer outcomes are identical and the continuous state agrees within
1e-9, as in tests/test_torch_cellengine.py.
"""

import numpy as np
import pytest

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.config import RunParams

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import CellEngine
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.parallel.comm import run_ranks

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS
from .test_torch_cells import JaxCellStream, jax_cell_system, to_port
from .test_torch_state import jax_aux_fields, jax_state_fields
from .torch_ranks import record_draws, walker_cases

N_SUB = 4
CASES = {
    "T1": dict(cell_trials=1, mc_vol_prob=1.0 / 64, latt_sync_int=1),
    "T2": dict(cell_trials=2, mc_vol_prob=0.0, latt_sync_int=100000),
}


def _cut(eng):
    eng.sweeps_per_cycle = 1
    eng.n_tables = N_SUB
    eng.trials_per_cycle = N_SUB * eng.K * eng.T


def _case(system, name):
    kw = {**system["kw"], "list_update_int": 1, "mpi_sync_int": 1,
          **CASES[name]}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, system["jgrid"],
                       system["jaux"], system["jcg"], system["jcaux"])
    assert jeng.use_cell_apply and jeng.use_chain_kernel
    _, taux, tcaux = to_port(system["jst"], system["jaux"], system["jcaux"])
    teng = CellEngine(TRunParams(**kw), TMW, system["tgrid"], taux,
                      system["tcg"], tcaux, device="cpu")
    for eng in (jeng, teng):
        _cut(eng)
    js, _ = jeng.run_cycles(system["jst"], 1)
    draws = record_draws(JaxCellStream(system["jst"]), teng, 1)
    return jax_state_fields(js), dict(
        kw=kw, fields=jax_state_fields(system["jst"]),
        aux=jax_aux_fields(system["jaux"]),
        caux=jax_aux_fields(system["jcaux"]), cellgrid=system["tcg"],
        draws=draws, n_tables=N_SUB, n_cycles=1)


@pytest.fixture(scope="module")
def runs():
    system = jax_cell_system(n_walkers=4)
    ref, cases = {}, {}
    for name in CASES:
        ref[name], cases[name] = _case(system, name)
    return ref, cases, run_ranks(walker_cases, 2, cases)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cell_engine_matches_jax(runs, name):
    ref, cases, out = runs
    jf = ref[name]
    for rank, res in enumerate(out):
        tf = res[name]["hist"][0]
        assert int(tf["cycle"]) == int(jf["cycle"]) == 1
        for f in INT_FIELDS:
            np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(tf[f], jf[f], rtol=0, atol=1e-9,
                                       err_msg=f)
        for f in ("master_eta", "master_hist", "master_uhist"):
            t64 = tf[f][0].astype(np.float64) + tf[f][1]
            j64 = jf[f][0].astype(np.float64) + jf[f][1]
            np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=f)
            np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                       err_msg=f)
        shard = res[name]["shard"]
        np.testing.assert_array_equal(shard["slot2mol"],
                                      tf["slot2mol"][:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(shard["origin"], tf["origin"])
    tf = out[0][name]["hist"][0]
    assert (tf["acc"][0] > 0).all()
    assert np.abs(tf["origin"]).max() > 0                 # the rebin ran
    hist = tf["master_hist"][0].astype(np.float64) + tf["master_hist"][1]
    assert hist.sum() > 0                                 # merged
    if name == "T1":
        assert (tf["att"][1] == 1).all()                  # a volume move
        # the resync recomputed energies from scratch: no residual
        assert (tf["energy_err"] == 0).all()
