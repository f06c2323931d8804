"""One whole multi-trial cycle of the port's cell engine against the JAX
``CellEngine`` at ``cell_trials=2``, on the N=8064 stacking pair,
float64, W = 2, under JAX's own draws: integer outcomes identical,
continuous state within 1e-9.

The cycle is cut to ONE sweep (``sweeps_per_cycle = 1`` on both engine
objects: 64 sub-steps of 8 movers x 2 trials) and holds a rebin, a
scheduled volume move and a delta-sync.  The JAX engine runs its XLA
sub-step (``cell_pallas='off'``, the chain kernel in interpret mode),
which the JAX package's own tests hold equal to its Pallas route
(tests/test_multitrial.py) and which compiles in half the time; the
port's Pallas counterparts are held against the JAX kernels one by one
in tests/test_torch_multitrial.py and tests/test_torch_cell_kernels.py.
"""

import numpy as np
import pytest

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.config import RunParams

from mc_water_ls_mw_tpu_torch.mcmc.cellengine import cell_state_to_numpy
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_cellengine import assert_states_match, engines
from .test_torch_cells import jax_cell_system


@pytest.fixture(scope="module")
def cycle():
    system = jax_cell_system(cell_trials=2)
    over = dict(list_update_int=1, mpi_sync_int=1, mc_vol_prob=1.0 / 1024)
    _, teng, ts = engines(system, **over)
    jeng = JCellEngine(
        RunParams(**{**system["kw"], **over, "cell_pallas": "off"},
                  fused="off"),
        MW, system["jgrid"], system["jaux"], system["jcg"], system["jcaux"])
    assert not jeng.use_cell_pallas and jeng.use_chain_kernel
    for eng in (jeng, teng):
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K * eng.T
    js, jsamples = jeng.run_cycles(system["jst"], 1)
    ts, tsamples = teng.run_cycles(ts, 1)
    return dict(js=js, ts=ts, jsamples=jsamples, tsamples=tsamples)


def test_multitrial_cycle_matches_jax(cycle):
    r = cycle
    assert_states_match(r["ts"], r["js"])
    tf = cell_state_to_numpy(r["ts"])
    # the rebin moved the origin, a volume move ran, the delta-sync
    # merged the WL growth
    assert np.abs(tf["origin"]).max() > 0
    assert tf["att"][1].min() >= 1
    assert tf["att"][0].min() > 900 and tf["acc"][0].min() > 100
    assert (tf["occ_overflow"] == 0).all()
    assert ds_value64(r["ts"].master_hist).sum() > 0
    assert np.abs(tf["weight"]).max() == 0
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))
