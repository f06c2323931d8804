"""One N=216 cycle of the port's dense engine at ``dense_trials=2``
under MINU and Swetnam against the JAX engine's fused kernel in
interpret mode, the only JAX path of the multi-trial branch (the
kernel's plain version on CPU tensors; float64).  Split from
test_torch_engine_variants.py, whose helpers it uses, so that the
test workers share the two files."""

import numpy as np

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
    state_from_numpy,
    state_to_numpy,
)

from .test_torch_engine_variants import assert_states_match
from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)


def test_multitrial_minu_swetnam_matches_fused_kernel():
    """One N=216 cycle at dense_trials=2 under MINU and Swetnam against
    the JAX engine's fused kernel (interpret mode), which is the only
    JAX path of the multi-trial branch."""
    kw = small_run_params(minu=True, wl_swetnam=True, samplerun=False,
                          wl_alpha=1e-3, dense_trials=2, mc_vol_prob=0.0,
                          latt_sync_int=1000)
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
    assert teng.fused_cycle.kernel == "fused_cycle_multi_ext"
    ts, _ = teng.run_cycles(ts0, 1)
    jf, tf = jax_state_fields(js), state_to_numpy(ts)
    assert tf["acc"][0].sum() > 0 and (tf["sumhist"] > 0).all()
    assert (tf["f"] != teng.prm.wl_factor).all()
    assert_states_match(tf, jf, 2)
