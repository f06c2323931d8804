"""The PyTorch port's dense engine against the JAX engine's scan path
under the settings beyond the plain two-lattice NPT run: one lattice
(the single-box NPT run), NVT, MINU, leshift and the Swetnam and 1/t
Wang-Landau schedules.

Both engines start from the same state and consume the same random
draws (the port through a stream that reproduces JAX's threefry draws)
over 2 cycles with a delta-sync every cycle and a chain resync at the
second: the N=216 switch pair in table mode (static neighbour tables,
displacement wall) and the N=48 stacking cells in dense mode (three
folded shifts).  The port runs its plain versions (CPU tensors);
float64 throughout.

The cases are spread over files, one group of settings each, so that
the test workers share them: MINU and leshift here, the Swetnam and 1/t
schedules in test_torch_engine_variants_wl.py, one lattice and NVT in
test_torch_engine_variants_single.py, and the multi-trial cycle under
MINU + Swetnam against the JAX fused kernel in
test_torch_engine_variants_multi.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.stacking import (
    stacking_switch_pair as jstacking_switch_pair,
)
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

from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)

N_CYCLES = 2

# id -> (structure, overrides of small_run_params, preset invt_active)
CASES = {
    "minu": ("n216", dict(minu=True), None),
    "minu_leshift": ("n216", dict(minu=True, leshift=True,
                                  samplerun=False), None),
    "leshift": ("n216", dict(leshift=True), None),
    # a small wl_alpha puts Swetnam's f = ln(rms) alpha B below the cap
    "swetnam": ("n216", dict(wl_swetnam=True, samplerun=False,
                             wl_alpha=1e-3), None),
    # f = 0.5 lies above the 1/t cap B / (cycle N) from the first cycle
    "useinvt": ("n216", dict(wl_useinvt=True, samplerun=False,
                             wl_factor=0.5), (True, False)),
    "nvt": ("n216", dict(mc_ensemble="nvt", samplerun=False), None),
    "single": ("n216", dict(num_lattices=1, samplerun=False), None),
    "n48_single": ("n48", dict(num_lattices=1, samplerun=False), None),
    "n48_minu": ("n48", dict(minu=True, samplerun=False), None),
}


def _structure(name, L):
    if name == "n48":
        r0, H0 = jstacking_switch_pair(1, 2, 6)
    else:
        r0, H0 = switch_pair_216()
    return r0[:L], H0[:L]


def _run_both(case):
    name, over, invt = CASES[case]
    kw = small_run_params(nwater=48 if name == "n48" else 216, **over)
    L = kw["num_lattices"]
    r0, H0 = _structure(name, L)
    w0 = 0.02 * (np.arange(21) - 10.0) ** 2 if L == 2 else None
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=w0)
    if invt is not None:
        js0 = js0._replace(invt_active=jnp.asarray(invt))
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    assert (jeng.tbl is None) == (name == "n48")
    js, jsamples = jeng.run_cycles(js0, N_CYCLES)

    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts0, taux = state_from_numpy(jax_state_fields(js0), jax_aux_fields(jaux),
                                 device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js0))
    ts, tsamples = teng.run_cycles(ts0, N_CYCLES)
    return dict(js=js, jsamples=jsamples, ts=ts, tsamples=tsamples,
                prm=teng.prm)


def assert_states_match(tf, jf, L):
    """The port's final state against the JAX engine's: identical
    integers, floats within 1e-9 (absolute; energies and the WL arrays
    within 1e-10)."""
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped",
                 "invt_active"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "ref_r", "h"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(tf["volume"], jf["volume"], rtol=1e-13)
    for name in ("energy", "moments", "weight", "hist", "uhist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("avg_energy", "mu", "min_dmu", "max_dmu", "f", "sumhist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["minu", "minu_leshift", "leshift",
                                  "n48_minu"])
def test_variant_matches_jax(case):
    check_variant(case)


def check_variant(case):
    """Run a case through both engines and hold the port's run against
    the JAX engine's."""
    r = _run_both(case)
    prm = r["prm"]
    L = prm.num_lattices
    jf, tf = jax_state_fields(r["js"]), state_to_numpy(r["ts"])
    assert tf["cycle"] == jf["cycle"] == N_CYCLES
    att, acc = tf["att"], tf["acc"]
    # the run exercised its paths: translations accepted, volume moves
    # under NPT only, switches with two lattices only
    assert acc[0].sum() > 0
    assert (att[1].sum() > 0) == (prm.mc_ensemble == "npt")
    assert (att[2].sum() > 0) == (L == 2)
    assert_states_match(tf, jf, L)
    if L == 2:
        assert (jf["master_hist"][0] > 0).sum() > 0
    else:
        # one lattice: no order parameter, no WL arrays
        assert not tf["hist"].any() and not tf["master_hist"][0].any()
        assert (tf["mu"] == 0).all()
    if case == "useinvt":
        # the 1/t cap only for the walker that runs it
        assert tf["f"][0] < 0.5 and tf["f"][1] == 0.5
    if case == "swetnam":
        assert (tf["f"] != prm.wl_factor).all() and (tf["sumhist"] > 0).all()
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))
