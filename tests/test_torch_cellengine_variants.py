"""The PyTorch port's large-N cell engine against the JAX CellEngine under
the settings beyond the plain two-lattice NPT run: one lattice (the
single-box NPT run, at one and two trials per mover), MINU (the XLA
chain at T=1, the chain kernel's plain version at T=2), the Swetnam and
1/t Wang-Landau schedules (T=2, the chain kernel), leshift and NVT.

Both engines start from each package's own init_cell_state (the N=8064
Ih/Ic stacking pair, or its Ih lattice alone), float64, W = 2, and
consume the same random draws (the port through a stream that
reproduces JAX's threefry draws) over one cycle cut to 4 sub-steps on
both engine objects (the first 4 (colour, block) tables), because the
JAX engine runs its Pallas kernels in interpret mode on the CPU.  The
JAX engine resolves its modes as its tests run it (the apply kernel;
the chain kernel where ``cell_chain='on'``); the port runs the plain
versions of its kernels.

The cases are spread over files, one group of settings each, so that
the test workers share them: one lattice here, MINU in
test_torch_cellengine_variants_minu.py, the Swetnam and 1/t schedules in
test_torch_cellengine_variants_wl.py, leshift and NVT in
test_torch_cellengine_variants_ens.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.cellengine import (
    init_cell_state as jinit_cell_state,
)
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.ops import cells as jcells

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_to_numpy,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.ops import cells as tcells

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS
from .test_torch_cells import (
    JaxCellStream,
    build_grids,
    cell_run_params,
    to_port,
)
from .test_torch_state import jax_state_fields

N_SUB = 4
W0 = 0.002 * (np.arange(201) - 100.0) ** 2

# id -> (lattices, overrides of cell_run_params, preset invt_active)
CASES = {
    "single_t1": (1, dict(num_lattices=1, cell_chain="off"), None),
    "single_t2": (1, dict(num_lattices=1, cell_chain="off",
                          cell_trials=2), None),
    "minu_t1_xla": (2, dict(minu=True, cell_chain="off"), None),
    "minu_t2_chain": (2, dict(minu=True, cell_trials=2), None),
    # a small wl_alpha puts Swetnam's f = ln(rms) alpha B below the cap
    "swetnam_t2": (2, dict(wl_swetnam=True, wl_alpha=1e-4,
                           cell_trials=2), None),
    # f = 0.5 lies above the 1/t cap B / (cycle N)
    "useinvt_t2": (2, dict(wl_useinvt=True, wl_factor=0.5,
                           cell_trials=2), (True, False)),
    "leshift": (2, dict(leshift=True), None),
    "nvt": (2, dict(mc_ensemble="nvt"), None),
}


@pytest.fixture(scope="module")
def grids():
    """The N=8064 pair's grids (build_grids) and the single Ih lattice's
    (no correspondence mismatch), each package's own."""
    r0, H0, mx, jcg, tcg = build_grids()
    r1, H1 = r0[:1], H0[:1]
    jshape = jcells.choose_grid_shape(H1, MW, 0.0)
    jcg1 = jcells.build_grid(
        jshape, jcells.cap_for_positions(r1, H1, jshape), H1, MW, 0.0)
    tshape = tcells.choose_grid_shape(H1, TMW, 0.0)
    tcg1 = tcells.build_grid(
        tshape, tcells.cap_for_positions(r1, H1, tshape), H1, TMW, 0.0)
    return {2: (r0, H0, jcg, tcg), 1: (r1, H1, jcg1, tcg1)}


def _run_both(grids, case):
    L, over, invt = CASES[case]
    r0, H0, jcg, tcg = grids[L]
    kw = cell_run_params(eq_mc_cycles=0, list_update_int=100000,
                         mpi_sync_int=1, mc_vol_prob=1e-6, **over)
    w0 = W0 if L == 2 else None
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"],
                                 dtype=jnp.float64)
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    jst, jaux, jcaux = jinit_cell_state(RunParams(**kw, fused="off"), MW,
                                        r0, H0, jgrid, jcg, weight0=w0)
    # each package's initial state
    ts0, _, _ = init_cell_state(TRunParams(**kw), TMW, r0, H0, tgrid, tcg,
                                weight0=w0, device="cpu")
    if invt is not None:
        jst = jst._replace(invt_active=jnp.asarray(invt))
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux, jcg,
                       jcaux)
    ts, taux, tcaux = to_port(jst, jaux, jcaux)
    teng = CellEngine(TRunParams(**kw), TMW, tgrid, taux, tcg, tcaux,
                      device="cpu", stream=JaxCellStream(jst))
    assert teng.use_chain_kernel == jeng.use_chain_kernel \
        == (kw["cell_chain"] == "on")
    for eng in (jeng, teng):
        eng.sweeps_per_cycle = 1
        eng.n_tables = N_SUB
        eng.trials_per_cycle = N_SUB * eng.K * eng.T
    js, jsamples = jeng.run_cycles(jst, 1)
    ts, tsamples = teng.run_cycles(ts, 1)
    return dict(jst=jst, ts0=ts0, js=js, ts=ts, jsamples=jsamples,
                tsamples=tsamples, prm=teng.prm)


@pytest.mark.parametrize("case", ["single_t1", "single_t2"])
def test_cell_variant_matches_jax(grids, case):
    check_cell_variant(grids, case)


def check_cell_variant(grids, case):
    """Run a case through both engines and hold the port's cycle against
    the JAX engine's."""
    r = _run_both(grids, case)
    prm = r["prm"]
    L = prm.num_lattices
    # init_cell_state of both packages (NVT's and leshift's reference
    # enthalpies and initial mu, one lattice's state)
    jf0, tf0 = jax_state_fields(r["jst"]), cell_state_to_numpy(r["ts0"])
    for name in ("r", "mu", "energy", "moments"):
        np.testing.assert_allclose(tf0[name], jf0[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    for name in ("slot2mol", "mol2slot", "ls"):
        np.testing.assert_array_equal(tf0[name], jf0[name], err_msg=name)

    jf, tf = jax_state_fields(r["js"]), cell_state_to_numpy(r["ts"])
    assert int(tf["cycle"]) == int(jf["cycle"]) == 1
    for name in INT_FIELDS + ("invt_active",):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in FLOAT_FIELDS + ("sumhist",):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                   err_msg=name)
    att, acc = tf["att"], tf["acc"]
    assert acc[0].min() > 0
    assert (att[2].sum() > 0) == (L == 2)
    if L == 1:
        assert not tf["hist"].any() and (tf["mu"] == 0).all()
    else:
        assert (tf["master_hist"][0] > 0).sum() > 0
    if prm.wl_useinvt:
        assert tf["f"][0] < 0.5 and tf["f"][1] == 0.5
    if prm.wl_swetnam:
        assert (tf["f"] != prm.wl_factor).all()
        assert (tf["sumhist"] > 0).all()
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
