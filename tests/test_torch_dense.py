"""The PyTorch port's dense-candidate engine against the JAX engine's scan
path.

Dense-candidate mode builds no neighbour tables: each walker moves its
own molecule and every molecule under every folded image shift is a
candidate, with no displacement wall.  Two cases: the reference's N=48
cell size (the (1,2,6) stacking pair, N < 96 and a box that is not
MIC-unique: three folded shifts) and the N=216 stacking pair with
``nbr_table='off'`` (one shift).  Both engines start from the same
state and consume the same random draws (the port through a stream that
reproduces JAX's threefry draws) over 3 cycles with volume moves, a
delta-sync every cycle and a chain resync every second cycle, in the
sample-run and the WL-generation modes.  The port runs its plain
versions (CPU tensors); float64 throughout.
"""

import numpy as np
import pytest

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

N_CYCLES = 3

# (stack, overrides, folded shifts)
CASES = {
    "n48": ((1, 2, 6), dict(nwater=48), 3),
    "n216_off": ((3, 3, 6), dict(nwater=216, nbr_table="off"), 1),
}


def _run_both(case, samplerun):
    stack, over, n_shifts = CASES[case]
    kw = small_run_params(samplerun=samplerun, **over)
    r0, H0 = jstacking_switch_pair(*stack)
    w0 = 0.02 * (np.arange(21) - 10.0) ** 2
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=w0)
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    assert jeng.tbl is None and len(jeng.fold_shifts) == n_shifts
    js, jsamples = jeng.run_cycles(js0, N_CYCLES)

    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts0, taux = state_from_numpy(jax_state_fields(js0), jax_aux_fields(jaux),
                                 device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js0))
    assert teng.dense and teng.fused_cycle.kernel == "fused_cycle_dense"
    ts, tsamples = teng.run_cycles(ts0, N_CYCLES)
    return dict(js=js, jsamples=jsamples, ts=ts, tsamples=tsamples)


@pytest.mark.parametrize("samplerun", [True, False],
                         ids=["samplerun", "wl_generation"])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_engine_matches_jax(case, samplerun):
    r = _run_both(case, samplerun)
    jf, tf = jax_state_fields(r["js"]), state_to_numpy(r["ts"])
    assert tf["cycle"] == jf["cycle"] == N_CYCLES
    # the run exercised every path: translations, switches, volume moves
    att, acc = tf["att"], tf["acc"]
    assert (att > 0).all() and acc[0].sum() > 0 and acc[1].sum() > 0
    # each walker drew its own molecules
    assert (tf["trans_per_mol"][:, 0] != tf["trans_per_mol"][:, 1]).any()
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "ref_r", "h"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(tf["volume"], jf["volume"], rtol=1e-13)
    for name in ("energy", "moments"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("avg_energy", "mu", "min_dmu", "max_dmu"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("weight", "hist", "uhist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-10,
                                   err_msg=name)
    assert (jf["master_hist"][0] > 0).sum() > 0
    if samplerun:
        assert (jf["master_uhist"][0] > 0).sum() > 0
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))


# ----------------------------------------------------------------------
# the front end: the &tpu keys that pick the branch, and the reference's
# own N=48 example end to end
# ----------------------------------------------------------------------

def _sample_input(tmp_path, tpu_lines):
    """runs/n216_sample/ice.input (the reference's N=48 example) with a
    &tpu namelist appended."""
    import os
    import shutil

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path / "ice.input"
    shutil.copy(os.path.join(repo, "runs", "n216_sample", "ice.input"), path)
    with open(path, "a") as f:
        f.write("\n&tpu\n" + "\n".join(tpu_lines) + "\n/\n")
    return str(path)


@pytest.mark.parametrize("tpu, nwater, kernel, n_shifts", [
    (["stack = 1, 2, 6"], 48, "fused_cycle_dense", 3),
    (["stack = 3, 3, 6", "nbr_table = 'off'"], 216, "fused_cycle_dense", 1),
    (["stack = 3, 3, 6", "dense_trials = 8"], 216, "fused_cycle_multi", 1),
], ids=["n48", "n216_off", "n216_dense_trials"])
def test_tpu_keys_reach_the_engine(tmp_path, tpu, nwater, kernel, n_shifts):
    from mc_water_ls_mw_tpu_torch.app import Application
    from mc_water_ls_mw_tpu_torch.io.namelist import read_input

    # nwater belongs to &config, which the example sets to 48
    prm = read_input(_sample_input(tmp_path, tpu + [
        "n_walkers = 2", "dtype = 'float64'"]),
        extra_overrides={"nwater": nwater})
    app = Application(prm, workdir=str(tmp_path), device="cpu")
    try:
        app.setup()
        eng = app.engine
        assert eng.fused_cycle.kernel == kernel
        assert len(eng.fold_shifts) == n_shifts
        assert app.state.r.shape[2] == nwater
        assert eng.dT == prm.dense_trials == (8 if "multi" in kernel else 1)
        assert (eng.tbl is None) == ("dense" in kernel)
    finally:
        app.close()


def test_n48_example_runs_and_resumes(tmp_path):
    """The reference's N=48 example through run_input_file: WL
    generation with volume moves, delta-syncs, a chain resync,
    monitor_stats with eq_adjust_mc, check_flatness and checkpoints of a
    state without tables, then a second call resumed from the
    checkpoint."""
    import os

    from mc_water_ls_mw_tpu_torch.app import run_input_file

    path = _sample_input(tmp_path, ["stack = 1, 2, 6"])
    over = dict(n_walkers=2, dtype="float64", eq_mc_cycles=4, monitor_int=2,
                flat_chk_int=4, file_output_int=2, chkpt_dump_int=2,
                mpi_sync_int=2, latt_sync_int=4, mc_vol_prob=0.05)
    cwd = os.getcwd()
    try:
        s = run_input_file(path, overrides=over, max_cycles=4, device="cpu")
        assert s.cycle == 4
        s = run_input_file(path, overrides=over, max_cycles=2, device="cpu")
    finally:
        os.chdir(cwd)
    assert s.cycle == 6
    node = (tmp_path / "node000.log").read_text()
    glog = (tmp_path / "mc.log").read_text()
    for text in ("# Restarting from cycle 4 (", "# Max molecule translation",
                 "# Checking flatness of histogram at cycle"):
        assert text in node + glog, text
    # volume-move attempts of the monitored cycles
    assert sum(int(ln.split()[5]) for ln in node.splitlines()
               if ln.endswith(" box moves")) > 0
    assert {"checkpoint000.npz.1", "checkpoint000.npz.2", "eta_weights.dat",
            "histogram.dat", "ice000_therm.dat", "mW.dcd"} <= set(
                os.listdir(tmp_path))
    rows = np.loadtxt(tmp_path / "ice000_therm.dat")
    assert rows[:, 0].tolist() == [2, 4, 6]
    assert np.isfinite(s.energy.numpy()).all()
