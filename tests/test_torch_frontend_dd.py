"""The port's front end in the 'dd' mu-window decomposition, against the
JAX package's, on the CPU in float64.

* a checkpoint of a 'dd' state (master rows [nwin, B], window ids,
  bounds and membership) written by either package loads in the other,
  for a dense N=216 state and a cell N=8064 state;
* ``run_input_file`` on runs/n216_sample_dd/ice.input (parallel_strategy
  = 'dd' in its namelist; stack (3,3,6), 4 walkers over 2 windows, a few
  cycles across eq_mc_cycles) in Wang-Landau generation: the JAX app's
  set of files, among them the per-window curves and the stitched
  eta_weights.dat, the per-window monitor rows, the same "Computed
  energies" line; then a resumed call; then a sample phase started from
  each app's generation checkpoint: the port recomputes the JAX
  package's log_unbiased_norm of its checkpoint's stitched weights, and
  both write the same set of files, among them the per-window dumps
  ``uhist_windows_<cycle>.dat`` and ``hist_windows_<cycle>.dat``, which
  scripts/deltag_error.py --dd reads.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from mc_water_ls_mw_tpu import app as japp
from mc_water_ls_mw_tpu.io.namelist import read_input as jread_input
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.cellengine import (
    init_cell_state as jinit_cell_state,
)
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.state import (
    compute_log_unbiased_norm as jcompute_log_unbiased_norm,
    init_state as jinit_state,
)
from mc_water_ls_mw_tpu.parallel.windows import join_eta as jjoin_eta
from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch.io import checkpoint as tckpt
from mc_water_ls_mw_tpu_torch.mcmc.state import state_from_numpy
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_cells import build_grids, cell_run_params, to_port
from .test_torch_frontend import REPO, _cross_load, _line
from .test_torch_state import jax_state_fields, small_run_params

DD_OVERRIDES = dict(
    stack=(3, 3, 6), n_walkers=4, n_windows=2, dtype="float64", nbins=21,
    mu_min=-400.0, mu_max=400.0, eq_mc_cycles=2, mpi_sync_int=1,
    list_update_int=2, file_output_int=1, monitor_int=2, flat_chk_int=2,
    chkpt_dump_int=2, traj_output_int=2, therm_walkers=2, mc_vol_prob=0.02,
    deltaG_int=2, fused="off",
)


def _int32(window_id):
    """The JAX package's window ids in its layout without x64 (int32, as
    the port keeps them): with x64 on, as in these tests, its 'dd'
    initialisers leave numpy's int64, and the checkpoint fingerprints of
    the two layouts differ."""
    return window_id.astype(jnp.int32)


def test_dd_dense_checkpoint_cross_loads(tmp_path):
    kw = small_run_params(n_walkers=6, parallel_strategy="dd", n_windows=3)
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(21, -400.0, 400.0)
    js, _ = jinit_state(RunParams(**kw), MW, r0, H0, jgrid,
                        weight0=np.linspace(0.0, 2.0, 21), n_windows=3)
    rng = np.random.default_rng(1)
    js = js._replace(
        cycle=jnp.asarray(9, jnp.int32), window_id=_int32(js.window_id),
        in_window=jnp.asarray([True, False, True, True, False, False]),
        master_hist=type(js.master_hist)(
            jnp.asarray(rng.uniform(size=(3, 21))),
            jnp.asarray(rng.uniform(size=(3, 21)) * 1e-9)))
    ts, _ = state_from_numpy(jax_state_fields(js), {
        "shifts": np.zeros((1, 3)), "ref_h": H0, "ref_enthalpy": [0, 0],
        "log_unbiased_norm": 0.0}, device="cpu")
    got = _cross_load(js, ts, tmp_path)
    assert got.master_eta.hi.shape == (3, 21)
    assert got.window_id.tolist() == [0, 1, 2, 0, 1, 2]
    assert got.in_window.tolist() == [True, False, True, True, False, False]


def test_dd_cell_checkpoint_cross_loads(tmp_path):
    kw = cell_run_params(parallel_strategy="dd", n_windows=2)
    r0, H0, _, jcg, _ = build_grids()
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"],
                                 dtype=jnp.float64)
    js, jaux, jcaux = jinit_cell_state(RunParams(**kw, fused="off"), MW, r0,
                                       H0, jgrid, jcg, n_windows=2)
    js = js._replace(cycle=jnp.asarray(40, jnp.int32),
                     window_id=_int32(js.window_id))
    ts, _, _ = to_port(js, jaux, jcaux)
    got = _cross_load(js, ts, tmp_path)
    assert type(got).__name__ == "CellState"
    assert got.master_uhist.hi.shape == (2, 201)
    assert got.window_id.tolist() == [0, 1]


def _run(run, d, over, max_cycles, **kw):
    cwd = os.getcwd()
    try:
        return run(str(d / "ice.input"), overrides=over,
                   max_cycles=max_cycles, **kw)
    finally:
        os.chdir(cwd)


def _files(d):
    # the liveness heartbeat among them (both apps write it)
    return set(os.listdir(d))


def test_dd_app_matches_jax_resumes_and_samples(tmp_path):
    src = os.path.join(REPO, "runs", "n216_sample_dd", "ice.input")
    jd, td = tmp_path / "jax", tmp_path / "port"
    for d in (jd, td):
        d.mkdir()
        shutil.copy(src, d / "ice.input")
    _run(japp.run_input_file, jd, DD_OVERRIDES, 4, use_mesh=False)
    s = _run(tapp.run_input_file, td, DD_OVERRIDES, 4, device="cpu")
    assert s.master_eta.hi.shape == (2, 21) and s.in_window.all()
    per_window = {f"{k}_{w:03d}.dat" for w in range(2)
                  for k in ("eta_weights", "histogram",
                            "unbiased_histogram")}
    assert _files(td) == _files(jd)
    assert per_window | {"eta_weights.dat", "checkpoint000.npz.1",
                         "checkpoint000.npz.2", "mc.log",
                         "node000.log"} <= _files(td)
    assert "histogram.dat" not in _files(td)
    for start in ("# Computed energies", "# Computed enthalpies",
                  "# Monte-Carlo statistics", "# window  walkers"):
        assert _line(td / "node000.log", start) == \
            _line(jd / "node000.log", start), start
    assert len(_line(td / "node000.log", "# win   1")) == 2
    # the stitched curve: the windows' rows joined over their overlap
    # and re-zeroed at the central bin; WL grew it
    tw = np.loadtxt(td / "eta_weights.dat", skiprows=1)
    assert tw.shape == (21, 2) and tw[10, 1] == 0.0
    assert np.abs(tw[:, 1]).max() > 0

    # keep the generation checkpoint of cycle 4 for the sample phase
    gen = tmp_path / "port_gen"
    gen.mkdir()
    for name in ("checkpoint000.npz.1", "checkpoint000.npz.2"):
        shutil.copy(td / name, gen / name)

    # resume: a second call continues from the checkpoint's cycle
    s6 = _run(tapp.run_input_file, td, DD_OVERRIDES, 2, device="cpu")
    assert s6.cycle == 6
    assert _line(td / "node000.log", "# Restarting from cycle 4 (")

    # a sample phase from each app's generation checkpoint of cycle 4
    # (f > 0): 4 cycles with a Delta G dump each
    sample = {**DD_OVERRIDES, "samplerun": True, "deltaG_int": 1}
    js_d, ts_d = tmp_path / "jax_sample", tmp_path / "port_sample"
    for d, ck in ((js_d, jd), (ts_d, gen)):
        d.mkdir()
        shutil.copy(src, d / "ice.input")
        for name in ("checkpoint000.npz.1", "checkpoint000.npz.2"):
            shutil.copy(ck / name, d / name)
    _run(japp.run_input_file, js_d, sample, 4, use_mesh=False)
    s = _run(tapp.run_input_file, ts_d, sample, 4, device="cpu")
    assert s.cycle == 8 and float(s.f.max()) == 0.0
    assert _files(ts_d) == _files(js_d)
    dumps = {f"{k}_{c:010d}.dat" for c in range(5, 9)
             for k in ("uhist_windows", "hist_windows",
                       "unbiased_histogram")}
    assert dumps | {"unbiased_histogram.dat"} <= _files(ts_d)
    u = np.loadtxt(ts_d / "uhist_windows_0000000008.dat", comments="#")
    assert u.shape == (21, 3) and (u[:, 1:].sum(axis=0) > 0).all()
    h = np.loadtxt(ts_d / "hist_windows_0000000008.dat", comments="#")
    assert h.shape == (21, 5)
    # the norm the port recomputed is the JAX package's of the same
    # checkpoint's stitched weights
    norm = _line(ts_d / "node000.log", "# Recomputed log_unbiased_norm")
    assert len(norm) == 1
    loaded = tckpt.load_checkpoint(s6, str(gen))[0]
    jprm = jread_input(str(ts_d / "ice.input"), extra_overrides={
        **sample, "nwater": 216})
    jgrid = jbins.build_bin_grid(jprm.nbins, jprm.mu_min, jprm.mu_max,
                                 dtype=jnp.float64)
    want = jcompute_log_unbiased_norm(
        jprm, jgrid, jjoin_eta(ds_value64(loaded.master_eta), 21, 2), 4)
    assert norm[0].split("=")[1].split()[0] == f"{want:.3f}"
    # scripts/deltag_error.py --dd reads the port's per-window dumps
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "deltag_error.py"),
         str(ts_d), "--nwater", "216", "--mu-min", "-400", "--mu-max",
         "400", "--dd", "--overlap", "2", "--skip-blocks", "0"],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "blocks used: 3" in out.stdout, out.stdout
