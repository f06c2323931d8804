"""The port's front end against the JAX package's under the settings
beyond the plain two-lattice run, on the CPU in float64:

* the single-box NPT run (``num_lattices=1``: one Ih cell of the N=216
  stacking pair) of ``runs/n216_wl/ice.input`` through both apps: the
  same files and physics lines, resumed from the port's checkpoint,
  which loads in the JAX package;
* a 1/t Wang-Landau generation (``wl_useinvt``) of the same input
  through both apps: the switch to 1/t at the first flatness check, the
  f history and the cycle-tagged curves of both, resumed with every
  walker on 1/t;
* checkpoints of one lattice, and of the 1/t and Swetnam schedules'
  state (``invt_active``, ``sumhist``), cross-loaded both ways;
* ``compute_deltaG`` under leshift against the JAX package's.
"""

import os

import numpy as np
import jax.numpy as jnp

from mc_water_ls_mw_tpu import app as japp
from mc_water_ls_mw_tpu.io import checkpoint as jckpt
from mc_water_ls_mw_tpu.io.namelist import read_input as jread_input
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.engine import Engine as JEngine
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state
from mc_water_ls_mw_tpu.mcmc.wanglandau import (
    compute_deltaG as jcompute_deltaG,
)
from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.stacking import stacking_cell
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.ops.dsfloat import ds_from64 as jds_from64

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine as TEngine
from mc_water_ls_mw_tpu_torch.mcmc.state import state_from_numpy
from mc_water_ls_mw_tpu_torch.mcmc.wanglandau import (
    compute_deltaG,
    deltaG_from_uhist,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW

from .test_torch_engine import _Logs
from .test_torch_frontend import _cross_load, _line
from .test_torch_state import jax_aux_fields, jax_state_fields, small_run_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "runs", "n216_wl", "ice.input")

# runs/n216_wl/ice.input at test size: two walkers, float64, intervals
# of two cycles
SMALL = dict(
    stack=(3, 3, 6), n_walkers=2, dtype="float64", eq_mc_cycles=2,
    mpi_sync_int=1, list_update_int=2, file_output_int=1, monitor_int=2,
    flat_chk_int=2, chkpt_dump_int=2, traj_output_int=2, therm_walkers=2,
    mc_vol_prob=0.02, fused="off",
)
SINGLE = dict(SMALL, num_lattices=1)
# the 1/t run: the first flatness check (cycle 2) finds f below
# B / (2 N) and switches every walker to 1/t; the 1/t dumps every 2
# cycles
INVT = dict(SMALL, wl_useinvt=True, wl_factor=1e-4, nbins=21,
            mu_min=-400.0, mu_max=400.0, invt_dump_int=2)


def _run(run, d, over, max_cycles, **kw):
    cwd = os.getcwd()
    try:
        return run(str(d / "ice.input"), overrides=over,
                   max_cycles=max_cycles, **kw)
    finally:
        os.chdir(cwd)


def _apps(tmp_path, over, max_cycles):
    """Both apps on a copy of runs/n216_wl/ice.input each; returns
    (JAX directory, port directory, the port's final state)."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    for d in (jd, td):
        d.mkdir()
        (d / "ice.input").write_text(open(SRC).read())
    _run(japp.run_input_file, jd, over, max_cycles, use_mesh=False)
    s = _run(tapp.run_input_file, td, over, max_cycles, device="cpu")
    return jd, td, s


def _files(d):
    # the liveness heartbeat among them (both apps write it)
    return set(os.listdir(d))


def _jax_template(d, over):
    """A JAX state of the run in ``d`` (its input and overrides), the
    template its checkpoints load into."""
    jprm = jread_input(str(d / "ice.input"), extra_overrides={
        **over, "nwater": 216})
    jgrid = jbins.build_bin_grid(jprm.nbins, jprm.mu_min, jprm.mu_max,
                                 dtype=jnp.float64)
    if jprm.num_lattices == 1:
        r, H = stacking_cell("ABABAB", 3, 3)
        r0, H0 = r[None], H[None]
    else:
        from mc_water_ls_mw_tpu.models.stacking import stacking_switch_pair
        r0, H0 = stacking_switch_pair(3, 3, 6)
    return jinit_state(jprm, MW, r0, H0, jgrid)[0]


def test_single_box_app_matches_jax_and_resumes(tmp_path):
    jd, td, s = _apps(tmp_path, SINGLE, 4)
    assert s.r.shape[0] == 1 and s.cycle == 4
    assert _files(td) == _files(jd)
    assert {"mc.log", "node000.log", "mW.psf", "mW.dcd", "ice000_therm.dat",
            "checkpoint000.npz.1", "checkpoint000.npz.2"} <= _files(td)
    # one lattice keeps no weights or histograms
    assert not {"eta_weights.dat", "histogram.dat"} & _files(td)
    for start in ("# Computed energies", "# Computed enthalpies",
                  "# Monte-Carlo statistics", "# lattice 2"):
        assert _line(td / "node000.log", start) == \
            _line(jd / "node000.log", start), start
    for d in (td, jd):
        node = (d / "node000.log").read_text()
        assert "lattice switches" not in node and "mu   drift" not in node
        assert "box moves" in node and "#  latt 1" in node
    assert (td / "mW.psf").read_bytes() == (jd / "mW.psf").read_bytes()
    # the therm rows of one lattice: cycle, E, V (the JAX layout)
    trows = np.loadtxt(td / "ice000_therm.dat")
    jrows = np.loadtxt(jd / "ice000_therm.dat")
    assert trows.shape == jrows.shape and trows.shape[0] == 4
    assert trows[:, 0].tolist() == [1, 2, 3, 4]
    # no switch, no mu
    assert (s.ls == 0).all() and (s.mu == 0).all() and (s.att[2] == 0).all()

    s6 = _run(tapp.run_input_file, td, SINGLE, 2, device="cpu")
    assert s6.cycle == 6
    assert _line(td / "node000.log", "# Restarting from cycle 4 (")
    jgot, jcycle, _ = jckpt.load_checkpoint(_jax_template(td, SINGLE),
                                            str(td))
    assert jcycle == 6 and np.asarray(jgot.r).shape[0] == 1
    np.testing.assert_array_equal(np.asarray(jgot.energy), s6.energy.numpy())


def test_invt_app_matches_jax_and_resumes(tmp_path):
    jd, td, s = _apps(tmp_path, INVT, 4)
    assert _files(td) == _files(jd)
    tags = [f"{c:020d}" for c in (2, 4)]
    assert {"wlf.dat"} | {f"{n}.dat_{t}" for n in ("eta_weights",
                                                   "histogram")
                          for t in tags} <= _files(td)
    for d in (td, jd):
        assert _line(d / "mc.log", "# Switching to 1/t method")
    # the f history: the cycles of the 1/t dumps, f at most B / (c N)
    twlf, jwlf = (np.loadtxt(d / "wlf.dat", ndmin=2) for d in (td, jd))
    np.testing.assert_array_equal(twlf[:, 0], jwlf[:, 0])
    assert twlf[:, 0].tolist() == [2, 4]
    assert (twlf[:, 1] <= 21 / (twlf[:, 0] * 216) * (1 + 1e-12)).all()
    assert s.invt_active.all()
    assert (s.f.numpy() <= 21 / (4 * 216) * (1 + 1e-12)).all()

    s6 = _run(tapp.run_input_file, td, INVT, 2, device="cpu")
    assert s6.cycle == 6 and s6.invt_active.all()
    assert _line(td / "node000.log", "# Restarting from cycle 4 (")
    assert (s6.f.numpy() <= 21 / (6 * 216) * (1 + 1e-12)).all()
    assert np.loadtxt(td / "wlf.dat", ndmin=2)[:, 0].tolist() == [2, 4, 6]
    jgot, jcycle, _ = jckpt.load_checkpoint(_jax_template(td, INVT),
                                            str(td))
    assert jcycle == 6 and np.asarray(jgot.invt_active).all()
    np.testing.assert_array_equal(np.asarray(jgot.f), s6.f.numpy())


def _state_pair(**over):
    """A JAX initial state of the N=216 pair (one lattice: its first)
    with the run parameters ``over``, and the port's state of it."""
    kw = small_run_params(**over)
    L = kw["num_lattices"]
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(21, -400.0, 400.0)
    js, jaux = jinit_state(RunParams(**kw), MW, r0[:L], H0[:L], jgrid)
    ts, taux = state_from_numpy(jax_state_fields(js), jax_aux_fields(jaux),
                                device="cpu")
    return kw, js, jaux, ts, taux


def test_single_lattice_checkpoint_cross_loads(tmp_path):
    _, js, _, ts, _ = _state_pair(num_lattices=1)
    js = js._replace(cycle=jnp.asarray(9, jnp.int32), att=js.att + 2)
    got = _cross_load(js, ts, tmp_path)
    assert got.cycle == 9 and got.r.shape[0] == 1


def test_schedule_checkpoint_cross_loads(tmp_path):
    """The 1/t and Swetnam schedules' state travels: invt_active set on
    one walker, sumhist and f changed."""
    _, js, _, ts, _ = _state_pair(samplerun=False, wl_useinvt=True)
    js = js._replace(cycle=jnp.asarray(12, jnp.int32),
                     invt_active=jnp.asarray([True, False]),
                     sumhist=jnp.asarray([37.0, 41.0]),
                     f=jnp.asarray([0.004, 0.0025]))
    got = _cross_load(js, ts, tmp_path)
    assert got.invt_active.tolist() == [True, False]
    assert got.sumhist.tolist() == [37.0, 41.0]
    assert got.f.tolist() == [0.004, 0.0025]


def test_compute_deltaG_leshift_matches_jax(tmp_path, monkeypatch):
    """Delta G under leshift: the reference enthalpies' shift
    beta (h_2 - h_1) added back, in the logged lines and the dump."""
    # reference enthalpies of their own (Hartree), so that the shift
    # is not zero
    kw, js, jaux, ts, taux = _state_pair(
        leshift=True, input_ref_enthalpy=(-6.08, -6.07))
    rng = np.random.default_rng(4)
    u = rng.uniform(1.0, 50.0, (1, 21))
    js = js._replace(master_uhist=jds_from64(u))
    ts, _ = state_from_numpy(jax_state_fields(js), jax_aux_fields(jaux),
                             device="cpu")
    jeng = JEngine(RunParams(**kw, fused="off"), MW,
                   jbins.build_bin_grid(21, -400.0, 400.0), jaux)
    teng = TEngine(TRunParams(**kw), TMW,
                   tbins.build_bin_grid(21, -400.0, 400.0), taux,
                   device="cpu")
    monkeypatch.chdir(tmp_path)
    jlogs, tlogs = _Logs(), _Logs()
    jcompute_deltaG(jeng, js, jlogs, jaux)
    jdump = np.loadtxt("unbiased_histogram_0000000000.dat", skiprows=1)
    compute_deltaG(teng, ts, tlogs, taux)
    assert [x.split("=")[0] for x in tlogs.lines] == \
        [x.split("=")[0] for x in jlogs.lines]
    for a, b in zip(tlogs.lines[1:], jlogs.lines[1:]):
        np.testing.assert_allclose(float(a.split("=")[1].split()[0]),
                                   float(b.split("=")[1].split()[0]),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.loadtxt("unbiased_histogram_0000000000.dat", skiprows=1), jdump,
        rtol=1e-12, atol=0)
    # the shift itself: leshift's estimate less the plain one
    rh = taux.ref_enthalpy.numpy()
    plain = deltaG_from_uhist(TRunParams(**{**kw, "leshift": False}),
                              teng.grid, u[0])
    shifted = deltaG_from_uhist(teng.prm, teng.grid, u[0], rh)
    assert rh.tolist() == [-6.08, -6.07]
    np.testing.assert_allclose(shifted["kT"] - plain["kT"],
                               teng.prm.beta * (rh[1] - rh[0]), rtol=1e-9)
