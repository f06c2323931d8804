"""The port's front end against the JAX package's: the namelist reader,
the writers, the checkpoints and the app, on the CPU in float64.

* ``read_input`` of every committed ``runs/*/ice.input``, with and
  without the overrides of ``runs/n8064_wl/run.py``, equals the JAX
  reader's field by field;
* every writer's file is byte for byte the JAX writer's for the same
  numbers;
* a checkpoint written by either package loads in the other, for a dense
  N=216 state and a cell N=8064 state (the PRNG keys and the port's
  generator states aside), and a cell checkpoint migrates to a larger
  slab capacity;
* ``run_input_file`` at N=216 (stack (3,3,6), W = 2, a few cycles)
  writes the JAX app's set of files with the same header lines,
  prints the same "Computed energies" line and resumes from its
  checkpoint;
* the CLI parses its flags.

The JAX app tests (tests/test_app.py) need the reference's example
directory; these build their cells with ``stack=`` and need none.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from mc_water_ls_mw_tpu import app as japp
from mc_water_ls_mw_tpu.io import checkpoint as jckpt
from mc_water_ls_mw_tpu.io import writers as jwriters
from mc_water_ls_mw_tpu.io.namelist import read_input as jread_input
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state
from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch import cli as tcli
from mc_water_ls_mw_tpu_torch.io import checkpoint as tckpt
from mc_water_ls_mw_tpu_torch.io import writers as twriters
from mc_water_ls_mw_tpu_torch.io.namelist import read_input as tread_input
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    cell_state_to_numpy,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.engine import PhiloxStream
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    state_from_numpy,
    state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.models.stacking import correspondence_mismatch
from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.ops import cells as tcells
from mc_water_ls_mw_tpu_torch.ops.cells import gather_from_slab

from .test_torch_cells import jax_cell_system, to_port
from .test_torch_state import jax_state_fields, small_run_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs/n8064_wl/run.py's overrides
N8064_WL = chip_smoke.N8064_WL


# ----------------------------------------------------------------------
# the namelist reader
# ----------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [None, N8064_WL],
                         ids=["as_committed", "n8064_wl_overrides"])
def test_read_input_matches_jax(overrides):
    paths = sorted(glob.glob(os.path.join(REPO, "runs", "*", "ice.input")))
    assert len(paths) >= 10
    for path in paths:
        j = jread_input(path, extra_overrides=overrides)
        t = tread_input(path, extra_overrides=overrides)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), path


def test_read_input_rejects_what_jax_rejects(tmp_path):
    p = tmp_path / "bad.input"
    p.write_text("&thermal\ntemperature = 200\ncolour = 'blue'\n/\n")
    for reader in (jread_input, tread_input):
        with pytest.raises(ValueError, match="unknown key"):
            reader(str(p))


# ----------------------------------------------------------------------
# the writers
# ----------------------------------------------------------------------

def _write_all(w, d, rng_seed=3):
    """Every writer of module ``w`` into directory ``d``."""
    rng = np.random.default_rng(rng_seed)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        mub = np.linspace(-400, 400, 21)
        w.write_curve("eta_weights.dat", mub, rng.normal(size=21), 0.005)
        w.write_curve("histogram.dat_0.002500000000", mub,
                      rng.uniform(0, 1e6, 21), 0.0025)
        w.append_wlf("wlf.dat", 1000, 0.005, 0.0025)
        w.append_wlf("wlf.dat", 2000, 0.0025)
        for samplerun, L in ((True, 2), (False, 2), (False, 1)):
            tw = w.ThermWriter(f"ice{L}{int(samplerun)}", range(2), 216)
            for c in (50, 100):
                for k in tw.files:
                    tw.write(k, c, -3.2 + rng.normal(), rng.normal(0, 50),
                             rng.uniform(7e4, 8e4, 2), int(rng.integers(2)),
                             L, samplerun)
            tw.close()
        w.write_psf("mW.psf", 216, 2)
        w.write_dcd_header("mW.dcd", 432)
        H = np.diag([35.0, 36.0, 38.0]) + rng.normal(0, 0.1, (3, 3))
        for _ in range(2):
            w.append_dcd_snapshot("mW.dcd", rng.uniform(0, 30, (216, 3)),
                                  rng.uniform(0, 30, (216, 3)), H)
        w.write_history_header("HISTORY", 216, 2)
        w.append_history("HISTORY", 7, rng.uniform(0, 30, (216, 3)),
                         rng.uniform(0, 30, (216, 3)), H)
        return w.read_eta_weights("eta_weights.dat")
    finally:
        os.chdir(cwd)


def test_writers_byte_identical(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jf, jw = _write_all(jwriters, tmp_path / "j")
    tf, tw = _write_all(twriters, tmp_path / "t")
    assert jf == tf == 0.005
    np.testing.assert_array_equal(tw, jw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 12
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def _assert_same_fields(a: dict, b: dict):
    assert set(a) == set(b)
    for name in a:
        if isinstance(a[name], tuple):
            for x, y in zip(a[name], b[name]):
                np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a[name]),
                                          np.asarray(b[name]), err_msg=name)


def _cross_load(js, ts, tmp_path):
    """A checkpoint of the JAX state ``js`` loaded by the port into the
    template ``ts``, written back by the port and loaded by the JAX
    package; returns the port's loaded state."""
    jdir, tdir = tmp_path / "from_jax", tmp_path / "from_port"
    jdir.mkdir()
    tdir.mkdir()
    # the fingerprints agree
    assert tckpt.state_fingerprint(ts) == jckpt.state_fingerprint(js)

    # JAX -> port: the port re-seeds its streams from (seed, cycle)
    jckpt.CheckpointWriter(str(jdir)).write(js)
    stream = PhiloxStream(11, "cpu")
    fresh = PhiloxStream(11, "cpu")
    fresh.reseed(int(js.cycle))
    got, cycle, path = tckpt.load_checkpoint(ts, str(jdir), stream=stream)
    assert cycle == int(js.cycle) and path.endswith("checkpoint000.npz.1")
    assert torch.equal(stream.sched.get_state(), fresh.sched.get_state())
    assert torch.equal(stream.walk.get_state(), fresh.walk.get_state())
    _assert_same_fields(state_to_numpy(got), jax_state_fields(js))

    # port -> JAX: the JAX loader takes the port's file; the port's own
    # generator states travel beside it and come back on a port load
    stream.walk.manual_seed(5)
    w = tckpt.CheckpointWriter(str(tdir), seed=11)
    w.write(got, stream=stream)
    jgot, jcycle, _ = jckpt.load_checkpoint(js, str(tdir))
    assert jcycle == cycle
    _assert_same_fields(jax_state_fields(jgot), jax_state_fields(js))
    assert jgot.key.shape == js.key.shape and jgot.key.dtype == js.key.dtype
    back = PhiloxStream(11, "cpu")
    tckpt.load_checkpoint(ts, str(tdir), stream=back)
    assert torch.equal(back.walk.get_state(), stream.walk.get_state())
    return got


def test_dense_checkpoint_cross_loads(tmp_path):
    kw = small_run_params()
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(21, -400.0, 400.0)
    js, _ = jinit_state(RunParams(**kw), MW, r0, H0, jgrid)
    rng = np.random.default_rng(0)
    js = js._replace(cycle=jnp.asarray(17, jnp.int32),
                     mu=js.mu + jnp.asarray(rng.normal(size=2)),
                     att=js.att + 3)
    ts, _ = state_from_numpy(jax_state_fields(js), {
        "shifts": np.zeros((1, 3)), "ref_h": H0, "ref_enthalpy": [0, 0],
        "log_unbiased_norm": 0.0}, device="cpu")
    ts.mu.zero_()                       # the template's values are not read
    got = _cross_load(js, ts, tmp_path)
    assert got.cycle == 17 and type(got).__name__ == "SamplerState"
    # a template of another layout is refused, not mis-loaded
    other, _ = state_from_numpy(
        {**jax_state_fields(js),
         "trans_per_mol": np.zeros((216, 3), np.int32)}, {
            "shifts": np.zeros((1, 3)), "ref_h": H0,
            "ref_enthalpy": [0, 0], "log_unbiased_norm": 0.0},
        device="cpu")
    with pytest.raises(RuntimeError, match="incompatible"):
        tckpt.load_checkpoint(other, str(tmp_path / "from_port"))
    # two slots written alternately; a torn newer slot leaves the older
    d = tmp_path / "torn"
    d.mkdir()
    w = tckpt.CheckpointWriter(str(d), background=True)
    w.write(got)
    got.cycle = 18
    path2 = w.write(got)
    w.wait()
    assert tckpt.load_checkpoint(got, str(d))[1] == 18
    with open(path2, "r+b") as fh:
        fh.truncate(100)
    assert tckpt.load_checkpoint(got, str(d))[1] == 17


@pytest.fixture(scope="module")
def cell_system():
    return jax_cell_system()


def test_cell_checkpoint_cross_loads(cell_system, tmp_path):
    js = cell_system["jst"]._replace(cycle=jnp.asarray(250, jnp.int32))
    ts, _, _ = to_port(js, cell_system["jaux"], cell_system["jcaux"])
    got = _cross_load(js, ts, tmp_path)
    assert type(got).__name__ == "CellState" and got.cycle == 250


def test_cell_checkpoint_migrates_to_larger_cap(cell_system, tmp_path):
    """A checkpoint of slab capacity cap loads into a cap + 4 layout
    with every molecule's position, moments and cell kept."""
    ts, _, _ = to_port(cell_system["jst"], cell_system["jaux"],
                       cell_system["jcaux"])
    tckpt.CheckpointWriter(str(tmp_path)).write(ts)
    cg = cell_system["tcg"]
    mismatch, _ = correspondence_mismatch(cell_system["r0"],
                                          cell_system["H0"])
    big = tcells.build_grid(cg.n, cg.cap + 4, cell_system["H0"], TMW,
                            mismatch, m=cg.m)
    prm = TRunParams(**cell_system["kw"])
    tmpl, _, _ = init_cell_state(prm, TMW, cell_system["r0"],
                                 cell_system["H0"], cell_system["tgrid"],
                                 big, device="cpu")
    with pytest.raises(RuntimeError, match="incompatible"):
        tckpt.load_checkpoint(tmpl, str(tmp_path))
    got, cycle, path = tckpt.load_checkpoint(
        tmpl, str(tmp_path), cell_migrate=(big.nfine, big.cap))
    assert f"migrated {cg.cap} -> {big.cap}" in path
    assert got.r.shape[2] == big.nslot
    np.testing.assert_array_equal(
        gather_from_slab(got.r, got.mol2slot).numpy(),
        gather_from_slab(ts.r, ts.mol2slot).numpy())
    np.testing.assert_array_equal(
        gather_from_slab(got.moments, got.mol2slot).numpy(),
        gather_from_slab(ts.moments, ts.mol2slot).numpy())
    np.testing.assert_array_equal((got.mol2slot // big.cap).numpy(),
                                  (ts.mol2slot // cg.cap).numpy())
    assert int((got.slot2mol >= 0).sum()) == int((ts.slot2mol >= 0).sum())
    f = cell_state_to_numpy(got)
    np.testing.assert_array_equal(f["energy"], ts.energy.numpy())


# ----------------------------------------------------------------------
# the app
# ----------------------------------------------------------------------

APP_OVERRIDES = dict(
    stack=(3, 3, 6), n_walkers=2, dtype="float64", nbins=21,
    mu_min=-400.0, mu_max=400.0, eq_mc_cycles=2, mpi_sync_int=1,
    list_update_int=2, file_output_int=1, monitor_int=2, flat_chk_int=2,
    chkpt_dump_int=2, traj_output_int=2, therm_walkers=2, mc_vol_prob=0.02,
    fused="off",
)


def _run_app(run, tmp_path, name, **kw):
    d = tmp_path / name
    d.mkdir()
    src = os.path.join(REPO, "runs", "n216_wl", "ice.input")
    (d / "ice.input").write_text(open(src).read())
    cwd = os.getcwd()
    try:
        run(str(d / "ice.input"), overrides=APP_OVERRIDES, max_cycles=4,
            **kw)
    finally:
        os.chdir(cwd)
    return d


def _line(path, start):
    return [ln for ln in open(path) if ln.startswith(start)]


def test_app_matches_jax_and_resumes(tmp_path):
    jd = _run_app(japp.run_input_file, tmp_path, "jax", use_mesh=False)
    td = _run_app(tapp.run_input_file, tmp_path, "port", device="cpu")
    # the JAX app's set of files (its liveness heartbeat aside: the
    # wedge guard is not ported)
    jfiles = set(os.listdir(jd)) - {"heartbeat"}
    assert set(os.listdir(td)) == jfiles
    assert {"mc.log", "node000.log", "mW.psf", "mW.dcd", "ice000_therm.dat",
            "ice001_therm.dat", "eta_weights.dat", "histogram.dat",
            "unbiased_histogram.dat", "checkpoint000.npz.1",
            "checkpoint000.npz.2"} <= jfiles
    # the float64 physics line and the monitor's report lines
    for start in ("# Computed energies", "# Computed enthalpies",
                  "# Monte-Carlo statistics"):
        assert _line(td / "node000.log", start) == \
            _line(jd / "node000.log", start), start
    assert _line(td / "mc.log", "# Built stacking pair") == \
        _line(jd / "mc.log", "# Built stacking pair")
    for name in ("mW.psf",):
        assert (td / name).read_bytes() == (jd / name).read_bytes()
    # therm rows: one per cycle and walker, cycles 1..4
    rows = np.loadtxt(td / "ice000_therm.dat")
    assert rows.shape[0] == 4 and rows[:, 0].tolist() == [1, 2, 3, 4]
    # the curve dumps: the JAX layout, the weights grew (WL is live)
    jw, tw = (np.loadtxt(d / "eta_weights.dat", skiprows=1)
              for d in (jd, td))
    np.testing.assert_array_equal(tw[:, 0], jw[:, 0])
    assert np.abs(tw[:, 1]).max() > 0

    # resume: a second call continues from the checkpoint's cycle
    cwd = os.getcwd()
    try:
        s = tapp.run_input_file(str(td / "ice.input"),
                                overrides=APP_OVERRIDES, max_cycles=2,
                                device="cpu")
    finally:
        os.chdir(cwd)
    assert s.cycle == 6
    assert _line(td / "node000.log", "# Restarting from cycle 4 (")
    rows = np.loadtxt(td / "ice000_therm.dat")
    assert rows[:, 0].tolist() == [1, 2, 3, 4, 5, 6]
    # and the port's checkpoint loads in the JAX package
    jprm = jread_input(str(td / "ice.input"), extra_overrides={
        **APP_OVERRIDES, "nwater": 216})
    jgrid = jbins.build_bin_grid(jprm.nbins, jprm.mu_min, jprm.mu_max,
                                 dtype=jnp.float64)
    from mc_water_ls_mw_tpu.models.stacking import stacking_switch_pair
    r0, H0 = stacking_switch_pair(3, 3, 6)
    tmpl, _ = jinit_state(jprm, MW, r0, H0, jgrid)
    jgot, jcycle, _ = jckpt.load_checkpoint(tmpl, str(td))
    assert jcycle == 6 and np.isfinite(np.asarray(jgot.energy)).all()


def test_cli_parses_flags(monkeypatch):
    a = tcli.parse_args(["ice.input", "--walkers", "8", "--max-cycles", "3",
                         "--dtype", "float64", "--device", "cpu", "--seed",
                         "9", "--profile-dir", "prof"])
    assert (a.input, a.walkers, a.max_cycles, a.dtype, a.device, a.seed,
            a.profile_dir) == ("ice.input", 8, 3, "float64", "cpu", 9,
                               "prof")
    assert tcli.parse_args(["x.input"]).device == "cuda"
    with pytest.raises(SystemExit):
        tcli.parse_args(["x.input", "--device", "tpu"])
    seen = {}
    monkeypatch.setattr(tapp, "run_input_file",
                        lambda path, **kw: seen.update(path=path, **kw))
    assert tcli.main(["ice.input", "--walkers", "8", "--device", "cpu"]) == 0
    assert seen == {"path": "ice.input", "overrides": {"n_walkers": 8},
                    "max_cycles": None, "profile_dir": None,
                    "device": "cpu"}
