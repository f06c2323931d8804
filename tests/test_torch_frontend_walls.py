"""Round 5's N=8064 pipeline through the port's front end, against the
JAX package's, on the CPU in float64.

``runs/n8064_wl2/ice.input`` with its ``run.py`` overrides shrunk to a
test (two walkers over two 'dd' windows, T=2, the volume wall at 0.2 and
a displacement wall of 1 Bohr, intervals cut to a cycle or two, a cycle
cut to one sweep of the (colour, block) tables in both packages' cell
engines), called as ``run.py`` calls it (``jit_chunk=20``,
``use_mesh=True``): the JAX app's set of files and the same "Computed
energies" line; a resumed call; then ``runs/n8064_sample2``'s sample
phase (T=1, the wall, ``samplerun``) from each app's generation
checkpoint through the gen -> sample restart, the same files again;
and the sample phase's checkpoints cross-loaded both ways.
"""

import os
import shutil

import numpy as np
import pytest
import jax.numpy as jnp

from mc_water_ls_mw_tpu import app as japp
from mc_water_ls_mw_tpu.mcmc import cellengine as jcellengine

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch.mcmc import cellengine as tcellengine
from mc_water_ls_mw_tpu_torch.models.stacking import stacking_switch_pair

from .test_torch_frontend import REPO, _cross_load, _line
from .test_torch_frontend_dd import _files, _int32, _run
from .test_torch_trans_wall import max_disp

WL2 = dict(
    stack=(14, 8, 18), n_walkers=2, parallel_strategy="dd", n_windows=2,
    window_overlap=2, mu_min=-27000.0, mu_max=27000.0, nbins=201,
    cell_trials=2, mc_max_trans=0.10, mc_dv_max=0.2, mc_vol_wall=0.2,
    cell_trans_wall=1.0, eq_adjust_mc=True, wl_factor=0.005 * 16.0 / 128,
    eq_mc_cycles=2, list_update_int=2, mpi_sync_int=1, monitor_int=2,
    flat_chk_int=2, wl_minhist=5, file_output_int=1, therm_walkers=2,
    traj_output_int=100_000_000, chkpt_dump_int=1, mc_vol_prob=1.0 / 1024,
    dtype="float64",
)
SAMPLE2 = {**WL2, "samplerun": True, "cell_trials": 1,
           "eq_adjust_mc": False, "deltaG_int": 1}
CALL = dict(jit_chunk=20, use_mesh=True)


class _JCut(jcellengine.CellEngine):
    """The JAX cell engine with a cycle cut to one sweep."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.sweeps_per_cycle = 1
        self.trials_per_cycle = self.n_tables * self.K * self.T


class _TCut(tcellengine.CellEngine):
    """The port's cell engine with a cycle cut to one sweep."""

    def _init_layout(self):
        super()._init_layout()
        self.sweeps_per_cycle = 1
        self.trials_per_cycle = self.n_tables * self.K * self.T


@pytest.fixture
def cut_cycles(monkeypatch):
    monkeypatch.setattr(jcellengine, "CellEngine", _JCut)
    monkeypatch.setattr(tcellengine, "CellEngine", _TCut)


def test_wl2_to_sample2_matches_jax(tmp_path, cut_cycles):
    src = os.path.join(REPO, "runs", "n8064_wl2", "ice.input")
    jd, td = tmp_path / "jax", tmp_path / "port"
    for d in (jd, td):
        d.mkdir()
        shutil.copy(src, d / "ice.input")
    _run(japp.run_input_file, jd, WL2, 2, **CALL)
    s = _run(tapp.run_input_file, td, WL2, 2, device="cpu", **CALL)
    assert isinstance(s, tcellengine.CellState) and s.cycle == 2
    assert s.master_eta.hi.shape == (2, 201)
    assert _files(td) == _files(jd)
    for start in ("# Computed energies", "# Computed enthalpies",
                  "# Large-N cell engine"):
        assert _line(td / "node000.log", start) + _line(td / "mc.log",
                                                        start) == \
            _line(jd / "node000.log", start) + _line(jd / "mc.log",
                                                     start), start
    gen = tmp_path / "port_gen"
    gen.mkdir()
    for name in ("checkpoint000.npz.1", "checkpoint000.npz.2"):
        shutil.copy(td / name, gen / name)

    # resume: a second call continues from the checkpoint's cycle
    s3 = _run(tapp.run_input_file, td, WL2, 1, device="cpu", **CALL)
    assert s3.cycle == 3
    assert _line(td / "node000.log", "# Restarting from cycle 2 (")

    # runs/n8064_sample2: the two checkpoint slots and nothing else
    js_d, ts_d = tmp_path / "jax_sample", tmp_path / "port_sample"
    for d, ck in ((js_d, jd), (ts_d, gen)):
        d.mkdir()
        shutil.copy(os.path.join(REPO, "runs", "n8064_sample2",
                                 "ice.input"), d / "ice.input")
        for name in ("checkpoint000.npz.1", "checkpoint000.npz.2"):
            shutil.copy(ck / name, d / name)
    jfin = _run(japp.run_input_file, js_d, SAMPLE2, 1, **CALL)
    tfin = _run(tapp.run_input_file, ts_d, SAMPLE2, 1, device="cpu",
                **CALL)
    assert tfin.cycle == 3 and float(tfin.f.max()) == 0.0
    assert _files(ts_d) == _files(js_d)
    assert {"uhist_windows_0000000003.dat", "hist_windows_0000000003.dat",
            "unbiased_histogram_0000000003.dat"} <= _files(ts_d)
    assert _line(ts_d / "node000.log", "# Sample phase from a generation")
    # both walls held: every box within 20% of its reference volume, no
    # molecule beyond 1 Bohr of its lattice-1 reference site
    r0, H0 = stacking_switch_pair(14, 8, 18)
    vref = np.abs(np.linalg.det(H0))[:, None]
    assert (np.abs(tfin.volume.numpy() / vref - 1) <= 0.2).all()
    fref0 = (r0[0] @ np.linalg.inv(H0[0]).T).T
    assert (max_disp(fref0, tfin) <= 1.0).all()

    # the sample phase's checkpoints cross-load both ways
    jfin = jfin._replace(window_id=_int32(jfin.window_id))
    got = _cross_load(jfin, tfin, tmp_path)
    assert type(got).__name__ == "CellState" and got.cycle == 3
    assert jnp.asarray(got.window_id.numpy()).tolist() == [0, 1]
