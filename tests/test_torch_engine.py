"""The PyTorch port's engine against the JAX engine's scan path.

The whole slice on the N=216 switch pair (static neighbour tables,
displacement wall): both engines start from the same state and consume
the same random draws (the port through a stream that reproduces JAX's
threefry draws), over 3 cycles with volume moves, a delta-sync every
cycle and a chain resync every second cycle, in the sample-run and the
WL-generation modes.  The port runs its plain versions (CPU tensors) of
both kernels; float64 throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.engine import Engine as JEngine
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state
from mc_water_ls_mw_tpu.mcmc.wanglandau import (
    compute_deltaG as jcompute_deltaG,
)
from mc_water_ls_mw_tpu.ops.dsfloat import ds_value64 as jds_value64

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine as TEngine
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    state_from_numpy,
    state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.mcmc.wanglandau import (
    compute_deltaG,
    deltaG_from_uhist,
)
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)

N_CYCLES = 3


def _run_both(samplerun):
    kw = small_run_params(samplerun=samplerun)
    r0, H0 = switch_pair_216()
    # a non-trivial warm-start curve, so eta differences matter
    w0 = 0.02 * (np.arange(21) - 10.0) ** 2
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=w0)
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    js, jsamples = jeng.run_cycles(js0, N_CYCLES)

    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts0, taux = state_from_numpy(jax_state_fields(js0), jax_aux_fields(jaux),
                                 device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js0))
    ts, tsamples = teng.run_cycles(ts0, N_CYCLES)
    return dict(jeng=jeng, js=js, jsamples=jsamples, jaux=jaux,
                teng=teng, ts=ts, tsamples=tsamples)


@pytest.fixture(scope="module", params=[True, False],
                ids=["samplerun", "wl_generation"])
def runs(request):
    return request.param, _run_both(request.param)


def test_engine_matches_jax(runs):
    samplerun, r = runs
    jf, tf = jax_state_fields(r["js"]), state_to_numpy(r["ts"])
    assert tf["cycle"] == jf["cycle"] == N_CYCLES
    # the run exercised every path: translations, switches, volume moves
    att = tf["att"]
    assert (att[0] > 0).all() and (att[1] > 0).all() and (att[2] > 0).all()
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    np.testing.assert_allclose(tf["r"], jf["r"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf["ref_r"], jf["ref_r"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf["h"], jf["h"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf["volume"], jf["volume"], rtol=1e-13)
    np.testing.assert_allclose(tf["energy"], jf["energy"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tf["avg_energy"], jf["avg_energy"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tf["moments"], jf["moments"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tf["mu"], jf["mu"], rtol=0, atol=1e-9)
    for name in ("min_dmu", "max_dmu"):
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
    # per-cycle therm samples
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))


class _Logs:
    def __init__(self):
        self.lines = []

    def g(self, msg):
        self.lines.append(msg)

    my = g


def test_deltaG_matches_jax(runs, tmp_path, monkeypatch):
    samplerun, r = runs
    prm = r["teng"].prm
    mine = deltaG_from_uhist(prm, r["teng"].grid,
                             ds_value64(r["ts"].master_uhist)[0])
    if not samplerun:
        # WL generation keeps no unbiased histogram
        assert mine is None
        return
    # the JAX reduction (wanglandau.py:396-418) on the JAX master; it
    # writes its histogram dump into the working directory
    monkeypatch.chdir(tmp_path)
    logs = _Logs()
    jcompute_deltaG(r["jeng"], r["js"], logs, r["jaux"])
    per_mol = [float(x.split("=")[1].split()[0]) for x in logs.lines
               if "kT/molecule" in x][0]
    j_per_mol = [float(x.split("=")[1].split()[0]) for x in logs.lines
                 if "J/mole" in x][0]
    np.testing.assert_allclose(mine["kT_per_mol"], per_mol, rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(mine["J_per_mol"], j_per_mol, rtol=1e-7,
                               atol=1e-7)
    # and the exact value against the JAX master's float64 view
    u = jds_value64(r["js"].master_uhist)[0]
    bw = np.asarray(r["jeng"].grid.binwidth)
    p = u / (u * bw).sum()
    B = len(bw)
    dg = np.log((p[:B // 2] * bw[:B // 2]).sum()
                / (p[B // 2:] * bw[B // 2:]).sum())
    np.testing.assert_allclose(mine["kT"], dg, rtol=1e-10)
    # the logging form writes the same lines and the same dump
    jdump = np.loadtxt(tmp_path / f"unbiased_histogram_{r['ts'].cycle:010d}"
                       ".dat", skiprows=1)
    tlogs = _Logs()
    compute_deltaG(r["teng"], r["ts"].clone(), tlogs, None)
    assert [x.split("=")[0] for x in tlogs.lines] == \
        [x.split("=")[0] for x in logs.lines]
    for a, b in zip(tlogs.lines[1:], logs.lines[1:]):
        np.testing.assert_allclose(float(a.split("=")[1].split()[0]),
                                   float(b.split("=")[1].split()[0]),
                                   rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / f"unbiased_histogram_{r['ts'].cycle:010d}"
                   ".dat", skiprows=1), jdump, rtol=1e-10, atol=0)


@pytest.mark.parametrize("setting", [
    dict(minu=True), dict(wl_swetnam=True),
    dict(wl_useinvt=True), dict(leshift=True), dict(mc_vol_wall=0.05),
    dict(mc_ensemble="nvt"),
])
def test_unported_settings_raise(runs, setting):
    r = runs[1]
    prm = dataclasses.replace(r["teng"].prm, **setting)
    with pytest.raises(NotImplementedError):
        TEngine(prm, TMW, r["teng"].grid, r["teng"].aux, device="cpu")


def test_audit_heals_and_reports_drift(runs):
    r = runs[1]
    s = r["ts"].clone()
    s.energy[:, 0] += 1e-3
    s, drift = r["teng"].audit_energy(s, n_walkers=1)
    assert drift.shape == (2, 1)
    np.testing.assert_allclose(drift.numpy(), 1e-3, rtol=1e-6)
    np.testing.assert_allclose(s.energy.numpy(), r["ts"].energy.numpy(),
                               rtol=0, atol=1e-10)
    torch.testing.assert_close(s.moments, r["ts"].moments, rtol=0,
                               atol=1e-10)
