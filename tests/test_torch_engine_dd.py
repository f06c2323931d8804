"""The PyTorch port's dense engine in the 'dd' mu-window decomposition,
against the JAX engine's scan path.

The N=216 switch pair (static neighbour tables), 8 walkers over 4
windows of the 21-bin grid, float64, a non-trivial warm-start curve:
both engines start from the same state and consume the same random
draws (the port through a stream that reproduces JAX's threefry draws)
over 3 cycles with eq_mc_cycles = 2, so that the run crosses the
equilibration boundary: cycle 1 tracks each walker's window membership
with switches suppressed, cycle 2 is the boundary (membership frozen,
switches on), cycle 3 has every walker in its window and the walls
live.  Volume moves, a delta-sync every cycle and a chain resync every
second cycle fall in the run.  Both sample run and WL generation, each
under both dd_seeding settings.  Then the host events on the dd state:
monitor_stats (per-window rows and curve files, stitched curves),
check_flatness (per-window halving) and compute_deltaG (the stitched
estimate and the per-window dumps), against the JAX package's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc import wanglandau as jwl
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.engine import Engine as JEngine
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc import wanglandau as twl
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine as TEngine
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    init_state as tinit_state,
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
N_WIN = 4
W0 = 0.02 * (np.arange(21) - 10.0) ** 2
CASES = [(True, True), (True, False), (False, True), (False, False)]
IDS = ["samplerun-seeding", "samplerun-reach-once", "wl-seeding",
       "wl-reach-once"]


def dd_params(samplerun, seeding, **over):
    return small_run_params(**{
        **dict(samplerun=samplerun, n_walkers=8, parallel_strategy="dd",
               n_windows=N_WIN, dd_seeding=seeding, eq_mc_cycles=2,
               mpi_sync_int=1, latt_sync_int=2), **over})


def _run_both(samplerun, seeding):
    kw = dd_params(samplerun, seeding)
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=W0,
                            n_windows=N_WIN)
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    # the JAX state after each cycle (window membership is decided at
    # the top of a cycle)
    js_hist, js = [], js0
    for _ in range(N_CYCLES):
        js, _ = jeng.run_cycles(js, 1)
        js_hist.append(js)

    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts0, taux = state_from_numpy(jax_state_fields(js0), jax_aux_fields(jaux),
                                 device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js0))
    ts_hist = []
    for _ in range(N_CYCLES):
        ts, _ = teng.run_cycles(ts0, 1)
        ts_hist.append(ts.clone())
    return dict(jeng=jeng, js=js, js_hist=js_hist, jaux=jaux, js0=js0,
                teng=teng, ts=ts, ts_hist=ts_hist, kw=kw)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def runs(request):
    return request.param, _run_both(*request.param)


def _assert_match(tf, jf):
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped",
                 "in_window", "window_id", "start_bin", "end_bin"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "ref_r", "h"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-12,
                                   err_msg=name)
    for name in ("energy", "moments", "weight", "hist", "uhist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    for name in ("mu", "min_dmu", "max_dmu", "avg_energy"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        assert t64.shape == (N_WIN, 21), name
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-10,
                                   err_msg=name)


def test_dd_engine_matches_jax(runs):
    (samplerun, seeding), r = runs
    for c, (ts, js) in enumerate(zip(r["ts_hist"], r["js_hist"]), 1):
        tf, jf = state_to_numpy(ts), jax_state_fields(js)
        assert tf["cycle"] == jf["cycle"] == c
        _assert_match(tf, jf)
    tf = state_to_numpy(r["ts"])
    att = tf["att"]
    assert (att[0] > 0).all() and (att[1] > 0).all()
    # switches were suppressed in cycle 1 (before eq_mc_cycles): fewer
    # switch attempts than translations under mc_always_switch
    assert (att[2] > 0).all() and (att[2] < att[0]).all()
    # every window's master rows were written
    hist = tf["master_hist"][0].astype(np.float64) + tf["master_hist"][1]
    assert (hist.sum(axis=1) > 0).all()
    if samplerun:
        uh = tf["master_uhist"][0].astype(np.float64) + tf["master_uhist"][1]
        assert (uh > 0).any()


def test_dd_window_tracking(runs):
    """Membership through the boundary: tracked before it (some walkers
    in their windows, some not), all in after it."""
    (_, seeding), r = runs
    inw = [state_to_numpy(ts)["in_window"] for ts in r["ts_hist"]]
    assert inw[0].any() and not inw[0].all()
    assert inw[2].all()
    if not seeding:
        # reach-once: a walker that was in its window stays in
        assert (inw[1] >= inw[0]).all()


def test_dd_switch_gating():
    """Switches are suppressed before the boundary in 'dd' only, and the
    plain step loop of the fused cycle honours the gate: a switch-only
    schedule attempts no switch with the gate shut, every one open."""
    kw = dd_params(True, True, eq_mc_cycles=5)
    r0, H0 = switch_pair_216()
    grid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    s, aux = tinit_state(TRunParams(**kw), TMW, r0, H0, grid, weight0=W0,
                         n_windows=N_WIN, device="cpu")
    eng = TEngine(TRunParams(**kw), TMW, grid, aux, device="cpu")
    assert not eng._switch_ok(4) and eng._switch_ok(5)
    mw = TEngine(TRunParams(**{**kw, "parallel_strategy": "mw"}), TMW,
                 grid, aux, device="cpu")
    assert mw._switch_ok(1)
    codes = torch.full((216,), 2)
    sched = torch.zeros(216, dtype=torch.int64)
    u = torch.rand((216, 7, 8), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    eng.fused_cycle.plain(s, codes, sched, u, False, False)
    assert int(s.att[2].sum()) == 0
    eng.fused_cycle.plain(s, codes, sched, u, False, True)
    assert s.att[2].tolist() == [216] * 8


@pytest.mark.parametrize("seeding", [True, False],
                         ids=["seeding", "reach-once"])
def test_dd_init_state_matches_jax(seeding):
    kw = dd_params(True, seeding)
    r0, H0 = switch_pair_216()
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=W0,
                           n_windows=N_WIN)
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    ts, taux = tinit_state(TRunParams(**kw), TMW, r0, H0, tgrid, weight0=W0,
                           n_windows=N_WIN, device="cpu")
    jf, tf = jax_state_fields(js), state_to_numpy(ts)
    for name in ("ls", "window_id", "start_bin", "end_bin", "in_window"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("my_mu_min", "my_mu_max"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        for a, b in zip(tf[name], jf[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert not tf["in_window"].any()
    assert len(set(tf["ls"].tolist())) == 2
    np.testing.assert_allclose(taux.log_unbiased_norm,
                               jaux.log_unbiased_norm, rtol=1e-14)


# ----------------------------------------------------------------------
# the host events on the dd state
# ----------------------------------------------------------------------

class _Logs:
    def __init__(self):
        self.lines = []

    def g(self, msg):
        self.lines.append(msg)

    my = g


def _numbers(line):
    out = []
    for tok in line.replace("[", " ").replace("]", " ").replace(",", " ") \
            .split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return out


def assert_logs_match(tl, jl):
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        na, nb = _numbers(a), _numbers(b)
        assert len(na) == len(nb), (a, b)
        np.testing.assert_allclose(na, nb, rtol=1e-7, atol=1e-7,
                                   err_msg=f"{a!r} / {b!r}")


def assert_dirs_match(td, jd):
    tfiles, jfiles = sorted(os.listdir(td)), sorted(os.listdir(jd))
    assert tfiles == jfiles
    for name in tfiles:
        with open(os.path.join(td, name)) as f:
            thead = f.readline()
        with open(os.path.join(jd, name)) as f:
            jhead = f.readline()
        ta = np.loadtxt(os.path.join(td, name), ndmin=2, comments="#")
        ja = np.loadtxt(os.path.join(jd, name), ndmin=2, comments="#")
        if thead.startswith("#"):
            assert _numbers(thead)[:1] == pytest.approx(
                _numbers(jhead)[:1], rel=1e-10, abs=1e-12), name
        np.testing.assert_allclose(ta, ja, rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    return tfiles


def _events(fn, pkg, r, path, monkeypatch, prm_over=None):
    """Run the host event ``fn`` of package ``pkg`` ('j' or 't') on a copy
    of the run's final state in ``path``."""
    path.mkdir()
    monkeypatch.chdir(path)
    logs = _Logs()
    eng = r["jeng"] if pkg == "j" else r["teng"]
    state = r["js"] if pkg == "j" else r["ts"].clone()
    prm0 = eng.prm
    if prm_over:
        eng.prm = dataclasses.replace(prm0, **prm_over)
    try:
        if fn == "monitor":
            mod = jwl if pkg == "j" else twl
            out = mod.monitor_stats(eng, state, logs,
                                    r["jaux"] if pkg == "j" else
                                    eng.aux)
        elif fn == "flatness":
            out = (jwl if pkg == "j" else twl).check_flatness(eng, state,
                                                              logs)
        else:
            out = (jwl if pkg == "j" else twl).compute_deltaG(
                eng, state, logs, r["jaux"] if pkg == "j" else eng.aux)
    finally:
        eng.prm = prm0
    return out, logs.lines


def test_dd_monitor_stats_matches_jax(runs, tmp_path, monkeypatch):
    (samplerun, _), r = runs
    js, jl = _events("monitor", "j", r, tmp_path / "j", monkeypatch)
    ts, tl = _events("monitor", "t", r, tmp_path / "t", monkeypatch)
    assert_logs_match(tl, jl)
    assert any(x.startswith("# win   3") for x in tl)
    files = assert_dirs_match(tmp_path / "t", tmp_path / "j")
    want = {f"{k}_{w:03d}.dat" for w in range(N_WIN)
            for k in ("eta_weights", "histogram", "unbiased_histogram")}
    want.add("eta_weights.dat")
    if samplerun:
        want.add("unbiased_histogram.dat")
    assert set(files) == want
    _assert_match(state_to_numpy(ts), jax_state_fields(js))


@pytest.mark.parametrize("over", [
    dict(), dict(wl_minhist=10 ** 9, wl_flattol=100.0)],
    ids=["first-pass", "halving"])
def test_dd_check_flatness_matches_jax(runs, tmp_path, monkeypatch, over):
    (samplerun, _), r = runs
    js, jl = _events("flatness", "j", r, tmp_path / "j", monkeypatch, over)
    ts, tl = _events("flatness", "t", r, tmp_path / "t", monkeypatch, over)
    assert_logs_match(tl, jl)
    assert_dirs_match(tmp_path / "t", tmp_path / "j")
    tf, jf = state_to_numpy(ts), jax_state_fields(js)
    _assert_match(tf, jf)
    for name in ("f", "firstcycle", "histogram_reset"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    if samplerun:
        return
    f0 = state_to_numpy(r["ts"])["f"]
    if over:
        # per-window halving: the windows with visits halve their f,
        # the rest keep it
        halved = tf["f"] < f0
        assert halved.any()
        wid = tf["window_id"]
        for w in range(N_WIN):
            assert len(set(halved[wid == w].tolist())) == 1
        assert os.path.exists(tmp_path / "t" / "wlf.dat")


def test_dd_compute_deltaG_matches_jax(runs, tmp_path, monkeypatch):
    (samplerun, _), r = runs
    js, jl = _events("deltaG", "j", r, tmp_path / "j", monkeypatch)
    ts, tl = _events("deltaG", "t", r, tmp_path / "t", monkeypatch)
    assert_logs_match(tl, jl)
    files = assert_dirs_match(tmp_path / "t", tmp_path / "j")
    if samplerun:
        c = f"{N_CYCLES:010d}"
        assert set(files) == {f"unbiased_histogram_{c}.dat",
                              f"uhist_windows_{c}.dat",
                              f"hist_windows_{c}.dat"}
