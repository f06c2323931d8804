"""The PyTorch port's cell engine on grids whose same-colour coverage
stencils overlap: the scatter path of the sub-step (``cell_pallas='on'``,
the mover kernel's per-candidate deltas scatter-added into the slab) and
the rule that picks it.

* Against the JAX ``CellEngine`` on the N=6048 (12,7,18) stacking pair
  (coarse 4^3, m = 2, 512 fine cells of 28 slots, 75-cell stencils that
  overlap between same-colour movers), float64, W = 2, the same state and
  the same random draws: a handful of sub-steps through
  ``_substep_canonical`` and a cycle cut to one sweep (64 of its 768
  sub-steps) that opens with a rebin at a random origin and holds a
  volume move and a delta-sync.  The JAX engine runs
  ``cell_pallas='off'`` with ``cell_chain='on'``: the same scatter fed by
  XLA deltas (its own slow test
  ``tests/test_cell_pallas.py::test_pallas_substep_matches_xla_substep``
  holds it equal to 'on'), with the chain kernel in interpret mode.  The
  port resolves ``'auto'`` to 'on' there.

  At the grid origin of the initial state, sites of this crystal lie on
  fine-cell faces, so whether a move from there stays in its fine cell
  (the sub-step's wall) is decided by rounding: the JAX engine's jitted
  and eager sub-steps disagree on one such move of these sub-steps, and
  the port agrees with the eager one.  The sub-steps are therefore held
  against the eager JAX sub-step, and the cycle rebins first, as every
  cycle of a production run with ``list_update_int = 1`` does.
* The port's 'on' against its 'apply' on the disjoint N=8064 grid.
* The mode rule of ``CellEngine._resolve_modes``, case by case (the
  unfused modes' rows among them; test_torch_cellengine_unfused.py holds
  every pair of settings against the JAX engine's resolution).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.ops.cell_kernels import MoverEnergiesKernel
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS, assert_states_match
from .test_torch_cells import JaxCellStream, jax_cell_system, to_port, tt

DIMS = (12, 7, 18)              # N = 6048


@functools.lru_cache(maxsize=None)
def cell_system(dims):
    """jax_cell_system of the stacking pair ``dims``, built once per
    process (the tests copy the state they run)."""
    return jax_cell_system(dims)


def port_engine(sys_, stream=None, **over):
    """(port engine, port state of the JAX initial state)."""
    ts, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    prm = TRunParams(**{**sys_["kw"], **over})
    return CellEngine(prm, TMW, sys_["tgrid"], taux, sys_["tcg"], tcaux,
                      device="cpu", stream=stream), ts


def engines(sys_, **over):
    """(JAX engine on the XLA deltas, port engine with the modes left to
    'auto', port state of the JAX initial state)."""
    kw = {**sys_["kw"], **over}
    jeng = JCellEngine(
        RunParams(**{**kw, "cell_pallas": "off", "cell_chain": "on"},
                  fused="off"),
        MW, sys_["jgrid"], sys_["jaux"], sys_["jcg"], sys_["jcaux"])
    assert not jeng.use_cell_pallas and jeng.use_chain_kernel
    assert not jeng.scatter_unique
    teng, ts = port_engine(sys_, JaxCellStream(sys_["jst"]), **over,
                           cell_pallas="auto", cell_chain="auto")
    assert teng.use_cell_pallas and not teng.use_cell_apply
    assert teng.use_chain_kernel and not teng.scatter_unique
    return jeng, teng, ts


@pytest.fixture(scope="module")
def system():
    return cell_system(DIMS)


@pytest.fixture(scope="module")
def substeps(system):
    """Four sub-steps at different (colour, block) tables, each with its
    own move codes, from the initial state at cycle 1 (WL live)."""
    jeng, teng, ts = engines(system)
    K, W = jeng.K, 2
    js = system["jst"]._replace(cycle=jnp.asarray(1, jnp.int32))
    ts.cycle = 1
    jtpm = jnp.zeros((system["jcg"].nslot, W), dtype=jnp.int32)
    ttpm = torch.zeros((system["tcg"].nslot, W), dtype=torch.int32)
    sw_ok = jnp.ones(W, dtype=bool)
    # eager, not jitted: see the module docstring
    jstep = jeng._substep_canonical
    plan = [(5, [0] * K), (20, [0, 0, 2, 0, 3, 0, 1, 0]),
            (41, [0, 2, 0, 0, 0, 0, 0, 0]), (5, [0] * K)]
    for n, (tbl, codes) in enumerate(plan):
        u = jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, 200 + n),
                                         (K, 7), dtype=jnp.float64),
            out_axes=2)(js.key)
        js, jtpm = jstep(js, jtpm, jeng.fc_stack[tbl], jeng.cand_stack[tbl],
                         jeng.off_stack[tbl], u,
                         jnp.asarray(codes, jnp.int32), sw_ok)
        ts, ttpm = teng._substep_canonical(
            ts, ttpm, tbl, tt(u), torch.as_tensor(codes, dtype=torch.int32))
    return dict(jeng=jeng, teng=teng, js=js, ts=ts, jtpm=jtpm, ttpm=ttpm)


def test_scatter_substeps_match_jax(substeps):
    r = substeps
    assert_states_match(r["ts"], r["js"])
    np.testing.assert_array_equal(r["ttpm"].numpy(), np.asarray(r["jtpm"]))
    tf = cell_state_to_numpy(r["ts"])
    # sub-steps of 8, 5, 7 and 8 translations; switch attempts after
    # every translation and at the two scheduled switches
    assert tf["att"][0].tolist() == [28, 28]
    assert 0 < tf["acc"][0].min() <= tf["acc"][0].max() < 28
    assert (tf["hist"].sum(axis=0) > 0).all()
    # every sub-step launched the mover kernel with its delta output
    assert isinstance(r["teng"].mover_kernel, MoverEnergiesKernel)
    assert r["teng"].mover_kernel.with_deltas
    assert not hasattr(r["teng"], "apply_kernel")


@pytest.fixture(scope="module")
def cycles(system):
    # a rebin at a random origin opens the cycle (see the module
    # docstring); one scheduled volume move (each costs the port's plain
    # slab_full_energy of both lattices, ~30 s on one CPU thread here)
    over = dict(list_update_int=1, mpi_sync_int=1, mc_vol_prob=1.0 / 1536)
    jeng, teng, ts = engines(system, **over)
    for eng in (jeng, teng):
        # one sweep per cycle (see the module docstring)
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K
    js, jsamples = jeng.run_cycles(system["jst"], 1)
    ts, tsamples = teng.run_cycles(ts, 1)
    return dict(js=js, ts=ts, jsamples=jsamples, tsamples=tsamples)


def test_scatter_cycles_match_jax(cycles):
    r = cycles
    assert_states_match(r["ts"], r["js"])
    tf = cell_state_to_numpy(r["ts"])
    # translations, switch attempts, volume moves, a rebin, the sync
    assert tf["att"][0].min() > 450 and tf["acc"][0].min() > 50
    assert tf["att"][1].tolist() == [1, 1] and tf["att"][2].min() > 450
    assert np.abs(tf["origin"]).max() > 0
    assert (tf["occ_overflow"] == 0).all()
    assert ds_value64(r["ts"].master_hist).sum() > 0
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))


@pytest.fixture(scope="module")
def disjoint():
    return cell_system((14, 8, 18))


@pytest.mark.parametrize("route", ["substeps", "cycle"])
def test_on_matches_apply_on_disjoint_grid(disjoint, route):
    """Where same-colour stencils are disjoint both apply stages run:
    'on' (deltas scattered) and 'apply' (deltas recomputed in place)
    give identical integer outcomes and slabs within 1e-10 (the moved
    coordinates differ by the rounding of p_old + (p_new - p_old))."""
    over = dict(list_update_int=1, mpi_sync_int=1)
    out, tpms = {}, {}
    for mode in ("on", "apply"):
        eng, s = port_engine(disjoint, cell_pallas=mode, **over)
        assert eng.use_cell_apply == (mode == "apply")
        assert eng.mover_kernel.with_deltas == (mode == "on")
        if route == "cycle":
            eng.sweeps_per_cycle = 1
            eng.trials_per_cycle = eng.n_tables * eng.K
            s, _ = eng.run_cycles(s, 1)
        else:
            s.cycle = 1
            tpm = torch.zeros((disjoint["tcg"].nslot, 2), dtype=torch.int32)
            rng = np.random.default_rng(21)
            for tbl in (3, 30, 63):
                u = torch.as_tensor(rng.uniform(size=(eng.K, 7, 2)))
                codes = torch.as_tensor([0, 0, 2, 0, 0, 0, 0, 0],
                                        dtype=torch.int32)
                s, tpm = eng._substep_canonical(s, tpm, tbl, u, codes)
            tpms[mode] = tpm
        out[mode] = cell_state_to_numpy(s)
    a, b = out["on"], out["apply"]
    if route == "substeps":
        assert torch.equal(tpms["on"], tpms["apply"])
    for name in INT_FIELDS:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(a[name], b[name], rtol=0, atol=1e-10,
                                   err_msg=name)
    assert a["acc"][0].min() > 0


# ----------------------------------------------------------------------
# the mode rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dims,setting,modes", [
    # (use_cell_pallas, use_cell_apply, use_chain_kernel, with deltas;
    # None where there is no mover-energies kernel)
    ((14, 8, 18), dict(), (True, True, True, False)),
    ((14, 8, 18), dict(cell_trials=8), (True, True, True, None)),
    ((14, 8, 18), dict(cell_pallas="on"), (True, False, True, True)),
    ((14, 8, 18), dict(cell_pallas="on", cell_chain="on"),
     (True, False, True, True)),
    ((12, 7, 18), dict(), (True, False, True, True)),
    ((12, 7, 18), dict(cell_pallas="on"), (True, False, True, True)),
    ((12, 7, 18), dict(cell_trials=8), (False, False, False, None)),
    ((12, 7, 18), dict(cell_trials=8, cell_chain="on"),
     (False, False, True, None)),
    ((12, 7, 18), dict(cell_pallas="off"), (False, False, False, None)),
    ((14, 8, 18), dict(cell_pallas="off", cell_chain="on"),
     (False, False, True, None)),
    ((14, 8, 18), dict(cell_chain="off"), (True, True, False, False)),
    ((12, 7, 18), dict(cell_pallas="on", cell_chain="off"),
     (True, False, False, True)),
], ids=["disjoint-auto", "disjoint-auto-T8", "disjoint-on",
        "disjoint-on-chain-on", "overlap-auto", "overlap-on",
        "overlap-auto-T8", "overlap-auto-T8-chain-on", "overlap-off",
        "disjoint-off-chain-on", "disjoint-chain-off",
        "overlap-on-chain-off"])
def test_mode_rule_runs(dims, setting, modes):
    sys_ = cell_system(dims)
    eng, _ = port_engine(sys_, **{"cell_pallas": "auto",
                                  "cell_chain": "auto", **setting})
    pallas, apply_, chain, deltas = modes
    assert (eng.use_cell_pallas, eng.use_cell_apply,
            eng.use_chain_kernel) == (pallas, apply_, chain)
    assert hasattr(eng, "apply_kernel") == apply_
    assert hasattr(eng, "chain_kernel") == chain
    assert hasattr(eng, "points_kernel") == (pallas and eng.T > 1)
    if deltas is None:
        assert not hasattr(eng, "mover_kernel")
    else:
        assert eng.mover_kernel.with_deltas == deltas
    # explicit modes resolve as the JAX engine resolves them
    if setting.get("cell_pallas") in ("on", "off"):
        kw = {**sys_["kw"], "cell_chain": "auto", **setting}
        jeng = JCellEngine(RunParams(**kw, fused="off"), MW, sys_["jgrid"],
                           sys_["jaux"], sys_["jcg"], sys_["jcaux"])
        assert (jeng.use_cell_pallas, jeng.use_cell_apply,
                jeng.use_chain_kernel) == modes[:3]


@pytest.mark.parametrize("dims,setting,error,match", [
    ((12, 7, 18), dict(cell_pallas="apply"), ValueError, "disjoint"),
    ((14, 8, 18), dict(cell_pallas="on", cell_trials=8), ValueError,
     "per-candidate delta"),
    ((12, 7, 18), dict(cell_pallas="on", cell_trials=2), ValueError,
     "per-candidate delta"),
    ((12, 7, 18), dict(num_lattices=1, cell_chain="on",
                       cell_pallas="auto"), ValueError, "num_lattices = 2"),
], ids=["overlap-apply", "disjoint-on-T8", "overlap-on-T2", "one-lattice"])
def test_mode_rule_refuses(dims, setting, error, match):
    sys_ = cell_system(dims)
    with pytest.raises(error, match=match):
        port_engine(sys_, **{"cell_pallas": "auto", "cell_chain": "auto",
                             **setting})
    if error is ValueError:
        # the JAX engine refuses the explicit modes alike
        kw = {**sys_["kw"], "cell_chain": "auto", **setting}
        with pytest.raises(ValueError, match=match):
            JCellEngine(RunParams(**kw, fused="off"), MW, sys_["jgrid"],
                        sys_["jaux"], sys_["jcg"], sys_["jcaux"])


def test_padded_grid_refused():
    sys_ = cell_system(DIMS)
    tcg = sys_["tcg"]
    padded = dataclasses.replace(
        tcg, full_mask=np.concatenate([tcg.full_mask[:-1], [False]]))
    ts, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    with pytest.raises(NotImplementedError, match="padded"):
        CellEngine(TRunParams(**{**sys_["kw"], "cell_pallas": "auto"}), TMW,
                   sys_["tgrid"], taux, padded, tcaux, device="cpu")


def test_front_end_runs_the_flagship_on_the_scatter_path(tmp_path,
                                                          monkeypatch):
    """The N=24192 flagship, stacking_switch_pair(24,14,18), with no mode
    override: the front end's grid (Application._cell_grid) is coarse
    (8,8,4) x 2^3 with 75-cell stencils, and the engine resolves 'auto'
    to the scatter path with the chain kernel, as the JAX engine does on
    an accelerator.  (The engine is built on hand-made aux tuples: no
    energy is needed to resolve the modes.)"""
    from mc_water_ls_mw_tpu_torch.app import Application
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import CellAux
    from mc_water_ls_mw_tpu_torch.mcmc.state import EngineAux
    from mc_water_ls_mw_tpu_torch.models.stacking import stacking_switch_pair

    from .test_torch_cells import cell_run_params

    kw = cell_run_params((24, 14, 18))
    kw.pop("cell_pallas"), kw.pop("cell_chain")
    prm = TRunParams(**kw, stack=(24, 14, 18), method="stack")
    assert (prm.cell_pallas, prm.cell_chain) == ("auto", "auto")
    monkeypatch.chdir(tmp_path)
    app = Application(prm, workdir=tmp_path, device="cpu")
    r0, H0 = stacking_switch_pair(24, 14, 18)
    cg = app._cell_grid(r0, H0)
    assert cg.n == (8, 8, 4) and cg.m == 2 and cg.full_cells.shape[1] == 75
    f = [r0[l] @ np.linalg.inv(H0[l]).T for l in range(2)]
    dfrac0 = f[0] - f[1]
    dfrac0 -= np.round(dfrac0)
    aux = EngineAux(shifts=np.zeros((1, 3), np.int32), ref_h=H0,
                    ref_enthalpy=torch.zeros(2, dtype=torch.float64),
                    log_unbiased_norm=0.0)
    caux = CellAux(dfrac0=torch.as_tensor(dfrac0.T.copy()))
    eng = CellEngine(prm, TMW, build_bin_grid(prm.nbins, prm.mu_min,
                                              prm.mu_max), aux, cg, caux,
                     device="cpu")
    assert eng.use_cell_pallas and not eng.use_cell_apply
    assert eng.use_chain_kernel and eng.mover_kernel.with_deltas
    assert not eng.scatter_unique and eng.K == 32
    assert (eng.sweeps_per_cycle, eng.n_tables) == (12, 64)
