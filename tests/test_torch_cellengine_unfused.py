"""The cell engine's unfused sub-step and XLA chains in the PyTorch port
against the JAX ``CellEngine``.

``cell_pallas='off'`` computes a sub-step's energies with the tensor
code of ops/cell_energy.py and applies the accepted movers by a scatter
of per-candidate deltas; ``cell_chain='off'`` runs the acceptance chain
as the JAX engine's XLA chains: at one trial per mover the micro-batched
chain (eta on the weights frozen at the sub-step's start, the WL
increments in one batched update after it), at T > 1 the per-move chain
over the K x T trials.  'auto' picks both at T > 1 on grids whose
same-colour stencils overlap (the N=24192 flagship's case).

Float64, two walkers, the same state and the same uniforms in both
packages (the port through a stream that reproduces JAX's threefry
draws), integer outcomes exactly, continuous state within 1e-9 and the
master WL rows within 1e-12 relative:

* a handful of sub-steps through ``_substep_canonical`` on the disjoint
  N=8064 grid (14,8,18) and on the overlap N=6048 grid (12,7,18), each
  mode against the JAX engine's XLA sub-step (jitted; on the overlap
  grid after a rebin at a random origin, where no site sits on a
  fine-cell face: see test_torch_cellengine_scatter.py);
* a cycle cut to one sweep at T=1 with 'off' (the micro-batched chain
  with WL live, a rebin, a volume move and a delta-sync) and at T=2 on
  the overlap grid with the modes left to 'auto';
* three 'dd' cycles at T=2 with 'off' across the equilibration boundary
  (cut to 4 sub-steps, as test_torch_cellengine_dd.py cuts them);
* the mode rule for every pair of settings on both grids at T=1 and
  T=2, against the JAX engine's resolution on an accelerator.
"""

import itertools
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.config import RunParams

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS, \
    assert_states_match
from .test_torch_cellengine_dd import N_CYCLES, N_SUB, N_WIN, _states, \
    dd_kw
from .test_torch_cellengine_scatter import cell_system
from .test_torch_cells import JaxCellStream, build_grids, to_port, tt
from .test_torch_state import jax_state_fields

DISJOINT, OVERLAP = (14, 8, 18), (12, 7, 18)
# (table, move-code pattern) of each sub-step: all translations, then
# translations mixed with switches (2), volume (1) and no-op (3) codes
PLAN = [(5, [0]), (20, [0, 0, 2, 0, 3, 0, 1, 0]), (41, [0, 2, 0, 0]),
        (5, [0])]


def engines(dims, T, port_modes, jax_modes, **over):
    """(JAX engine, port engine, JAX state, port state) of the stacking
    pair ``dims`` at T trials per mover."""
    sys_ = cell_system(dims)
    kw = {**sys_["kw"], "cell_trials": T, **over}
    jeng = JCellEngine(
        RunParams(**{**kw, "cell_pallas": jax_modes[0],
                     "cell_chain": jax_modes[1]}, fused="off"),
        MW, sys_["jgrid"], sys_["jaux"], sys_["jcg"], sys_["jcaux"])
    assert not jeng.use_cell_pallas
    ts, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    teng = CellEngine(
        TRunParams(**{**kw, "cell_pallas": port_modes[0],
                      "cell_chain": port_modes[1]}),
        TMW, sys_["tgrid"], taux, sys_["tcg"], tcaux, device="cpu",
        stream=JaxCellStream(sys_["jst"]))
    return jeng, teng, sys_["jst"], ts


SUBSTEP_CASES = {
    # name: (grid, T, port (cell_pallas, cell_chain), JAX modes)
    "t1-off": (DISJOINT, 1, ("off", "auto"), ("off", "off")),
    "t1-on-chain-off-overlap": (OVERLAP, 1, ("on", "off"), ("off", "off")),
    "t2-off": (DISJOINT, 2, ("off", "auto"), ("off", "off")),
    "t4-off": (DISJOINT, 4, ("off", "off"), ("off", "off")),
    "t2-auto-overlap": (OVERLAP, 2, ("auto", "auto"), ("auto", "auto")),
    "t4-auto-overlap": (OVERLAP, 4, ("auto", "auto"), ("auto", "auto")),
    "t2-off-chain-on-overlap": (OVERLAP, 2, ("off", "on"), ("off", "off")),
}


@pytest.mark.parametrize("case", list(SUBSTEP_CASES))
def test_unfused_substeps_match_jax(case):
    dims, T, port_modes, jax_modes = SUBSTEP_CASES[case]
    jeng, teng, js, ts = engines(dims, T, port_modes, jax_modes)
    want_pallas = port_modes[0] == "on"
    assert (teng.use_cell_pallas, teng.use_cell_apply) == (want_pallas,
                                                           False)
    assert teng.use_chain_kernel == (port_modes[1] == "on")
    K, W = jeng.K, 2
    js = js._replace(cycle=jnp.asarray(1, jnp.int32))
    ts.cycle = 1
    if dims == OVERLAP:
        js = jax.jit(jeng._rebin)(js)
        teng._rebin(ts)
        assert_states_match(ts, js)
    jtpm = jnp.zeros((jeng.cellgrid.nslot, W), dtype=jnp.int32)
    ttpm = torch.zeros((teng.cellgrid.nslot, W), dtype=torch.int32)
    jstep = jax.jit(jeng._substep_canonical)
    n_u = 7 if T == 1 else 4 + 5 * T
    for n, (tbl, pattern) in enumerate(PLAN):
        codes = (pattern * (K * T))[:K * T]
        u = jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, 100 + n), (K, n_u), dtype=jnp.float64),
            out_axes=2)(js.key)
        js, jtpm = jstep(js, jtpm, jeng.fc_stack[tbl], jeng.cand_stack[tbl],
                         jeng.off_stack[tbl], u,
                         jnp.asarray(codes, jnp.int32),
                         jnp.ones(W, dtype=bool))
        ts, ttpm = teng._substep_canonical(
            ts, ttpm, tbl, tt(u), torch.as_tensor(codes, dtype=torch.int32))
    assert_states_match(ts, js)
    np.testing.assert_array_equal(ttpm.numpy(), np.asarray(jtpm))
    tf = cell_state_to_numpy(ts)
    n_trans = sum((p * (K * T))[:K * T].count(0) for _, p in PLAN)
    assert tf["att"][0].tolist() == [n_trans] * W
    assert (tf["acc"][0] > 0).all() and (tf["acc"][0] < n_trans).all()
    assert (tf["att"][2] > 0).all()
    assert (tf["hist"].sum(axis=0) > 0).all()          # WL was live
    assert (tf["weight"].sum(axis=0) > 0).all()


CYCLE_CASES = {
    # name: (grid, T, port modes, JAX modes, overrides)
    "t1-off": (DISJOINT, 1, ("off", "off"), ("off", "off"),
               dict(list_update_int=2, mpi_sync_int=1, latt_sync_int=2,
                    mc_vol_prob=1.0 / 512)),
    "t2-auto-overlap": (OVERLAP, 2, ("auto", "auto"), ("auto", "auto"),
                        dict(list_update_int=1, mpi_sync_int=1,
                             mc_vol_prob=1e-9)),
}


@pytest.mark.parametrize("case", list(CYCLE_CASES))
def test_unfused_cycles_match_jax(case):
    """Cycles cut to one sweep (every (colour, block) table once) on
    both engine objects; with 'off' at T=1 two cycles (a rebin, a volume
    move, a delta-sync every cycle and a chain resync in the second),
    with 'auto' at T=2 on the overlap grid one cycle that opens with a
    rebin and holds a delta-sync (no volume move: a whole-cell energy on
    this grid costs ~30 s on one CPU thread here)."""
    dims, T, port_modes, jax_modes, over = CYCLE_CASES[case]
    jeng, teng, js, ts = engines(dims, T, port_modes, jax_modes, **over)
    assert not (teng.use_cell_pallas or teng.use_chain_kernel)
    for eng in (jeng, teng):
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K * eng.T
    n_cycles = 2 if T == 1 else 1
    js, jsamples = jeng.run_cycles(js, n_cycles)
    ts, tsamples = teng.run_cycles(ts, n_cycles)
    assert_cycle_match(ts, js)
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(tsamples[k].numpy(),
                                   np.asarray(jsamples[k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    tf = cell_state_to_numpy(ts)
    assert (tf["acc"][0] > 0).all() and np.abs(tf["origin"]).max() > 0
    assert (tf["occ_overflow"] == 0).all()
    assert ds_value64(ts.master_hist).sum() > 0
    if T == 1:
        assert (tf["att"][1] >= 1).all()


def assert_cycle_match(ts, js):
    """assert_states_match of test_torch_cellengine.py, with mu and the
    dmu extrema (kT) held within 1e-9 relative as well as absolute: a
    volume move or a resync sets mu from whole-cell energies of N=8064
    molecules (~150 Hartree), whose sums the two packages take in
    different orders (1e-15 relative), and beta = 1/kT multiplies their
    difference by ~1600 per Hartree."""
    jf, tf = jax_state_fields(js), cell_state_to_numpy(ts)
    assert int(tf["cycle"]) == int(jf["cycle"])
    for name in INT_FIELDS:
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in FLOAT_FIELDS:
        rtol = 1e-9 if name in ("mu", "min_dmu", "max_dmu") else 0
        np.testing.assert_allclose(tf[name], jf[name], rtol=rtol, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                   err_msg=name)


def test_unfused_dd_cycles_match_jax():
    """Three cycles at T=2 with 'off' over 4 windows, across the
    equilibration boundary (switches shut in cycle 1, walls live
    after), WL generation with window seeding."""
    grids = build_grids()
    kw = {**dd_kw(2, False, True), "cell_pallas": "off",
          "cell_chain": "off"}
    jgrid, tgrid, (jst, jaux, jcaux), _ = _states(grids, kw)
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux,
                       grids[3], jcaux)
    ts, taux, tcaux = to_port(jst, jaux, jcaux)
    teng = CellEngine(TRunParams(**kw), TMW, tgrid, taux, grids[4], tcaux,
                      device="cpu", stream=JaxCellStream(jst))
    assert not (teng.use_cell_pallas or teng.use_chain_kernel)
    for eng in (jeng, teng):
        eng.sweeps_per_cycle = 1
        eng.n_tables = N_SUB
        eng.trials_per_cycle = N_SUB * eng.K * eng.T
    js = jst
    for c in range(1, N_CYCLES + 1):
        js, _ = jeng.run_cycles(js, 1)
        teng.run_cycles(ts, 1)
        jf, tf = jax_state_fields(js), cell_state_to_numpy(ts)
        for name in INT_FIELDS + ("in_window", "window_id"):
            np.testing.assert_array_equal(tf[name], jf[name],
                                          err_msg=f"{name} cycle {c}")
        for name in FLOAT_FIELDS:
            np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                       atol=1e-9, err_msg=f"{name} cycle {c}")
        for name in ("master_eta", "master_hist"):
            t64 = tf[name][0].astype(np.float64) + tf[name][1]
            j64 = jf[name][0].astype(np.float64) + jf[name][1]
            assert t64.shape == (N_WIN, 201)
            np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                       err_msg=f"{name} cycle {c}")
        if c == 1:
            assert (tf["att"][2] == 0).all() and (tf["att"][0] > 0).all()
    assert (tf["att"][2] > 0).all() and tf["in_window"].all()


# ----------------------------------------------------------------------
# the mode rule against the JAX engine's resolution on an accelerator
# ----------------------------------------------------------------------

MODES = list(itertools.product(("auto", "off", "on", "apply"),
                               ("auto", "on", "off")))


@pytest.mark.parametrize("pallas,chain", MODES,
                         ids=[f"{p}-{c}" for p, c in MODES])
@pytest.mark.parametrize("dims,T", [(DISJOINT, 1), (DISJOINT, 2),
                                    (OVERLAP, 1), (OVERLAP, 2)],
                         ids=["disjoint-T1", "disjoint-T2", "overlap-T1",
                              "overlap-T2"])
def test_mode_rule_matches_jax(monkeypatch, dims, T, pallas, chain):
    """The port resolves every pair of settings on the CPU as the JAX
    engine does on an accelerator (its 'auto' asks
    jax.default_backend(), here answered 'gpu'), or raises the JAX
    engine's ValueError."""
    sys_ = cell_system(dims)
    kw = {**sys_["kw"], "cell_trials": T, "cell_pallas": pallas,
          "cell_chain": chain}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    try:
        jeng = JCellEngine(RunParams(**kw, fused="off"), MW, sys_["jgrid"],
                           sys_["jaux"], sys_["jcg"], sys_["jcaux"])
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err)[:40])):
            cell_engine(sys_, kw)
        return
    teng = cell_engine(sys_, kw)
    for name in ("use_cell_pallas", "use_cell_apply", "use_chain_kernel",
                 "scatter_unique"):
        assert getattr(teng, name) == getattr(jeng, name), name
    # the kernels each mode builds
    assert hasattr(teng, "mover_kernel") == (teng.use_cell_pallas
                                             and T == 1)
    assert hasattr(teng, "points_kernel") == (teng.use_cell_pallas
                                              and T > 1)
    assert hasattr(teng, "apply_kernel") == teng.use_cell_apply
    assert hasattr(teng, "chain_kernel") == teng.use_chain_kernel


def cell_engine(sys_, kw):
    _, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    return CellEngine(TRunParams(**kw), TMW, sys_["tgrid"], taux,
                      sys_["tcg"], tcaux, device="cpu")
