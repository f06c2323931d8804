"""The PyTorch port's large-N cell engine against the JAX CellEngine.

The slice as a whole on the N=8064 Ih/Ic stacking pair (coarse 4^3,
m = 2, 512 fine cells of 32 slots, 27-cell stencils), float64, W = 2:
both engines start from the same state and consume the same random
draws (the port through a stream that reproduces JAX's threefry draws).

* a handful of sub-steps through ``_substep_canonical``;
* two whole cycles through ``run_cycles`` with a delta-sync every cycle,
  a rebin and a chain resync in the second and scheduled volume moves.
  The depth of a cycle is cut to ONE sweep (``sweeps_per_cycle = 1`` on
  both engine objects: 64 sub-steps, every (colour, block) table once,
  512 trials per walker instead of 16 sweeps), because one full-depth
  cycle of the JAX engine takes minutes in Pallas interpret mode.

The JAX engine runs as its own tests run it on the CPU: Pallas in
interpret mode, ``cell_pallas='apply'``, ``cell_chain='on'``.  The port
runs the plain versions of its three kernels (CPU tensors).
"""

import dataclasses

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
from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import ChainWLKernel
from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
    MoverApplyKernel,
    MoverEnergiesKernel,
)
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

from .test_torch_cells import (
    JaxCellStream,
    build_grids,
    jax_cell_system,
    to_port,
    tt,
)
from .test_torch_state import jax_state_fields

N_CYCLES = 2
INT_FIELDS = ("att", "acc", "ls", "trans_per_mol", "slot2mol", "mol2slot",
              "occ_overflow", "dropped")
# continuous state within 1e-9 (positions in Bohr, energies in Hartree,
# mu in kT)
FLOAT_FIELDS = ("r", "h", "recip", "volume", "energy", "energy_err", "mu",
                "moments", "origin", "weight", "hist", "uhist", "avg_energy",
                "min_dmu", "max_dmu", "f")


def engines(sys_, **over):
    """(JAX engine, port engine, port state of the JAX initial state)."""
    kw = {**sys_["kw"], **over}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, sys_["jgrid"],
                       sys_["jaux"], sys_["jcg"], sys_["jcaux"])
    assert jeng.use_cell_apply and jeng.use_chain_kernel
    ts, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    teng = CellEngine(TRunParams(**kw), TMW, sys_["tgrid"], taux,
                      sys_["tcg"], tcaux, device="cpu",
                      stream=JaxCellStream(sys_["jst"]))
    return jeng, teng, ts


def assert_states_match(ts, js, int_fields=INT_FIELDS):
    jf, tf = jax_state_fields(js), cell_state_to_numpy(ts)
    assert int(tf["cycle"]) == int(jf["cycle"])
    for name in int_fields:
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        t64 = tf[name][0].astype(np.float64) + tf[name][1]
        j64 = jf[name][0].astype(np.float64) + jf[name][1]
        # the histogram bins are identical
        np.testing.assert_array_equal(t64 != 0, j64 != 0, err_msg=name)
        np.testing.assert_allclose(t64, j64, rtol=1e-12, atol=1e-9,
                                   err_msg=name)


@pytest.fixture(scope="module")
def system():
    return jax_cell_system()


@pytest.fixture(scope="module")
def substeps(system):
    """Three sub-steps at different (colour, block) tables, each with
    its own move codes, from the initial state at cycle 1 (WL live)."""
    jeng, teng, ts = engines(system)
    K, W = jeng.K, 2
    js = system["jst"]._replace(cycle=jnp.asarray(1, jnp.int32))
    ts.cycle = 1
    jtpm = jnp.zeros((system["jcg"].nslot, W), dtype=jnp.int32)
    ttpm = torch.zeros((system["tcg"].nslot, W), dtype=torch.int32)
    sw_ok = jnp.ones(W, dtype=bool)
    jstep = jax.jit(jeng._substep_canonical)
    plan = [(5, [0] * K), (20, [0, 0, 2, 0, 3, 0, 1, 0]),
            (41, [0, 2, 0, 0, 0, 0, 0, 0]), (5, [0] * K)]
    for n, (tbl, codes) in enumerate(plan):
        u = jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, 100 + n),
                                         (K, 7), dtype=jnp.float64),
            out_axes=2)(js.key)
        js, jtpm = jstep(js, jtpm, jeng.fc_stack[tbl], jeng.cand_stack[tbl],
                         jeng.off_stack[tbl], u,
                         jnp.asarray(codes, jnp.int32), sw_ok)
        ts, ttpm = teng._substep_canonical(
            ts, ttpm, tbl, tt(u), torch.as_tensor(codes, dtype=torch.int32))
    return dict(jeng=jeng, teng=teng, js=js, ts=ts, jtpm=jtpm, ttpm=ttpm)


def test_substeps_match_jax(substeps):
    r = substeps
    assert_states_match(r["ts"], r["js"])
    np.testing.assert_array_equal(r["ttpm"].numpy(), np.asarray(r["jtpm"]))
    tf = cell_state_to_numpy(r["ts"])
    # sub-steps of 8, 5, 7 and 8 translations; switch attempts after
    # every translation and at the two scheduled switches
    assert tf["att"][0].tolist() == [28, 28]
    assert 0 < tf["acc"][0].min() <= tf["acc"][0].max() < 28
    assert tf["att"][2].tolist() == [30, 30]
    assert r["ttpm"].sum(dim=0).tolist() == [28, 28]
    assert (tf["hist"].sum(axis=0) > 0).all()          # WL was live
    assert np.abs(tf["energy_err"]).max() > 0          # two-sum residuals


def test_audit_after_substeps(substeps):
    """Incremental energies and moments are drift-free through the
    sub-steps: the tracked (energy + energy_err) against a recomputation
    from scratch, the moments likewise."""
    teng = substeps["teng"]
    s = substeps["ts"].clone()
    before = s.moments.clone()
    s, drift = teng.audit_energy(s)
    assert drift.shape == (2, 2)
    assert float(drift.abs().max()) < 1e-9
    torch.testing.assert_close(s.moments, before, rtol=0, atol=1e-9)
    assert float(s.energy_err.abs().max()) == 0.0
    # an audit of the first walker only, of a perturbed energy
    s.energy[:, 0] += 1e-3
    s, drift = teng.audit_energy(s, n_walkers=1)
    assert drift.shape == (2, 1)
    np.testing.assert_allclose(drift.numpy(), 1e-3, rtol=1e-6)


@pytest.fixture(scope="module")
def cycles(system):
    over = dict(list_update_int=2, mpi_sync_int=1, latt_sync_int=2,
                mc_vol_prob=1.0 / 512)
    jeng, teng, ts = engines(system, **over)
    for eng in (jeng, teng):
        # one sweep per cycle (see the module docstring)
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K
    js, jsamples = jeng.run_cycles(system["jst"], N_CYCLES)
    ts, tsamples = teng.run_cycles(ts, N_CYCLES)
    return dict(jeng=jeng, teng=teng, js=js, ts=ts, jsamples=jsamples,
                tsamples=tsamples)


def test_cycles_match_jax(cycles):
    r = cycles
    assert_states_match(r["ts"], r["js"])
    tf = cell_state_to_numpy(r["ts"])
    # every part of the cycle ran: translations in (nearly) every
    # scheduled trial, switch attempts, volume moves, a rebin (the origin
    # moved and the slots were reassigned), the delta-sync
    assert tf["att"][0].min() > 900 and tf["acc"][0].min() > 100
    assert tf["att"][1].min() >= 1 and tf["att"][2].min() > 900
    assert np.abs(tf["origin"]).max() > 0
    assert (tf["occ_overflow"] == 0).all()
    assert ds_value64(r["ts"].master_hist).sum() > 0
    assert np.abs(tf["weight"]).max() == 0            # merged and re-zeroed
    # the resync at the end of cycle 2 refreshed energies from scratch
    assert np.abs(tf["energy_err"]).max() == 0
    for k in ("E_ls", "mu", "vol"):
        np.testing.assert_allclose(r["tsamples"][k].numpy(),
                                   np.asarray(r["jsamples"][k]), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(r["tsamples"]["ls"].numpy(),
                                  np.asarray(r["jsamples"]["ls"]))
    np.testing.assert_array_equal(r["tsamples"]["cycle"].numpy(),
                                  np.asarray(r["jsamples"]["cycle"]))


def test_molecules_stay_in_stored_fine_cells(cycles):
    """The static coverage tables are exact only while every molecule
    remains inside the fine cube it was binned into."""
    from mc_water_ls_mw_tpu_torch.ops.cells import (
        cell_of_frac,
        gather_from_slab,
    )
    from mc_water_ls_mw_tpu_torch.ops.geometry import to_frac

    teng, s = cycles["teng"], cycles["ts"]
    r1 = gather_from_slab(s.r[0], s.mol2slot)                  # [3,N,W]
    f1 = to_frac(s.recip[0][:, :, None, :], r1)
    fmid = f1 - 0.5 * teng.cellaux.dfrac0[:, :, None]
    cid = cell_of_frac(teng.cellgrid, fmid, s.origin, level="fine")
    assert torch.equal(cid, s.mol2slot // teng.cellgrid.cap)


def test_auto_resolves_to_the_kernels(system):
    """On this grid (disjoint same-colour stencils) 'auto' means the
    apply stage and the chain kernel on every device, as the JAX engine
    resolves it on an accelerator: what is computed never depends on
    the device."""
    jeng, _, _ = engines(system)
    ts, taux, tcaux = to_port(system["jst"], system["jaux"],
                              system["jcaux"])
    prm = TRunParams(**{**system["kw"], "cell_pallas": "auto",
                        "cell_chain": "auto"})
    teng = CellEngine(prm, TMW, system["tgrid"], taux, system["tcg"], tcaux,
                      device="cpu")
    assert isinstance(teng.mover_kernel, MoverEnergiesKernel)
    assert not teng.mover_kernel.with_deltas
    assert isinstance(teng.apply_kernel, MoverApplyKernel)
    assert isinstance(teng.chain_kernel, ChainWLKernel)
    assert teng.scatter_unique and teng.use_cell_apply
    assert teng.use_cell_pallas and teng.use_chain_kernel
    assert (teng.K, teng.n_tables, teng.sweeps_per_cycle,
            teng.trials_per_cycle) == (8, 64, 16, 8192)
    assert (jeng.K, jeng.n_tables, jeng.sweeps_per_cycle,
            jeng.trials_per_cycle) == (8, 64, 16, 8192)
    for name in ("fc_stack", "cand_stack", "off_stack"):
        np.testing.assert_array_equal(getattr(teng, name).numpy(),
                                      np.asarray(getattr(jeng, name)))


@pytest.mark.parametrize("setting", [
    dict(leshift=True), dict(minu=True), dict(mc_ensemble="nvt"),
    dict(wl_swetnam=True), dict(num_lattices=1),
])
def test_setting_chain_terms_match_jax(system, setting):
    """The settings the port's cell engine once refused build, resolve
    their modes as the JAX engine does (one lattice: the XLA chains), and
    hoist the same switch, mu-from-scratch and MINU terms of the chain
    (its _hoisted_chain_terms) from the initial state."""
    kw = {**system["kw"], "cell_chain": "auto", **setting}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, system["jgrid"],
                       system["jaux"], system["jcg"], system["jcaux"])
    ts, taux, tcaux = to_port(system["jst"], system["jaux"],
                              system["jcaux"])
    teng = CellEngine(TRunParams(**kw), TMW, system["tgrid"], taux,
                      system["tcg"], tcaux, device="cpu")
    assert teng.use_chain_kernel == jeng.use_chain_kernel \
        == (kw["num_lattices"] == 2)
    two, *jterms = jeng._hoisted_chain_terms(system["jst"])
    if not two:
        return
    for mine, ref in zip(teng._hoisted_chain_terms(ts), jterms):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(
        teng._mu_scratch(ts.energy, ts.volume).numpy(),
        np.asarray(jeng._mu_scratch(system["jst"].energy,
                                    system["jst"].volume)), rtol=0,
        atol=1e-9)


def test_unported_grids_raise(system):
    ts, taux, tcaux = to_port(system["jst"], system["jaux"],
                              system["jcaux"])
    prm = TRunParams(**system["kw"])
    tcg = system["tcg"]
    padded = dataclasses.replace(
        tcg, full_mask=np.concatenate([tcg.full_mask[:-1], [False]]))
    with pytest.raises(NotImplementedError, match="padded"):
        CellEngine(prm, TMW, system["tgrid"], taux, padded, tcaux,
                   device="cpu")
    # the smallest box the grid supports: 75-cell stencils that overlap
    # between same-colour movers.  The scatter path runs them at one
    # trial per mover (test_torch_cellengine_scatter.py); the in-place
    # apply stage does not, and at T > 1 'auto' picks the unfused
    # sub-step with the XLA chain (test_torch_cellengine_unfused.py)
    small = build_grids(12, 7, 18)[4]
    assert small.full_mask.all()
    with pytest.raises(ValueError, match="disjoint"):
        CellEngine(prm, TMW, system["tgrid"], taux, small, tcaux,
                   device="cpu")
    multi = TRunParams(**{**system["kw"], "cell_pallas": "auto",
                          "cell_chain": "auto", "cell_trials": 8})
    eng = CellEngine(multi, TMW, system["tgrid"], taux, small, tcaux,
                     device="cpu")
    assert not (eng.use_cell_pallas or eng.use_cell_apply
                or eng.use_chain_kernel)
