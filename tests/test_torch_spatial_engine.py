"""The port's spatially sharded cell engine against the JAX CellEngine.

The N=8064 Ih/Ic stacking pair (coarse 4^3, m = 2: 512 fine cells,
27-cell stencils, reach 1, so at D=2 each rank owns 4 fine x-layers and
carries 2 halo layers per side), float64, W = 2, cell_pallas='apply'
and the chain kernel.  The JAX package's UNSHARDED engine runs three
consecutive sub-steps (tables 5, 6 and 7, with scheduled switches and a
no-op among the move codes) through its jitted ``_substep_canonical``,
its Pallas kernels in interpret mode as its own tests run them on the
CPU.  The port runs the same three sub-steps in one sharded loop
(``SpatialCellEngine._sharded_scan``), so the second and third read
halo rows refreshed by the ring shift after the first's writes:

* in one process (D = 1: the degenerate plan, local rows and the dummy
  row, no halo);
* on 2 gloo ranks along space, at one trial per mover and at two;
* on 4 ranks as space 2 x walkers 2 (one walker per walker rank).

Integer outcomes (acceptance counters, ``ls``, trial counts per slot,
slot occupancy) are identical and the continuous state agrees within
1e-9 (the JAX package's own spatial tolerance), as in
tests/test_torch_cellengine.py.  The ranks run the plain versions of
kernels 3-6 (CPU tensors).  Then the refusals of the JAX engine.
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
from mc_water_ls_mw_tpu_torch.parallel.comm import run_ranks
from mc_water_ls_mw_tpu_torch.parallel.spatial import (
    SpatialCellEngine,
    build_spatial_plan,
)

from .test_torch_cellengine import FLOAT_FIELDS, INT_FIELDS
from .test_torch_cells import jax_cell_system
from .test_torch_state import jax_aux_fields, jax_state_fields
from .torch_ranks import spatial_cases, spatial_rank

TABLE = 5
N_SUB = 3
# per sub-step move codes of the K = 8 movers (one per mover-trial):
# translations with a scheduled switch (2) and a no-op (3)
CODES = [0, 0, 2, 0, 3, 0, 0, 0]


@pytest.fixture(scope="module")
def system():
    return jax_cell_system()


def _jax_substeps(system, T):
    """The JAX engine's three unsharded sub-steps and the draws."""
    kw = {**system["kw"], "cell_trials": T}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, system["jgrid"],
                       system["jaux"], system["jcg"], system["jcaux"])
    assert jeng.use_cell_apply and jeng.use_chain_kernel
    K, W = jeng.K, kw["n_walkers"]
    js = system["jst"]._replace(cycle=jnp.asarray(1, jnp.int32))
    u = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, 300 + T),
                                     (N_SUB, K, 7 if T == 1 else 4 + 5 * T),
                                     dtype=jnp.float64),
        out_axes=3)(js.key))                        # [N_SUB, K, n_u, W]
    codes = np.asarray(CODES * T * N_SUB, np.int32)
    jtpm = jnp.zeros((system["jcg"].nslot, W), dtype=jnp.int32)
    jstep = jax.jit(jeng._substep_canonical)
    out = js
    for i in range(N_SUB):
        t = TABLE + i
        out, jtpm = jstep(out, jtpm, jeng.fc_stack[t], jeng.cand_stack[t],
                          jeng.off_stack[t], jnp.asarray(u[i]),
                          jnp.asarray(codes[i * K * T:(i + 1) * K * T]),
                          jnp.ones(W, dtype=bool))
    case = dict(kw=kw, fields=jax_state_fields(js),
                aux=jax_aux_fields(system["jaux"]),
                caux=jax_aux_fields(system["jcaux"]),
                cellgrid=system["tcg"], u=u, codes=codes, tbl=TABLE,
                n_sub=N_SUB, cycle=1)
    return dict(js=out, jtpm=np.asarray(jtpm), case=case)


@pytest.fixture(scope="module")
def runs(system):
    ref = {T: _jax_substeps(system, T) for T in (1, 2)}
    two = run_ranks(spatial_cases, 2, {T: dict(ref[T]["case"], walkers=1)
                                       for T in (1, 2)})
    d2 = {T: [out[T] for out in two] for T in (1, 2)}
    grid2x2 = run_ranks(spatial_rank, 4, dict(ref[1]["case"], walkers=2))
    return dict(ref=ref, d2=d2, grid2x2=grid2x2)


def _assert_matches(out, ref):
    """The port's state and trial counts (numpy) against the JAX
    sub-steps': integers identical, the rest within 1e-9."""
    tf, jf = out["state"], jax_state_fields(ref["js"])
    assert int(tf["cycle"]) == int(jf["cycle"])
    for name in INT_FIELDS:
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-9,
                                   err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        for a, b in zip(tf[name], jf[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(out["tpm"], ref["jtpm"])


def test_single_rank_matches_jax(system, runs):
    """D = 1 in this process: the degenerate plan (K_loc = K, the dummy
    row after the owned rows, no halo) is the serial sub-step."""
    ref = runs["ref"][1]
    case = ref["case"]
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
        cell_state_from_numpy,
        cell_state_to_numpy,
    )
    ts, taux, tcaux = cell_state_from_numpy(case["fields"], case["aux"],
                                            case["caux"], device="cpu")
    eng = SpatialCellEngine(TRunParams(**case["kw"]), TMW, system["tgrid"],
                            taux, system["tcg"], tcaux, device="cpu")
    assert eng.plan.ndev == 1 and eng.plan.K_loc == eng.K
    assert eng.plan.dummy_row == system["tcg"].nfine
    ts.cycle = 1
    ts, tpm = eng._sharded_scan(ts, torch.as_tensor(case["codes"]),
                                torch.as_tensor(case["u"]), N_SUB, t0=TABLE)
    _assert_matches(dict(state=cell_state_to_numpy(ts), tpm=tpm.numpy()),
                    ref)


@pytest.mark.parametrize("T", [1, 2], ids=["T1", "T2"])
def test_two_ranks_match_jax(runs, T):
    ref = runs["ref"][T]
    for out in runs["d2"][T]:
        assert out["ranks"] == (2, 1)
        assert out["plan"][0] == 2
        _assert_matches(out, ref)
    tf = runs["d2"][T][0]["state"]
    # translations on both walkers, some accepted, WL live
    assert (tf["acc"][0] > 0).all() and (tf["att"][2] > 0).all()
    assert (tf["hist"].sum(axis=0) > 0).all()


def test_space2_walkers2_matches_jax(runs):
    ref = runs["ref"][1]
    for out in runs["grid2x2"]:
        assert out["ranks"] == (2, 2)
        _assert_matches(out, ref)


def test_boundary_movers_are_computed_on_both_ranks(system):
    """At D = 2 the movers of the boundary fine blocks reach both ranks'
    owned rows (redundant compute), every mover is computed somewhere,
    and every rank's padding addresses its dummy row only."""
    cg = system["tcg"]
    eng_fc = np.stack([cg.block_cells[np.asarray(cg.color_cells[c])][:, b]
                       for c in range(8) for b in range(cg.m ** 3)])
    plan = build_spatial_plan(cg, eng_fc, 2)
    K = eng_fc.shape[1]
    shared = 0
    for t in range(eng_fc.shape[0]):
        held = [set(plan.mover_idx[t, d][plan.mover_idx[t, d] >= 0])
                for d in range(2)]
        assert held[0] | held[1] == set(range(K))
        shared += len(held[0] & held[1])
        pad = plan.mover_idx[t] < 0
        assert (plan.fc_local[t][pad] == plan.dummy_row).all()
        assert (plan.cand_local[t][pad] == plan.dummy_row).all()
    assert shared > 0


def test_refusals(system):
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import cell_state_from_numpy

    _, taux, tcaux = cell_state_from_numpy(
        jax_state_fields(system["jst"]), jax_aux_fields(system["jaux"]),
        jax_aux_fields(system["jcaux"]), device="cpu")
    prm = TRunParams(**system["kw"])

    def make(**over):
        return SpatialCellEngine(dataclasses.replace(prm, **over), TMW,
                                 system["tgrid"], taux, system["tcg"], tcaux,
                                 device="cpu")

    with pytest.raises(ValueError, match="cell_pallas"):
        make(cell_pallas="on")
    with pytest.raises(ValueError, match="requires the in-place apply"):
        make(cell_pallas="off", cell_trials=2)
    # the unfused sub-step at one trial per mover is taken
    assert not make(cell_pallas="off").use_cell_pallas
