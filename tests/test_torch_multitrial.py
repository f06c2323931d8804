"""The port's multi-trial cell sub-step (``cell_trials = T > 1``) against
the JAX package, on the N=8064 stacking pair, float64, W = 2.

* ``MoverPointsKernel.plain`` and ``cell_energy.mover_point_energies``
  against the JAX ``MoverPointsPallas`` (interpret mode, as the JAX
  package's own tests run it on the CPU) and the JAX
  ``mover_point_energies``, at T = 2 and T = 8, within 1e-10;
* a few multi-trial sub-steps through ``_substep_canonical`` against
  the JAX ``CellEngine`` at ``cell_trials=2`` (``cell_pallas='apply'``,
  the chain kernel) under JAX's own draws: integer outcomes identical,
  continuous state within 1e-9.  One whole cycle is held against it in
  tests/test_torch_multitrial_cycle.py.

The chain at T = 8 and the chain's non-finite point table are held
against ``ChainWLPallas`` in tests/test_torch_cell_kernels.py.  The CUDA
kernel is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.ops.cell_energy import (
    mover_point_energies as jmover_point_energies,
)
from mc_water_ls_mw_tpu.ops.cell_pallas import MoverPointsPallas
from mc_water_ls_mw_tpu.ops.dense import Moments as JMoments

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import cell_state_to_numpy
from mc_water_ls_mw_tpu_torch.ops.cell_energy import mover_point_energies
from mc_water_ls_mw_tpu_torch.ops.cell_kernels import MoverPointsKernel
from mc_water_ls_mw_tpu_torch.ops.cells import PK_R0, PK_VALID
from mc_water_ls_mw_tpu_torch.ops.dense import Moments

from .test_torch_cell_kernels import movers, port_args  # noqa: F401
from .test_torch_cellengine import assert_states_match, engines
from .test_torch_cells import jax_cell_system, tt


@pytest.fixture(scope="module")
def system():
    return jax_cell_system(cell_trials=2)


@pytest.mark.parametrize("T", [2, 8])
def test_points_plain_matches_pallas(movers, T):  # noqa: F811
    """Point 0 is the stored position, points 1..T random displacements
    of 0.3 Bohr (some leave the fine cell, some bring a neighbour into
    or out of range)."""
    m = movers
    P = T + 1
    rng = np.random.default_rng(40 + T)
    p0 = m["p_old"]                                         # [L,3,K,W]
    pts = np.stack([p0] + [p0 + rng.normal(scale=0.3, size=p0.shape)
                           for _ in range(T)])               # [P,L,3,K,W]
    pks, shared = port_args(m)
    tcg, jcg = m["sys"]["tcg"], m["sys"]["jcg"]
    kern = MoverPointsKernel(TMW, tcg, P)
    e, own = kern(pks, *shared, tt(pts))
    assert kern.launches == 0            # CPU tensors: the plain version
    assert e.shape == (2, 8, P, 2) and own.shape == (2, 8, P, 10, 2)

    # jitted: the second lattice reuses the first one's compilation
    jkern = jax.jit(MoverPointsPallas(MW, jcg, n_points=P))
    slot = m["fc"].astype(np.int64)[:, None] * jcg.cap + m["rank"]
    for l in range(2):
        je, jowns = jkern(jnp.asarray(m["pk"][l]), m["jst"].h[l],
                          m["cand"], m["off"], m["fc"],
                          jnp.asarray(m["rank"]),
                          jnp.moveaxis(jnp.asarray(pts[:, l]), 0, 1))
        np.testing.assert_allclose(e[l].numpy(),
                                   np.moveaxis(np.asarray(je), 0, 1),
                                   rtol=0, atol=1e-10)
        jown = np.stack([np.stack([np.asarray(f) for f in o], axis=1)
                         for o in jowns], axis=1)            # [K,P,10,W]
        np.testing.assert_allclose(own[l].numpy(), jown, rtol=0, atol=1e-10)

        # the plain function itself against the JAX one, on the slab
        pk = m["pk"][l]
        nslot = pk.shape[0] * pk.shape[2]
        rows = lambda i: pk[:, i].reshape(nslot, -1)      # noqa: E731
        je2, jowns2, _ = jmover_point_energies(
            jnp.asarray(np.stack([rows(PK_R0 + a) for a in range(3)])),
            JMoments(*(jnp.asarray(rows(i)) for i in range(10))),
            jnp.asarray(rows(PK_VALID) > 0.5), m["jst"].h[l],
            jnp.asarray(m["cand"]), jnp.asarray(m["off"]), jcg.full_mask,
            jcg.cap, jnp.asarray(slot), jnp.asarray(pts[:, l]), MW)
        te2, towns2, _ = mover_point_energies(
            [tt(rows(PK_R0 + a)) for a in range(3)],
            Moments(*(tt(rows(i)) for i in range(10))),
            tt(rows(PK_VALID) > 0.5), shared[0][l], shared[1].long(),
            shared[2], tcg.full_mask, tcg.cap, tt(slot), tt(pts[:, l]),
            TMW)
        np.testing.assert_allclose(te2.numpy(), np.asarray(je2), rtol=0,
                                   atol=1e-10)
        for a, b in zip(towns2, jowns2):
            for fa, fb in zip(a, b):
                np.testing.assert_allclose(fa.numpy(), np.asarray(fb),
                                           rtol=0, atol=1e-10)
    # the points differ in energy: the comparison is not of zeros
    assert float((e[:, :, 1:] - e[:, :, :1]).abs().min()) > 1e-7


@pytest.fixture(scope="module")
def substeps(system):
    """Three multi-trial sub-steps at different (colour, block) tables,
    each with its own move codes over the K*T trials, from the initial
    state at cycle 1 (WL live)."""
    jeng, teng, ts = engines(system)
    assert jeng.T == teng.T == 2 and teng.n_u == 14
    K, T, W = jeng.K, jeng.T, 2
    js = system["jst"]._replace(cycle=jnp.asarray(1, jnp.int32))
    ts.cycle = 1
    jtpm = jnp.zeros((system["jcg"].nslot, W), dtype=jnp.int32)
    ttpm = torch.zeros((system["tcg"].nslot, W), dtype=torch.int32)
    sw_ok = jnp.ones(W, dtype=bool)
    jstep = jax.jit(jeng._substep_canonical)
    plan = [(5, [0] * K * T),
            (20, [0, 0, 2, 0, 3, 0, 1, 0] * T),
            (41, [0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3])]
    for n, (tbl, codes) in enumerate(plan):
        u = jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, 200 + n),
                                         (K, 4 + 5 * T),
                                         dtype=jnp.float64),
            out_axes=2)(js.key)
        js, jtpm = jstep(js, jtpm, jeng.fc_stack[tbl], jeng.cand_stack[tbl],
                         jeng.off_stack[tbl], u,
                         jnp.asarray(codes, jnp.int32), sw_ok)
        ts, ttpm = teng._substep_canonical(
            ts, ttpm, tbl, tt(u), torch.as_tensor(codes, dtype=torch.int32))
    return dict(jeng=jeng, teng=teng, js=js, ts=ts, jtpm=jtpm, ttpm=ttpm)


def test_multitrial_substeps_match_jax(substeps):
    r = substeps
    assert_states_match(r["ts"], r["js"])
    np.testing.assert_array_equal(r["ttpm"].numpy(), np.asarray(r["jtpm"]))
    tf = cell_state_to_numpy(r["ts"])
    # 16 + 10 + 14 translation trials; a switch attempt after each and
    # at the three scheduled switches
    assert tf["att"][0].tolist() == [40, 40]
    assert 0 < tf["acc"][0].min() <= tf["acc"][0].max() < 40
    assert tf["att"][2].tolist() == [43, 43]
    assert r["ttpm"].sum(dim=0).tolist() == [40, 40]
    assert (tf["hist"].sum(axis=0) > 0).all()          # WL was live
    # the apply stage left energies and moments exact
    s = r["ts"].clone()
    before = s.moments.clone()
    s, drift = r["teng"].audit_energy(s)
    assert float(drift.abs().max()) < 1e-9
    torch.testing.assert_close(s.moments, before, rtol=0, atol=1e-9)
