"""The port's spatial-partition plan (parallel/spatial.py) against the
JAX package's, and the invariants its runtime argument rests on.

numpy only: both packages build the plan on the host from their own
cell grid.  The port's ``build_spatial_plan`` equals JAX's array for
array on the N=8064 stacking pair's grid (coarse 4^3) at D = 1, 2 and 4
and on the N=16128 pair's (coarse 8 x 4 x 4) at D = 8, and both refuse
the same invalid rank counts.  Then the invariants of
tests/test_spatial.py on the port's own plan of a 75 Bohr cubic box:
exact ownership, the halo ring, schedule closure, one owner per written
cell, the degenerate single-rank plan.
"""

import dataclasses

import numpy as np
import pytest

from mc_water_ls_mw_tpu.parallel.spatial import (
    build_spatial_plan as jbuild_spatial_plan,
    stencil_reach as jstencil_reach,
)

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.ops.cells import build_grid
from mc_water_ls_mw_tpu_torch.parallel.spatial import (
    SpatialPlan,
    build_spatial_plan,
    stencil_reach,
)

from .test_torch_cells import build_grids


def _fc_stack(cg):
    """The engines' stacked (colour, fine-block) schedule."""
    return np.stack([cg.block_cells[np.asarray(cg.color_cells[c])][:, b]
                     for c in range(8) for b in range(cg.m ** 3)])


@pytest.fixture(scope="module")
def grids():
    """{name: (JAX grid, port grid)} of the N=8064 and N=16128 pairs."""
    out = {}
    for name, dims in (("n8064", (14, 8, 18)), ("n16128", (28, 8, 18))):
        _, _, _, jcg, tcg = build_grids(*dims)
        out[name] = (jcg, tcg)
    return out


@pytest.mark.parametrize("name,ndev", [("n8064", 1), ("n8064", 2),
                                       ("n8064", 4), ("n16128", 8)])
def test_plan_equals_jax(grids, name, ndev):
    jcg, tcg = grids[name]
    fcs = _fc_stack(tcg)
    np.testing.assert_array_equal(fcs, _fc_stack(jcg))
    np.testing.assert_array_equal(stencil_reach(tcg), jstencil_reach(jcg))
    tp = build_spatial_plan(tcg, fcs, ndev)
    jp = jbuild_spatial_plan(jcg, _fc_stack(jcg), ndev)
    for f in dataclasses.fields(SpatialPlan):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tp.rows_local == jp.rows_local


@pytest.mark.parametrize("name,ndev", [("n8064", 3), ("n8064", 8),
                                       ("n16128", 16)])
def test_invalid_rank_counts_refused_as_jax(grids, name, ndev):
    jcg, tcg = grids[name]
    with pytest.raises(ValueError) as terr:
        build_spatial_plan(tcg, _fc_stack(tcg), ndev)
    with pytest.raises(ValueError) as jerr:
        jbuild_spatial_plan(jcg, _fc_stack(jcg), ndev)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------------
# the invariants of tests/test_spatial.py, on the port's plan
# ----------------------------------------------------------------------

def _grid():
    H = np.eye(3) * 75.0
    return build_grid((4, 4, 4), 4, [H, H], TMW, 0.0, m=2)


@pytest.fixture(scope="module")
def plan2():
    cg = _grid()
    return cg, _fc_stack(cg), build_spatial_plan(cg, _fc_stack(cg), 2)


def _owner(cg, plan):
    return (np.arange(cg.nfine) // (cg.nf[1] * cg.nf[2])) // plan.layers_owned


def test_reach(plan2):
    # fine side 75/8 = 9.4 Bohr > the coverage radius: reach 1
    assert stencil_reach(plan2[0]).tolist() == [1, 1, 1]
    assert plan2[2].halo_layers == 2


def test_ownership_and_halo_ring(plan2):
    cg, _, plan = plan2
    owner = _owner(cg, plan)
    for d in range(plan.ndev):
        loc = plan.loc_of_global[d]
        owned = np.nonzero((loc >= 0) & (loc < plan.rows_owned))[0]
        assert np.array_equal(owned, np.nonzero(owner == d)[0])
        assert np.array_equal(loc[owned], np.arange(plan.rows_owned))
        # lo halo = the down neighbour's last owned rows, hi halo = the
        # up neighbour's first (the ring shift's two blocks)
        dn, up = (d - 1) % plan.ndev, (d + 1) % plan.ndev
        assert np.array_equal(plan.halo_lo_src[d],
                              np.nonzero(owner == dn)[0][-plan.rows_halo:])
        assert np.array_equal(plan.halo_hi_src[d],
                              np.nonzero(owner == up)[0][:plan.rows_halo])
        assert np.array_equal(loc[plan.halo_lo_src[d]],
                              plan.rows_owned + np.arange(plan.rows_halo))
        assert np.array_equal(
            loc[plan.halo_hi_src[d]],
            plan.rows_owned + plan.rows_halo + np.arange(plan.rows_halo))


def test_schedule_closure_and_single_owner(plan2):
    cg, fcs, plan = plan2
    T, K = fcs.shape
    for t in range(T):
        cand = cg.full_cells[fcs[t]]
        fc_owned = np.zeros(K, int)
        cand_owned = np.zeros(cand.shape, int)
        for d in range(plan.ndev):
            loc = plan.loc_of_global[d]
            for j in range(plan.K_loc):
                k = plan.mover_idx[t, d, j]
                if k < 0:
                    assert plan.fc_local[t, d, j] == plan.dummy_row
                    assert not plan.own_fc[t, d, j]
                    continue
                assert loc[fcs[t, k]] == plan.fc_local[t, d, j]
                assert np.all(plan.cand_local[t, d, j] == loc[cand[k]])
                assert np.all(loc[cand[k]] >= 0)
                fc_owned[k] += plan.own_fc[t, d, j]
                cand_owned[k] += plan.own_cand[t, d, j]
        assert (fc_owned == 1).all() and (cand_owned == 1).all()


def test_single_rank_degenerates():
    cg = _grid()
    fcs = _fc_stack(cg)
    plan = build_spatial_plan(cg, fcs, 1)
    assert plan.K_loc == fcs.shape[1]
    assert plan.dummy_row == cg.nfine == plan.rows_owned
    assert np.array_equal(plan.loc_of_global[0], np.arange(cg.nfine))
    assert plan.own_fc[:, 0].all()
    order = np.argsort(plan.mover_idx[0, 0])
    assert np.array_equal(plan.fc_local[0, 0][order], fcs[0])
    # 4 ranks own 2 fine layers each: exactly the halo depth, allowed
    assert build_spatial_plan(cg, fcs, 4).layers_owned == 2
