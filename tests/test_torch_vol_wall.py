"""The NPT volume wall (``mc_vol_wall``) of the PyTorch port against the
JAX engines.

The three cases of ``tests/test_vol_wall.py``: the wall confines every
walker that starts inside it, ratchets a walker that starts outside it
(a checkpoint written without the wall) back in, and a zero wall changes
nothing.  Both packages start from the same state and consume the same
random draws (the port through a stream that reproduces JAX's threefry
draws) and are compared after every cycle or volume move: integer
outcomes exactly, continuous state within 1e-10, float64.

* The dense engine on the N=48 cells of the (1,2,6) stacking pair (four
  walkers, a volume move in every fifth trial), against the JAX engine's
  scan path.
* The cell engine on the N=8064 stacking pair of
  ``test_torch_cellengine.py`` (two walkers): volume moves one at a time
  through ``_volume`` in both packages, one walker at its reference
  volumes and one at 1.1 times them, under a wall narrower than the
  largest proposals' strain.  (A volume move of the cell engine costs a
  whole-cell energy of both lattices, ~8 s on one CPU thread here.)
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mc_water_ls_mw_tpu.models.stacking import (
    stacking_switch_pair as jstacking_switch_pair,
)
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.engine import Engine as JEngine
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine as TEngine
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    state_from_numpy,
    state_to_numpy,
)

from .test_torch_cellengine import assert_states_match
from .test_torch_cells import jax_cell_system, to_port, tt
from .test_torch_state import (
    JaxStream,
    jax_aux_fields,
    jax_state_fields,
    small_run_params,
)

WALL = 0.04
SCALE = 1.1             # the outside walkers' volume / reference volume
# (wall, cycles, walkers scaled outside the wall) of each case
CASES = {
    "confines": (WALL, 40, ()),
    "ratchets": (WALL, 60, (2, 3)),
    "zero_wall": (0.0, 20, ()),
}


def vref_of(ref_h):
    return np.abs(np.linalg.det(np.asarray(ref_h, np.float64)))   # [L]


def scaled_outside(fields, walkers, scale=SCALE):
    """A state field dict whose walkers ``walkers`` have their boxes
    scaled to ``scale`` times their volume at fixed fractional
    coordinates (the analogue of a checkpoint written without the
    wall)."""
    f = dict(fields)
    lin = scale ** (1.0 / 3.0)
    w = list(walkers)
    for name, fac in (("h", lin), ("r", lin), ("ref_r", lin),
                      ("recip", 1.0 / lin), ("volume", scale)):
        if name in f:
            a = np.array(f[name])
            a[..., w] = a[..., w] * fac
            f[name] = a
    return f


def dense_engines(wall):
    kw = small_run_params(nwater=48, n_walkers=4, mc_vol_prob=0.2,
                          mc_switch_prob=0.0, samplerun=True,
                          eq_mc_cycles=0, mpi_sync_int=10,
                          mc_vol_wall=wall)
    r0, H0 = jstacking_switch_pair(1, 2, 6)
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    js0, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid)
    jeng = JEngine(RunParams(**kw, fused="off"), MW, jgrid, jaux)
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    return kw, jeng, js0, jaux, tgrid


def assert_dense_match(ts, js):
    jf, tf = jax_state_fields(js), state_to_numpy(ts)
    for name in ("att", "acc", "ls", "trans_per_mol", "dropped"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "h", "volume", "energy", "moments", "mu", "uhist",
                 "hist"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_engine_wall_matches_jax(case):
    wall, n_cycles, outside = CASES[case]
    kw, jeng, js, jaux, tgrid = dense_engines(wall)
    if outside:
        fields = scaled_outside(jax_state_fields(js), outside)
        js = js._replace(**{k: jnp.asarray(fields[k]) for k in
                            ("h", "r", "ref_r", "recip", "volume")})
        js, _ = jeng.audit_energy(js)
    ts, taux = state_from_numpy(jax_state_fields(js), jax_aux_fields(jaux),
                                device="cpu")
    teng = TEngine(TRunParams(**kw), TMW, tgrid, taux, device="cpu",
                   stream=JaxStream(js))
    vref = vref_of(jaux.ref_h)[:, None]

    def where_(st):
        """(inside the wall [W], distance from the reference volumes
        sum_l |ln(V_l / Vref_l)| [W])."""
        ratio = st.volume.numpy() / vref                             # [L,W]
        inside = ((ratio >= 1 - wall - 1e-12)
                  & (ratio <= 1 + wall + 1e-12)).all(axis=0)
        return inside, np.abs(np.log(ratio)).sum(axis=0)

    inside, dist = where_(ts)
    assert inside.tolist() == [w not in outside for w in range(4)]
    for _ in range(n_cycles):
        js, _ = jeng.run_cycles(js, 1)
        ts, _ = teng.run_cycles(ts, 1)
        assert_dense_match(ts, js)
        inside1, dist1 = where_(ts)
        if wall > 0:
            # no walker that was inside leaves; one outside comes in or
            # moves no farther out
            assert inside1[inside].all()
            assert (inside1 | (dist1 <= dist + 1e-12))[~inside].all()
        inside, dist = inside1, dist1
    assert ts.att[1].sum() > 0 and ts.acc[1].sum() > 0
    if outside:
        # the outside walkers were ratcheted inward
        assert dist[list(outside)].mean() < 2 * np.log(SCALE)


# ----------------------------------------------------------------------
# the cell engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cell_system():
    """The N=8064 system with walker 1 at 1.1 times its reference
    volumes (energies and moments recomputed by the JAX audit)."""
    sys_ = jax_cell_system()
    fields = scaled_outside(jax_state_fields(sys_["jst"]), [1])
    js = sys_["jst"]._replace(**{k: jnp.asarray(fields[k]) for k in
                                 ("h", "r", "recip", "volume")})
    jeng = JCellEngine(RunParams(**sys_["kw"], fused="off"), MW,
                       sys_["jgrid"], sys_["jaux"], sys_["jcg"],
                       sys_["jcaux"])
    js, _ = jax.jit(jeng._audit_energy)(js)
    return sys_, js


# the volume draws k of each case (the folds of cycle 1's keys, as the
# engine draws them): k = 0 strains walker 0's box by 0.11% on a
# diagonal element, k = 4 expands walker 1's, k = 3 shrinks it; the other
# draws strain off-diagonal elements (second order in the volume)
@pytest.mark.parametrize("wall,draws", [(0.0005, (0, 3, 4)), (0.0, (0, 3))],
                         ids=["confines_and_ratchets", "zero_wall"])
def test_cell_engine_wall_matches_jax(cell_system, wall, draws):
    sys_, js = cell_system
    kw = {**sys_["kw"], "mc_vol_wall": wall}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, sys_["jgrid"],
                       sys_["jaux"], sys_["jcg"], sys_["jcaux"])
    ts, taux, tcaux = to_port(js, sys_["jaux"], sys_["jcaux"])
    teng = CellEngine(TRunParams(**kw), TMW, sys_["tgrid"], taux,
                      sys_["tcg"], tcaux, device="cpu")
    jvol = jax.jit(jeng._volume)
    vref = vref_of(sys_["jaux"].ref_h)[:, None]
    dist = np.abs(np.log(ts.volume.numpy() / vref)).sum(axis=0)
    np.testing.assert_allclose(dist, [0.0, 2 * np.log(SCALE)], atol=1e-12)
    walled = 0
    for k in draws:
        keys = jax.vmap(lambda kk: jax.random.fold_in(
            jax.random.fold_in(kk, 1), 100_003 + k))(js.key)
        u = jax.vmap(lambda kk: jax.random.uniform(
            kk, (4,), dtype=jnp.float64))(keys)
        # the proposal (mc_volume's symmetric strain of one element) and
        # whether the wall lets it through
        un = np.asarray(u)
        i, j = (np.minimum((un[:, a] * 3).astype(int), 2) for a in (0, 1))
        h_new = cell_state_to_numpy(ts)["h"].copy()
        for w in range(2):
            dlt = (2 * un[w, 2] - 1) * float(ts.dv_max[w])
            h_new[:, i[w], j[w], w] += dlt
            if i[w] != j[w]:
                h_new[:, j[w], i[w], w] += dlt
        ratio = np.abs(np.linalg.det(np.moveaxis(h_new, -1, 1))) / vref
        passes = (np.abs(ratio - 1) <= wall).all(axis=0) | (
            np.abs(np.log(ratio)).sum(axis=0) < dist)
        vol0 = ts.volume.numpy().copy()
        js = jvol(js, keys)
        teng._volume(ts, tt(u))
        assert_states_match(ts, js)
        if wall > 0:
            # a proposal the wall stops leaves the box as it was
            walled += int((~passes).sum())
            assert (ts.volume.numpy()[:, ~passes] == vol0[:, ~passes]).all()
        dist = np.abs(np.log(ts.volume.numpy() / vref)).sum(axis=0)
    tf = cell_state_to_numpy(ts)
    assert (tf["att"][1] == len(draws)).all()
    ratio = ts.volume.numpy() / vref
    if wall > 0:
        # the wall stopped a proposal; walker 0 stayed inside, and walker
        # 1 moved inward
        assert walled > 0
        assert (np.abs(ratio[:, 0] - 1) <= wall).all()
        assert tf["acc"][1][1] > 0 and dist[1] < 2 * np.log(SCALE)
    else:
        assert tf["acc"][1][0] > 0
