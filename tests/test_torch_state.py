"""PyTorch port vs the JAX package: state initialisation, the state
converter, and the small ops modules (geometry, double-single, bins).

Also holds the helpers that the other port tests share: the conversion
of a JAX state into the port's numpy field dict, and a random stream
that reproduces the JAX engine's threefry draws for the port's engine.
Everything in float64 on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.constants import ANG_TO_BOHR, AUP_TO_ATM
from mc_water_ls_mw_tpu.models.lattices import switch_pair_216
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.state import init_state as jinit_state
from mc_water_ls_mw_tpu.ops import dsfloat as jds
from mc_water_ls_mw_tpu.ops import geometry as jgeo

from mc_water_ls_mw_tpu_torch.models.lattices import (
    switch_pair_216 as tswitch_pair_216,
)
from mc_water_ls_mw_tpu_torch.models.stacking import stacking_switch_pair
from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    init_state as tinit_state,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.ops import dsfloat as tds
from mc_water_ls_mw_tpu_torch.ops import geometry as tgeo

# The port's CPU tests run small tensors, which PyTorch's intra-op
# threads do not speed up; left at one thread per core, parallel test
# workers oversubscribe the cores (a full-depth cell cycle costs ~5x the
# CPU seconds for a 1.3x shorter wall).  The port's engine tests import
# this module, and pytest collects it in every worker process, so the
# port runs on one thread in each.
torch.set_num_threads(1)

TRANS, VOL, SWITCH, NOOP = 0, 1, 2, 3


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------

def jax_state_fields(s) -> dict:
    """JAX SamplerState -> the port's numpy field dict (moments stacked
    [10,L,N,W], DS masters as (hi, lo) pairs, PRNG keys dropped)."""
    out = {}
    for name, v in s._asdict().items():
        if name in ("key", "shared_key"):
            continue
        if name == "moments":
            out[name] = np.stack([np.asarray(f) for f in v])
        elif isinstance(v, jds.DS):
            out[name] = (np.asarray(v.hi), np.asarray(v.lo))
        else:
            out[name] = np.asarray(v)
    return out


def jax_aux_fields(aux) -> dict:
    return {name: (None if v is None else np.asarray(v))
            for name, v in aux._asdict().items()}


class JaxStream:
    """The draws of the JAX Engine._one_cycle and
    _scheduled_volume_moves (engine.py:1055-1131, 824-837) from a JAX
    state's keys, handed to the port's engine as tensors: no molecule
    schedule in dense mode, the multi-trial shape at T > 1."""

    def __init__(self, jax_state):
        self.shared_key = jax_state.shared_key
        self.keys = jax_state.key

    def cycle_draws(self, cycle, probs, N, W, dtype, trials=1,
                    shared_mol=True):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        ck = jax.random.fold_in(self.shared_key, cycle)
        xi = jax.random.uniform(ck, (N,), dtype=jdt)
        transP, volP, swP = probs
        codes = jnp.where(
            xi < transP, TRANS,
            jnp.where(xi < volP, VOL, jnp.where(xi < swP, SWITCH, NOOP)))
        # multi-trial steps: N/T movers of 4 + 5T uniforms each
        # (engine.py:1110-1130)
        n_steps = N // trials
        n_u = 7 if trials == 1 else 4 + 5 * trials
        sched = None
        if shared_mol:
            sched = torch.as_tensor(np.array(jax.random.randint(
                jax.random.fold_in(ck, 0x6d6f6c), (N,), 0, N,
                dtype=jnp.int32))[:n_steps])
        cycle_u = jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, cycle),
                                         (n_steps, n_u), dtype=jdt),
            out_axes=2,
        )(self.keys)
        return (torch.as_tensor(np.array(codes)), sched,
                torch.as_tensor(np.asarray(cycle_u)))

    def volume_draws(self, cycle, k, W, dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        keys = jax.vmap(lambda kk: jax.random.fold_in(
            jax.random.fold_in(kk, cycle), 100_003 + k))(self.keys)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (4,), dtype=jdt))(
            keys)
        zeta2 = jax.vmap(lambda kk: jax.random.uniform(
            jax.random.fold_in(kk, 104729), (), dtype=jdt))(keys)
        return (torch.as_tensor(np.array(u)),
                torch.as_tensor(np.array(zeta2)))


def small_run_params(**over):
    """N=216 switch-pair parameters at test size (float64, W=2)."""
    kw = dict(
        nwater=216, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=1.1 * ANG_TO_BOHR, mc_dv_max=0.924 * ANG_TO_BOHR,
        nbins=21, mu_min=-400.0, mu_max=400.0,
        mc_vol_prob=0.02, mc_switch_prob=0.0, samplerun=True,
        eq_mc_cycles=1, mpi_sync_int=1, latt_sync_int=2,
        n_walkers=2, dtype="float64",
    )
    kw.update(over)
    return kw


# ----------------------------------------------------------------------
# init_state and the converter
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_states():
    kw = small_run_params()
    r0, H0 = switch_pair_216()
    w0 = np.linspace(0.0, 3.0, 21)
    jgrid = jbins.build_bin_grid(21, -400.0, 400.0)
    js, jaux = jinit_state(RunParams(**kw), MW, r0, H0, jgrid, weight0=w0)
    tgrid = tbins.build_bin_grid(21, -400.0, 400.0)
    ts, taux = tinit_state(TRunParams(**kw), TMW, r0, H0, tgrid,
                           weight0=w0, device="cpu")
    return js, jaux, jgrid, ts, taux, tgrid


def test_init_state_parity(both_states):
    js, jaux, jgrid, ts, taux, tgrid = both_states
    jf, tf = jax_state_fields(js), state_to_numpy(ts)
    for name in ("r", "ref_r", "h", "recip", "volume"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=1e-14,
                                   atol=1e-14, err_msg=name)
    np.testing.assert_allclose(tf["energy"], jf["energy"], rtol=1e-12)
    np.testing.assert_allclose(tf["moments"], jf["moments"], rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(tf["mu"], jf["mu"], atol=1e-9)
    for name in ("ls", "window_id", "start_bin", "end_bin", "in_window",
                 "att", "acc", "trans_per_mol"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        for a, b in zip(tf[name], jf[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(taux.nbr_tbl, np.asarray(jaux.nbr_tbl))
    np.testing.assert_allclose(taux.frac0, np.asarray(jaux.frac0),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(taux.shifts, np.asarray(jaux.shifts))
    assert taux.wall == jaux.wall == 1.5
    assert taux.nbr_tbl.shape == (2, 216, 32)
    np.testing.assert_allclose(taux.log_unbiased_norm,
                               jaux.log_unbiased_norm, rtol=1e-14)
    np.testing.assert_allclose(taux.ref_enthalpy.numpy(),
                               np.asarray(jaux.ref_enthalpy), rtol=1e-12)
    np.testing.assert_allclose(tgrid.mu_bin, np.asarray(jgrid.mu_bin),
                               rtol=1e-15)
    np.testing.assert_allclose(tgrid.binwidth, np.asarray(jgrid.binwidth),
                               rtol=1e-15)
    assert tgrid.av_binwidth == jgrid.av_binwidth


def test_state_round_trip(both_states):
    js, jaux = both_states[:2]
    fields = jax_state_fields(js)
    ts, taux = state_from_numpy(fields, jax_aux_fields(jaux), device="cpu")
    back = state_to_numpy(ts)
    assert set(back) == set(fields)
    for name, v in fields.items():
        if isinstance(v, tuple):
            for a, b in zip(back[name], v):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(back[name], v, err_msg=name)
            assert back[name].dtype == v.dtype, name
    assert ts.moments.shape == (10, 2, 216, 2)
    assert ts.r.dtype == torch.float64
    np.testing.assert_array_equal(taux.nbr_tbl, np.asarray(jaux.nbr_tbl))
    # a clone is independent of its source
    tc = ts.clone()
    tc.r += 1.0
    assert not torch.equal(tc.r, ts.r)


def test_builders_match():
    r0, H0 = switch_pair_216()
    t0, tH = tswitch_pair_216()
    np.testing.assert_array_equal(r0, t0)
    np.testing.assert_array_equal(H0, tH)
    from mc_water_ls_mw_tpu.models.stacking import (
        stacking_switch_pair as jstack,
    )
    for a, b in zip(jstack(3, 3, 6), stacking_switch_pair(3, 3, 6)):
        np.testing.assert_array_equal(a, b)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


# ----------------------------------------------------------------------
# ops: geometry, double-single, bins
# ----------------------------------------------------------------------

def _random_cells(W=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.eye(3)[:, :, None] * 20.0 + rng.normal(0, 2.0, (3, 3, W))


def test_geometry_parity():
    H = _random_cells()
    jH = jnp.asarray(H)
    tH = torch.as_tensor(H)
    np.testing.assert_allclose(tgeo.determinant3(tH).numpy(),
                               np.asarray(jgeo.determinant3(jH)),
                               rtol=1e-15)
    np.testing.assert_allclose(tgeo.recip_matrix(tH).numpy(),
                               np.asarray(jgeo.recip_matrix(jH)),
                               rtol=1e-14)
    rng = np.random.default_rng(1)
    v = rng.normal(0, 15.0, (3, 5))
    rec = np.asarray(jgeo.recip_matrix(jH))
    # the JAX helpers take one cell and xyz-last vectors
    for w in range(5):
        jv = jnp.asarray(v[:, w])
        jfrac = np.asarray(jgeo.to_frac(jnp.asarray(rec[..., w]), jv))
        tfrac = tgeo.to_frac(torch.as_tensor(rec), torch.as_tensor(v))
        np.testing.assert_allclose(tfrac[:, w].numpy(), jfrac, rtol=1e-13,
                                   atol=1e-15)
        jmi = np.asarray(jgeo.min_image(jv, jH[..., w],
                                        jnp.asarray(rec[..., w])))
        tmi = tgeo.min_image(torch.as_tensor(v), tH, torch.as_tensor(rec))
        np.testing.assert_allclose(tmi[:, w].numpy(), jmi, rtol=1e-12,
                                   atol=1e-12)
    assert tgeo.cell_shift_range(H[..., 0], 9.6) == jgeo.cell_shift_range(
        H[..., 0], 9.6)
    np.testing.assert_array_equal(tgeo.enumerate_shifts((1, 2, 1)),
                                  jgeo.enumerate_shifts((1, 2, 1)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dsfloat_parity(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1e6, 64)
    incs = rng.uniform(0, 0.25, (50, 64)).astype(dtype)
    jd = jds.ds_from64(x, dtype=jnp.dtype(dtype))
    td = tds.ds_from64(x, dtype=getattr(torch, dtype), device="cpu")
    np.testing.assert_array_equal(td.hi.numpy(), np.asarray(jd.hi))
    np.testing.assert_array_equal(td.lo.numpy(), np.asarray(jd.lo))
    for inc in incs:
        jd = jds.ds_add(jd, jnp.asarray(inc))
        td = tds.ds_add(td, torch.as_tensor(inc))
    jd = jds.ds_sub(jd, jnp.asarray(incs[0]))
    td = tds.ds_sub(td, torch.as_tensor(incs[0]))
    np.testing.assert_array_equal(td.hi.numpy(), np.asarray(jd.hi))
    np.testing.assert_array_equal(td.lo.numpy(), np.asarray(jd.lo))
    np.testing.assert_array_equal(tds.ds_value64(td), jds.ds_value64(jd))


def test_mu_to_bin_and_eta_parity():
    jgrid = jbins.build_bin_grid(101, -700.0, 700.0)
    tgrid = tbins.build_bin_grid(101, -700.0, 700.0)
    rng = np.random.default_rng(3)
    mu = np.concatenate([rng.uniform(-900, 900, 500), tgrid.mu_bin,
                         [0.0, 0.5, -0.5, 699.9, -699.9]])
    np.testing.assert_array_equal(
        tbins.mu_to_bin(tgrid, torch.as_tensor(mu)).numpy(),
        np.asarray(jbins.mu_to_bin(jgrid, jnp.asarray(mu))))
    weight = rng.normal(0, 5.0, 101)
    for interp in (True, False):
        for m in mu[::25]:
            je = jbins.eta_weight(jgrid, jnp.asarray(weight), m, -700.0,
                                  700.0, 0, 100, True, interp)
            te = tbins.eta_weight(tgrid, weight, torch.as_tensor(m),
                                  -700.0, 700.0, 0, 100, True, interp)
            np.testing.assert_allclose(float(te), float(je), rtol=1e-13,
                                       atol=1e-13)
    # outside the window: the wall; before the window: no bias
    assert float(tbins.eta_weight(tgrid, weight, torch.as_tensor(800.0, dtype=torch.float64),
                                  -700.0, 700.0, 0, 100, True,
                                  True)) == tbins.ETA_WALL
    assert float(tbins.eta_weight(tgrid, weight, torch.as_tensor(10.0, dtype=torch.float64),
                                  -700.0, 700.0, 0, 100, False,
                                  True)) == 0.0
