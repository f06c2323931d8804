"""PyTorch port vs the JAX package: the two-level cell grid
(ops/cells.py), the slab full energy (ops/cell_energy.py) and the
initial slab state (mcmc/cellengine.init_cell_state).

Also holds the helpers that the other cell-engine tests of the port
share: the N=8064 stacking pair in both packages, the conversion of a
JAX CellState into the port's numpy field dict, a jittered slab state,
and a random stream that reproduces the JAX CellEngine's threefry draws
for the port's engine.  Everything in float64 on the CPU, W = 2.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.constants import ANG_TO_BOHR, AUP_TO_ATM
from mc_water_ls_mw_tpu.models.stacking import (
    correspondence_mismatch as jmismatch,
    stacking_switch_pair as jstack,
)
from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc import bins as jbins
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.cellengine import (
    init_cell_state as jinit_cell_state,
)
from mc_water_ls_mw_tpu.ops import cells as jcells
from mc_water_ls_mw_tpu.ops.cell_energy import (
    slab_full_energy as jslab_full_energy,
)

from mc_water_ls_mw_tpu_torch.models.stacking import (
    correspondence_mismatch,
    stacking_switch_pair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import bins as tbins
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    cell_state_from_numpy,
    cell_state_to_numpy,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.ops import cells as tcells
from mc_water_ls_mw_tpu_torch.ops.cell_energy import slab_full_energy

from .test_torch_state import JaxStream, jax_aux_fields, jax_state_fields

TRANS, VOL, SWITCH, NOOP = 0, 1, 2, 3


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------

def cell_run_params(dims=(14, 8, 18), **over):
    """The parameters of the stacking pair ``dims`` (N = 4 * product;
    the N=8064 pair by default) at test size (float64, W = 2; step sizes
    and bins of the JAX package's own large-N benchmark,
    scripts/bench_largen.py)."""
    N = 4 * int(np.prod(dims))
    kw = dict(
        nwater=N, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=0.25 * ANG_TO_BOHR, mc_dv_max=0.2 * ANG_TO_BOHR,
        nbins=201, mu_min=-1200.0, mu_max=1200.0,
        mc_vol_prob=1.0 / N, mc_switch_prob=0.1, samplerun=False,
        eq_mc_cycles=0, wl_factor=0.05, list_update_int=100000,
        mpi_sync_int=100000, latt_sync_int=100000,
        n_walkers=2, dtype="float64",
        cell_trials=1, cell_pallas="apply", cell_chain="on",
    )
    kw.update(over)
    return kw


def build_grids(nx=14, ny=8, m=18):
    """(r0, H0, mismatch, JAX CellGrid, port CellGrid) of a stacking
    pair, each grid built by its own package."""
    r0, H0 = jstack(nx, ny, m)
    mx, _ = jmismatch(r0, H0)
    jshape = jcells.choose_grid_shape(H0, MW, mx)
    jcg = jcells.build_grid(
        jshape, jcells.cap_for_positions(r0, H0, jshape), H0, MW, mx)
    tr0, tH0 = stacking_switch_pair(nx, ny, m)
    tmx, _ = correspondence_mismatch(tr0, tH0)
    tshape = tcells.choose_grid_shape(tH0, TMW, tmx)
    tcg = tcells.build_grid(
        tshape, tcells.cap_for_positions(tr0, tH0, tshape), tH0, TMW, tmx)
    return r0, H0, mx, jcg, tcg


def jax_cell_system(dims=(14, 8, 18), **over):
    """The system of the stacking pair ``dims`` (N=8064 by default) in
    the JAX package: a dict with the run parameters, both bin grids, both
    cell grids and the JAX initial state with its aux tuples."""
    kw = cell_run_params(dims, **over)
    r0, H0, mx, jcg, tcg = build_grids(*dims)
    jgrid = jbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"],
                                 dtype=jnp.float64)
    tgrid = tbins.build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    jst, jaux, jcaux = jinit_cell_state(RunParams(**kw, fused="off"), MW,
                                        r0, H0, jgrid, jcg)
    return dict(kw=kw, r0=r0, H0=H0, jcg=jcg, tcg=tcg, jgrid=jgrid,
                tgrid=tgrid, jst=jst, jaux=jaux, jcaux=jcaux)


def to_port(jst, jaux, jcaux):
    """(CellState, EngineAux, CellAux) of the port from a JAX cell
    state and its aux tuples, on the CPU."""
    return cell_state_from_numpy(
        jax_state_fields(jst), jax_aux_fields(jaux),
        jax_aux_fields(jcaux), device="cpu")


def jitter_slab(sys_, seed=0, scale=0.05):
    """A JAX cell state whose occupied slots are displaced by
    N(0, scale) Bohr in both lattices (small against the fine cells, so
    the coverage tables stay valid), with moments and energies
    recomputed from scratch."""
    jst, jcg = sys_["jst"], sys_["jcg"]
    rng = np.random.default_rng(seed)
    valid = np.asarray(jst.slot2mol) >= 0                    # [nslot,W]
    r = np.asarray(jst.r) + np.where(
        valid[None, None], rng.normal(0, scale, jst.r.shape), 0.0)
    r = jnp.asarray(r)
    per = [jslab_full_energy(r[l], jnp.asarray(valid), jst.h[l], jcg, MW)
           for l in range(2)]
    moments = type(jst.moments)(*(
        jnp.stack([per[l][1][i] for l in range(2)]) for i in range(10)))
    return jst._replace(r=r, moments=moments,
                        energy=jnp.stack([p[0] for p in per]))


def tt(x):
    """A JAX or numpy array as a (writable) CPU tensor."""
    return torch.as_tensor(np.array(x))


class JaxCellStream(JaxStream):
    """The draws of the JAX CellEngine._cycle_with and _rebin
    (cellengine.py:1792-1795, 1974-1999) and of the inherited volume
    moves from a JAX state's keys, handed to the port's engine as
    tensors."""

    def rebin_origin(self, cycle, dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        okey = jax.random.fold_in(
            jax.random.fold_in(self.shared_key, cycle), 0x0E161)
        return tt(jax.random.uniform(okey, (3,), dtype=jdt))

    def cell_cycle_draws(self, cycle, probs, n_trials, n_sub, K, n_u, W,
                         dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        ck = jax.random.fold_in(self.shared_key, cycle)
        xi = jax.random.uniform(ck, (n_trials,), dtype=jdt)
        transP, volP, swP = probs
        codes = jnp.where(
            xi < transP, TRANS,
            jnp.where(xi < volP, VOL, jnp.where(xi < swP, SWITCH, NOOP)))
        u_all = jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, cycle),
                                         (n_sub, K, n_u), dtype=jdt),
            out_axes=3,
        )(self.keys)
        return tt(codes), tt(u_all)


@pytest.fixture(scope="module")
def system():
    return jax_cell_system()


# ----------------------------------------------------------------------
# the grid construction (host numpy in both packages)
# ----------------------------------------------------------------------

def stencils_overlap(cg) -> bool:
    """Whether the coverage stencils of some two same-colour movers
    share a fine cell (the engine's scatter_unique is its negation on an
    unpadded grid)."""
    for col in range(8):
        cells_c = np.asarray(cg.color_cells[col])
        for b in range(cg.m ** 3):
            cand = cg.full_cells[cg.block_cells[cells_c][:, b]]
            if len(np.unique(cand)) != cand.size:
                return True
    return False


@pytest.mark.parametrize("dims", [(14, 8, 18), (12, 7, 18), (24, 14, 18)])
def test_grid_tables_identical(dims):
    r0, H0, mx, jcg, tcg = build_grids(*dims)
    assert tcg.n == jcg.n and tcg.m == jcg.m and tcg.cap == jcg.cap
    assert tcg.guard == jcg.guard
    for f in dataclasses.fields(jcg):
        a, b = getattr(tcg, f.name), getattr(jcg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    for prop in ("nf", "ncoarse", "nfine", "nslot", "cells_per_color"):
        assert getattr(tcg, prop) == getattr(jcg, prop)
    if dims == (14, 8, 18):
        # the geometry the slice runs: coarse 4^3, m = 2, 512 fine
        # cells, cap 32, the 27-cell stencil with no padding
        assert tcg.n == (4, 4, 4) and tcg.m == 2 and tcg.nfine == 512
        assert tcg.cap == 32 and tcg.full_cells.shape == (512, 27)
        assert tcg.full_mask.all() and tcg.cells_per_color == 8
        # the disjoint-stencil shape is refused for this box in both
        with pytest.raises(ValueError):
            tcells.choose_grid_shape(H0, TMW, mx, prefer_disjoint=True)
        with pytest.raises(ValueError):
            jcells.choose_grid_shape(H0, MW, mx, prefer_disjoint=True)
        assert not stencils_overlap(tcg)
    elif dims == (24, 14, 18):
        # the N=24192 flagship on the grid the front end picks for it:
        # coarse (8,8,4), 2048 fine cells narrower than the coverage
        # radius, 75-cell stencils that overlap between same-colour
        # movers, 32 movers per sub-step
        assert tcg.n == (8, 8, 4) and tcg.m == 2 and tcg.nfine == 2048
        assert tcg.cap == 32 and tcg.full_cells.shape == (2048, 75)
        assert tcg.full_mask.all() and tcg.cells_per_color == 32
        assert stencils_overlap(tcg)
        # only the disjoint-stencil request gives it the 27-cell grid
        assert tcells.choose_grid_shape(
            H0, TMW, mx, prefer_disjoint=True) == (6, 6, 4)
        assert jcells.choose_grid_shape(
            H0, MW, mx, prefer_disjoint=True) == (6, 6, 4)
    else:
        assert tcg.full_cells.shape[1] == 75 and stencils_overlap(tcg)


def test_grid_helpers_identical():
    r0, H0, mx, jcg, tcg = build_grids(12, 7, 18)
    np.testing.assert_array_equal(tcells.perp_widths(H0[0]),
                                  jcells.perp_widths(H0[0]))
    assert tcells.coverage_radius(TMW, mx) == jcells.coverage_radius(MW, mx)
    assert tcells.min_coarse_side(TMW, mx, 1.13) == jcells.min_coarse_side(
        MW, mx, 1.13)
    for samples in (1, 8):
        assert tcells.cap_for_positions(r0, H0, tcg.n, samples=samples) \
            == jcells.cap_for_positions(r0, H0, jcg.n, samples=samples)
    with pytest.raises(ValueError):
        tcells.build_grid((3, 4, 4), 8, H0, TMW, mx)


# ----------------------------------------------------------------------
# the tensor functions
# ----------------------------------------------------------------------

def test_cell_of_frac_and_binning_identical(system):
    jcg, tcg = system["jcg"], system["tcg"]
    rng = np.random.default_rng(1)
    N, W = 8064, 3
    f = rng.uniform(-1.5, 2.5, (3, N, W))
    origin = rng.uniform(0, 1, 3)
    for level in ("coarse", "fine"):
        jc = np.asarray(jcells.cell_of_frac(jcg, jnp.asarray(f),
                                            jnp.asarray(origin), level))
        tc = tcells.cell_of_frac(tcg, torch.as_tensor(f),
                                 torch.as_tensor(origin), level)
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), jc, err_msg=level)
    # a crystal-like occupancy (every cell holds molecules, ties by
    # molecule index) and one walker that overflows the capacity
    cid = np.array(jcells.cell_of_frac(jcg, jnp.asarray(f),
                                       jnp.asarray(origin), "fine"))
    cid[:100, 2] = 7
    jslot, jmax = jcells.bin_molecules(jcg, jnp.asarray(cid))
    tslot, tmax = tcells.bin_molecules(tcg, torch.as_tensor(cid))
    assert tslot.dtype == torch.int32 and tmax.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    assert int(tmax[2]) > tcg.cap >= int(tmax[0])


def test_slab_scatter_gather_identical(system):
    jcg, tcg = system["jcg"], system["tcg"]
    rng = np.random.default_rng(2)
    N, W = 8064, 2
    slot = np.stack([rng.permutation(tcg.nslot)[:N] for _ in range(W)],
                    axis=1).astype(np.int32)
    vals = rng.normal(0, 1, (2, 3, N, W))
    jslab = jcells.scatter_to_slab(jnp.asarray(vals), jnp.asarray(slot),
                                   jcg.nslot)
    tslab = tcells.scatter_to_slab(torch.as_tensor(vals),
                                   torch.as_tensor(slot), tcg.nslot)
    np.testing.assert_array_equal(tslab.numpy(), np.asarray(jslab))
    back = tcells.gather_from_slab(tslab, torch.as_tensor(slot))
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jcells.gather_from_slab(jslab, jnp.asarray(slot))))
    ints = rng.integers(0, 9, (tcg.nslot, W)).astype(np.int32)
    np.testing.assert_array_equal(
        tcells.gather_from_slab(torch.as_tensor(ints),
                                torch.as_tensor(slot)).numpy(),
        np.asarray(jcells.gather_from_slab(jnp.asarray(ints),
                                           jnp.asarray(slot))))


# ----------------------------------------------------------------------
# slab full energy, init_cell_state and the converter
# ----------------------------------------------------------------------

def test_slab_full_energy_matches_jax(system):
    jst = jitter_slab(system, seed=3)
    valid = np.asarray(jst.slot2mol) >= 0
    for l in range(2):
        je, jmom = jslab_full_energy(jst.r[l], jnp.asarray(valid), jst.h[l],
                                     system["jcg"], MW)
        te, tmom = slab_full_energy(tt(jst.r[l]), tt(valid), tt(jst.h[l]),
                                    system["tcg"], TMW)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12)
        np.testing.assert_allclose(
            tmom.numpy(), np.stack([np.asarray(f) for f in jmom]),
            rtol=0, atol=1e-12)
        # another chunking sums in another order only
        te2, tmom2 = slab_full_energy(tt(jst.r[l]), tt(valid), tt(jst.h[l]),
                                      system["tcg"], TMW, max_elems=1 << 20)
        np.testing.assert_allclose(te2.numpy(), te.numpy(), rtol=1e-12)
        np.testing.assert_allclose(tmom2.numpy(), tmom.numpy(), rtol=0,
                                   atol=1e-12)


def test_init_cell_state_parity(system):
    kw = system["kw"]
    w0 = 0.002 * (np.arange(201) - 100.0) ** 2
    jst, jaux, jcaux = jinit_cell_state(
        RunParams(**kw, fused="off"), MW, system["r0"], system["H0"],
        system["jgrid"], system["jcg"], weight0=w0)
    ts, taux, tcaux = init_cell_state(
        TRunParams(**kw), TMW, system["r0"], system["H0"], system["tgrid"],
        system["tcg"], weight0=w0, device="cpu")
    jf, tf = jax_state_fields(jst), cell_state_to_numpy(ts)
    assert set(tf) == set(jf)
    floats = ("r", "h", "recip", "volume", "energy", "energy_err", "mu",
              "moments", "origin", "weight", "hist", "uhist", "f",
              "sumhist", "my_mu_min", "my_mu_max", "max_trans", "dv_max",
              "avg_energy", "min_dmu", "max_dmu")
    for name in floats:
        assert tf[name].shape == jf[name].shape, name
        np.testing.assert_allclose(tf[name], jf[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    for name in set(jf) - set(floats) - {
            "master_eta", "master_hist", "master_uhist"}:
        assert tf[name].shape == jf[name].shape, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("master_eta", "master_hist", "master_uhist"):
        for a, b in zip(tf[name], jf[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tf["slot2mol"] >= 0).sum(axis=0).tolist() == [8064, 8064]
    np.testing.assert_allclose(tcaux.dfrac0.numpy(),
                               np.asarray(jcaux.dfrac0), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(tcaux.fref0.numpy(),
                                  np.asarray(jcaux.fref0))
    assert tcaux._fields == ("dfrac0", "fref0")
    np.testing.assert_allclose(taux.ref_h, np.asarray(jaux.ref_h),
                               rtol=1e-15)
    np.testing.assert_allclose(taux.ref_enthalpy.numpy(),
                               np.asarray(jaux.ref_enthalpy), rtol=1e-12)
    np.testing.assert_allclose(taux.log_unbiased_norm,
                               jaux.log_unbiased_norm, rtol=1e-14)


def test_cell_state_round_trip(system):
    fields = jax_state_fields(system["jst"])
    ts, taux, tcaux = to_port(system["jst"], system["jaux"],
                              system["jcaux"])
    back = cell_state_to_numpy(ts)
    assert set(back) == set(fields)
    for name, v in fields.items():
        if isinstance(v, tuple):
            for a, b in zip(back[name], v):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(back[name], v, err_msg=name)
            assert back[name].dtype == v.dtype, name
    assert ts.moments.shape == (10, 2, system["tcg"].nslot, 2)
    assert ts.slot2mol.dtype == ts.mol2slot.dtype == torch.int32
    assert ts.energy_err.shape == (2, 2) and ts.cycle == 0
    assert taux.nbr_tbl is None
    # a clone is independent of its source
    tc = ts.clone()
    tc.r += 1.0
    tc.slot2mol += 1
    assert not torch.equal(tc.r, ts.r)
    assert not torch.equal(tc.slot2mol, ts.slot2mol)


def test_init_one_lattice_matches_jax(system):
    """init_cell_state at one lattice (the pair's first lattice alone, on
    the pair's grid) against the JAX package's: the slab layout, the
    energy and moments, mu 0 and the reference enthalpy."""
    kw = {**system["kw"], "num_lattices": 1}
    r0, H0 = system["r0"][:1], system["H0"][:1]
    jst, jaux, _ = jinit_cell_state(RunParams(**kw, fused="off"), MW, r0,
                                    H0, system["jgrid"], system["jcg"])
    ts, taux, _ = init_cell_state(TRunParams(**kw), TMW, r0, H0,
                                  system["tgrid"], system["tcg"],
                                  device="cpu")
    jf, tf = jax_state_fields(jst), cell_state_to_numpy(ts)
    assert tf["r"].shape[0] == 1 and set(tf) == set(jf)
    for name in ("slot2mol", "mol2slot", "ls"):
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("r", "energy", "moments", "mu", "volume"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert (tf["mu"] == 0).all()
    np.testing.assert_allclose(taux.ref_enthalpy.numpy(),
                               np.asarray(jaux.ref_enthalpy), rtol=1e-12)
