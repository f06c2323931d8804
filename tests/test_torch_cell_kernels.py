"""The plain PyTorch versions of the port's three cell-engine kernels
against the JAX functions that reach the Pallas kernels they replace.

On a jittered N=8064 slab state (the production-shaped grid: 27-cell
stencils, disjoint for same-colour movers), float64, W = 2:

* ``MoverEnergiesKernel.plain`` vs ``MoverEnergiesPallas``
  (with_deltas=False);
* ``MoverApplyKernel.plain`` vs ``MoverApplyPallas`` (the packed slab);
* ``ChainWLKernel.plain`` vs ``ChainWLPallas`` with WL live and in a
  sample run, at one, two and eight trials per mover, at the flagship's
  32 movers, and on a point table that holds a non-finite energy
  (integer outputs identical);

and on a jittered N=6048 state of the (12,7,18) pair (75-cell stencils
that overlap between same-colour movers) ``MoverEnergiesKernel.plain``
with deltas vs ``MoverEnergiesPallas(with_deltas=True)``.

The Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.chain_pallas import ChainWLPallas
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.ops.cell_pallas import (
    MoverApplyPallas,
    MoverEnergiesPallas,
)

from mc_water_ls_mw_tpu_torch.models.sw import MW as TMW
from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams as TRunParams
from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
    MoverApplyKernel,
    MoverEnergiesKernel,
)
from mc_water_ls_mw_tpu_torch.ops.cells import PK_ROWS, PK_VALID

from .test_torch_cells import cell_run_params, jax_cell_system, jitter_slab, tt
from .test_torch_chain_plan import chain_inputs, poison_point


def pack_lattice(st, cg, l):
    """Packed slab [nfine, PK_ROWS, cap, W] of lattice l of a JAX cell
    state (the CellEngine._pack layout), as numpy."""
    nfine, cap = cg.nfine, cg.cap
    W = st.r.shape[-1]
    rows = [np.asarray(f[l]).reshape(nfine, cap, W) for f in st.moments]
    rows += [np.asarray(st.r[l, a]).reshape(nfine, cap, W)
             for a in range(3)]
    rows.append((np.asarray(st.slot2mol) >= 0).astype(rows[0].dtype)
                .reshape(nfine, cap, W))
    return np.stack(rows, axis=1)


def mover_case(dims, with_deltas=False):
    """A sub-step's inputs on a jittered state of the stacking pair
    ``dims``: the (colour 3, block 1) table, random ranks among the
    occupants, proposals 0.3 Bohr from the old positions (some within a
    fine cell, some beyond)."""
    sys_ = jax_cell_system(dims)
    jcg = sys_["jcg"]
    jst = jitter_slab(sys_, seed=5)
    K, cap, W = jcg.cells_per_color, jcg.cap, 2
    rng = np.random.default_rng(6)
    fc = jcg.block_cells[np.asarray(jcg.color_cells[3])][:, 1]
    cand, off = jcg.full_cells[fc], jcg.full_off[fc]
    occ = (np.asarray(jst.slot2mol).reshape(jcg.nfine, cap, W) >= 0
           ).sum(axis=1)
    rank = np.stack([[rng.integers(0, max(occ[fc[k], w], 1))
                      for w in range(W)] for k in range(K)]).astype(np.int32)
    slot = fc[:, None] * cap + rank
    r = np.asarray(jst.r)
    p_old = np.stack([np.stack([r[l, a][slot, np.arange(W)[None, :]]
                                for a in range(3)]) for l in range(2)])
    p_new = p_old + rng.normal(scale=0.3, size=p_old.shape)
    pk = np.stack([pack_lattice(jst, jcg, l) for l in range(2)])
    assert pk.shape == (2, jcg.nfine, PK_ROWS, cap, W)
    # the JAX kernels jitted, so that the second lattice and the second
    # test reuse the first call's compilation (an eager interpret-mode
    # call traces and compiles the kernel anew every time)
    return dict(sys=sys_, jst=jst, fc=fc.astype(np.int32),
                cand=cand.astype(np.int32), off=off.astype(np.int32),
                rank=rank, p_old=p_old, p_new=p_new, pk=pk,
                accf=rng.uniform(size=(K, W)) < 0.6,
                jenergies=jax.jit(MoverEnergiesPallas(
                    MW, jcg, with_deltas=with_deltas)),
                japply=jax.jit(MoverApplyPallas(MW, jcg)))


@pytest.fixture(scope="module")
def movers():
    """The N=8064 pair's sub-step inputs (mover_case)."""
    return mover_case((14, 8, 18))


@pytest.fixture(scope="module")
def movers75():
    """The (12,7,18) pair's sub-step inputs: CF = 75, overlapping
    same-colour stencils (mover_case)."""
    return mover_case((12, 7, 18), with_deltas=True)


def port_args(m):
    pks = [tt(m["pk"][l]) for l in range(2)]
    return pks, (tt(m["jst"].h), tt(m["cand"]), tt(m["off"]), tt(m["fc"]),
                 tt(m["rank"]))


def jax_energies(m, l):
    return m["jenergies"](
        jnp.asarray(m["pk"][l]), m["jst"].h[l], m["cand"], m["off"],
        m["fc"], jnp.asarray(m["rank"]), jnp.asarray(m["p_old"][l]),
        jnp.asarray(m["p_new"][l]))


def test_mover_energies_plain_matches_pallas(movers):
    m = movers
    pks, shared = port_args(m)
    kern = MoverEnergiesKernel(TMW, m["sys"]["tcg"])
    e, own = kern(pks, *shared, tt(m["p_old"]), tt(m["p_new"]))
    assert kern.launches == 0            # CPU tensors: the plain version
    assert e.shape == (2, 8, 2, 2) and own.shape == (2, 8, 10, 2)
    e_old, e_new = e[:, :, 0], e[:, :, 1]
    for l in range(2):
        je_old, je_new, jown, jd = jax_energies(m, l)
        assert jd is None
        np.testing.assert_allclose(e_old[l].numpy(), np.asarray(je_old),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(e_new[l].numpy(), np.asarray(je_new),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            own[l].numpy(), np.stack([np.asarray(f) for f in jown], axis=1),
            rtol=0, atol=1e-10)
    # the proposals change the energies: the comparison is not of zeros
    assert float((e_new - e_old).abs().min()) > 1e-6


def test_mover_energies_deltas_plain_matches_pallas(movers75):
    """The per-candidate delta output (the JAX kernel's with_deltas=True)
    on 75-cell stencils: energies, own moments and every field of the
    deltas new - old of every candidate slot."""
    m = movers75
    tcg = m["sys"]["tcg"]
    K, CF, cap = tcg.cells_per_color, tcg.full_cells.shape[1], tcg.cap
    assert (K, CF, cap) == (8, 75, 28)
    pks, shared = port_args(m)
    kern = MoverEnergiesKernel(TMW, tcg, with_deltas=True)
    e, own, dlt = kern(pks, *shared, tt(m["p_old"]), tt(m["p_new"]))
    assert kern.launches == 0 and kern.name == "mover_energies_deltas"
    assert dlt.shape == (2, K, CF, 10, cap, 2)
    for l in range(2):
        je_old, je_new, jown, jd = jax_energies(m, l)
        np.testing.assert_allclose(e[l, :, 0].numpy(), np.asarray(je_old),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(e[l, :, 1].numpy(), np.asarray(je_new),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            own[l].numpy(), np.stack([np.asarray(f) for f in jown], axis=1),
            rtol=0, atol=1e-10)
        for f in range(10):
            np.testing.assert_allclose(dlt[l, :, :, f].numpy(),
                                       np.asarray(jd[f]), rtol=0, atol=1e-10,
                                       err_msg=f"delta field {f}")
        # the deltas are not all zeros: some slots of every mover's
        # stencil are in range of one of its two positions
        nz = (dlt[l] != 0).any(dim=2)                     # [K,CF,cap,W]
        assert bool(nz.flatten(1, 2).any(dim=1).all())
    # the same energies and own moments as without the delta output
    e0, own0 = MoverEnergiesKernel(TMW, tcg)(pks, *shared, tt(m["p_old"]),
                                             tt(m["p_new"]))
    assert torch.equal(e0, e) and torch.equal(own0, own)


def test_mover_apply_plain_matches_pallas(movers):
    m = movers
    pks, shared = port_args(m)
    tcg = m["sys"]["tcg"]
    own = MoverEnergiesKernel(TMW, tcg).plain(
        pks, *shared, tt(m["p_old"]), tt(m["p_new"]))[1]
    before = [pk.clone() for pk in pks]
    kern = MoverApplyKernel(TMW, tcg)
    out = kern(pks, *shared, tt(m["accf"]), tt(m["p_old"]), tt(m["p_new"]),
               own)
    assert out[0] is pks[0] and kern.launches == 0       # in place
    for l in range(2):
        jown = jax_energies(m, l)[2]
        jpk = m["japply"](jnp.asarray(m["pk"][l]), m["jst"].h[l], m["cand"],
                     m["off"], m["fc"], jnp.asarray(m["rank"]),
                     jnp.asarray(m["accf"]), jnp.asarray(m["p_old"][l]),
                     jnp.asarray(m["p_new"][l]), jown)
        np.testing.assert_allclose(pks[l].numpy(), np.asarray(jpk), rtol=0,
                                   atol=1e-10)
        # accepted movers moved, the validity row is untouched, and the
        # strided float form of the accept flags gives the same slab
        changed = (pks[l] != before[l]).any(dim=1).any(dim=1)  # [nfine,W]
        assert bool(changed[m["fc"].astype(np.int64)][tt(m["accf"])].all())
        assert torch.equal(pks[l][:, PK_VALID], before[l][:, PK_VALID])
    joh = torch.stack([1.0 - tt(m["accf"]).double(),
                       tt(m["accf"]).double()], dim=1)          # [K,2,W]
    again = kern.plain([b.clone() for b in before], *shared, joh[:, 1],
                       tt(m["p_old"]), tt(m["p_new"]), own)
    for l in range(2):
        assert torch.equal(again[l], pks[l])


@functools.lru_cache(maxsize=None)
def chain_case(samplerun, T, K):
    """(inputs, port chain, port tensors after the pass, joh, cnt) of one
    chain test case on W = 6 walkers, after run_chains held it against
    ``ChainWLPallas``; once per process, because an interpret-mode call
    of the JAX kernel traces and compiles it anew (~30 s).  At T = 2 one
    point energy is infinite (poison_point)."""
    W = 6
    x = chain_inputs(K, T, W, 201, seed=11 + T)
    if T == 2:
        poison_point(x, K, T)
    return (x, *run_chains(x, K, T, W, samplerun))


def run_chains(x, K, T, W, samplerun=False, **over):
    """One chain pass of ``ChainWLPallas`` and of the port's plain
    chain on the inputs ``x`` (chain_inputs) at cycle 7, the run's rules
    changed by ``over``.  Returns (port chain, port tensors after the
    pass, joh, cnt) after asserting that the integer outputs are
    identical and the rows and slabs agree within 1e-10."""
    kw = cell_run_params(samplerun=samplerun, n_walkers=W, cell_trials=T,
                         **over)
    jprm, tprm = RunParams(**kw, fused="off"), TRunParams(**kw)
    from mc_water_ls_mw_tpu.mcmc.bins import build_bin_grid as jgrid
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid as tgrid
    jg = jgrid(kw["nbins"], kw["mu_min"], kw["mu_max"], dtype=jnp.float64)
    tg = tgrid(kw["nbins"], kw["mu_min"], kw["mu_max"])
    log_norm = 3.0

    jk = ChainWLPallas(jprm, jg, K, T, log_norm)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    jcf, jci, jw, jh, ju, jjoh, jcnt = jk(
        j["codes"], jnp.asarray([1, 7], jnp.int32), j["cf"], j["ci"],
        j["wgt"], j["hist"], j["uh"], j["basew"], j["baseh"],
        jg.binwidth[:, None], jg.mu_bin[:, None], j["e"], j["inc"],
        j["hasm"], j["ua"], j["uz"])

    tk = ck.ChainWLKernel(tprm, tg, K, T, log_norm)
    t = {k: tt(v) for k, v in x.items()}
    joh, cnt = tk(t["codes"], True, t["cf"], t["ci"], t["wgt"], t["hist"],
                  t["uh"], t["basew"], t["e"], t["inc"], t["hasm"], t["ua"],
                  t["uz"], baseh=t["baseh"], cycle=7)
    assert tk.launches == 0
    np.testing.assert_array_equal(t["ci"].numpy(), np.asarray(jci))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(joh.numpy(), np.asarray(jjoh))
    for name, mine, ref in (("cf", t["cf"], jcf), ("wgt", t["wgt"], jw),
                            ("hist", t["hist"], jh), ("uh", t["uh"], ju)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-10, err_msg=name)
    return tk, t, joh, cnt


@pytest.mark.parametrize("samplerun,T,K", [(False, 1, 8), (True, 1, 8),
                                           (False, 2, 8), (False, 8, 2),
                                           (False, 1, 32)],
                         ids=["wl_live", "samplerun", "two_trials",
                              "eight_trials", "thirty_two_movers"])
def test_chain_plain_matches_pallas(samplerun, T, K):
    # (eight trials on two movers: the interpret-mode JAX kernel's
    # compile time grows with the trials times the points per mover;
    # 32 movers at one trial: the N=24192 flagship's sub-step)
    W = 6
    x, tk, t, joh, cnt = chain_case(samplerun, T, K)
    # the pass did something of every kind, and the gates held
    c = cnt.numpy()
    assert c[ck.CN_EN].sum() > c[ck.CN_ACC].sum() > 0
    assert c[ck.CN_SWEN].sum() > 0
    if T == 1:
        assert joh.numpy().reshape(K, 2, W)[0, 1, 0] == 0.0   # the overlap
    else:
        # some movers ended at a point beyond the first trial's
        assert joh.numpy().reshape(K, T + 1, W)[:, 2:].sum() > 0
    grew = (t["hist"].numpy() != x["hist"]).any(axis=0)
    assert grew[:-1].all() and not grew[-1]      # the overflowed walker
    if samplerun:
        np.testing.assert_array_equal(t["wgt"].numpy(), x["wgt"])
    else:
        np.testing.assert_array_equal(t["uh"].numpy(), x["uh"])
    # WL not live: the slabs stay as they are
    t2 = {k: tt(v) for k, v in x.items()}
    tk(t2["codes"], False, t2["cf"], t2["ci"], t2["wgt"], t2["hist"],
       t2["uh"], t2["basew"], t2["e"], t2["inc"], t2["hasm"], t2["ua"],
       t2["uz"])
    for name in ("wgt", "hist", "uh"):
        np.testing.assert_array_equal(t2[name].numpy(), x[name])


def test_chain_nonfinite_point_matches_pallas():
    """Two trials per mover; point 2 of mover 1 of walker 0 holds an
    infinite energy (poison_point).  The current point's energy is read
    as the sum over the point table of the accepted-point one-hot times
    the energy, as the JAX kernel reads it, so 0 * inf poisons every
    trial of that mover (a direct read of the current point would
    accept its first trial: translation, both points in the cell, accept
    uniform 0).  The run is the two_trials case's, held against
    ``ChainWLPallas`` there."""
    K, T = 8, 2
    P = T + 1
    x, tk, t, joh, cnt = chain_case(False, T, K)
    assert np.isinf(x["e"].reshape(2, K, P, -1)[0, 1, 2, 0])
    oh = joh.numpy().reshape(K, P, -1)
    assert oh[1, :, 0].tolist() == [1.0, 0.0, 0.0]    # never moved
    assert cnt.numpy()[ck.CN_FIXED + 1, 0] == T       # both trials enabled
    # the other walkers' mover 1 and walker 0's other movers do move
    assert oh[1, 1:, 1:].sum() + oh[[0, 2, 3, 4, 5, 6, 7], 1:, 0].sum() > 0
    assert np.isfinite(t["cf"].numpy()[ck.CF_MU]).all()


def rule_inputs(K, T, W, setting):
    """Chain inputs that exercise the rule ``setting``: MINU's hoisted
    term, a master histogram and a count of updates for Swetnam (whose
    small wl_alpha keeps its f below the cap), 1/t on half the walkers
    (at cycle 7 its cap lies below f)."""
    x = chain_inputs(K, T, W, 201, seed=23 + T)
    rng = np.random.default_rng(5)
    x["cf"][ck.CF_MINUC] = rng.normal(0, 1.0, W)
    x["cf"][ck.CF_SUMHIST] = 150.0
    x["baseh"] = rng.uniform(0, 20, (201, W))
    x["ci"][ck.CI_INVT] = np.arange(W) % 2
    return x


@pytest.mark.parametrize("setting", [
    dict(minu=True), dict(wl_swetnam=True, wl_alpha=1e-4),
    dict(wl_useinvt=True), dict(num_lattices=1),
], ids=["minu", "swetnam", "useinvt", "single"])
def test_chain_kernel_rules_match_pallas(setting):
    """The MINU fold-in and the Swetnam and 1/t schedules of the chain
    kernel's plain version against ``ChainWLPallas`` (one trial per
    mover: the interpret-mode kernel compiles fastest); one lattice is outside both kernels (the two-replica rule:
    the engines run the XLA chain there)."""
    from mc_water_ls_mw_tpu.mcmc.bins import build_bin_grid as jgrid
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    K, T, W = 8, 1, 6
    if setting.get("num_lattices") == 1:
        kw = cell_run_params(**setting)
        for make, grid in (
                (ck.ChainWLKernel, build_bin_grid(201, -1200., 1200.)),
                (ChainWLPallas, jgrid(201, -1200., 1200.,
                                      dtype=jnp.float64))):
            prm = (TRunParams if make is ck.ChainWLKernel
                   else RunParams)(**kw)
            with pytest.raises(AssertionError, match="two-replica"):
                make(prm, grid, K, T, 0.0)
        return
    x = rule_inputs(K, T, W, setting)
    tk, t, joh, cnt = run_chains(x, K, T, W, **setting)
    cf = t["cf"].numpy()
    if "minu" in setting:
        # some accepted move carried its walker to the other lattice
        assert cnt.numpy()[ck.CN_ACC].sum() > 0
        assert (t["ci"].numpy()[ck.CI_LS] != x["ci"][ck.CI_LS]).any()
    elif "wl_swetnam" in setting:
        assert (cf[ck.CF_F] != 0.05).any()
        assert (cf[ck.CF_SUMHIST] > 150.0).any()
    else:
        # the cap B / (7 N) on the walkers that run 1/t, only
        np.testing.assert_array_equal(cf[ck.CF_F] < 0.05,
                                      x["ci"][ck.CI_INVT] == 1)


def test_mover_kernels_refuse_cpu_misuse(movers):
    """The wrappers check what a kernel would be given; a padded
    coverage table is refused at construction."""
    import dataclasses
    tcg = movers["sys"]["tcg"]
    padded = dataclasses.replace(
        tcg, full_mask=np.concatenate([tcg.full_mask[:-1], [False]]))
    for cls in (MoverEnergiesKernel, MoverApplyKernel):
        with pytest.raises(ValueError, match="unpadded"):
            cls(TMW, padded)
