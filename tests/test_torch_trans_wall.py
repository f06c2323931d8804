"""The cell engine's displacement wall (``cell_trans_wall``) of the
PyTorch port against the JAX ``CellEngine``.

The cases of ``tests/test_trans_wall.py`` on the N=8064 stacking pair
(float64, two walkers, steps of 0.6 Bohr against a wall of 0.35 Bohr,
so that the wall binds within a few sub-steps): six sub-steps of
translations at successive (colour, block) tables, at one trial per
mover and at T=2, in both packages from the same state with the same
uniforms.  The port runs its kernels' plain versions ('auto': the apply
stage and the chain kernel) and its unfused sub-step with the XLA chains
('off'); the JAX engine runs its XLA sub-step, with the chain kernel in
interpret mode where the port's chain is the per-move one at T=1.
Integer outcomes must agree exactly, continuous state within 1e-9; no
molecule may end farther than the wall from its lattice-1 reference
site (minimum image), while the same drive without the wall carries one
past it.  A volume move whose rescale would carry a molecule past the
wall is refused: the volume hook against the JAX engine's, and one
volume move of the port.
"""

import functools

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

from .test_torch_cellengine import assert_states_match
from .test_torch_cells import jax_cell_system, to_port, tt

WALL = 0.35             # Bohr
N_SUB = 6


@functools.lru_cache(maxsize=None)
def wall_system():
    return jax_cell_system(mc_max_trans=0.6)


def max_disp(fref0, s):
    """Per-walker largest minimum-image displacement (Bohr) of an
    occupied slot from its molecule's lattice-1 reference site."""
    f = cell_state_to_numpy(s)
    mol = np.maximum(f["slot2mol"], 0)                       # [ns,W]
    fd = np.einsum("abw,amw->bmw", f["recip"][0], f["r"][0]) / (2 * np.pi)
    fd = fd - np.asarray(fref0)[:, mol]
    fd -= np.round(fd)
    dsp = np.einsum("abw,bmw->amw", f["h"][0], fd)
    d = np.sqrt((dsp ** 2).sum(axis=0))
    return np.where(f["slot2mol"] >= 0, d, 0.0).max(axis=0)  # [W]


def drive(T, port_modes, jax_modes=None, wall=WALL):
    """N_SUB all-translation sub-steps (tables 0..5, the uniforms of
    cycles 2..7) in the port and, given ``jax_modes``, in the JAX
    engine; each sub-step from cycle 1, WL live."""
    sys_ = wall_system()
    kw = {**sys_["kw"], "cell_trials": T, "cell_trans_wall": wall}
    ts, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    teng = CellEngine(
        TRunParams(**{**kw, "cell_pallas": port_modes[0],
                      "cell_chain": port_modes[1]}),
        TMW, sys_["tgrid"], taux, sys_["tcg"], tcaux, device="cpu")
    js = jeng = jstep = None
    if jax_modes is not None:
        jeng = JCellEngine(
            RunParams(**{**kw, "cell_pallas": jax_modes[0],
                         "cell_chain": jax_modes[1]}, fused="off"),
            MW, sys_["jgrid"], sys_["jaux"], sys_["jcg"], sys_["jcaux"])
        jstep = jax.jit(jeng._substep_canonical)
        js = sys_["jst"]
    W, K = 2, teng.K
    n_u = 7 if T == 1 else 4 + 5 * T
    codes = np.zeros(K * T, np.int32)                        # all TRANS
    ttpm = torch.zeros((sys_["tcg"].nslot, W), dtype=torch.int32)
    jtpm = jnp.zeros((sys_["jcg"].nslot, W), dtype=jnp.int32)
    keys = sys_["jst"].key
    for i in range(N_SUB):
        u = jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, 2 + i), (K, n_u), dtype=jnp.float64),
            out_axes=2)(keys)
        ts.cycle = 1
        ts, ttpm = teng._substep_canonical(ts, ttpm, i, tt(u),
                                           torch.as_tensor(codes))
        if jeng is not None:
            js, jtpm = jstep(
                js._replace(cycle=jnp.asarray(1, jnp.int32)), jtpm,
                jeng.fc_stack[i], jeng.cand_stack[i], jeng.off_stack[i], u,
                jnp.asarray(codes), jnp.ones(W, dtype=bool))
    return teng, ts, ttpm, js, jtpm


@pytest.mark.parametrize("T,port_modes,jax_modes", [
    (1, ("auto", "auto"), ("off", "on")),
    (1, ("off", "off"), ("off", "off")),
    (2, ("auto", "auto"), ("off", "off")),
    (2, ("off", "off"), ("off", "off")),
], ids=["t1-kernels", "t1-unfused", "t2-kernels", "t2-unfused"])
def test_wall_matches_jax_and_confines(T, port_modes, jax_modes):
    teng, ts, ttpm, js, jtpm = drive(T, port_modes, jax_modes)
    if port_modes[0] == "auto":
        assert teng.use_cell_apply and teng.use_chain_kernel
    else:
        assert not (teng.use_cell_pallas or teng.use_chain_kernel)
    js = js._replace(cycle=jnp.asarray(1, jnp.int32))
    assert_states_match(ts, js)
    np.testing.assert_array_equal(ttpm.numpy(), np.asarray(jtpm))
    d = max_disp(teng.cellaux.fref0.numpy(), ts)
    assert (d <= WALL + 1e-9).all(), d
    tf = cell_state_to_numpy(ts)
    # the wall does not freeze the chain
    assert (tf["acc"][0] > 0).all()
    assert (tf["att"][0] == N_SUB * teng.K * T).all()


def test_without_the_wall_the_drive_crosses_it():
    teng, ts, _, _, _ = drive(2, ("auto", "auto"), wall=0.0)
    assert max_disp(teng.cellaux.fref0.numpy(), ts).max() > WALL


def test_volume_move_past_the_wall_is_refused():
    """On the walled state after the drive: with the wall set just above
    the state's largest displacement, expanding the box of the walker
    that holds it would carry that molecule past the wall, shrinking
    the other's would not.  The volume hook says so in both packages;
    the port's volume move then refuses the expansion and accepts the
    shrink (an accept uniform of 0)."""
    teng, ts, _, js, _ = drive(2, ("auto", "auto"), ("off", "off"))
    d = max_disp(teng.cellaux.fref0.numpy(), ts)
    grow = int(np.argmax(d))
    wall = float(d.max()) * (1 + 1e-5)
    sys_ = wall_system()
    kw = {**sys_["kw"], "cell_trials": 2, "cell_trans_wall": wall}
    jeng = JCellEngine(RunParams(**{**kw, "cell_pallas": "off",
                                    "cell_chain": "off"}, fused="off"),
                       MW, sys_["jgrid"], sys_["jaux"], sys_["jcg"],
                       sys_["jcaux"])
    _, taux, tcaux = to_port(sys_["jst"], sys_["jaux"], sys_["jcaux"])
    weng = CellEngine(TRunParams(**kw), TMW, sys_["tgrid"], taux,
                      sys_["tcg"], tcaux, device="cpu")
    # walker ``grow``: h00 + dv_max (the largest proposal of the volume
    # move); the other: h00 - dv_max
    dv = float(ts.dv_max[0])
    dh = np.zeros((2, 3, 3, 2))
    dh[:, 0, 0, grow], dh[:, 0, 0, 1 - grow] = dv, -dv
    h_new = cell_state_to_numpy(ts)["h"] + dh
    ok_t = weng._vol_extra_ok(torch.as_tensor(h_new), ts).numpy()
    ok_j = np.asarray(jeng._vol_extra_ok(jnp.asarray(h_new), js))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t[grow] and ok_t[1 - grow]
    # the same boxes as a volume move of the port: u picks element
    # (0, 0) and the strain's sign per walker, and accepts whatever the
    # walls let through
    u = torch.zeros((2, 4), dtype=torch.float64)
    u[grow, 2] = 1.0
    vol0 = ts.volume.clone()
    acc0 = ts.acc[1].clone()
    weng._volume(ts, u)
    assert torch.equal(ts.volume[:, grow], vol0[:, grow])
    assert not torch.equal(ts.volume[:, 1 - grow], vol0[:, 1 - grow])
    assert (ts.acc[1] - acc0).tolist() == [int(w != grow) for w in range(2)]
