"""One full-depth cycle of the PyTorch port's large-N cell engine.

The comparison with the JAX CellEngine (test_torch_cellengine.py) cuts a
cycle to one sweep.  Here the port alone runs a whole N=8064 cycle on
the CPU in float64, W = 2: a rebin at a random origin, then 16 sweeps =
1024 sub-steps over the same packed slabs and chain rows, scheduled
volume moves and a delta-sync, under the engine's own Philox stream.
What only depth shows is held against recomputation from scratch: the
compensated energy after some 10^3 accepted moves per walker, the
incrementally updated moments, the per-slot trial counts, and the static
tables' premise that no molecule leaves its stored fine cell.
"""

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.models.stacking import (
    correspondence_mismatch,
    stacking_switch_pair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.ops import cells
from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64
from mc_water_ls_mw_tpu_torch.ops.geometry import to_frac

from .test_torch_cells import cell_run_params


@pytest.fixture(scope="module")
def cycle():
    prm = RunParams(**cell_run_params(
        list_update_int=1, mpi_sync_int=1, mc_vol_prob=2.0 / 8064, seed=11))
    r0, H0 = stacking_switch_pair(14, 8, 18)
    mx, _ = correspondence_mismatch(r0, H0)
    shape = cells.choose_grid_shape(H0, MW, mx)
    cg = cells.build_grid(shape, cells.cap_for_positions(r0, H0, shape), H0,
                          MW, mx)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg, device="cpu")
    eng = CellEngine(prm, MW, grid, aux, cg, caux, device="cpu")
    start = s.clone()
    # an accepted volume move refreshes energies and moments from
    # scratch: keep the state as the sub-step loop left it
    after_loop = []
    volume_moves = eng._scheduled_volume_moves

    def keep_then_move(st, *args):
        after_loop.append(st.clone())
        return volume_moves(st, *args)

    eng._scheduled_volume_moves = keep_then_move
    s, samples = eng.run_cycles(s, 1)
    return dict(eng=eng, start=start, s=s, samples=samples,
                after_loop=after_loop[0])


def test_full_depth_cycle_ran_every_part(cycle):
    eng, s, start = cycle["eng"], cycle["s"], cycle["start"]
    assert (eng.sweeps_per_cycle, eng.n_tables, eng.K) == (16, 64, 8)
    att, acc = s.att.numpy(), s.acc.numpy()
    # 8192 scheduled trials per walker, nearly all of them translations
    assert att[0].min() > 7000 and att[0].max() <= 8192
    assert acc[0].min() > 1000 and (acc[0] < att[0]).all()
    assert att[1].min() >= 1 and att[2].min() > 7000
    # the rebin moved the origin and reassigned the slots
    assert float(s.origin.abs().max()) > 0
    assert not torch.equal(s.mol2slot, start.mol2slot)
    assert int(s.occ_overflow.max()) == 0
    # WL was live and the delta-sync merged the walkers' growth
    assert ds_value64(s.master_hist).sum() > 0
    assert float(s.weight.abs().max()) == 0.0
    assert torch.isfinite(cycle["samples"]["E_ls"]).all()


def test_full_depth_trial_counts(cycle):
    """Every enabled translation was counted once at its mover."""
    s = cycle["s"]
    assert torch.equal(s.trans_per_mol.sum(dim=0, dtype=torch.int32),
                       s.att[0])
    # one trial per molecule per cycle on average, none starved
    assert int(s.trans_per_mol.max()) < 12
    assert float((s.trans_per_mol > 0).double().mean()) > 0.5


def test_full_depth_energy_and_moments_drift(cycle):
    """Tracked (energy + energy_err) and the incrementally updated
    moments against a recomputation from scratch."""
    eng = cycle["eng"]
    for name in ("after_loop", "s"):
        tracked = cycle[name]
        s = tracked.clone()
        before = s.moments.clone()
        s, drift = eng.audit_energy(s)
        assert float(drift.abs().max()) < 1e-9, name           # Hartree
        torch.testing.assert_close(s.moments, before, rtol=0, atol=1e-9)
        mu = eng._mu_scratch(s.energy, s.volume)
        # kT: beta is ~1.6e3 per Hartree at 200 K
        np.testing.assert_allclose(tracked.mu.numpy(), mu.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    s = cycle["after_loop"]
    assert float(s.energy_err.abs().min()) > 0     # two-sum residuals
    assert int(s.acc[0].min()) > 1000              # over >10^3 accepts


def test_full_depth_molecules_stay_in_stored_fine_cells(cycle):
    eng, s = cycle["eng"], cycle["s"]
    r1 = cells.gather_from_slab(s.r[0], s.mol2slot)            # [3,N,W]
    f1 = to_frac(s.recip[0][:, :, None, :], r1)
    fmid = f1 - 0.5 * eng.cellaux.dfrac0[:, :, None]
    cid = cells.cell_of_frac(eng.cellgrid, fmid, s.origin, level="fine")
    assert torch.equal(cid, s.mol2slot // eng.cellgrid.cap)
    # and slot2mol is the inverse of mol2slot
    N, W = s.mol2slot.shape
    back = torch.gather(s.slot2mol, 0, s.mol2slot.long())
    assert torch.equal(back, torch.arange(N, dtype=torch.int32)[:, None]
                       .expand(N, W))
