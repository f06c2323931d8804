"""One full-depth cycle of the PyTorch port's cell engine on the scatter
path (``cell_pallas='on'``).

The comparison with the JAX CellEngine (test_torch_cellengine_scatter.py)
cuts a cycle to one sweep.  Here the port alone runs a whole cycle of the
N=6048 (12,7,18) stacking pair on the CPU in float64, W = 2: 75-cell
stencils that overlap between same-colour movers, so the per-candidate
deltas of every sub-step are scatter-added with repeated cell indices.
A rebin at a random origin, then 12 sweeps = 768 sub-steps over the same
packed slabs and chain rows, the scheduled volume moves and a
delta-sync, under the engine's own Philox stream.  The compensated
energies and the scattered moments after the sub-step loop are held
against a recomputation from scratch, as test_torch_cellengine_depth.py
holds the apply stage's.
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
from mc_water_ls_mw_tpu_torch.ops.geometry import to_frac

from .test_torch_cells import cell_run_params

DIMS = (12, 7, 18)


@pytest.fixture(scope="module")
def cycle():
    prm = RunParams(**cell_run_params(
        DIMS, list_update_int=1, mpi_sync_int=1, seed=13,
        cell_pallas="auto", cell_chain="auto"))
    r0, H0 = stacking_switch_pair(*DIMS)
    mx, _ = correspondence_mismatch(r0, H0)
    shape = cells.choose_grid_shape(H0, MW, mx)
    cg = cells.build_grid(shape, cells.cap_for_positions(r0, H0, shape), H0,
                          MW, mx)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg, device="cpu")
    eng = CellEngine(prm, MW, grid, aux, cg, caux, device="cpu")
    start = s.clone()
    # keep the state as the sub-step loop left it (an accepted volume
    # move refreshes energies and moments from scratch)
    after_loop = []
    volume_moves = eng._scheduled_volume_moves

    def keep_then_move(st, *args):
        after_loop.append(st.clone())
        return volume_moves(st, *args)

    eng._scheduled_volume_moves = keep_then_move
    s, samples = eng.run_cycles(s, 1)
    return dict(eng=eng, start=start, s=s, samples=samples,
                after_loop=after_loop[0])


def test_scatter_full_depth_cycle_ran_every_part(cycle):
    eng, s, start = cycle["eng"], cycle["s"], cycle["start"]
    assert (eng.sweeps_per_cycle, eng.n_tables, eng.K) == (12, 64, 8)
    assert eng.use_cell_pallas and not eng.use_cell_apply
    assert eng.mover_kernel.with_deltas and not eng.scatter_unique
    att, acc = s.att.numpy(), s.acc.numpy()
    # 6144 scheduled trials per walker, nearly all of them translations
    assert att[0].min() > 5000 and att[0].max() <= 6144
    assert acc[0].min() > 500 and (acc[0] < att[0]).all()
    assert att[2].min() > 5000
    assert float(s.origin.abs().max()) > 0
    assert not torch.equal(s.mol2slot, start.mol2slot)
    assert int(s.occ_overflow.max()) == 0
    assert torch.equal(s.trans_per_mol.sum(dim=0, dtype=torch.int32),
                       s.att[0])
    assert torch.isfinite(cycle["samples"]["E_ls"]).all()


def test_scatter_full_depth_energy_and_moments_drift(cycle):
    """Tracked (energy + energy_err) and the scattered moments after
    768 sub-steps against a recomputation from scratch."""
    eng = cycle["eng"]
    tracked = cycle["after_loop"]
    s = tracked.clone()
    before = s.moments.clone()
    s, drift = eng.audit_energy(s)
    assert float(drift.abs().max()) < 1e-9                       # Hartree
    torch.testing.assert_close(s.moments, before, rtol=0, atol=1e-9)
    mu = eng._mu_scratch(s.energy, s.volume)
    np.testing.assert_allclose(tracked.mu.numpy(), mu.numpy(), rtol=0,
                               atol=1e-6)
    assert float(tracked.energy_err.abs().max()) > 0      # two-sum residuals
    assert int(tracked.acc[0].min()) > 500


def test_scatter_full_depth_molecules_stay_in_stored_fine_cells(cycle):
    eng, s = cycle["eng"], cycle["s"]
    r1 = cells.gather_from_slab(s.r[0], s.mol2slot)            # [3,N,W]
    f1 = to_frac(s.recip[0][:, :, None, :], r1)
    fmid = f1 - 0.5 * eng.cellaux.dfrac0[:, :, None]
    cid = cells.cell_of_frac(eng.cellgrid, fmid, s.origin, level="fine")
    assert torch.equal(cid, s.mol2slot // eng.cellgrid.cap)
