"""Rank functions of the port's multi-rank CPU tests.

The tests spawn gloo groups with ``parallel.comm.run_ranks``; each rank
imports this module (torch and the port only: no JAX in the ranks),
runs the port on its shard and returns plain numpy results.  The random
draws come from the test process as a ``ReplayStream``: the JAX
package's threefry draws, computed there once for the whole ensemble.
"""

from __future__ import annotations

import numpy as np
import torch

from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    cell_state_from_numpy,
    cell_state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import VOL, Engine
from mc_water_ls_mw_tpu_torch.mcmc.state import (
    state_from_numpy,
    state_to_numpy,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.parallel.mesh import (
    gather_state,
    shard_state,
    walker_block,
)
from mc_water_ls_mw_tpu_torch.parallel.spatial import (
    SpatialCellEngine,
    make_spatial_mesh,
)


def _np(x):
    return None if x is None else np.asarray(x).copy()


class ReplayStream:
    """An engine stream that returns recorded draws of the whole
    ensemble, keyed by the call (cycle draws, volume move k of a cycle,
    rebin origin)."""

    def __init__(self, draws: dict):
        self.draws = draws

    def _get(self, *key):
        return [None if x is None else torch.as_tensor(x.copy())
                for x in self.draws[key]]

    def cycle_draws(self, cycle, probs, N, W, dtype, trials=1,
                    shared_mol=True):
        return tuple(self._get("cycle", cycle))

    def volume_draws(self, cycle, k, W, dtype):
        return tuple(self._get("vol", cycle, k))

    def rebin_origin(self, cycle, dtype):
        return self._get("origin", cycle)[0]

    def cell_cycle_draws(self, cycle, probs, n_trials, n_sub, K, n_u, W,
                         dtype):
        return tuple(self._get("cell", cycle))


def record_draws(stream, eng, n_cycles: int) -> dict:
    """The draws engine ``eng`` (a serial port engine of the run's
    settings) takes from ``stream`` over cycles 1..n_cycles: the cycle
    draws, the rebin origins at the list_update_int cadence and the
    volume moves of the cycle's schedule."""
    prm = eng.prm
    W = prm.n_walkers
    dtype = eng.dtype
    out = {}
    cell = isinstance(eng, CellEngine)
    for c in range(1, n_cycles + 1):
        if cell:
            if c % prm.list_update_int == 0:
                out[("origin", c)] = [_np(stream.rebin_origin(c, dtype))]
            codes, u = stream.cell_cycle_draws(
                c, eng.probs, eng.trials_per_cycle,
                eng.sweeps_per_cycle * eng.n_tables, eng.K, eng.n_u, W,
                dtype)
            out[("cell", c)] = [_np(codes), _np(u)]
        else:
            codes, sched, u = stream.cycle_draws(
                c, eng.probs, prm.nwater, W, dtype, trials=eng.dT,
                shared_mol=not eng.dense)
            out[("cycle", c)] = [_np(codes), _np(sched), _np(u)]
        if prm.mc_ensemble == "npt" and prm.allow_vol:
            for k in range(int((np.asarray(codes) == VOL).sum())):
                out[("vol", c, k)] = [
                    _np(x) for x in stream.volume_draws(c, k, W, dtype)]
    return out


def _grid(kw):
    return build_bin_grid(kw["nbins"], kw["mu_min"], kw["mu_max"])


def _cut(eng, n_tables):
    """A cycle cut to ``n_tables`` sub-steps (one sweep)."""
    if n_tables:
        eng.sweeps_per_cycle = 1
        eng.n_tables = n_tables
        eng.trials_per_cycle = n_tables * eng.K * eng.T


def walker_rank(comm, case):
    """The walker-sharded run of ``case`` (dense or cell engine) from the
    whole initial state: the gathered state after each cycle, and this
    rank's shard after the last."""
    kw = case["kw"]
    prm = RunParams(**kw)
    stream = ReplayStream(case["draws"])
    if case.get("cellgrid") is None:
        s, aux = state_from_numpy(case["fields"], case["aux"], device="cpu")
        eng = Engine(prm, MW, _grid(kw), aux, device="cpu", stream=stream,
                     comm=comm)
        to_np = state_to_numpy
    else:
        s, aux, caux = cell_state_from_numpy(
            case["fields"], case["aux"], case["caux"], device="cpu")
        eng = CellEngine(prm, MW, _grid(kw), aux, case["cellgrid"], caux,
                         device="cpu", stream=stream, comm=comm)
        _cut(eng, case.get("n_tables"))
        to_np = cell_state_to_numpy
    s = shard_state(s, comm, prm.n_walkers)
    hist, samples = [], []
    for _ in range(case["n_cycles"]):
        s, smp = eng.run_cycles(s, 1)
        hist.append(to_np(gather_state(s, comm)))
        samples.append({k: v.numpy() for k, v in smp.items()})
    return dict(hist=hist, samples=samples, shard=to_np(s))


def spatial_rank(comm, case):
    """``case['n_sub']`` sub-steps from table row ``case['tbl']`` of the
    spatially sharded engine (``case['walkers']`` walker ranks, the rest
    along space) on the whole state: the gathered state and trial
    counts."""
    kw = case["kw"]
    mesh = make_spatial_mesh(comm, case["walkers"])
    s, aux, caux = cell_state_from_numpy(case["fields"], case["aux"],
                                         case["caux"], device="cpu")
    eng = SpatialCellEngine(RunParams(**kw), MW, _grid(kw), aux,
                            case["cellgrid"], caux, mesh=mesh, device="cpu")
    s = shard_state(s, mesh.walkers, kw["n_walkers"])
    s.cycle = case["cycle"]
    lo, hi = walker_block(mesh.walkers, kw["n_walkers"])
    u = torch.as_tensor(case["u"][..., lo:hi].copy())
    s, tpm = eng._sharded_scan(s, torch.as_tensor(case["codes"]), u,
                               case["n_sub"], t0=case["tbl"])
    s = gather_state(s, mesh.walkers)
    return dict(state=cell_state_to_numpy(s),
                tpm=mesh.walkers.cat(tpm).numpy(),
                ranks=(mesh.space.size, mesh.walkers.size),
                plan=(eng.plan.ndev, eng.plan.K_loc),
                modes=(eng.use_cell_pallas, eng.use_cell_apply,
                       eng.use_chain_kernel))


def spatial_cases(comm, cases):
    """``spatial_rank`` of each case of a dict, in one group."""
    return {name: spatial_rank(comm, case) for name, case in cases.items()}


def walker_cases(comm, cases):
    """``walker_rank`` of each case of a dict, in one group."""
    return {name: walker_rank(comm, case) for name, case in cases.items()}


def collectives(comm):
    """Every collective of a Comm on small rank-dependent tensors."""
    x = torch.arange(3, dtype=torch.float64) + 10 * comm.rank
    up, dn = comm.ring_shift(x, -x)
    flag = torch.tensor([comm.rank == 1])
    return dict(
        cat=comm.cat(x[None], dim=0).numpy(),
        sum=comm.sum(x).numpy(),
        max=comm.max(x).numpy(), min=comm.min(x).numpy(),
        bcast=comm.broadcast(x, src=1).numpy(),
        up=up.numpy(), dn=dn.numpy(),
        flag=bool(comm.max(flag)),
        gather_bool=comm.cat(flag).tolist())


def fail_on_rank_1(comm):
    """Rank 1 raises while rank 0 waits in a collective."""
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails")
    comm.barrier()


def frontend_jobs(comm, jobs):
    """``run_input_file`` runs of the front end on these ranks, in
    order: (workdir, overrides, max_cycles) each; a job whose overrides
    the front end refuses returns the error's message."""
    import os

    from mc_water_ls_mw_tpu_torch.app import run_input_file

    out = []
    cwd = os.getcwd()
    for workdir, over, max_cycles in jobs:
        try:
            s = run_input_file(os.path.join(workdir, "ice.input"),
                               overrides=over, max_cycles=max_cycles,
                               device="cpu")
            out.append(int(s.cycle))
        except ValueError as err:
            out.append(str(err))
        finally:
            os.chdir(cwd)
    return out
