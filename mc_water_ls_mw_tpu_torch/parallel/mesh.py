"""Sharding of the walker ensemble over ranks.

Counterpart of ``mc_water_ls_mw_tpu/parallel/mesh.py``: the reference
scales out with MPI ranks (comms_mpi.f90); the JAX package shards the
trailing walker axis of its state over a 1-D device mesh and lets GSPMD
lower every cross-walker reduction to a collective.  Here a rank is one
process (``parallel/comm.py``): rank r of D holds the contiguous walker
block [r W/D, (r+1) W/D), as ``NamedSharding(P('walkers'))`` places it,
and the engines make their reductions over walkers explicit collectives
(``Engine._gw``).  A world of one rank is the serial case.

* ``shard_state`` slices every per-walker field (trailing axis W; the
  port has no walker-first leaf: its random streams are not state) and
  keeps the window-major masters, the grid origin, the cycle and the
  drop counter replicated.  It decides by field, not by shape, so a
  field whose last extent equals W by chance is never mistaken for a
  walker axis.
* In 'dd' the window of walker w is ``w % nwin`` over the GLOBAL index,
  so each rank holds an equal slice of every window (the state is built
  whole on every rank and then sliced).
* ``WalkerSlice`` wraps an engine's random stream: each rank draws the
  whole [.., W] block, in the same order as the serial run, and keeps
  its slice, so a rank's walkers see the uniforms they see unsharded.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.dsfloat import DS
from .comm import Comm

# state fields with no walker axis
REPLICATED_FIELDS = frozenset({
    "master_eta", "master_hist", "master_uhist", "origin", "cycle",
    "dropped",
})


def walker_block(comm: Comm, n_walkers: int) -> tuple[int, int]:
    """[lo, hi) of the global walkers rank ``comm.rank`` holds."""
    if n_walkers % comm.size:
        raise ValueError(
            f"n_walkers={n_walkers} does not divide over {comm.size} ranks")
    per = n_walkers // comm.size
    return comm.rank * per, (comm.rank + 1) * per


def shard_state(state, comm: Comm, n_walkers: int):
    """This rank's shard of a whole state (a new state; the whole one is
    not modified)."""
    if comm.size == 1:
        return state
    lo, hi = walker_block(comm, n_walkers)
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name not in REPLICATED_FIELDS and isinstance(v, torch.Tensor):
            v = v[..., lo:hi].contiguous()
        out[f.name] = v
    return type(state)(**out)


def gather_state(state, comm: Comm):
    """The whole state from the ranks' shards, on every rank (a new
    state; collective: every rank calls it)."""
    if comm.size == 1:
        return state
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name not in REPLICATED_FIELDS and isinstance(v, torch.Tensor):
            v = comm.cat(v, dim=-1)
        elif isinstance(v, DS):
            v = DS(v.hi.clone(), v.lo.clone())
        elif isinstance(v, torch.Tensor):
            v = v.clone()
        out[f.name] = v
    return type(state)(**out)


class WalkerSlice:
    """An engine's random stream seen by one rank: every draw is made
    for the whole ensemble of ``n_walkers`` in the serial order, and the
    rank keeps its block of the walker axis.  The shared draws (move
    codes, molecule schedule, grid origin) and the generator state are
    the inner stream's, the same on every rank."""

    def __init__(self, inner, comm: Comm, n_walkers: int):
        self.inner = inner
        self.W = int(n_walkers)
        self.lo, self.hi = walker_block(comm, self.W)

    def __getattr__(self, name):
        # seed, device, get_state, set_state, reseed, rebin_origin, ...
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def cycle_draws(self, cycle, probs, N, W, dtype, trials=1,
                    shared_mol=True):
        codes, sched, cycle_u = self.inner.cycle_draws(
            cycle, probs, N, self.W, dtype, trials=trials,
            shared_mol=shared_mol)
        return codes, sched, cycle_u[..., self.lo:self.hi].contiguous()

    def volume_draws(self, cycle, k, W, dtype):
        u, zeta2 = self.inner.volume_draws(cycle, k, self.W, dtype)
        return (u[self.lo:self.hi].contiguous(),
                zeta2[self.lo:self.hi].contiguous())

    def cell_cycle_draws(self, cycle, probs, n_trials, n_sub, K, n_u, W,
                         dtype):
        codes, u_all = self.inner.cell_cycle_draws(
            cycle, probs, n_trials, n_sub, K, n_u, self.W, dtype)
        return codes, u_all[..., self.lo:self.hi].contiguous()

