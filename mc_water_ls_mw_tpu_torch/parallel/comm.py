"""Ranks of a run and the collectives between them.

What GSPMD, ``psum`` and ``ppermute`` do implicitly in the JAX package
(``parallel/mesh.py``, ``parallel/spatial.py``) is explicit here: a rank
is one process of a ``torch.distributed`` group, and a ``Comm`` is one
axis of ranks (the whole world, or a subgroup of it).  A ``Comm`` of one
rank is the serial case and makes no ``torch.distributed`` call.

* Under ``torchrun`` each rank uses ``cuda:LOCAL_RANK`` with the NCCL
  backend (``init_from_env``).  With ``device='cpu'`` the ranks use
  gloo, as the tests do; ``run_ranks`` spawns such a group (on the CPU,
  or several ranks on one card over gloo: NCCL refuses two ranks on one
  card).
* Every reduction over ranks is deterministic: the per-rank pieces are
  gathered and combined in rank order, never in the backend's reduction
  order, so a result does not depend on the backend.  Min and max are
  exact in any order.
* Under gloo, tensors on the card go through host copies (``stage``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

# a rank that raises must not leave the others waiting in a collective
# for ever: every group of run_ranks / init_from_env times out
DEFAULT_TIMEOUT_S = 600


class Comm:
    """One axis of ranks.  ``group``: a torch.distributed group (None:
    the default world group); ``size`` 1 makes every method an identity
    without touching torch.distributed."""

    def __init__(self, group=None, size: int | None = None):
        self.group = group
        if size == 1 or not (dist.is_available() and dist.is_initialized()):
            self.size, self.rank = 1, 0
            self.stage = False
            return
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.stage = dist.get_backend(group) == "gloo"

    @property
    def sharded(self) -> bool:
        return self.size > 1

    # ------------------------------------------------------------------

    def _to_wire(self, x):
        """(tensor to send, restore function): bool as uint8 (gloo has no
        bool collectives); a card tensor through the host under gloo."""
        dev, dt = x.device, x.dtype
        y = x.to(torch.uint8) if dt == torch.bool else x
        if self.stage and dev.type != "cpu":
            y = y.cpu()
        y = y.contiguous()

        def back(z):
            z = z.to(dev)
            return z.to(torch.bool) if dt == torch.bool else z
        return y, back

    def gather(self, x) -> list:
        """Every rank's ``x`` (same shape on each rank), in rank order."""
        if self.size == 1:
            return [x]
        y, back = self._to_wire(x)
        out = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(out, y, group=self.group)
        return [back(z) for z in out]

    def cat(self, x, dim: int = -1):
        """The ranks' ``x`` concatenated along ``dim`` in rank order (the
        walker all-gather: [..., W_local] -> [..., W])."""
        if self.size == 1:
            return x
        return torch.cat(self.gather(x), dim=dim)

    def sum(self, x):
        """Sum over ranks, added in rank order (bitwise the same on
        every backend and every run)."""
        if self.size == 1:
            return x
        parts = self.gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def _reduce(self, x, op):
        if self.size == 1:
            return x
        y, back = self._to_wire(x)
        y = y.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return back(y)

    def max(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def min(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def broadcast(self, x, src: int = 0):
        """Rank ``src``'s ``x`` on every rank (``src`` in this axis)."""
        if self.size == 1:
            return x
        y, back = self._to_wire(x)
        y = y.clone()
        gsrc = (src if self.group is None
                else dist.get_global_rank(self.group, src))
        dist.broadcast(y, src=gsrc, group=self.group)
        return back(y)

    def ring_shift(self, to_up, to_down):
        """The +-1 ring shift of ``parallel/spatial.py``'s halo rows (the
        JAX package's two ``ppermute`` calls): rank d sends ``to_up`` to
        rank d+1 and ``to_down`` to rank d-1 (periodic) and returns
        (from_down, from_up), what ranks d-1 and d+1 sent.  Built on one
        all-gather, a collective both gloo and NCCL take; it moves each
        rank's two blocks to every rank."""
        if self.size == 1:
            return to_up, to_down
        parts = self.gather(torch.stack([to_up, to_down]))
        d, n = self.rank, self.size
        return parts[(d - 1) % n][0], parts[(d + 1) % n][1]

    def barrier(self):
        if self.size > 1:
            dist.barrier(group=self.group)


SINGLE = Comm(size=1)


def new_subgroups(rows):
    """A torch.distributed subgroup per list of world ranks in ``rows``;
    every rank creates every group (as torch.distributed requires) and
    gets back the Comm of the group it belongs to."""
    me = dist.get_rank() if dist.is_initialized() else 0
    mine = SINGLE
    for ranks in rows:
        ranks = [int(r) for r in ranks]
        g = dist.new_group(ranks=ranks, timeout=datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S)) if len(ranks) > 1 else None
        if me in ranks:
            mine = Comm(g) if len(ranks) > 1 else SINGLE
    return mine


# ----------------------------------------------------------------------
# starting the ranks
# ----------------------------------------------------------------------

def init_from_env(device="cuda") -> tuple[Comm, torch.device]:
    """The world of this process: the group already initialised (ranks
    of ``run_ranks``), the world of a ``torchrun`` launch (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment), or
    one rank.  Under torchrun each rank takes ``cuda:LOCAL_RANK`` and
    NCCL on the card, gloo on the CPU.  Returns (comm, device)."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return Comm(), device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return SINGLE, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return Comm(), device


def _rank_main(rank, fn, world, outdir, timeout_s, args):
    # the ranks meet through a file of the call's own directory: no port
    # to pick, so concurrent groups on one host cannot collide
    dist.init_process_group(
        backend="gloo", init_method=f"file://{outdir}/store",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        torch.set_num_threads(1)
        result = fn(Comm(), *args)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout_s: int = DEFAULT_TIMEOUT_S):
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks of a gloo group
    on this host; returns the ranks' return values (picklable) in rank
    order.  ``fn`` must be importable by its module and name.  A rank
    that raises makes this raise (the others are terminated), and every
    collective times out after ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks") as outdir:
        mp.start_processes(
            _rank_main,
            args=(fn, world, outdir, timeout_s, args),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
