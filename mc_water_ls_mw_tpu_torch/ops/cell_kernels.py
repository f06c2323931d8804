"""The three stencil kernels of the cell engine's sub-step: the CUDA
kernels and their plain versions.

Counterpart of ``mc_water_ls_mw_tpu/ops/cell_pallas.py``
(``MoverEnergiesPallas`` with and without its per-candidate delta
output, ``MoverPointsPallas`` and ``MoverApplyPallas``).  One call serves
every lattice (the JAX package calls its kernels once per lattice):

* ``MoverEnergiesKernel(pks, h, cand, off, fc, rank, p_old, p_new)`` ->
  (e [L,K,2,W], own_new [L,K,10,W]): each mover's local energy at its
  old (point 0) and at its proposed position (point 1), in the layout of
  the chain kernel's point table, and its new own moments; built with
  ``with_deltas=True`` it returns a third tensor, dlt [L,K,CF,10,cap,W],
  every candidate slot's moment deltas new - old (zero for masked slots
  and slots out of range of both positions): per lattice, viewed as
  [K*CF, 10, cap, W], the moment rows 0:10 of the packed slab's blocks
  at ``cand``, which the engine's scatter path adds to the slab;
* ``MoverPointsKernel(pks, h, cand, off, fc, rank, pts)`` with ``pts``
  [P,L,3,K,W] (point 0 the stored position) -> (e [L,K,P,W], own
  [L,K,P,10,W]): the multi-trial sub-step's local energies at all P
  points in one stencil pass, again in the chain kernel's layout, and
  the own moments at every point;
* ``MoverApplyKernel(pks, h, cand, off, fc, rank, accf, p_old, p_new,
  own_new)`` updates the packed slabs IN PLACE for the accepted movers:
  neighbours' moment rows += their per-candidate deltas new - old, the
  mover's own slot := its new moments, its coordinate rows := p_new.

``pks`` is the list of L packed slabs [nfine, PK_ROWS, cap, W]
(ops/cells.py PK_* layout), ``h`` [L,3,3,W], ``cand`` [K,CF] / ``off``
[K,CF,3] / ``fc`` [K] int32 rows of the engine's static tables, ``rank``
[K,W] int32 the movers' slot ranks, ``p_old``/``p_new`` [L,3,K,W],
``accf`` [K,W] accepted flags (bool, or the working float type: > 0.5;
rows may be strided).

The kernels are ``csrc/cell_movers.cu`` (its header says what bounds
them on the H100 and how the design answers that).  The plain versions
are ``cell_energy.mover_energies``, ``cell_energy.mover_point_energies``
and the scatter of the per-candidate deltas.  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  All require an unpadded coverage table, and the apply
kernel disjoint same-colour stencils (the engine checks both).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build, tracing
from ..cuda_build import SMEM_BLOCK_MAX
from ..models.sw import SWParams
from .cell_energy import mover_energies, mover_point_energies
from .cells import PK_R0, PK_ROWS, PK_VALID, CellGrid
from .dense import Moments


class MoverArgs(ctypes.Structure):
    """Mirror of ``struct MoverArgs`` in csrc/cell_movers.cu."""

    _fields_ = (
        [("pk", ctypes.c_void_p * 2)]
        + [(n, ctypes.c_void_p) for n in (
            "h", "cand", "off", "fc", "rank", "p_old", "p_new", "e", "own",
            "accf", "dlt")]
        + [("acc_stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("L", "K", "CF", "cap", "W")]
        + [("sw", cuda_build.SWConsts)]
        + [(n, ctypes.c_int) for n in ("apply_warps", "en_warps")]
    )


# The apply kernel's split of a candidate cell's slots: a warp takes
# APPLY_SLOTS_PER_WARP of them at a time (APPLY_SPW in
# csrc/cell_movers.cu), a block at most APPLY_WARPS_MAX warps.
APPLY_SLOTS_PER_WARP = 4
APPLY_WARPS_MAX = 8


def apply_geometry(L, K, CF, cap, W):
    """(grid, block) of the apply kernel: a block per (32-walker tile,
    mover x candidate cell, lattice), grid (ceil(W/32), K*CF, L), of
    (32, nw) threads, nw warps enough for the cell's ``cap`` slots at
    APPLY_SLOTS_PER_WARP each (at most APPLY_WARPS_MAX).  Block (x, y, z)
    takes the walkers 32 x + lane of mover y // CF at candidate cell
    y % CF in lattice z; its warp wy the slots wy + nw (q +
    APPLY_SLOTS_PER_WARP i), q < APPLY_SLOTS_PER_WARP, below cap."""
    nw = max(1, min(APPLY_WARPS_MAX, -(-cap // APPLY_SLOTS_PER_WARP)))
    return (-(-W // 32), K * CF, L), (32, nw)


# The energies kernel's block: a warp takes ENERGIES_SLOTS_PER_WARP
# slots of a cell a pass (EN_SPW in csrc/cell_movers.cu), a block at
# most ENERGIES_WARPS_MAX warps.
ENERGIES_SLOTS_PER_WARP = 4
ENERGIES_WARPS_MAX = 8


def energies_geometry(L, K, CF, cap, W):
    """(grid, block) of the energies kernel: a block per (32-walker
    tile, mover, lattice), grid (ceil(W/32), K, L), of (32, nw) threads,
    nw warps enough for a cell's cap slots at ENERGIES_SLOTS_PER_WARP
    each (at most ENERGIES_WARPS_MAX).  Block (x, y, z) takes the
    walkers 32 x + lane of mover y in lattice z; its warp wy, cell after
    cell, the slots p nw S + wy + nw q (q < S = ENERGIES_SLOTS_PER_WARP)
    below cap of pass p < ceil(cap / (nw S)).  The warps' sums are added
    in warp order."""
    nw = max(1, min(ENERGIES_WARPS_MAX,
                    -(-cap // ENERGIES_SLOTS_PER_WARP)))
    return (-(-W // 32), K, L), (32, nw)


class PointsArgs(ctypes.Structure):
    """Mirror of ``struct PointsArgs`` in csrc/cell_movers.cu."""

    _fields_ = (
        [("pk", ctypes.c_void_p * 2)]
        + [(n, ctypes.c_void_p) for n in (
            "h", "cand", "off", "fc", "rank", "pts", "e", "own")]
        + [(n, ctypes.c_int) for n in ("L", "K", "CF", "cap", "W", "P",
                                       "nw")]
        + [("sw", cuda_build.SWConsts)]
        + [(n, ctypes.c_void_p) for n in ("part", "ticket")]
        + [(n, ctypes.c_int) for n in ("cpg", "ng")]
    )


# The points kernel's block: a warp per point, at least POINTS_WARPS_MIN
# (they stage the slots) and at most POINTS_WARPS_MAX (PT_WARPS_MAX in
# csrc/cell_movers.cu), POINTS_CELLS_PER_GROUP candidate cells, fewer
# where their staged slots would keep two blocks off one SM
POINTS_WARPS_MIN = 8
POINTS_WARPS_MAX = 9
POINTS_CELLS_PER_GROUP = 3
POINTS_SMEM_TARGET = SMEM_BLOCK_MAX // 2    # two blocks an SM


class PointsPlan(NamedTuple):
    """A launch of the points kernel: ``grid`` (ceil(W/32), K ng, L) of
    (32, nw) threads, ``cpg`` candidate cells per group, ``ng`` groups
    per mover, ``smem`` dynamic shared bytes (``points_smem_bytes``)."""

    grid: tuple
    nw: int
    cpg: int
    ng: int
    smem: int


def points_smem_bytes(cpg, cap, nw, itemsize) -> int:
    """Shared memory of a points block: the group's staged slots (flag
    and coordinates, [cpg cap][4][32]), its cells' image shifts
    ([cpg][3][32]), and per thread its points' farthest distance from
    point 0, the count and the int16 indices of its near slots ([nw][32]
    each and [nw][ceil(cpg cap / nw)][32])."""
    qmax = -(-cpg * cap // nw)
    return (itemsize * 32 * (4 * cpg * cap + 3 * cpg + nw) + 4 * 32 * nw
            + 2 * 32 * nw * qmax)


def points_geometry(L, K, CF, cap, W, P, itemsize) -> PointsPlan:
    """The points kernel's split: block (x, y, z) takes the walkers 32 x
    + lane of mover y // ng in lattice z, and the candidate cells g cpg
    ... min(CF, (g + 1) cpg) - 1 of group g = y % ng; its thread (wy,
    lane) stages the slots s = wy + nw q (cell s // cap, slot s % cap)
    of the group and lists those near point 0; its warp wy owns the
    points wy + nw q, walking every thread's list of its lane in order
    (thread 0's first).  nw = P warps, at least POINTS_WARPS_MIN and at
    most POINTS_WARPS_MAX (the points spread evenly above); the last
    block of a (tile, mover, lattice) adds the ng groups' sums in index
    order."""
    nw = max(POINTS_WARPS_MIN, -(-P // -(-P // POINTS_WARPS_MAX)))
    cpg = min(POINTS_CELLS_PER_GROUP, CF)
    while (cpg > 1 and points_smem_bytes(cpg, cap, nw, itemsize)
           > POINTS_SMEM_TARGET):
        cpg -= 1
    smem = points_smem_bytes(cpg, cap, nw, itemsize)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"mover_points: a cell of {cap} slots does not fit "
                         "one block's shared memory")
    ng = -(-CF // cpg)
    return PointsPlan((-(-W // 32), K * ng, L), nw, cpg, ng, smem)


@functools.lru_cache(maxsize=None)
def _entry(which, dtype):
    """The C entry point ``mover_<which>_<f32|f64>`` of csrc/cell_movers.cu
    (``which``: energies, energies_deltas, points, apply)."""
    sym = f"mover_{which}_" + ("f32" if dtype == torch.float32 else "f64")
    struct = PointsArgs if which == "points" else MoverArgs
    return cuda_build.bind("cell_movers", sym,
                           [ctypes.POINTER(struct), ctypes.c_void_p])


class _MoverKernel:
    """What both kernels share: the grid's shapes, the argument checks
    and the argument structure."""

    name = ""

    def __init__(self, model: SWParams, cg: CellGrid):
        if not bool(np.all(cg.full_mask)):
            raise ValueError(
                f"{type(self).__name__} requires an unpadded coverage "
                "table (cells.build_grid full_mask all True)")
        self.model = model
        self.nfine = cg.nfine
        self.cap = cg.cap
        self.CF = cg.full_cells.shape[1]
        self.full_mask = np.asarray(cg.full_mask)
        self.consts = cuda_build.SWConsts.of(model)
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0
        tracing.register(self, self.name)

    def _check(self, pks, h, cand, off, fc, rank, points, points_shape):
        """Raise unless the inputs are what the kernels take; ``points``
        are the evaluation-point tensors, each of ``points_shape``."""
        L, W = len(pks), pks[0].shape[-1]
        K, CF = cand.shape
        dtype, dev = pks[0].dtype, pks[0].device
        floats = list(pks) + [h] + list(points)
        ints = [cand, off, fc, rank]
        shapes_ok = (
            L in (1, 2) and CF == self.CF
            and all(pk.shape == (pks[0].shape[0], PK_ROWS, self.cap, W)
                    for pk in pks)
            and h.shape == (L, 3, 3, W) and off.shape == (K, CF, 3)
            and fc.shape == (K,) and rank.shape == (K, W)
            and all(p.shape == points_shape for p in points))
        if not (shapes_ok and dtype in (torch.float32, torch.float64)
                and all(t.dtype == dtype for t in floats)
                and all(t.dtype == torch.int32 for t in ints)
                and all(t.device == dev and t.is_contiguous()
                        for t in floats + ints)):
            raise ValueError(
                f"{self.name}: needs {L} contiguous packed slabs "
                f"[nfine,{PK_ROWS},{self.cap},W] of one float type, "
                "h [L,3,3,W], int32 cand [K,CF] / off [K,CF,3] / fc [K] / "
                f"rank [K,W] and points {points_shape} on one device")

    def _args(self, pks, h, cand, off, fc, rank, p_old, p_new):
        """Checked MoverArgs of the shared inputs."""
        L, W = len(pks), pks[0].shape[-1]
        K, CF = cand.shape
        self._check(pks, h, cand, off, fc, rank, (p_old, p_new),
                    (L, 3, K, W))
        a = MoverArgs(
            h=h.data_ptr(), cand=cand.data_ptr(), off=off.data_ptr(),
            fc=fc.data_ptr(), rank=rank.data_ptr(), p_old=p_old.data_ptr(),
            p_new=p_new.data_ptr(), L=L, K=K, CF=CF, cap=self.cap, W=W,
            sw=self.consts)
        for l, pk in enumerate(pks):
            a.pk[l] = pk.data_ptr()
        return a

    def _launch(self, which, args, dtype, dev):
        """Launch kernel ``which`` on the current stream and count it."""
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(which, dtype)(ctypes.byref(args), stream)
        cuda_build.check(err, self.name)
        self.launches += 1

    def _candidates(self, pk, H, cand, off, fc, rank, p_old, p_new):
        """cell_energy.mover_energies of one lattice on the packed slab's
        rows: (e_old, e_new, cand_old, cand_new)."""
        mover_slot = fc.long()[:, None] * self.cap + rank.long()
        return mover_energies(
            [pk[:, PK_R0 + a] for a in range(3)],
            Moments(*(pk[:, i] for i in range(10))),
            pk[:, PK_VALID] > 0.5, H, cand.long(), off, self.full_mask,
            self.cap, mover_slot, p_old, p_new, self.model)

    def _deltas(self, co, cn):
        """Per-candidate moment deltas new - old [K, CF, 10, cap, W] of
        one lattice from the candidate objects of ``_candidates``."""
        K, _, W = co.w.shape
        return torch.stack([
            (fn - fo).reshape(K, self.CF, self.cap, W)
            for fo, fn in zip(co.delta(), cn.delta())
        ], dim=2)


class MoverEnergiesKernel(_MoverKernel):
    """Local energies at the old and the new position and new own
    moments of K movers; with ``with_deltas`` also every candidate
    slot's moment deltas (the JAX kernel's constructor flag)."""

    def __init__(self, model: SWParams, cg: CellGrid,
                 with_deltas: bool = False):
        self.with_deltas = bool(with_deltas)
        self.name = ("mover_energies_deltas" if self.with_deltas
                     else "mover_energies")
        super().__init__(model, cg)
        # warps per block of the energies kernel (energies_geometry)
        self.en_warps = energies_geometry(1, 1, self.CF, self.cap, 1)[1][1]

    def occupancy(self, dtype, L, K, W):
        """The energies kernel (without deltas) at L lattices, K movers
        and W walkers, from the CUDA runtime: a dict of registers and
        spill (local) bytes per thread, blocks resident on one SM,
        dynamic shared bytes per block and blocks."""
        fn = cuda_build.bind("cell_movers", "mover_energies_occupancy",
                             [ctypes.c_int, ctypes.POINTER(MoverArgs),
                              ctypes.POINTER(ctypes.c_int)])
        args = MoverArgs(L=L, K=K, CF=self.CF, cap=self.cap, W=W,
                         en_warps=self.en_warps)
        out = (ctypes.c_int * 5)()
        err = fn(int(dtype == torch.float64), ctypes.byref(args), out)
        cuda_build.check(err, "mover_energies occupancy")
        return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                         "smem_bytes", "blocks"), out))

    def plain(self, pks, h, cand, off, fc, rank, p_old, p_new):
        e, own, dlt = [], [], []
        for l, pk in enumerate(pks):
            eo, en, co, cn = self._candidates(pk, h[l], cand, off, fc, rank,
                                              p_old[l], p_new[l])
            e.append(torch.stack([eo, en], dim=1))           # [K,2,W]
            own.append(torch.stack(list(cn.own), dim=1))     # [K,10,W]
            if self.with_deltas:
                dlt.append(self._deltas(co, cn))             # [K,CF,10,cap,W]
        if self.with_deltas:
            return torch.stack(e), torch.stack(own), torch.stack(dlt)
        return torch.stack(e), torch.stack(own)

    def __call__(self, pks, h, cand, off, fc, rank, p_old, p_new):
        if not pks[0].is_cuda:
            return self.plain(pks, h, cand, off, fc, rank, p_old, p_new)
        args = self._args(pks, h, cand, off, fc, rank, p_old, p_new)
        L, K, W = args.L, args.K, args.W
        dtype, dev = pks[0].dtype, pks[0].device
        e = torch.empty((L, K, 2, W), dtype=dtype, device=dev)
        own = torch.empty((L, K, 10, W), dtype=dtype, device=dev)
        args.e, args.own = e.data_ptr(), own.data_ptr()
        if not self.with_deltas:
            args.en_warps = self.en_warps
            self._launch("energies", args, dtype, dev)
            return e, own
        # every slot is written by the kernel: no zero fill
        dlt = torch.empty((L, K, self.CF, 10, self.cap, W), dtype=dtype,
                          device=dev)
        args.dlt = dlt.data_ptr()
        self._launch("energies_deltas", args, dtype, dev)
        return e, own, dlt


class MoverPointsKernel(_MoverKernel):
    """Local energies and own moments of K movers at P = T + 1 points
    each (the multi-trial sub-step)."""

    name = "mover_points"

    def __init__(self, model: SWParams, cg: CellGrid, n_points: int):
        super().__init__(model, cg)
        if n_points < 2:
            raise ValueError("MoverPointsKernel needs n_points >= 2")
        self.P = int(n_points)
        # per (dtype, L, K, W, device): the plan, the groups' sums
        # [L,K,ng,P,13,W] and the tickets [L,K,tiles] (zero between
        # launches)
        self._shapes = {}

    def plan(self, dtype, L, K, W) -> PointsPlan:
        return points_geometry(L, K, self.CF, self.cap, W, self.P,
                               torch.empty((), dtype=dtype).element_size())

    def _shape(self, dtype, L, K, W, dev):
        key = (dtype, L, K, W, dev)
        if key not in self._shapes:
            plan = self.plan(dtype, L, K, W)
            self._shapes[key] = (
                plan,
                torch.empty((L, K, plan.ng, self.P, 13, W), dtype=dtype,
                            device=dev),
                torch.zeros((L, K, plan.grid[0]), dtype=torch.int32,
                            device=dev))
        return self._shapes[key]

    def occupancy(self, dtype, L, K, W):
        """The points kernel at L lattices, K movers and W walkers, from
        the CUDA runtime: a dict of registers and spill (local) bytes per
        thread, blocks resident on one SM, dynamic shared bytes per block
        and blocks."""
        fn = cuda_build.bind("cell_movers", "mover_points_occupancy",
                             [ctypes.c_int, ctypes.POINTER(PointsArgs),
                              ctypes.POINTER(ctypes.c_int)])
        plan = self.plan(dtype, L, K, W)
        args = PointsArgs(L=L, K=K, CF=self.CF, cap=self.cap, W=W, P=self.P,
                          nw=plan.nw, cpg=plan.cpg, ng=plan.ng)
        out = (ctypes.c_int * 5)()
        err = fn(int(dtype == torch.float64), ctypes.byref(args), out)
        cuda_build.check(err, "mover_points occupancy")
        return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                         "smem_bytes", "blocks"), out))

    def plain(self, pks, h, cand, off, fc, rank, pts):
        mover_slot = fc.long()[:, None] * self.cap + rank.long()
        e, own = [], []
        for l, pk in enumerate(pks):
            el, owns, _ = mover_point_energies(
                [pk[:, PK_R0 + a] for a in range(3)],
                Moments(*(pk[:, i] for i in range(10))),
                pk[:, PK_VALID] > 0.5, h[l], cand.long(), off,
                self.full_mask, self.cap, mover_slot, pts[:, l], self.model)
            e.append(el.transpose(0, 1))                     # [K,P,W]
            own.append(torch.stack(
                [torch.stack(list(m), dim=1) for m in owns], dim=1))
        return torch.stack(e), torch.stack(own)    # [L,K,P,W], [L,K,P,10,W]

    def launch_args(self, pks, h, cand, off, fc, rank, pts):
        """(args, (e, own)) of one launch on CUDA tensors: the checked
        PointsArgs and the output tensors it points to."""
        L, W = len(pks), pks[0].shape[-1]
        K, P = cand.shape[0], self.P
        self._check(pks, h, cand, off, fc, rank, (pts,), (P, L, 3, K, W))
        dtype, dev = pks[0].dtype, pks[0].device
        plan, part, ticket = self._shape(dtype, L, K, W, dev)
        e = torch.empty((L, K, P, W), dtype=dtype, device=dev)
        own = torch.empty((L, K, P, 10, W), dtype=dtype, device=dev)
        a = PointsArgs(
            h=h.data_ptr(), cand=cand.data_ptr(), off=off.data_ptr(),
            fc=fc.data_ptr(), rank=rank.data_ptr(), pts=pts.data_ptr(),
            e=e.data_ptr(), own=own.data_ptr(), L=L, K=K, CF=self.CF,
            cap=self.cap, W=W, P=P, nw=plan.nw, sw=self.consts,
            part=part.data_ptr(), ticket=ticket.data_ptr(), cpg=plan.cpg,
            ng=plan.ng)
        for l, pk in enumerate(pks):
            a.pk[l] = pk.data_ptr()
        return a, (e, own)

    def __call__(self, pks, h, cand, off, fc, rank, pts):
        if not pks[0].is_cuda:
            return self.plain(pks, h, cand, off, fc, rank, pts)
        args, out = self.launch_args(pks, h, cand, off, fc, rank, pts)
        self._launch("points", args, pks[0].dtype, pks[0].device)
        return out


class MoverApplyKernel(_MoverKernel):
    """Apply the accepted movers to the packed slabs, in place."""

    name = "mover_apply"

    def plain(self, pks, h, cand, off, fc, rank, accf, p_old, p_new,
              own_new):
        """The scatter path: per-candidate deltas new - old added to the
        stencil cells' moment rows (same-colour stencils are disjoint,
        so the scatter's indices are unique), then the movers' own slots
        set.  The deltas do not depend on the movers' own coordinate
        rows (each mover is masked out of its own stencil and absent
        from every other), so the order of the two steps is free."""
        K, CF = cand.shape
        cap, W = self.cap, pks[0].shape[-1]
        acc = (accf if accf.dtype == torch.bool else accf > 0.5)  # [K,W]
        cells = cand.long().reshape(-1)                           # [K*CF]
        fcl = fc.long()
        own_slot = (torch.arange(cap, device=rank.device)[None, :, None]
                    == rank.long()[:, None, :]) & acc[:, None, :]
        for l, pk in enumerate(pks):
            _, _, co, cn = self._candidates(pk, h[l], cand, off, fc, rank,
                                            p_old[l], p_new[l])
            dlt = torch.where(acc[:, None, None, None, :],
                              self._deltas(co, cn), 0.0)  # [K,CF,10,cap,W]
            pk[cells, 0:10] += dlt.reshape(K * CF, 10, cap, W)
            blk = pk[fcl]                              # [K,14,cap,W]
            blk[:, 0:10] = torch.where(
                own_slot[:, None], own_new[l][:, :, None, :], blk[:, 0:10])
            blk[:, PK_R0:PK_R0 + 3] = torch.where(
                own_slot[:, None], p_new[l].transpose(0, 1)[:, :, None, :],
                blk[:, PK_R0:PK_R0 + 3])
            pk[fcl] = blk
        return pks

    def __call__(self, pks, h, cand, off, fc, rank, accf, p_old, p_new,
                 own_new):
        if not pks[0].is_cuda:
            return self.plain(pks, h, cand, off, fc, rank, accf, p_old,
                              p_new, own_new)
        args, keep = self.launch_args(pks, h, cand, off, fc, rank, accf,
                                      p_old, p_new, own_new)
        self._launch("apply", args, pks[0].dtype, pks[0].device)
        del keep
        return pks

    def launch_args(self, pks, h, cand, off, fc, rank, accf, p_old, p_new,
                    own_new):
        """(args, keep) of one launch on CUDA tensors: the checked
        MoverArgs and the tensor its accept-flag pointer references
        (keep it alive until the launch is enqueued)."""
        args = self._args(pks, h, cand, off, fc, rank, p_old, p_new)
        L, K, W = args.L, args.K, args.W
        dtype, dev = pks[0].dtype, pks[0].device
        if accf.dtype == torch.bool:
            accf = accf.to(dtype)
        if not (accf.shape == (K, W) and accf.dtype == dtype
                and accf.device == dev and accf.stride(1) == 1
                and own_new.shape == (L, K, 10, W)
                and own_new.dtype == dtype and own_new.device == dev
                and own_new.is_contiguous()):
            raise ValueError(
                "mover_apply: needs accf [K,W] (bool or the slabs' float "
                "type, rows of unit stride) and contiguous own_new "
                "[L,K,10,W] on the slabs' device")
        args.accf, args.acc_stride = accf.data_ptr(), accf.stride(0)
        args.own = own_new.data_ptr()
        args.apply_warps = apply_geometry(L, K, self.CF, self.cap, W)[1][1]
        return args, accf
