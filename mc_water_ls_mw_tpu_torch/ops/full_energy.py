"""Whole-cell SW energy + moments of one lattice: the CUDA kernel and
its plain version.

Counterpart of ``mc_water_ls_mw_tpu/ops/pallas_energy.py``
(``FullEnergyPallas``), which serves the volume move and the chain
resync.  Contract: (r3 [3, N, W], H [3, 3, W]) -> (E [W], Moments of
[N, W]) over the minimum-image-folded shift set.

The kernel is ``csrc/full_energy.cu`` (its header says what bounds it on
the H100 and how the design answers that); ``full_energy_plan`` is its
split of the walkers and centres over blocks.  The plain version is
``ops/dense.full_energy_batch(..., mic=True)``, chunked over walkers.
The wrapper takes the plain version only for tensors that lie on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build, tracing
from ..cuda_build import SMEM_BLOCK_MAX
from ..models.sw import SWParams
from .dense import Moments, full_energy_batch

# a tile's staged rows stay below this where the walkers allow, so that
# two blocks share an SM
SMEM_TILE_TARGET = SMEM_BLOCK_MAX // 2
FE_WARPS = 16
# blocks a launch aims for: two waves of two blocks on the H100's 132
# SMs (fewer where the centres run out)
FE_BLOCKS = 528


class FullEnergyPlan(NamedTuple):
    """A launch of the kernel: ``tw`` walkers per tile (the threads of
    one centre slot), ``warps`` per block, ``slots`` = 32 warps / tw
    centres in flight per block, ``cpg`` centres per group (a multiple
    of the slots), ``groups`` blocks per tile, ``grid`` (tiles, groups)
    and ``smem`` dynamic shared bytes (the tile's 3 N rows and its S
    image vectors)."""

    tw: int
    warps: int
    slots: int
    cpg: int
    groups: int
    grid: tuple
    smem: int


def full_energy_plan(itemsize: int, N: int, W: int,
                     S: int = 1) -> FullEnergyPlan:
    """The kernel's split: a tile is one 128-byte line of a coordinate
    row (32 walkers in f32, 16 in f64), halved while its staged rows
    exceed SMEM_TILE_TARGET; block (x, y) takes the walkers tw x + tid %
    tw and the centres y cpg + tid // tw + slots q below min(N, (y + 1)
    cpg).  The centres are cut into enough groups for FE_BLOCKS blocks,
    each a whole number of the block's slots.  Raises where one walker's
    rows do not fit a block."""
    tw = 128 // itemsize
    while tw > 1 and 3 * (N + S) * tw * itemsize > SMEM_TILE_TARGET:
        tw //= 2
    smem = 3 * (N + S) * tw * itemsize
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"full_energy: N={N} does not fit one block's "
                         "shared memory")
    slots = 32 * FE_WARPS // tw
    tiles = -(-W // tw)
    groups = max(1, min(-(-FE_BLOCKS // tiles), -(-N // slots)))
    cpg = -(-(-(-N // groups)) // slots) * slots
    groups = -(-N // cpg)
    return FullEnergyPlan(tw, FE_WARPS, slots, cpg, groups, (tiles, groups),
                          smem)


class FullEnergyArgs(ctypes.Structure):
    """Mirror of ``struct FullEnergyArgs`` in csrc/full_energy.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "r", "h", "shifts", "mom", "E", "contrib", "ticket")]
        + [(n, ctypes.c_int) for n in (
            "S", "N", "W", "tw", "warps", "groups", "cpg")]
        + [("sw", cuda_build.SWConsts)]
    )


def _entry(dtype):
    sym = "full_energy_f32" if dtype == torch.float32 else "full_energy_f64"
    return cuda_build.bind("full_energy", sym,
                           [ctypes.POINTER(FullEnergyArgs), ctypes.c_void_p])


class FullEnergyKernel:
    """(r3 [3,N,W], H [3,3,W]) -> (E [W], Moments of [N,W])."""

    def __init__(self, model: SWParams, fold_shifts):
        self.model = model
        self.shifts = np.asarray(fold_shifts, np.int32).reshape(-1, 3)
        self.consts = cuda_build.SWConsts.of(model)
        self._shifts_dev = {}
        # per (dtype, N, W, device): the plan, the scratch row of the
        # centres' terms and the tiles' tickets (zero between launches)
        self._shapes = {}
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0
        tracing.register(self, "full_energy")

    def plan(self, dtype, N, W) -> FullEnergyPlan:
        return full_energy_plan(torch.empty((), dtype=dtype).element_size(),
                                N, W, len(self.shifts))

    def _shape(self, dtype, N, W, dev):
        key = (dtype, N, W, dev)
        if key not in self._shapes:
            plan = self.plan(dtype, N, W)
            self._shapes[key] = (
                plan, torch.empty((N, W), dtype=dtype, device=dev),
                torch.zeros((plan.grid[0],), dtype=torch.int32, device=dev))
        return self._shapes[key]

    def occupancy(self, dtype, N, W):
        """The kernel at N molecules and W walkers, from the CUDA runtime:
        a dict of registers and spill (local) bytes per thread, blocks
        resident on one SM, dynamic shared bytes per block and blocks."""
        fn = cuda_build.bind("full_energy", "full_energy_occupancy",
                             [ctypes.c_int, ctypes.POINTER(FullEnergyArgs),
                              ctypes.POINTER(ctypes.c_int)])
        plan = self.plan(dtype, N, W)
        args = FullEnergyArgs(S=len(self.shifts), N=N, W=W, tw=plan.tw,
                              warps=plan.warps, groups=plan.groups,
                              cpg=plan.cpg)
        out = (ctypes.c_int * 5)()
        err = fn(int(dtype == torch.float64), ctypes.byref(args), out)
        cuda_build.check(err, "full_energy occupancy")
        return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                         "smem_bytes", "blocks"), out))

    def plain(self, r3, H):
        return full_energy_batch(r3, H, self.shifts, self.model, True)

    def launch_args(self, r3, H):
        """(args, (E, mom)) of one launch on CUDA tensors: the checked
        FullEnergyArgs and the output tensors it points to."""
        _, N, W = r3.shape
        if (r3.dtype not in (torch.float32, torch.float64)
                or H.dtype != r3.dtype or H.shape != (3, 3, W)
                or H.device != r3.device):
            raise ValueError(
                f"FullEnergyKernel: r3 {tuple(r3.shape)} {r3.dtype}, "
                f"H {tuple(H.shape)} {H.dtype} on {H.device}"
            )
        dev = r3.device
        if dev not in self._shifts_dev:
            self._shifts_dev[dev] = torch.as_tensor(
                self.shifts.reshape(-1), device=dev)
        plan, contrib, ticket = self._shape(r3.dtype, N, W, dev)
        mom = torch.empty((10, N, W), dtype=r3.dtype, device=dev)
        E = torch.empty((W,), dtype=r3.dtype, device=dev)
        args = FullEnergyArgs(
            r=r3.data_ptr(), h=H.data_ptr(),
            shifts=self._shifts_dev[dev].data_ptr(), mom=mom.data_ptr(),
            E=E.data_ptr(), contrib=contrib.data_ptr(),
            ticket=ticket.data_ptr(), S=len(self.shifts), N=N, W=W,
            tw=plan.tw, warps=plan.warps, groups=plan.groups, cpg=plan.cpg,
            sw=self.consts)
        return args, (E, mom)

    def __call__(self, r3, H):
        if not r3.is_cuda:
            return self.plain(r3, H)
        r3, H = r3.contiguous(), H.contiguous()
        args, (E, mom) = self.launch_args(r3, H)
        stream = torch.cuda.current_stream(r3.device).cuda_stream
        cuda_build.check(_entry(r3.dtype)(ctypes.byref(args), stream),
                         "full_energy")
        self.launches += 1
        return E, Moments(*mom)
