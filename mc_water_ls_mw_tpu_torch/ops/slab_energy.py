"""Whole-cell SW energy and fresh moments of the cell engine's slab
layout, both lattices at once: the CUDA kernel and its plain version.

Contract: (r [L, 3, nslot, W], valid [nslot, W] bool, H [L, 3, 3, W])
-> (E [L, W], moments [10, L, nslot, W]) over the grid's static coverage
tables (ops/cells.py ``full_cells``, ``full_off``, ``full_mask``): per
occupied slot half the pair sum over its coverage candidates, each
image-shifted by H @ off, plus the closed-form centre-angle energy of its
ten leg moments; empty slots have zero moments and no energy.  It serves
the cell engine's volume moves, chain resyncs and audits
(``CellEngine._full_both``) and ``init_cell_state``.

The kernel is ``csrc/slab_energy.cu`` (it replaces no TPU kernel: the JAX
package's function is plain jnp that XLA fuses; its header says what
bounds it on the H100 and how the design answers that);
``slab_energy_plan`` is its split over blocks.  The plain version is
``ops/cell_energy.slab_full_energy``, one lattice a call.  The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  The coverage tables go to the device
once, when the wrapper is built.
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
from .cell_energy import slab_full_energy
from .cells import CellGrid

# centre slots a warp holds in registers (13 sums each), by item size
# (SPW in csrc/slab_energy.cu)
SLAB_SPW = {4: 4, 8: 2}
SLAB_WARPS_MAX = 16
# shared memory the coordinate ring aims for; between 2 and 4 stages
SLAB_RING_BYTES = 48 * 1024


class SlabEnergyPlan(NamedTuple):
    """A launch of the kernel: ``grid`` (tiles of 32 walkers, fine
    cells, lattices) of ``warps`` warps, ``spw`` centre slots per warp
    and pass, ``depth`` stages of the coordinate ring, ``smem`` dynamic
    shared bytes (``slab_energy_smem``)."""

    grid: tuple
    warps: int
    spw: int
    depth: int
    smem: int


def slab_energy_smem(CF, cap, warps, depth, itemsize) -> int:
    """Dynamic shared bytes of a block: the warps' sums [warps][32] in
    float64, the ring [depth][3][cap][32] and the centres' terms
    [cap][32] in the float type, the votes [CF + 1][cap], the coverage ids
    [CF], offsets [CF][3] and the centre list [cap] in 32 bits
    (csrc/slab_energy.cu ``smem_layout``)."""
    return (8 * 32 * warps + itemsize * 32 * (3 * depth * cap + cap)
            + 4 * ((CF + 1) * cap + 4 * CF + cap))


def slab_energy_plan(L, nfine, CF, cap, W, itemsize) -> SlabEnergyPlan:
    """The kernel's split: block (x, y, z) takes the walkers 32 x + lane
    (those below W), the centre cell y and lattice z.  The cell's slots
    that some walker of the tile occupies are listed in slot order and
    dealt ``spw`` to a warp per pass (entry i to warp (i mod warps x spw)
    / spw, register slot i mod spw, pass i / (warps x spw)); the others get
    zero moments from warp b % warps.  ``warps`` = ceil(cap / spw), at
    most SLAB_WARPS_MAX (larger cells take more passes); ``depth``: as
    many 3-row cap-slot stages as SLAB_RING_BYTES holds, 2 to 4.  Raises
    where a block does not fit the shared memory."""
    spw = SLAB_SPW[itemsize]
    warps = max(1, min(SLAB_WARPS_MAX, -(-cap // spw)))
    stage = 3 * cap * 32 * itemsize
    depth = max(2, min(4, SLAB_RING_BYTES // stage))
    smem = slab_energy_smem(CF, cap, warps, depth, itemsize)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"slab_energy: cells of {cap} slots with {CF} "
                         "coverage cells do not fit one block's shared "
                         "memory")
    return SlabEnergyPlan((-(-W // 32), nfine, L), warps, spw, depth, smem)


class SlabEnergyArgs(ctypes.Structure):
    """Mirror of ``struct SlabEnergyArgs`` in csrc/slab_energy.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "r", "valid", "h", "cells", "off", "mom", "E", "part",
            "ticket")]
        + [(n, ctypes.c_int) for n in (
            "L", "nfine", "cap", "CF", "W", "warps", "spw", "depth")]
        + [("sw", cuda_build.SWConsts)]
    )


@functools.lru_cache(maxsize=None)
def _entry(symbol):
    return cuda_build.bind("slab_energy", symbol,
                           [ctypes.POINTER(SlabEnergyArgs), ctypes.c_void_p])


class SlabEnergyKernel:
    """(r [L,3,nslot,W], valid [nslot,W], H [L,3,3,W]) -> (E [L,W],
    moments [10,L,nslot,W]) on the grid ``cg``; CUDA tensors must lie on
    ``device``, where the coverage tables are uploaded at construction."""

    def __init__(self, model: SWParams, cg: CellGrid, device="cpu"):
        self.model = model
        self.cg = cg
        self.nfine, self.cap = cg.nfine, cg.cap
        # the unmasked coverage columns (a padded column contributes
        # nothing in the plain version)
        keep = np.asarray(cg.full_mask, bool)
        self.cells = np.ascontiguousarray(
            np.asarray(cg.full_cells)[:, keep], np.int32)
        self.off = np.ascontiguousarray(
            np.asarray(cg.full_off)[:, keep], np.int32)
        self.CF = self.cells.shape[1]
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._cells_dev = torch.as_tensor(self.cells, device=self.device)
            self._off_dev = torch.as_tensor(self.off, device=self.device)
        self.consts = cuda_build.SWConsts.of(model)
        # per (dtype, L, W): the plan, the cells' terms [L,nfine,W] (in
        # float64: the energy is summed in it and rounded once) and the
        # tickets [L,tiles] (zero between launches)
        self._shapes = {}
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0
        tracing.register(self, "slab_energy")

    def plan(self, dtype, L, W) -> SlabEnergyPlan:
        return slab_energy_plan(L, self.nfine, self.CF, self.cap, W,
                                torch.empty((), dtype=dtype).element_size())

    def _shape(self, dtype, L, W):
        key = (dtype, L, W)
        if key not in self._shapes:
            plan = self.plan(dtype, L, W)
            self._shapes[key] = (
                plan,
                torch.empty((L, self.nfine, W), dtype=torch.float64,
                            device=self.device),
                torch.zeros((L, plan.grid[0]), dtype=torch.int32,
                            device=self.device))
        return self._shapes[key]

    def occupancy(self, dtype, L, W):
        """The kernel at L lattices and W walkers, from the CUDA runtime:
        a dict of registers and spill (local) bytes per thread, blocks
        resident on one SM, dynamic shared bytes per block and blocks."""
        fn = cuda_build.bind("slab_energy", "slab_energy_occupancy",
                             [ctypes.c_int, ctypes.POINTER(SlabEnergyArgs),
                              ctypes.POINTER(ctypes.c_int)])
        plan = self.plan(dtype, L, W)
        args = SlabEnergyArgs(L=L, nfine=self.nfine, cap=self.cap,
                              CF=self.CF, W=W, warps=plan.warps,
                              spw=plan.spw, depth=plan.depth)
        out = (ctypes.c_int * 5)()
        err = fn(int(dtype == torch.float64), ctypes.byref(args), out)
        cuda_build.check(err, "slab_energy occupancy")
        return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                         "smem_bytes", "blocks"), out))

    def plain(self, r, valid, H):
        per = [slab_full_energy(r[l], valid, H[l], self.cg, self.model)
               for l in range(r.shape[0])]
        return (torch.stack([p[0] for p in per]),
                torch.stack([p[1] for p in per], dim=1))

    def launch_args(self, r, valid, H):
        """(args, keep, (E, mom)) of one launch on CUDA tensors: the
        checked SlabEnergyArgs, the input tensors its pointers reference
        (keep them alive until the launch is enqueued) and the outputs."""
        L, W = r.shape[0], r.shape[-1]
        nslot = self.nfine * self.cap
        if not (r.dim() == 4 and L in (1, 2) and r.shape[1:] == (3, nslot, W)
                and r.dtype in (torch.float32, torch.float64)
                and valid.shape == (nslot, W) and valid.dtype == torch.bool
                and H.shape == (L, 3, 3, W) and H.dtype == r.dtype
                and r.device == self.device and valid.device == self.device
                and H.device == self.device):
            raise ValueError(
                f"slab_energy: needs r [L,3,{nslot},W] (L 1 or 2, float32 or "
                f"float64), bool valid [{nslot},W] and H [L,3,3,W] of r's "
                f"type on {self.device}; got r {tuple(r.shape)} {r.dtype} "
                f"on {r.device}, valid {tuple(valid.shape)} {valid.dtype} "
                f"on {valid.device}, H {tuple(H.shape)} {H.dtype} on "
                f"{H.device}")
        # a walker slice (an audit of the first n walkers) is copied
        r, valid, H = r.contiguous(), valid.contiguous(), H.contiguous()
        plan, part, ticket = self._shape(r.dtype, L, W)
        E = torch.empty((L, W), dtype=r.dtype, device=self.device)
        mom = torch.empty((10, L, nslot, W), dtype=r.dtype,
                          device=self.device)
        args = SlabEnergyArgs(
            r=r.data_ptr(), valid=valid.data_ptr(), h=H.data_ptr(),
            cells=self._cells_dev.data_ptr(), off=self._off_dev.data_ptr(),
            mom=mom.data_ptr(), E=E.data_ptr(), part=part.data_ptr(),
            ticket=ticket.data_ptr(), L=L, nfine=self.nfine, cap=self.cap,
            CF=self.CF, W=W, warps=plan.warps, spw=plan.spw,
            depth=plan.depth, sw=self.consts)
        return args, (r, valid, H), (E, mom)

    def __call__(self, r, valid, H):
        if not r.is_cuda:
            return self.plain(r, valid, H)
        args, keep, out = self.launch_args(r, valid, H)
        sym = ("slab_energy_f32" if r.dtype == torch.float32
               else "slab_energy_f64")
        stream = torch.cuda.current_stream(r.device).cuda_stream
        cuda_build.check(_entry(sym)(ctypes.byref(args), stream),
                         "slab_energy")
        del keep
        self.launches += 1
        return out
