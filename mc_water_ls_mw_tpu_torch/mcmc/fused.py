"""All translations, switch attempts and per-move WL updates of one
cycle: the CUDA kernels and their plain versions.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/fused.py`` (``FusedCycle``)
in all three branches of its kernel, each its own CUDA kernel here:

* ``fused_cycle``: the table branch with one trial per move
  (``_do_translation_tbl``): the shared molecule schedule, the static
  table partners, the displacement wall;
* ``fused_cycle_dense``: the dense-candidate branch
  (``_do_translation``): each walker moves its own molecule
  (``cycle_u[t, 0]``), every molecule under every folded image shift is
  a candidate, no wall;
* ``fused_cycle_multi``: the multi-trial table branch
  (``_do_translation_tbl_multi``, ``dense_trials`` = T > 1): N/T shared
  movers of T anchored-window trials each.

Those three are the two-lattice kernels of the plain settings.  One
lattice (the single-box NPT run: no mu, no WL, no switch) runs
``fused_cycle_1l`` or ``fused_cycle_dense_1l``; MINU, NVT, leshift and
the Swetnam and 1/t f schedules at two lattices run ``fused_cycle_ext``,
``fused_cycle_dense_ext`` or ``fused_cycle_multi_ext``
(``csrc/fused_cycle_variants.cu``), the settings read from the args.

I/O contract as in the JAX package: the state's r, moments, energy,
weight, hist, uhist and trans_per_mol plus the packed per-walker rows
wf [8, W] / wi [11, W] (row order below) are read and written; h, recip,
volume, the pre-drawn uniforms cycle_u ([N, 7, W], or [N/T, 4+5T, W] at
T > 1), the bin grid and the master weight base [B, W] are read; the
move codes [N] and the molecule schedule ([N/T], none in dense mode)
are uniform across walkers.

The kernels are in ``csrc/fused_warp.cuh`` (its header says what bounds
them on the H100 and how the design answers that), built as the
libraries ``fused_cycle`` and ``fused_cycle_variants``.  All three run one
warp per walker with the walker's state staged in shared memory;
``launch_plan`` chooses the walkers per block from the shared memory
budget (or reads the state in place where one walker's state does not
fit).  The plain versions
are Python loops over the steps on tensors that call the engine's own
steps (``Engine._translation_tbl``, ``_translation``,
``_translation_tbl_multi`` and ``_switch``).  The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
the engine's kernel or raises.  Both update the state in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build, tracing
from ..cuda_build import SMEM_BLOCK_MAX
from ..ops.dsfloat import ds_value
from .bins import (
    SCHED_INVT,
    SCHED_PLAIN,
    SCHED_SWETNAM,
    invt_cap,
    schedule_kind,
)

TRANS, VOL, SWITCH, NOOP = 0, 1, 2, 3

# wf (float per-walker rows)
WF_MU, WF_F, WF_SUMHIST, WF_MIN_DMU, WF_MAX_DMU = 0, 1, 2, 3, 4
WF_MAX_TRANS, WF_MU_MIN, WF_MU_MAX = 5, 6, 7
WF_ROWS = 8
# wi (int per-walker rows)
WI_LS = 0
WI_ATT = 1            # rows 1..3: attempted trans/vol/switch
WI_ACC = 4            # rows 4..6: accepted
WI_START, WI_END, WI_INWIN, WI_INVT = 7, 8, 9, 10
WI_ROWS = 11


class FusedArgs(ctypes.Structure):
    """Mirror of ``struct FusedArgs`` in csrc/fused_warp.cuh."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "r", "mom", "e", "wgt", "hist", "uh", "tpm", "wf", "wi",
            "h", "recip", "vol", "cu", "binw", "mub", "basew", "sched",
            "tbl", "frac0", "shifts")]
        + [(n, ctypes.c_int) for n in (
            "N", "W", "B", "M", "S", "T", "wl_active", "switch_ok",
            "samplerun", "eta_interp", "dd_seeding", "do_switch",
            "always_switch")]
        + [(n, ctypes.c_double) for n in (
            "beta", "betaP", "pressure", "nwater", "log_norm", "wall2",
            "av_bw", "cpos", "cneg", "a_pos", "a_neg", "lnr_pos",
            "lnr_neg")]
        + [("sw", cuda_build.SWConsts)]
        + [(n, ctypes.c_int) for n in ("wpb", "state_smem")]
        # the extended kernels' settings
        + [(n, ctypes.c_int) for n in ("minu", "npt", "leshift", "f_sched")]
        + [(n, ctypes.c_double) for n in (
            "rh0", "rh1", "alpha", "wl_factor", "invt_f")]
        + [(n, ctypes.c_void_p) for n in ("binfrac", "baseh")]
    )


# Walkers (warps) per block at most, by element size: the warp kernels'
# register bound (WarpCap in csrc/fused_warp.cuh).
WARP_CAP = {4: 8, 8: 5}
# rows of N values in one walker's state per lattice: r [3] and the
# moments [10]
STATE_ROWS = 13
# table slots (M) the multi-trial kernel takes at most: two a lane
# (MULTI_SL_MAX in csrc/fused_warp.cuh)
MULTI_SLOTS_MAX = 64
# the kernels: name -> (branch, lattices, library); each library exports
# <name>_f32/_f64 (launch) and <name>_occupancy_f32/_f64
TABLE, DENSE, MULTI = "table", "dense", "multi"
KERNELS = {
    "fused_cycle": (TABLE, 2, "fused_cycle"),
    "fused_cycle_dense": (DENSE, 2, "fused_cycle"),
    "fused_cycle_multi": (MULTI, 2, "fused_cycle"),
    "fused_cycle_1l": (TABLE, 1, "fused_cycle_variants"),
    "fused_cycle_dense_1l": (DENSE, 1, "fused_cycle_variants"),
    "fused_cycle_ext": (TABLE, 2, "fused_cycle_variants"),
    "fused_cycle_dense_ext": (DENSE, 2, "fused_cycle_variants"),
    "fused_cycle_multi_ext": (MULTI, 2, "fused_cycle_variants"),
}


def kernel_name(prm, dense: bool) -> str:
    """The kernel of a run's settings: its branch (dense candidates,
    ``dense_trials`` > 1, else tables), one lattice, or the extended
    settings (MINU, NVT, leshift, an f schedule of a WL generation
    run)."""
    base = ("fused_cycle_dense" if dense else
            "fused_cycle_multi" if max(1, int(prm.dense_trials)) > 1
            else "fused_cycle")
    if prm.num_lattices == 1:
        return base + "_1l"
    ext = (prm.minu or prm.leshift or prm.mc_ensemble != "npt"
           or schedule_kind(prm) != SCHED_PLAIN)
    return base + "_ext" if ext else base


class LaunchPlan(NamedTuple):
    """Geometry of a warp-kernel launch: ``wpb`` walkers (warps) per
    block, their state staged in shared memory (``state_smem``) or read
    in place in device memory, ``smem`` dynamic shared bytes per block,
    ``blocks`` blocks."""

    wpb: int
    state_smem: bool
    smem: int
    blocks: int


def smem_bytes(kernel, itemsize, N, B, S, wpb, state_smem, T=1):
    """Dynamic shared bytes of a block of a table (``fused_cycle...``),
    dense (``fused_cycle_dense...``) or multi-trial
    (``fused_cycle_multi...``, T trials per mover) kernel
    (warp_smem_bytes in csrc/fused_warp.cuh): the bin widths and centres,
    the walkers' states of the kernel's lattices when staged, the
    schedule (the N codes, then the molecule schedule: N molecules in
    table mode, N/T movers in multi-trial mode), the folded shifts, and
    in dense mode a list of N uint16 rows per walker."""
    branch, L, _ = KERNELS[kernel]
    sched = {TABLE: 2 * N, DENSE: N, MULTI: N + N // T}[branch]
    rows = STATE_ROWS * L * N
    return (itemsize * (2 * B + (wpb * rows if state_smem else 0))
            + 4 * (sched + 3 * S)
            + (2 * wpb * N if branch == DENSE else 0))


def launch_plan(kernel, itemsize, N, B, S, W, T=1):
    """The launch of a fused-cycle kernel (``KERNELS``; the multi-trial
    one at T trials per mover) for N molecules, B bins, S folded shifts
    and W walkers in elements of ``itemsize`` bytes: the most walkers
    per block (up to WARP_CAP and W) whose states fit in one block's
    shared memory; where not even one walker's state fits, the state is
    read in place and the block holds only the rest.  Raises where
    neither fits."""
    if kernel not in KERNELS:
        raise ValueError(f"launch_plan: no warp kernel {kernel!r}")
    cap = min(WARP_CAP[itemsize], W)
    if KERNELS[kernel][0] == DENSE and N > 65535:
        cap = 0                       # the row lists hold uint16 indices
    for state_smem in (True, False):
        for wpb in range(cap, 0, -1):
            nbytes = smem_bytes(kernel, itemsize, N, B, S, wpb, state_smem,
                                T)
            if nbytes <= SMEM_BLOCK_MAX:
                return LaunchPlan(wpb, state_smem, nbytes, -(-W // wpb))
    raise ValueError(
        f"{kernel}: N={N}, B={B}, S={S} in {itemsize}-byte elements do not "
        f"fit one block's {SMEM_BLOCK_MAX} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _entry(kernel, dtype):
    sym = f"{kernel}_{'f32' if dtype == torch.float32 else 'f64'}"
    return cuda_build.bind(KERNELS[kernel][2], sym,
                           [ctypes.POINTER(FusedArgs), ctypes.c_void_p])


class FusedCycle:
    """One cycle's step loop for a fixed engine (prm, model, grid, aux).

    ``fused(s, codes, sched_mol, cycle_u, wl_active, switch_ok)``
    advances the state in place.  ``kernel`` names the engine's kernel
    (``KERNELS``: its branch, one lattice, or the extended settings)."""

    def __init__(self, eng):
        self.eng = eng
        self.do_switch = eng.switches_on()
        self.kernel = kernel_name(eng.prm, eng.dense)
        # the reference enthalpies as host floats, read once: the aux
        # tensor may live on the card, and reading it per launch would
        # wait for the stream
        rh = eng.aux.ref_enthalpy.double().cpu().numpy()
        self.ref_enth = (float(rh[0]), float(rh[-1]))
        self._dev = {}
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0
        tracing.register(self, self.kernel)

    def _switch_on(self, code, switch_ok):
        prm = self.eng.prm
        return self.do_switch and switch_ok and (
            code == SWITCH or (prm.mc_always_switch and code == TRANS))

    def plain(self, s, codes, sched_mol, cycle_u, wl_active, switch_ok):
        """Step loop on tensors: the JAX scan path's step (engine.py:
        441-600 of the JAX package) with the shared molecule schedule in
        table mode or each walker's own molecule in dense mode, or the
        multi-trial step over the N/T movers.  A step whose scheduled
        move is not a translation leaves the state as it is, so it is
        skipped."""
        eng = self.eng
        codes = codes.tolist()
        if eng.dT > 1:
            T = eng.dT
            for t, imol in enumerate(sched_mol.tolist()):
                eng._translation_tbl_multi(s, cycle_u[t],
                                           codes[t * T:(t + 1) * T], imol,
                                           wl_active, switch_ok)
            return s
        for t, code in enumerate(codes):
            if code == TRANS:
                if eng.dense:
                    eng._translation(s, cycle_u[t], wl_active)
                else:
                    eng._translation_tbl(s, cycle_u[t], int(sched_mol[t]),
                                         wl_active)
            if self._switch_on(code, switch_ok):
                eng._switch(s, cycle_u[t, 6])
        return s

    def _constants(self, dev, dtype):
        """Per-device uploads of the static tables (flattened as
        (l*N + imol)*M + m and (l*3 + a)*N + imol, as in the JAX
        package; none in dense mode), the folded shifts, the bin grid
        and Swetnam's flat target per bin."""
        key = (dev, dtype)
        if key not in self._dev:
            eng = self.eng
            tbl = frac0 = None
            if not eng.dense:
                tbl = torch.as_tensor(eng.tbl.reshape(-1), device=dev)
                frac0 = eng.frac0.to(dev, dtype).reshape(-1).contiguous()
            self._dev[key] = (
                tbl, frac0,
                torch.as_tensor(np.ascontiguousarray(
                    eng.fold_shifts, np.int32).reshape(-1), device=dev),
                eng.binw.to(dev, dtype).contiguous(),
                eng.mub.to(dev, dtype).contiguous(),
                eng.binfrac.to(dev, dtype).contiguous(),
            )
        return self._dev[key]

    def plan(self, dtype, W):
        """The launch plan of the engine's kernel at W walkers.  Raises
        for a multi-trial table wider than MULTI_SLOTS_MAX."""
        eng = self.eng
        if KERNELS[self.kernel][0] == MULTI and \
                eng.tbl.shape[-1] > MULTI_SLOTS_MAX:
            raise ValueError(
                f"{self.kernel}: {eng.tbl.shape[-1]} table slots, at "
                f"most {MULTI_SLOTS_MAX}")
        itemsize = torch.empty((), dtype=dtype).element_size()
        return launch_plan(self.kernel, itemsize, eng.prm.nwater,
                           eng.grid.nbins, len(eng.fold_shifts), W, eng.dT)

    def _shape_args(self, dtype, W):
        """FusedArgs with the shape and launch plan only (no pointers)."""
        eng = self.eng
        plan = self.plan(dtype, W)
        return FusedArgs(
            N=eng.prm.nwater, W=W, B=eng.grid.nbins,
            M=0 if eng.dense else eng.tbl.shape[-1],
            S=len(eng.fold_shifts), T=eng.dT,
            wpb=plan.wpb, state_smem=int(plan.state_smem))

    def occupancy(self, dtype, W):
        """The engine's kernel at W walkers, from the CUDA runtime: a dict
        of registers and spill (local) bytes per thread, walkers resident
        on one SM, dynamic shared bytes per block, walkers per block and
        blocks."""
        sym = f"{self.kernel}_occupancy_" \
            f"{'f32' if dtype == torch.float32 else 'f64'}"
        fn = cuda_build.bind(KERNELS[self.kernel][2], sym,
                             [ctypes.POINTER(FusedArgs),
                              ctypes.POINTER(ctypes.c_int)])
        out = (ctypes.c_int * 6)()
        args = self._shape_args(dtype, W)
        err = fn(ctypes.byref(args), out)
        cuda_build.check(err, "fused_cycle occupancy")
        return dict(zip(("registers", "spill_bytes", "walkers_per_sm",
                         "smem_bytes", "walkers_per_block", "blocks"),
                        out))

    @tracing.traced("mw/step_kernel")
    def __call__(self, s, codes, sched_mol, cycle_u, wl_active,
                 switch_ok):
        if not s.r.is_cuda:
            return self.plain(s, codes, sched_mol, cycle_u, wl_active,
                              switch_ok)
        args, wf, wi, keep = self.launch_args(s, codes, sched_mol, cycle_u,
                                              wl_active, switch_ok)
        stream = torch.cuda.current_stream(s.r.device).cuda_stream
        err = _entry(self.kernel, s.r.dtype)(ctypes.byref(args), stream)
        cuda_build.check(err, self.kernel)
        self.launches += 1
        del keep
        return self.finish(s, wf, wi)

    def launch_args(self, s, codes, sched_mol, cycle_u, wl_active,
                    switch_ok):
        """(args, wf, wi, keep) of one launch on the CUDA state ``s``:
        the FusedArgs (pointers, constants, launch plan), the packed
        per-walker rows the kernel updates, and the tensors the pointers
        reference (keep them alive until the launch is enqueued)."""
        eng, prm, grid = self.eng, self.eng.prm, self.eng.grid
        L, _, N, W = s.r.shape
        T = eng.dT
        dtype, dev = s.r.dtype, s.r.device
        B = grid.nbins
        rw = [s.r, s.moments, s.energy, s.weight, s.hist, s.trans_per_mol]
        if prm.samplerun:
            rw.append(s.uhist)
        for t in rw + [s.h, s.recip, s.volume, cycle_u]:
            want = torch.int32 if t is s.trans_per_mol else dtype
            if not (t.is_contiguous() and t.device == dev
                    and t.dtype == want):
                raise ValueError("FusedCycle: state tensors must be "
                                 f"contiguous {dtype} (trans_per_mol "
                                 f"int32) on {dev}")
        n_u = 7 if T == 1 else 4 + 5 * T
        if (cycle_u.shape != (N // T, n_u, W) or codes.shape != (N,)
                or s.moments.shape != (10, L, N, W)
                or L != KERNELS[self.kernel][1]
                or (sched_mol is None) != eng.dense):
            raise ValueError(
                f"FusedCycle ({self.kernel}): cycle_u "
                f"{tuple(cycle_u.shape)}, codes {tuple(codes.shape)}, "
                f"moments {tuple(s.moments.shape)}, sched_mol "
                f"{None if sched_mol is None else tuple(sched_mol.shape)}")
        plan = self.plan(dtype, W)
        tbl, frac0, shifts, binw, mub, binfrac = self._constants(dev, dtype)
        wf = torch.stack([s.mu, s.f, s.sumhist, s.min_dmu, s.max_dmu,
                          s.max_trans, s.my_mu_min, s.my_mu_max])
        wi = torch.stack([
            s.ls, s.att[0], s.att[1], s.att[2], s.acc[0], s.acc[1],
            s.acc[2], s.start_bin, s.end_bin, s.in_window.to(torch.int32),
            s.invt_active.to(torch.int32),
        ]).to(torch.int32)
        basew = ds_value(s.master_eta)[s.window_id.long()].T.contiguous()
        sched_f = schedule_kind(prm)
        baseh = None
        if sched_f == SCHED_SWETNAM:
            baseh = ds_value(s.master_hist)[s.window_id.long()].T \
                .contiguous()
        # the move codes [N], then the molecule schedule [N/T] (table
        # mode)
        sched = codes.to(torch.int32)
        if sched_mol is not None:
            sched = torch.cat([sched, sched_mol.to(torch.int32)])
        with tracing.wait("move_codes"):
            sched = sched.to(dev)
        m = eng.model
        P = lambda t: None if t is None else t.data_ptr()   # noqa: E731
        args = FusedArgs(
            r=P(s.r), mom=P(s.moments), e=P(s.energy), wgt=P(s.weight),
            hist=P(s.hist), uh=P(s.uhist) if prm.samplerun else None,
            tpm=P(s.trans_per_mol), wf=P(wf), wi=P(wi), h=P(s.h),
            recip=P(s.recip), vol=P(s.volume), cu=P(cycle_u),
            binw=P(binw), mub=P(mub), basew=P(basew), sched=P(sched),
            tbl=P(tbl), frac0=P(frac0), shifts=P(shifts),
            N=N, W=W, B=B, M=0 if eng.dense else eng.tbl.shape[-1],
            S=len(eng.fold_shifts), T=T,
            wl_active=int(bool(wl_active)), switch_ok=int(bool(switch_ok)),
            samplerun=int(prm.samplerun), eta_interp=int(prm.eta_interp),
            dd_seeding=int(prm.dd_seeding), do_switch=int(self.do_switch),
            always_switch=int(prm.mc_always_switch),
            beta=prm.beta, betaP=prm.beta * prm.pressure,
            pressure=prm.pressure, nwater=float(prm.nwater),
            log_norm=eng.aux.log_unbiased_norm,
            wall2=eng.wall * eng.wall, av_bw=grid.av_binwidth,
            cpos=1.0 - grid.r_pos, cneg=1.0 - grid.r_neg,
            a_pos=grid.a_pos, a_neg=grid.a_neg,
            lnr_pos=float(np.log(grid.r_pos)),
            lnr_neg=float(np.log(grid.r_neg)),
            sw=cuda_build.SWConsts.of(m),
            wpb=plan.wpb, state_smem=int(plan.state_smem),
            minu=int(prm.minu), npt=int(prm.mc_ensemble == "npt"),
            leshift=int(prm.leshift), f_sched=sched_f,
            rh0=self.ref_enth[0], rh1=self.ref_enth[1], alpha=prm.wl_alpha,
            wl_factor=prm.wl_factor,
            invt_f=(invt_cap(B, s.cycle, prm.nwater, dtype)
                    if sched_f == SCHED_INVT else 0.0),
            binfrac=P(binfrac), baseh=P(baseh),
        )
        return args, wf, wi, (tbl, frac0, shifts, binw, mub, basew, sched,
                              binfrac, baseh)

    @staticmethod
    def finish(s, wf, wi):
        """The updated per-walker rows back into the state's fields (f
        and sumhist change under the f schedules only)."""
        s.mu, s.f, s.sumhist = wf[WF_MU], wf[WF_F], wf[WF_SUMHIST]
        s.min_dmu, s.max_dmu = wf[WF_MIN_DMU], wf[WF_MAX_DMU]
        s.ls = wi[WI_LS]
        s.att = wi[WI_ATT:WI_ATT + 3]
        s.acc = wi[WI_ACC:WI_ACC + 3]
        return s
