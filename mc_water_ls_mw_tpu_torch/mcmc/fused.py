"""All translations, switch attempts and per-move WL updates of one
cycle: the CUDA kernels and their plain versions.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/fused.py`` (``FusedCycle``)
for two lattices, in all three branches of its kernel, each its own
CUDA kernel here:

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

I/O contract as in the JAX package: the state's r, moments, energy,
weight, hist, uhist and trans_per_mol plus the packed per-walker rows
wf [8, W] / wi [11, W] (row order below) are read and written; h, recip,
volume, the pre-drawn uniforms cycle_u ([N, 7, W], or [N/T, 4+5T, W] at
T > 1), the bin grid and the master weight base [B, W] are read; the
move codes [N] and the molecule schedule ([N/T], none in dense mode)
are uniform across walkers.

The kernels are in ``csrc/fused_cycle.cu`` (its header says what bounds
them on the H100 and how the design answers that).  The plain versions
are Python loops over the steps on tensors that call the engine's own
steps (``Engine._translation_tbl``, ``_translation``,
``_translation_tbl_multi`` and ``_switch``).  The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
the engine's kernel or raises.  Both update the state in place.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from ..ops.dsfloat import ds_value

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
    """Mirror of ``struct FusedArgs`` in csrc/fused_cycle.cu."""

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
    )


@functools.lru_cache(maxsize=None)
def _entry(kernel, dtype):
    sym = f"{kernel}_{'f32' if dtype == torch.float32 else 'f64'}"
    return cuda_build.bind("fused_cycle", sym,
                           [ctypes.POINTER(FusedArgs), ctypes.c_void_p])


class FusedCycle:
    """One cycle's step loop for a fixed engine (prm, model, grid, aux).

    ``fused(s, codes, sched_mol, cycle_u, wl_active, switch_ok)``
    advances the state in place.  ``kernel`` names the engine's branch
    (``fused_cycle``, ``fused_cycle_dense`` or ``fused_cycle_multi``)."""

    def __init__(self, eng):
        self.eng = eng
        prm = eng.prm
        self.do_switch = prm.mc_always_switch or prm.allow_switch
        if eng.dense:
            self.kernel = "fused_cycle_dense"
        elif eng.dT > 1:
            self.kernel = "fused_cycle_multi"
        else:
            self.kernel = "fused_cycle"
        self._dev = {}
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0

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
        package; none in dense mode), the folded shifts and the bin
        grid."""
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
            )
        return self._dev[key]

    def occupancy(self, dtype):
        """(registers per thread, spill bytes per thread, resident blocks
        of 128 walkers per SM) of the engine's kernel, from the CUDA
        runtime."""
        fn = cuda_build.bind("fused_cycle", "fused_cycle_occupancy",
                             [ctypes.c_int] * 7
                             + [ctypes.POINTER(ctypes.c_int)])
        out = (ctypes.c_int * 3)()
        eng = self.eng
        branch = ("fused_cycle", "fused_cycle_dense",
                  "fused_cycle_multi").index(self.kernel)
        M = 0 if eng.dense else eng.tbl.shape[-1]
        N = eng.prm.nwater
        err = fn(branch, int(dtype == torch.float64), N, eng.grid.nbins, M,
                 len(eng.fold_shifts), N // eng.dT, out)
        cuda_build.check(err, "fused_cycle occupancy")
        return tuple(out)

    def __call__(self, s, codes, sched_mol, cycle_u, wl_active,
                 switch_ok):
        if not s.r.is_cuda:
            return self.plain(s, codes, sched_mol, cycle_u, wl_active,
                              switch_ok)
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
                or s.moments.shape != (10, L, N, W) or L != 2
                or (sched_mol is None) != eng.dense):
            raise ValueError(
                f"FusedCycle ({self.kernel}): cycle_u "
                f"{tuple(cycle_u.shape)}, codes {tuple(codes.shape)}, "
                f"moments {tuple(s.moments.shape)}, sched_mol "
                f"{None if sched_mol is None else tuple(sched_mol.shape)}")
        tbl, frac0, shifts, binw, mub = self._constants(dev, dtype)
        wf = torch.stack([s.mu, s.f, s.sumhist, s.min_dmu, s.max_dmu,
                          s.max_trans, s.my_mu_min, s.my_mu_max])
        wi = torch.stack([
            s.ls, s.att[0], s.att[1], s.att[2], s.acc[0], s.acc[1],
            s.acc[2], s.start_bin, s.end_bin, s.in_window.to(torch.int32),
            s.invt_active.to(torch.int32),
        ]).to(torch.int32)
        basew = ds_value(s.master_eta)[s.window_id.long()].T.contiguous()
        # the move codes [N], then the molecule schedule [N/T] (table
        # mode)
        sched = codes.to(torch.int32)
        if sched_mol is not None:
            sched = torch.cat([sched, sched_mol.to(torch.int32)])
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
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(self.kernel, dtype)(ctypes.byref(args), stream)
        cuda_build.check(err, self.kernel)
        self.launches += 1
        s.mu, s.f, s.sumhist = wf[WF_MU], wf[WF_F], wf[WF_SUMHIST]
        s.min_dmu, s.max_dmu = wf[WF_MIN_DMU], wf[WF_MAX_DMU]
        s.ls = wi[WI_LS]
        s.att = wi[WI_ATT:WI_ATT + 3]
        s.acc = wi[WI_ACC:WI_ACC + 3]
        return s
