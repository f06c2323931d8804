"""The acceptance chain + per-move Wang-Landau update of one cell-engine
sub-step: the CUDA kernel and its plain version.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/chain_pallas.py``
(``ChainWLPallas``).  After the mover energies of a sub-step are known
at all P = T + 1 points of each of its K movers, the K x T sequential
Metropolis trials are per-walker scalar arithmetic plus lookups and
updates of the [B, W] WL slabs at data-dependent bins.  WL increments
land PER MOVE, exactly as in the reference (mc_update_wl_bins after
every trial, mc_moves.F90:1597-1689) and in the N=216 engine.  Per
trial: the translation acceptance (mc_moves.F90:1113-1146) with the
compensated two-sum of the accepted energy change, the WL update, and
the switch attempt (mc_lattice_switch, :1536-1594).

Tensor layouts (row constants below, as in the JAX package):

* ``codes`` [K*T] int32 move codes (trial (k, t) at k*T + t), shared by
  all walkers;
* ``cf`` [CF_ROWS, W] float rows, ``ci`` [CI_ROWS, W] int32 rows (the
  chain state and its per-sub-step constants), updated IN PLACE;
* ``wgt`` / ``hist`` / ``uh`` [B, W]: the walkers' WL growth slabs,
  updated IN PLACE; ``basew`` [B, W] the frozen master weight view;
* ``e`` [2*K*P, W] point energies (lattice, then mover, then point),
  ``inc`` [K*P, W] in-cell flags and ``hasm`` [K, W] mover-exists flags
  (float 0/1), ``ua`` / ``uz`` [K*T, W] accept / switch uniforms;
* returns ``joh`` [K*P, W] (one-hot of each mover's accepted point) and
  ``cnt`` [CN_FIXED + K, W] int32 counters.

Against the JAX kernel's interface: the WL-live gate and the cycle
number are host values (the port's cycle counter lives on the host);
the master-histogram base ``baseh`` [B, W] is taken where the Swetnam
schedule reads it, and the 1/t schedule's cap B / (cycle * nwater) is
formed on the host in the working type.  As in the JAX kernel, MINU
folds a switch to the lattice of the lower trial enthalpy into each
translation (``CF_MINUC`` holds its hoisted volume and reference-
enthalpy terms), and f and sumhist follow the run's schedule from trial
to trial.  A mover's current point energies and in-cell flag are read
as the JAX kernel reads them, as the sum over the P points of the
accepted-point one-hot times the point's value: a non-finite energy at
any point of a mover makes every later trial of that mover non-finite,
and so rejected.

The kernel is ``csrc/chain_wl.cu`` (its header says what bounds it on
the H100 and how the design answers that); it shares ``eta_of`` and
``wl_update`` with the N=216 whole-cycle kernel (csrc/wl_common.cuh).
``chain_plan`` chooses its launch from the shapes: the walkers per block
whose WL columns and tables fit one block's shared memory, where the
chain then runs, or, where one walker's do not fit, the branch that
reads them in place.
The plain version is a loop over the K x T trials on [W] tensors, with
``bins.eta_lookup`` / ``bins.wl_move_update`` as the engines use them.
The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build, tracing
from ..cuda_build import SMEM_BLOCK_MAX
from ..ops.dsfloat import _two_sum
from .bins import (
    SCHED_INVT,
    SCHED_SWETNAM,
    BinGrid,
    eta_lookup,
    f_schedule,
    invt_cap,
    schedule_kind,
    swetnam_binfrac,
    wl_move_update,
)
from .config import RunParams

TRANS, VOL, SWITCH, NOOP = 0, 1, 2, 3

# cf: float per-walker rows (MU..MAX_DMU and the residuals mutate, the
# rest are constants of the sub-step)
CF_MU, CF_E0, CF_E1, CF_F, CF_SUMHIST = 0, 1, 2, 3, 4
CF_MIN_DMU, CF_MAX_DMU = 5, 6
CF_MU_MIN, CF_MU_MAX, CF_CMU, CF_SWC = 7, 8, 9, 10
CF_MINUC = 11
# compensated-energy residuals (CellState.energy_err): at N ~ 10^4 a
# move's dE equals ulp(total) in f32, so the chain two-sums every
# accepted dE into (E, E_err) instead of a plain add
CF_E0E, CF_E1E = 12, 13
CF_ROWS = 14
# ci: int per-walker rows (LS mutates)
CI_LS, CI_START, CI_END, CI_INWIN, CI_INVT = 0, 1, 2, 3, 4
CI_OCCOK, CI_SWOK = 5, 6
CI_ROWS = 7
# cnt: int output rows: attempted/accepted translations, attempted/
# accepted switches, then K per-mover translation-attempt counts
CN_EN, CN_ACC, CN_SWEN, CN_SWACC = 0, 1, 2, 3
CN_FIXED = 4


class ChainArgs(ctypes.Structure):
    """Mirror of ``struct ChainArgs`` in csrc/chain_wl.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "codes", "cf", "ci", "wgt", "hist", "uh", "basew", "binw",
            "mub", "e", "inc", "hasm", "ua", "uz", "joh", "cnt")]
        + [(n, ctypes.c_int) for n in (
            "K", "Tn", "W", "B", "wl_active", "samplerun", "eta_interp",
            "dd_seeding", "do_switch", "always_switch")]
        + [(n, ctypes.c_double) for n in (
            "beta", "av_bw", "log_norm", "cpos", "cneg", "a_pos", "a_neg",
            "lnr_pos", "lnr_neg")]
        + [(n, ctypes.c_int) for n in ("wpb", "staged")]
        # MINU and the f schedules
        + [(n, ctypes.c_int) for n in ("minu", "f_sched")]
        + [(n, ctypes.c_double) for n in ("alpha", "wl_factor", "invt_f")]
        + [(n, ctypes.c_void_p) for n in ("binfrac", "baseh")]
    )


# A block has a warp per walker (lane 0 runs its chain, all threads copy
# the columns in and out): CHAIN_WPB walkers in the staged branch, one
# for each of an SM's four warp schedulers (the plan passes wpb to the
# kernel; 8 ran 3-12% slower on an H100, two chains sharing a
# scheduler's issue slots; the kernel takes up to CHAIN_WPB_MAX),
# INPLACE_WPB in the in-place branch (constants of csrc/chain_wl.cu).
CHAIN_WPB = 4
CHAIN_WPB_MAX = 8
INPLACE_WPB = 8


class ChainPlan(NamedTuple):
    """Geometry of a chain launch: ``wpb`` walkers per block, their
    columns staged in shared memory (``staged``) or read in place,
    ``threads`` per block, ``smem`` dynamic shared bytes per block,
    ``blocks`` blocks."""

    wpb: int
    staged: bool
    threads: int
    smem: int
    blocks: int


def staged_rows(B, K, T, samplerun):
    """Rows of one walker's staged columns (staged_rows in
    csrc/chain_wl.cu): the WL slabs wgt, basew, hist (and uhist in a
    sample run), the point energies of both lattices, the in-cell flags,
    the mover flags and both uniform rows."""
    P = T + 1
    return (4 if samplerun else 3) * B + 3 * K * P + K + 2 * K * T


def chain_smem_bytes(itemsize, B, K, T, samplerun, wpb, staged):
    """Dynamic shared bytes of a chain block (chain_smem_bytes in
    csrc/chain_wl.cu): the bin widths and centres, the walkers' staged
    columns, the K*T move codes."""
    cols = wpb * staged_rows(B, K, T, samplerun) if staged else 0
    return itemsize * (2 * B + cols) + 4 * K * T


def chain_plan(itemsize, B, K, T, W, samplerun):
    """The launch of the chain kernel for B bins, K movers of T trials
    and W walkers in elements of ``itemsize`` bytes: the most walkers
    per block, up to CHAIN_WPB and W, whose columns fit one block's
    shared memory, a warp each; where not even one walker's fit, the
    in-place branch (INPLACE_WPB walkers a block, only the bin grid and
    the codes in shared memory).  Raises where neither fits."""
    for wpb in range(min(CHAIN_WPB, W), 0, -1):
        n = chain_smem_bytes(itemsize, B, K, T, samplerun, wpb, True)
        if n <= SMEM_BLOCK_MAX:
            return ChainPlan(wpb, True, 32 * wpb, n, -(-W // wpb))
    return in_place_plan(itemsize, B, K, T, W, samplerun)


def in_place_plan(itemsize, B, K, T, W, samplerun):
    """The in-place branch's launch (``chain_plan``'s arguments): the
    columns read where they lie.  Raises where not even the bin grid
    and the codes fit one block's shared memory."""
    n = chain_smem_bytes(itemsize, B, K, T, samplerun, INPLACE_WPB, False)
    if n <= SMEM_BLOCK_MAX:
        return ChainPlan(INPLACE_WPB, False, 32 * INPLACE_WPB, n,
                         -(-W // INPLACE_WPB))
    raise ValueError(
        f"chain_wl: B={B}, K={K}, T={T} in {itemsize}-byte elements do "
        f"not fit one block's {SMEM_BLOCK_MAX} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    sym = "chain_wl_f32" if dtype == torch.float32 else "chain_wl_f64"
    return cuda_build.bind("chain_wl", sym,
                           [ctypes.POINTER(ChainArgs), ctypes.c_void_p])


class ChainWLKernel:
    """One chain + WL pass per (colour, fine-block) sub-step; K, T and
    the run's rules are fixed per instance."""

    def __init__(self, prm: RunParams, grid: BinGrid, K: int, T: int,
                 log_norm: float):
        assert prm.num_lattices == 2, (
            "the chain kernel implements the two-replica rule; "
            "single-lattice large-N runs use the XLA chain")
        self.prm = prm
        self.grid = grid
        self.K = int(K)
        self.T = int(T)
        self.P = self.T + 1
        self.log_norm = float(log_norm)
        self.do_switch = prm.mc_always_switch or prm.allow_switch
        self._grid_dev = {}
        self._plans = {}
        # kernel launches (one per call on CUDA tensors)
        self.launches = 0
        tracing.register(self, "chain_wl")

    def _bins(self, dev, dtype):
        """(binw, mub, binfrac) [B] on the device, uploaded once
        (binfrac: Swetnam's flat target per bin)."""
        key = (dev, dtype)
        if key not in self._grid_dev:
            prm = self.prm
            self._grid_dev[key] = tuple(
                torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
                for a in (self.grid.binwidth, self.grid.mu_bin,
                          swetnam_binfrac(self.grid, prm.mu_min,
                                          prm.mu_max)))
        return self._grid_dev[key]

    def plan(self, dtype, W) -> ChainPlan:
        """The launch plan of the kernel at W walkers (``chain_plan``),
        computed once per shape."""
        key = (dtype, W)
        if key not in self._plans:
            itemsize = 8 if dtype == torch.float64 else 4
            self._plans[key] = chain_plan(itemsize, self.grid.nbins, self.K,
                                          self.T, W, self.prm.samplerun)
        return self._plans[key]

    def occupancy(self, dtype, W):
        """The kernel at W walkers, from the CUDA runtime: a dict of
        registers and spill (local) bytes per thread, blocks resident on
        one SM, dynamic shared bytes per block, walkers per block and
        blocks."""
        fn = cuda_build.bind("chain_wl", "chain_wl_occupancy",
                             [ctypes.c_int, ctypes.POINTER(ChainArgs),
                              ctypes.POINTER(ctypes.c_int)])
        plan = self.plan(dtype, W)
        args = ChainArgs(K=self.K, Tn=self.T, W=W, B=self.grid.nbins,
                         samplerun=int(self.prm.samplerun), wpb=plan.wpb,
                         staged=int(plan.staged))
        out = (ctypes.c_int * 6)()
        err = fn(int(dtype == torch.float64), ctypes.byref(args), out)
        cuda_build.check(err, "chain_wl occupancy")
        return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                         "smem_bytes", "walkers_per_block", "blocks"), out))

    def plain(self, codes, wl_active, cf, ci, wgt, hist, uh, basew, e,
              inc, hasm, ua, uz, baseh=None, cycle=0):
        prm, grid = self.prm, self.grid
        K, T, P = self.K, self.T, self.P
        W = cf.shape[1]
        dtype, dev = cf.dtype, cf.device
        binw, mub, binfrac = self._bins(dev, dtype)
        beta = prm.beta
        codes = codes.tolist()

        mu, e0, e1 = cf[CF_MU].clone(), cf[CF_E0].clone(), cf[CF_E1].clone()
        er0, er1 = cf[CF_E0E].clone(), cf[CF_E1E].clone()
        f, sumh = cf[CF_F].clone(), cf[CF_SUMHIST].clone()
        min_dmu, max_dmu = cf[CF_MIN_DMU].clone(), cf[CF_MAX_DMU].clone()
        cmu, sw_c, minu_c = cf[CF_CMU], cf[CF_SWC], cf[CF_MINUC]
        ls = ci[CI_LS].clone()
        invt_on = ci[CI_INVT] != 0
        in_window = ci[CI_INWIN] != 0
        occ_ok = ci[CI_OCCOK] != 0
        sw_ok = ci[CI_SWOK] != 0
        w_now, h_now, u_now = wgt, hist, uh

        def eta_of(mu_v):
            return eta_lookup(
                grid, w_now + basew, mu_v, binw, mub, ci[CI_START],
                ci[CI_END], cf[CF_MU_MIN], cf[CF_MU_MAX], in_window,
                prm.eta_interp, prm.dd_seeding)

        e = e.reshape(2, K, P, W)
        inc = inc.reshape(K, P, W)
        iota_p = torch.arange(P, device=dev)[:, None]
        joh = torch.zeros((K, P, W), dtype=dtype, device=dev)
        cnt = torch.zeros((CN_FIXED + K, W), dtype=torch.int32, device=dev)
        for k in range(K):
            has_k = hasm[k] > 0.5
            j = torch.zeros((W,), dtype=torch.int64, device=dev)
            for t in range(1, P):
                i = k * T + (t - 1)
                tt = codes[i] == TRANS
                swt = codes[i] == SWITCH
                sw_try = (tt or swt) if prm.mc_always_switch else swt
                if tt:
                    # dE(current point -> t) from the point table: the
                    # current point's values as sum_p onehot[p] * v[p]
                    oh = (iota_p == j[None, :]).to(dtype)      # [P,W]
                    ec0 = ec1 = ic = 0.0
                    for p in range(P):
                        ec0 = ec0 + oh[p] * e[0, k, p]
                        ec1 = ec1 + oh[p] * e[1, k, p]
                        ic = ic + oh[p] * inc[k, p]
                    dE0 = e[0, k, t] - ec0
                    dE1 = e[1, k, t] - ec1
                    gate = (ic > 0.5) & (inc[k, t] > 0.5)
                    dmu = (dE0 - dE1) * beta
                    mu_new = mu + dmu
                    eta_old = eta_of(mu)
                    eta_new = eta_of(mu_new)
                    dE_ls = torch.where(ls == 0, dE0, dE1)
                    diffkT = beta * dE_ls + eta_new - eta_old
                    if prm.minu:
                        # #ifdef MINU fold-in (mc_moves.F90:1119-1140):
                        # the move carries the walker to the lattice of
                        # the lower trial enthalpy
                        en0 = e0 + er0 + dE0
                        en1 = e1 + er1 + dE1
                        g10 = beta * (en1 - en0) + minu_c
                        lsn = torch.where(g10 < 0.0, 1, 0).to(ls.dtype)
                        E_lsn = torch.where(lsn == 0, en0, en1)
                        E_cur = torch.where(ls == 0, e0 + er0, e1 + er1)
                        sgn_c = torch.where(ls == 0, sw_c, -sw_c)
                        alt = (beta * (E_lsn - E_cur) + eta_new - eta_old
                               + sgn_c)
                        diffkT = torch.where(lsn != ls, alt, diffkT)
                    # finite-state guard: never accept non-finite deltas
                    ok = torch.isfinite(diffkT) & torch.isfinite(mu_new)
                    # a trial exists where the scheduled cell holds a
                    # molecule; the cell wall only vetoes acceptance
                    enabled = has_k
                    accept = enabled & gate & ok & (
                        ua[i] < torch.exp(-diffkT))
                    if prm.minu:
                        ls = torch.where(accept, lsn, ls)
                    # compensated accumulation (CF_E0E/CF_E1E note)
                    s0, r0 = _two_sum(e0, dE0)
                    h0, l0 = _two_sum(s0, er0 + r0)
                    e0 = torch.where(accept, h0, e0)
                    er0 = torch.where(accept, l0, er0)
                    s1, r1 = _two_sum(e1, dE1)
                    h1, l1 = _two_sum(s1, er1 + r1)
                    e1 = torch.where(accept, h1, e1)
                    er1 = torch.where(accept, l1, er1)
                    mu = torch.where(accept, mu_new, mu)
                    j = torch.where(accept, t, j)
                    en_i = enabled.to(torch.int32)
                    cnt[CN_EN] += en_i
                    cnt[CN_FIXED + k] += en_i
                    cnt[CN_ACC] += accept.to(torch.int32)
                    admu = torch.abs(dmu)
                    min_dmu = torch.minimum(
                        min_dmu, torch.where(accept, admu, float("inf")))
                    max_dmu = torch.maximum(
                        max_dmu, torch.where(accept, admu, 0.0))
                    # per-move WL update at mu after the trial; the
                    # occ-overflow gate keeps corrupt walkers out of the
                    # SHARED arrays
                    if wl_active:
                        healthy = (torch.isfinite(e0) & torch.isfinite(e1)
                                   & occ_ok)
                        sched = f_schedule(prm, grid, binfrac, dtype, sumh,
                                           baseh, invt_on, cycle)
                        w_now, h_now, u_now, f_n, sumh_n = wl_move_update(
                            grid, prm.samplerun, self.log_norm, binw,
                            w_now, h_now, u_now, eta_of, mu, f, enabled,
                            healthy, sched)
                        if sched is not None:
                            f, sumh = f_n, sumh_n
                if self.do_switch and sw_try:
                    de10 = beta * ((e1 - e0) + (er1 - er0))
                    dsw = torch.where(ls == 0, de10 + sw_c, -(de10 + sw_c))
                    sw_acc = sw_ok & torch.isfinite(dsw) & (
                        uz[i] < torch.exp(-dsw))
                    ls = torch.where(sw_acc, 1 - ls, ls)
                    # mu from scratch on accept (1578-1588)
                    mu = torch.where(sw_acc, cmu - de10, mu)
                    cnt[CN_SWEN] += sw_ok.to(torch.int32)
                    cnt[CN_SWACC] += sw_acc.to(torch.int32)
            joh[k] = (iota_p == j[None, :]).to(dtype)
        for row, val in ((CF_MU, mu), (CF_E0, e0), (CF_E1, e1),
                         (CF_E0E, er0), (CF_E1E, er1), (CF_F, f),
                         (CF_SUMHIST, sumh),
                         (CF_MIN_DMU, min_dmu), (CF_MAX_DMU, max_dmu)):
            cf[row] = val
        ci[CI_LS] = ls
        wgt.copy_(w_now)
        hist.copy_(h_now)
        if prm.samplerun:
            uh.copy_(u_now)
        return joh.reshape(K * P, W), cnt

    def __call__(self, codes, wl_active, cf, ci, wgt, hist, uh, basew, e,
                 inc, hasm, ua, uz, cnt=None, baseh=None, cycle=0):
        """Run the K x T chain for all walkers; returns (joh, cnt).
        ``cnt`` may be given as a preallocated output; ``baseh`` [B, W]
        the master histogram view (the Swetnam schedule), ``cycle`` the
        cycle number (the 1/t schedule)."""
        if not cf.is_cuda:
            joh, cnt_p = self.plain(codes, wl_active, cf, ci, wgt, hist, uh,
                                    basew, e, inc, hasm, ua, uz, baseh,
                                    cycle)
            return joh, (cnt_p if cnt is None else cnt.copy_(cnt_p))
        args, joh, cnt = self.launch_args(codes, wl_active, cf, ci, wgt,
                                          hist, uh, basew, e, inc, hasm, ua,
                                          uz, cnt, baseh, cycle)
        stream = torch.cuda.current_stream(cf.device).cuda_stream
        err = _entry(cf.dtype)(ctypes.byref(args), stream)
        cuda_build.check(err, "chain_wl")
        self.launches += 1
        return joh, cnt

    def launch_args(self, codes, wl_active, cf, ci, wgt, hist, uh, basew, e,
                    inc, hasm, ua, uz, cnt=None, baseh=None, cycle=0):
        """(args, joh, cnt) of one launch on CUDA tensors: the checked
        ChainArgs with the launch plan, and the outputs its pointers
        reference (``cnt`` allocated unless given)."""
        prm, grid = self.prm, self.grid
        K, T, P = self.K, self.T, self.P
        B, W = wgt.shape
        dtype, dev = cf.dtype, cf.device
        joh = torch.empty((K * P, W), dtype=dtype, device=dev)
        if cnt is None:
            cnt = torch.empty((CN_FIXED + K, W), dtype=torch.int32,
                              device=dev)
        floats = {"cf": (cf, (CF_ROWS, W)), "wgt": (wgt, (B, W)),
                  "hist": (hist, (B, W)), "basew": (basew, (B, W)),
                  "e": (e, (2 * K * P, W)), "inc": (inc, (K * P, W)),
                  "hasm": (hasm, (K, W)), "ua": (ua, (K * T, W)),
                  "uz": (uz, (K * T, W)), "joh": (joh, (K * P, W))}
        if prm.samplerun:
            floats["uh"] = (uh, (B, W))
        sched = schedule_kind(prm)
        if sched == SCHED_SWETNAM:
            floats["baseh"] = (baseh, (B, W))
        ints = {"codes": (codes, (K * T,)), "ci": (ci, (CI_ROWS, W)),
                "cnt": (cnt, (CN_FIXED + K, W))}
        for want, group in ((dtype, floats), (torch.int32, ints)):
            for name, (t, shape) in group.items():
                if not (t.shape == shape and t.dtype == want
                        and t.device == dev and t.is_contiguous()):
                    raise ValueError(
                        f"ChainWLKernel: {name} must be a contiguous "
                        f"{want} tensor of shape {shape} on {dev}, got "
                        f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if dtype not in (torch.float32, torch.float64) \
                or B != grid.nbins:
            raise ValueError(f"ChainWLKernel: {dtype}, {B} bins")
        binw, mub, binfrac = self._bins(dev, dtype)
        P_ = lambda t: t.data_ptr()                         # noqa: E731
        args = ChainArgs(
            codes=P_(codes), cf=P_(cf), ci=P_(ci), wgt=P_(wgt),
            hist=P_(hist), uh=P_(uh) if prm.samplerun else None,
            basew=P_(basew), binw=P_(binw), mub=P_(mub), e=P_(e),
            inc=P_(inc), hasm=P_(hasm), ua=P_(ua), uz=P_(uz), joh=P_(joh),
            cnt=P_(cnt), K=K, Tn=T, W=W, B=B,
            wl_active=int(bool(wl_active)), samplerun=int(prm.samplerun),
            eta_interp=int(prm.eta_interp), dd_seeding=int(prm.dd_seeding),
            do_switch=int(self.do_switch),
            always_switch=int(prm.mc_always_switch),
            beta=prm.beta, av_bw=grid.av_binwidth, log_norm=self.log_norm,
            cpos=1.0 - grid.r_pos, cneg=1.0 - grid.r_neg,
            a_pos=grid.a_pos, a_neg=grid.a_neg,
            lnr_pos=float(np.log(grid.r_pos)),
            lnr_neg=float(np.log(grid.r_neg)),
            minu=int(prm.minu), f_sched=sched, alpha=prm.wl_alpha,
            wl_factor=prm.wl_factor,
            invt_f=(invt_cap(B, cycle, prm.nwater, dtype)
                    if sched == SCHED_INVT else 0.0),
            binfrac=P_(binfrac),
            baseh=P_(baseh) if sched == SCHED_SWETNAM else None,
        )
        plan = self.plan(dtype, W)
        args.wpb, args.staged = plan.wpb, int(plan.staged)
        return args, joh, cnt
