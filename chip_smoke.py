#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of the repository:

    python3 chip_smoke.py

Phases (each exits non-zero on failure):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every hand-written kernel of csrc/ (one nvcc per
   source, all started together) and print the build seconds;
3. FullEnergyKernel against its plain PyTorch version on both N=216
   lattices at W=4096 with jittered positions (float64: rtol 1e-12;
   float32: the tolerances below), and likewise on the N=48 cells of
   the (1,2,6) stacking pair, three folded image shifts;
4. FusedCycle's table kernel against its plain version over one cycle
   with the same random draws (float64 at W=256: identical integer
   outcomes and continuous state within 1e-10; float32 at W=4096: at
   most 1% of walkers differ in any integer outcome); 4b. likewise its
   dense-candidate kernel at N=216 (nbr_table='off', one shift) and at
   N=48 (three shifts); 4c. likewise its multi-trial kernel (float64 at
   dense_trials=8; float32 at 2, 4 and 8, path C's trial counts); each
   with its time and bound, registers and walkers per block;
   4d. the kernels with 'dd' mu windows, on states reached by a few
   cycles of the engine, one before the equilibration boundary (walkers
   before their windows, switches shut) and one after it (walkers beyond
   their walls): the table kernel of the fused cycle on
   runs/n216_sample_dd (8 windows, float64 at W=16, float32 at W=4096),
   then a cycle in which half the walkers sit just beyond their window's
   upper wall, whose sample-run increments must stay out of uhist, and
   the per-window delta merge run twice (bitwise equal); the mover-points,
   chain + WL and mover-apply kernels of the multi-trial sub-step on
   runs/n8064_wl (16 windows, T=8, float64 at W=16, float32 at W=128),
   and the merge again; the gates of phases 4 and 8; the float32 checks
   of the table kernel here and in phase 4 print where their largest
   state error on walkers with equal integer outcomes comes from
   (fused_err_trace: the walker, the field, and the walker alone step
   by step, its accept sequence against the plain version's with the
   plain version's Metropolis margin where they differ);
   4e. kernel 1's other instantiations against their plain versions over
   one cycle with the same draws (float64 at W=256: identical integers,
   state within 1e-10; float32 at W=4096: at most 1% of walkers
   differing), each timed beside phase 4's table kernel and run
   VARIANT_CYCLES cycles through its engine: one lattice
   (fused_cycle_1l, the N=216 Ih cell; fused_cycle_dense_1l at N=48,
   the single-box semantics), and the extended settings
   (fused_cycle_ext: the N=216 sample run under MINU + leshift, and
   under NVT; runs/n216_wl's WL parameters under Swetnam and under 1/t
   with half the walkers' invt_active set; fused_cycle_dense_ext at
   N=48 under MINU; fused_cycle_multi_ext at T=8 under MINU +
   Swetnam; SCHED_CUTS lists what the schedules' checks cut);
5. the N=216 main path: the N=216 Ih/Ic stacking pair, W=4096,
   float32, a sample run from runs/n216_sample/eta_weights.dat with
   delta-syncs every 5 and chain resyncs every 10 cycles; 20 warm-up and
   20 timed cycles, launch counts of both kernels, a torch.profiler
   trace of 10 more cycles (device time per kernel, the device's busy
   share), an energy audit of 64 walkers and a finite Delta G from the
   merged unbiased histogram;
   5b. path B: the same sample run with nbr_table='off' (exact
   reference move semantics: the dense-candidate kernel), 20 warm-up
   and 20 timed cycles, a trace of 5 more, the audit and Delta G;
   5c. path C: the N=216 Wang-Landau run of the JAX package's
   scripts/bench_dense_multitrial.py at dense_trials = 1, 2, 4 and 8,
   20 timed cycles each (trials/s against T), the audit and the merged
   histogram at T=8;
   5d. runs/n216_sample_dd through the port's run_input_file (4096
   walkers over 8 windows, float32, its committed weights, a sample run;
   DD216_CUTS lists the interval cuts, eq_mc_cycles stays 1000) in
   build/chip_smoke_dd216: DD216_CYCLES, a first call and one resumed
   from the checkpoint; moves/s, walkers in their window per window at the
   boundary and at the end (none may be empty), the stitched Delta G
   and unbiased_histogram.dat (finite), the per-window dumps
   uhist_windows_*.dat;
   5e. the volume wall's inward ratchet: the N=216 sample run (W=4096,
   float32) with mc_vol_wall=0.04, every fourth walker's boxes scaled
   to 1.1 Vref at fixed fractional coordinates, full_energy against its
   plain version on them, an audit of 64 walkers, then 50 cycles
   checked one by one: no walker inside the wall leaves it, no outside
   walker's sum |ln(V/Vref)| rises (unless it comes inside), and their
   mean falls;
   5f. the single-box N=216 NPT run: runs/n216_wl/ice.input with one
   lattice (stack (3,3,6): the Ih cell), 4096 walkers, float32, through
   run_input_file in build/chip_smoke_single216 (SINGLE216_CUTS lists
   the interval cuts): 20 warm-up cycles, 10 resumed from the checkpoint,
   then 20 timed cycles of the resumed engine: moves/s, the launches of
   fused_cycle_1l and full_energy, an audit of 64 walkers, every volume
   within a factor 2 of the crystal's, no switch attempted;
   5g. a 1/t Wang-Landau generation: runs/n216_wl/ice.input with its
   run.py overrides and wl_useinvt (INVT_CUTS: the flatness check at
   cycle 10 switches every walker to 1/t) through run_input_file in
   build/chip_smoke_invt216, 20 cycles and 10 resumed: invt_active on
   every walker after the resume, f capped by B / (cycle N), the 1/t
   dumps (wlf.dat, eta_weights.dat_<cycle>, histogram.dat_<cycle>);
6. the three kernels of the large-N cell engine (mover energies, chain +
   WL, mover apply) against their plain versions on one sub-step of the
   N=8064 stacking pair after a cycle of sampling (float64 at W=64:
   every integer output identical, energies and slabs within 1e-10;
   float32 at W=512: the tolerances below, the chain's rows and WL
   slabs held on the walkers whose integer outcomes agree), the chain
   also in a sample run (samplerun=True, wl_factor=0: the unbiased
   histogram's branch of the WL update) in both types, with their
   times, registers, spills and blocks per SM;
7. the N=8064 main path: the cell engine at W=512, float32, Wang-Landau
   live, one warm-up and 3 timed cycles in which a rebin, scheduled
   volume moves, a delta-sync and a chain resync fall; seconds per
   cycle, trials/s, launch counts, slab overflow (must be 0), an energy
   audit of 64 walkers, a finite merged histogram, and a torch.profiler
   trace of one more cycle (device time per kernel, the idle share);
   6b. the scatter path (cell_pallas 'on', what 'auto' picks where
   same-colour stencils overlap) on the N=6048 (12,7,18) pair after a
   cycle of sampling, float64 at W=64: the mover kernel's delta output
   against its plain version (energies, own moments and every delta
   within 1e-10), and a whole sub-step through the kernels against the
   same through the plain versions (every integer output identical,
   slabs, chain rows and WL slabs within 1e-10), run twice through the
   kernels with bitwise-equal results;
   6c. 'on' against 'apply' on the N=8064 grid (disjoint stencils, where
   both run), one cycle each from one seed, float64 at W=64: integer
   state identical, continuous state within 1e-10;
   6c (rules). the chain + WL kernel under MINU, Swetnam and 1/t (half
   the walkers) on one T=8 sub-step of the N=8064 pair after a cycle of
   sampling (float64 at W=64, float32 at W=128; phase 8's gates), the
   MINU chain's time and bound;
   7b. the N=24192 flagship, stacking_switch_pair(24,14,18) on the grid
   the front end gives it (coarse (8,8,4) x 2^3, 75-cell stencils that
   overlap, K=32, 768 sub-steps per cycle), W=128, float32, the modes
   left to 'auto' (they must resolve to 'on' and the chain kernel): a
   warm-up cycle, the checks of 6b in float32 on its state (at most 1%
   of walkers with differing integer outcomes, the tolerances below),
   the delta kernel's and the K=32 chain's times and bounds, then 2
   timed cycles holding a
   rebin, volume moves, a delta-sync and a chain resync (FLAG_CUTS lists
   the cuts); seconds per cycle, trials/s, launches, slab overflow (must
   be 0), a torch.profiler trace of one more cycle (device time per
   kernel and of the scatter, the idle share), then an energy audit of
   64 walkers and a finite merged histogram;
   7d. the N=8064 single box: the cell engine at one lattice ((14,8,18)
   Ih cell, W=512, float32, T=1: the mover kernels at L = 1 with the XLA
   chain), both kernels against their plain versions on one sub-step,
   one timed cycle (trials/s, launches), slab overflow 0, an audit of 64
   walkers;
8. the multi-trial sub-step (cell_trials=8): the mover-points kernel and
   the chain + WL kernel at T=8 against their plain versions on one
   sub-step of the N=8064 pair after a cycle of sampling (float64 at
   W=16: every integer output identical, energies and own moments
   within 1e-10; float32 at W=128: the tolerances below; the points
   kernel launched twice with bitwise-equal results), with their
   times and bounds, the points kernel also at 3 and 5 points (T = 2
   and 4) on the first points of that proposal, and the mover-apply
   kernel at this shape (phase
   9's) with the chain's accepts (float64 also with every mover
   accepted and every mover rejected: moment rows within 1e-10, every
   other slab entry bitwise equal);
   8b. the displacement wall (cell_trans_wall 0.4 Bohr) on the N=8064
   pair at T=1 and T=8, float64 at W=16 and float32 at W=128, after a
   cycle of sampling under it: the share of a proposal's trial points
   it rejects (above 0), the largest displacement from the reference
   sites (within the wall), one sub-step's kernels against their plain
   versions with the gates of phases 6 and 8;
   8c. cell_pallas='off' (the unfused sub-step with the micro-batched
   chain) against 'apply' in a sample run on the N=8064 pair, one
   cycle each from one seed, float64 at W=64: integer state identical,
   continuous state within 1e-10, the WL slabs within 1e-12 relative;
   8d. the N=8064 pair under MINU at T=8, W=128, float32: one timed
   cycle through the points, apply and chain kernels (launches,
   trials/s), slab overflow 0, an audit of 64 walkers;
9. the front-end path: runs/n8064_wl/ice.input with its run.py
   overrides (128 walkers, float32, cell_trials=8, 'dd' over 16 windows
   with overlap 2; FRONTEND_CUTS lists every interval cut)
   through the port's run_input_file in build/chip_smoke_frontend: 2
   cycles and a resumed one that hold volume moves, delta-syncs, monitor_stats with
   eq_adjust_mc and its per-window rows, the equilibration boundary,
   check_flatness, checkpoints and rebins (FRONTEND_CYCLES); seconds
   per cycle,
   trials/s, launches, slab overflow (must be 0), an energy audit of 64
   walkers and a torch.profiler trace of one more cycle;
   9b. round 5's pipeline through run_input_file with jit_chunk=20, as
   its run.py files call it: runs/n8064_wl2 (128 walkers, float32,
   cell_trials=8, mc_vol_wall=0.2, 'dd' over 16 windows; ROUND5_CUTS
   lists the interval cuts) in build/chip_smoke_wl2 for a cycle and a
   resumed one, then its two checkpoint slots alone copied to
   build/chip_smoke_sample2 for runs/n8064_sample2 (a sample run at one
   trial per mover behind the same wall) through the gen -> sample
   restart, a cycle; seconds per cycle, trials/s, launches, slab
   overflow (must be 0), walkers per window, every walker's V/Vref
   (within the wall), an energy audit of 64 walkers after each stage,
   a finite stitched unbiased histogram and the per-window dumps;
10. path A: the reference's own N=48 example, runs/n216_sample/ice.input
   with --walkers 4096 and the (1,2,6) stacking pair (DENSE48_CUTS
   lists every interval cut), through run_input_file in
   build/chip_smoke_dense48: 40 cycles, then 8 resumed from the
   checkpoint; ms per cycle, moves/s, launches, an energy audit and the
   merged histogram;
11. (after phase 10) the ranks, gloo groups of 2 and 4 spawned on the
   one card (NCCL refuses two ranks on one card), each sharded run held
   against the serial run of the same settings in this process (f64:
   identical integers, the rest within 1e-10), and every kernel a
   phase's ranks launch held against its plain version on a rank's own
   inputs (f64: no differing walker or entry, errors within 1e-10; a
   launched kernel left unchecked fails the phase): 12a the N=216 sample
   run sharded over walkers (the fused cycle and the full energy on each
   rank's walkers; f32 moves/s at 1 and 2 ranks), 12b the N=8064 cell
   engine likewise (mover energies, chain + WL and apply on one sub-step
   of each rank's walkers), 12c runs/n216_sample_dd through
   run_input_file on 2 ranks (rank 0's files against the 1-rank run's,
   then resumed on 1 rank; its engine's kernels on each rank's final
   state), 13a-d the spatial engine (D=1 in process, D=2 at T=1 and 8,
   space 2 x walkers 2; the mover kernels and the apply on a rank's
   local slab, the chain on the tables assembled across the space
   ranks; ms per sub-step, the halo refresh's bytes and ms); RANK_* and
   SPATIAL_* list the sizes;
11b. phase 14 (after the ranks), the run's own tools on the card: 14b
   runs/n216_sample_torch cut to WATCH_RUN (256 walkers, float64, 200
   cycles, jit_chunk WATCH_CHUNK) under tools/watchdog.py with the
   card's probe gate, its first launch SIGSTOPped after its first
   checkpoint: one kill, one relaunch after "backend probe ok", resumed
   from the checkpoint to its end, the heartbeat at the final cycle,
   and the final state that of the same input run uninterrupted
   (identical integers, the rest within 1e-10), then the kernels of
   both runs against their plain versions on that final state; 14c
   tools/threebody_filter.py at N=216, W=16, float64, 4 cycles on the
   card, its kernels against their plain versions on its final state;
   then side by side in fresh processes: 14a liveness.probe_device
   ("ok"), 14c's --device cpu call (finite; ideal-cell values
   identical; the rest within 1e-9 relative, which holds as both walks
   meet no near-collinear triplet: they draw different streams), and
   14d the analysis tools (deltag_error on runs/n216_sample_torch,
   deltag_from_weights on runs/n216_wl_r2, compare_dd_mw) where JAX
   cannot be imported, the Done run's Delta G reproduced (+0.8506 +-
   0.0337 J/mol);
12. one JSON line with every kernel's launches (summed over the main
   paths of phases 5, 5b, 5c, 5d, 5e, 5f, 5g, 7, 7b, 7d, 8d, 9, 9b, 10,
   the ranks' runs of 12-13 and 14b-c, and 4e's engine runs of the dense
   and multi-trial instantiations; 7c runs no kernel), error against its plain
   version, times and bound; the multi-trial kernel has a line for each
   T of path C, kernel 1's new instantiations one each, the
   mover-apply kernel one for phase 7's shape ("mover_apply") and one
   for phase 9's, the chain kernel one for each of phases 7
   ("chain_wl"), 7b and 9 and one for 8d's MINU chain;
13. as the last line, {"ok": true, "device": {...}}.

Each phase prints its seconds ("[time]"), and the run its total.

It imports nothing of JAX.  Without CUDA, or without the repository
around it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
W_MAIN = 4096           # walkers of the main path and the f32 checks
W_FP64 = 256            # walkers of the float64 FusedCycle check

# f32 tolerances of FullEnergyKernel against its plain version: both sum
# the same terms in another order, so the energy (|E| ~ 4 Hartree, a
# sum of ~10^3 terms of ~1e-2) agrees to a few float32 ulps of its
# terms, and each moment (O(1), a sum of ~4-16 terms) likewise
F32_E_RTOL = 2e-5
F32_MOM_ATOL = 2e-5
# f32 FusedCycle: walkers whose accept/reject sequence differs from the
# plain version's (a decision within round-off of its threshold)
F32_MAX_DIFF_FRAC = 0.01
# f32 energy audit: |stored - recomputed| after 25 cycles, the last 5
# of them since a chain resync (accumulated f32 round-off of ~10^3
# accepted energy deltas of a -4 Hartree total)
AUDIT_MAX_DRIFT = 1e-4          # Hartree
# the N=48 example (three folded shifts), 5 cycles after a resync: the
# dense step of the JAX package counts a triplet (i, j, i') twice when
# molecule j sees two images of the moved molecule i within the cutoff
# (a box narrower than twice the cutoff), so its tracked energies drift
# from a recomputation by 2-6e-4 Hartree per walker in 2-6 cycles in
# float64, in the JAX engine and in the port alike (ROADMAP.md, queue 3)
AUDIT_DENSE48_MAX_DRIFT = 5e-3  # Hartree

# ---- the large-N cell engine (N=8064)
W_CELL = 512            # walkers of the N=8064 main path and f32 checks
W_CELL_FP64 = 64        # walkers of the float64 kernel checks
CELL_STACK = (14, 8, 18)        # N = 4*14*8*18 = 8064
# f32 mover energies: a local energy (|e| ~ 0.1 Hartree) is a sum of
# ~20 pair terms and ~10^2 three-body terms of <= 1e-2, summed in
# another order than the plain version's
F32_MOVER_E_ATOL = 2e-6         # Hartree
# f32 moment rows (O(1), sums of ~4-16 leg terms), own and neighbours'
F32_MOVER_MOM_ATOL = 2e-5
# f32 chain + WL on the walkers whose integer outcomes agree with the
# plain version's: chain rows (mu, both energies with their residuals,
# the dmu extrema) and WL slabs, each |kernel - plain| / max(1, |plain|).
# Both sides do the same arithmetic in the same order without FMA, so
# only a library function (exp, log) rounding differently can separate
# them: a few float32 ulps
F32_CHAIN_RTOL = 1e-6
# ---- the multi-trial sub-step (cell_trials = 8, the Wang-Landau
# production runs runs/n8064_wl and runs/n8064_wl2)
MT_TRIALS = 8
# the points kernel's point counts checked beside T + 1 = 9 (cell_trials
# 2 and 4)
MT_POINTS = (3, 5)
# the dense multi-trial branch (dense_trials = 8, path C at 2, 4, 8)
MULTI_T = 8
MULTI_TS = (2, 4, MULTI_T)
# the kernels line's name of the apply kernel at the multi-trial
# front-end path's shape (128 walkers, T=8; phase 7's is "mover_apply")
APPLY_MT = "mover_apply[W=128,T=8]"
W_MT = 128              # walkers of runs/n8064_wl, the f32 checks
# the kernels line's names of the chain kernel at the flagship's shape
# (K=32, 128 walkers) and at the front-end path's (T=8, 128 walkers;
# phase 7's K=8, 512 walkers is "chain_wl")
CHAIN_FLAG = "chain_wl_flagship"
CHAIN_T8 = "chain_wl_t8"
W_MT_FP64 = 16          # walkers of the float64 checks
# f32 energy audit of the cell engine, one cycle after a chain resync:
# the tracked and the recomputed total (-159 Hartree, ulp 1.5e-5) each
# carry a few ulps of f32 summation error, and ~4*10^3 accepted moves
# per walker each add an energy change good to ~1e-7 (compensated, so
# no quantisation against the total)
AUDIT_CELL_MAX_DRIFT = 2e-3     # Hartree
# ---- the scatter path (cell_pallas='on'): grids whose same-colour
# stencils overlap
SCATTER_STACK = (12, 7, 18)     # N = 6048, the float64 check's grid
FLAG_STACK = (24, 14, 18)       # N = 24192, the flagship: coarse (8,8,4)
W_FLAG = 128                    # walkers of the flagship path
# the flagship's cuts of scripts/bench_largen.py's intervals (5 timed
# cycles, list_update_int 5, mpi_sync_int 10, latt_sync_int 10^4), so
# that a rebin and a delta-sync (cycle 2) and a chain resync (cycle 3)
# fall in its 2 timed cycles (the schedule of seed 2014 puts 1 and 4
# volume moves there); the profiled cycle 4 (a rebin, a delta-sync, one
# volume move) precedes the audit, one cycle after the resync
FLAG_CUTS = dict(list_update_int=2, mpi_sync_int=2, latt_sync_int=3)
FLAG_TIMED = 2
# f32 energy audit of the flagship, one cycle after a chain resync: the
# N=8064 gate scaled by the total's f32 ulp (-477 Hartree: 3.1e-5)
AUDIT_FLAG_MAX_DRIFT = 4e-3     # Hartree

# H100 SXM peaks (NVIDIA data sheet): memory and float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# operation model of one minimum-image pair evaluation: displacement
# (3), fold (15 + 9 + 15), r^2 (5), cutoff test (1)
OPS_FOLD = 48
# one in-range leg: rsqrt, rij, denominator, pair term (9), leg weight
# (2), unit vector (3), ten moment and w^2 accumulations (21)
OPS_LEG = 39
# the wing term of a partner (quad + lin + per: 25) and its moved
# moments (20), per in-range leg of a translation
OPS_WING = 45
# a candidate slot's moment deltas new - old: two leg contributions (13
# each) and ten differences
OPS_DELTA = 36


def multi_name(T):
    """The kernels line's name of the multi-trial kernel at T trials per
    mover ("fused_cycle_multi" at MULTI_T, path C's main case)."""
    return ("fused_cycle_multi" if T == MULTI_T
            else f"fused_cycle_multi[T={T}]")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T_START = time.time()
_PHASE_T0 = [_T_START]


def phase_time(name: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.time()
    print(f"[time] {name}: {now - _PHASE_T0[0]:.1f} s", flush=True)
    _PHASE_T0[0] = now


def cuda_ms(fn, reps: int, run_ahead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events after one warm-up call.  ``run_ahead``: ~20 ms of other
    device work is queued first, so that the host has enqueued every
    call before the first one starts and the events see the calls back
    to back: the device time of a short kernel, free of the host's
    launch gaps."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        pad = torch.zeros(1 << 28, dtype=torch.float32, device=DEVICE)
    torch.cuda.synchronize()
    if run_ahead:
        for _ in range(30):
            pad.add_(1.0)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ----------------------------------------------------------------------
# set-up shared with tests/test_torch_kernels_cuda.py
# ----------------------------------------------------------------------

def sample_params(W, dtype, **over):
    """The N=216 sample run (runs/n216_sample: its ice.input and
    run.py overrides), at W walkers."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams

    kw = dict(
        nwater=216, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=1.1 * ANG_TO_BOHR, mc_dv_max=0.924 * ANG_TO_BOHR,
        nbins=101, mu_min=-700.0, mu_max=700.0, eta_interp=True,
        mc_always_switch=True,
        # the input reader's pre-namelist defaults (io.f90:171-172)
        mc_switch_prob=0.1, mc_vol_prob=1.0 / 768,
        samplerun=True, wl_factor=0.0, stack=(3, 3, 6), method="stack",
        n_walkers=W, dtype=dtype, seed=2014,
    )
    kw.update(over)
    return RunParams(**kw)


def stacking_cells(prm):
    """(r0, H0) of ``prm.stack`` as the front end builds them: the Ih/Ic
    stacking pair, or with one lattice the Ih cell alone (app.py)."""
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_cell,
        stacking_switch_pair,
    )

    nx, ny, m = prm.stack
    if prm.num_lattices == 2:
        return stacking_switch_pair(nx, ny, m)
    r, H = stacking_cell("AB" * ((m + 1) // 2), nx, ny)
    return r[None], H[None]


def make_engine(prm, stream=None, paper_pair=False, weights="n216_sample",
                comm=None):
    """(engine, state): the stacking pair of ``prm.stack`` (one lattice:
    its Ih cell) from the committed weights
    (runs/<weights>/eta_weights.dat; flat where ``weights`` is None or
    with one lattice), or with ``paper_pair`` the paper's N=216 pair
    (models/lattices.switch_pair_216) from flat weights; in 'dd' over
    ``prm.n_windows`` windows.  With ``comm`` the engine shards the
    walkers over its ranks (the state returned is the whole one)."""
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine
    from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
    from mc_water_ls_mw_tpu_torch.models.lattices import switch_pair_216
    from mc_water_ls_mw_tpu_torch.models.sw import MW

    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    if paper_pair:
        r0, H0 = switch_pair_216()
        w0 = None
    else:
        r0, H0 = stacking_cells(prm)
        w0 = None
        if weights is not None and prm.num_lattices == 2:
            w0 = np.loadtxt(os.path.join(ROOT, "runs", weights,
                                         "eta_weights.dat"),
                            skiprows=1)[:, 1]
            if len(w0) != grid.nbins:
                fail(f"eta_weights.dat has {len(w0)} bins, grid "
                     f"{grid.nbins}")
    s, aux = init_state(prm, MW, r0, H0, grid, weight0=w0,
                        n_windows=n_windows(prm), device=DEVICE)
    return Engine(prm, MW, grid, aux, device=DEVICE, stream=stream,
                  comm=comm), s


# the dense-candidate cases of kernel 1 (fused_cycle_dense): the
# reference's own example size, N=48 (runs/n216_sample/ice.input: 101
# bins over mu in [-400, 400]; cells of the (1,2,6) stacking pair, N < 96
# in a box that is not MIC-unique: three folded shifts), and the N=216
# sample run with exact reference move semantics (nbr_table='off': one
# shift)
DENSE_CASES = {
    "n48": dict(nwater=48, stack=(1, 2, 6), mu_min=-400.0, mu_max=400.0),
    "n216": dict(nbr_table="off"),
}


def dense_params(W, dtype, case, **over):
    return sample_params(W, dtype, **{**DENSE_CASES[case], **over})


def multi_params(W, dtype, T, **over):
    """The N=216 Wang-Landau run at dense_trials=T of the JAX package's
    scripts/bench_dense_multitrial.py (201 bins over mu in [-1800, 1800],
    samplerun off, mc_switch_prob 0.1, delta-sync every 250 cycles,
    eq_mc_cycles 1) with the rest of its N=216 parameters
    (__graft_entry__._setup: the paper's pair, 200 K, 1 atm, 1.1 A
    steps, mc_vol_prob 1/768, 'mw'), at W walkers."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams

    kw = dict(
        nwater=216, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=1.1 * ANG_TO_BOHR, mc_dv_max=0.924 * ANG_TO_BOHR,
        nbins=201, mu_min=-1800.0, mu_max=1800.0,
        mc_vol_prob=1.0 / 768, mc_switch_prob=0.1,
        samplerun=False, eq_mc_cycles=1, list_update_int=10,
        mpi_sync_int=250, parallel_strategy="mw", window_overlap=1,
        dense_trials=T, n_walkers=W, dtype=dtype, seed=2014,
    )
    kw.update(over)
    return RunParams(**kw)


def kernel_draws(eng, s, seed):
    """One cycle's draws of the engine's branch from a stream of its own
    (codes, molecule schedule or None, uniforms)."""
    from mc_water_ls_mw_tpu_torch.mcmc.engine import PhiloxStream

    _, _, N, W = s.r.shape
    return PhiloxStream(seed, DEVICE).cycle_draws(
        s.cycle + 1, eng.probs, N, W, s.r.dtype, trials=eng.dT,
        shared_mol=not eng.dense)


def jittered_cells(W, dtype, seed=0, stack=(3, 3, 6)):
    """Both lattices of a stacking pair as [3,N,W] positions with 0.05
    Bohr jitter, and their [3,3,W] cells."""
    import torch

    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )

    r0, H0 = stacking_switch_pair(*stack)
    N = r0.shape[1]
    rng = np.random.default_rng(seed)
    out = []
    for l in range(2):
        r3 = r0[l].T[:, :, None] + rng.normal(0, 0.05, (3, N, W))
        H = np.broadcast_to(H0[l][:, :, None], (3, 3, W))
        out.append((torch.as_tensor(r3, dtype=dtype, device=DEVICE),
                    torch.as_tensor(np.ascontiguousarray(H), dtype=dtype,
                                    device=DEVICE)))
    return out


def full_energy_errors(kern, r3, H):
    """(relative error of E, max abs error of the moments, max |mom|)
    of the kernel against its plain version."""
    import torch

    e, mom = kern(r3, H)
    e_p, mom_p = kern.plain(r3, H)
    torch.cuda.synchronize()
    rel = float(torch.max(torch.abs(e - e_p) / torch.abs(e_p)))
    mom, mom_p = torch.stack(list(mom)), torch.stack(list(mom_p))
    return rel, float(torch.max(torch.abs(mom - mom_p))), \
        float(torch.max(torch.abs(mom_p)))


def fused_compare(eng, s, draws, timed=False):
    """One cycle of FusedCycle's kernel and of its plain version from
    clones of ``s`` with the same draws, the WL phase and the switch gate
    of the cycle after ``s``'s as the engine decides them.  Returns
    (kernel state, plain state, [W] bool of walkers whose integer
    outcomes differ), and with ``timed`` the plain cycle's milliseconds
    (host clock: the plain versions are host-paced)."""
    import torch

    codes, sched, cu = draws
    sk, sp = s.clone(), s.clone()
    for st in (sk, sp):
        st.cycle += 1
    wl_active = sk.cycle >= eng.prm.eq_mc_cycles
    switch_ok = eng._switch_ok(sk.cycle)
    eng.fused_cycle(sk, codes, sched, cu, wl_active, switch_ok)
    torch.cuda.synchronize()
    t0 = time.time()
    eng.fused_cycle.plain(sp, codes, sched, cu, wl_active, switch_ok)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    differ = (sk.ls != sp.ls)
    for name in ("att", "acc", "trans_per_mol"):
        differ |= (getattr(sk, name) != getattr(sp, name)).any(dim=0)
    return (sk, sp, differ, plain_ms) if timed else (sk, sp, differ)


FUSED_FIELDS = ("r", "moments", "energy", "mu", "weight", "hist", "uhist",
                "min_dmu", "max_dmu", "f", "sumhist")


def fused_max_err(sk, sp, mask, names=None):
    """Largest |kernel - plain| over the walkers in ``mask``, scaled by
    max(1, |plain|), over the continuous fields ``names`` (by default
    every one the kernel writes)."""
    import torch

    err = 0.0
    names = FUSED_FIELDS if names is None else names
    for name in names:
        a, b = getattr(sk, name)[..., mask], getattr(sp, name)[..., mask]
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            return float("inf")
        d = torch.abs(a - b)[fin] / torch.clamp(torch.abs(b[fin]), min=1.0)
        if d.numel():
            err = max(err, float(d.max()))
    return err


def walker_slice(s, w):
    """A one-walker copy of a dense-engine state: walker ``w`` of every
    per-walker tensor (the shared master rows as they are)."""
    import dataclasses

    import torch

    W = s.mu.shape[0]
    return type(s)(**{
        f.name: (v[..., w:w + 1].clone()
                 if torch.is_tensor(v) and v.dim() and v.shape[-1] == W
                 else v)
        for f in dataclasses.fields(s) for v in (getattr(s, f.name),)})


def fused_err_trace(tag, eng, s, draws, sk, sp, ok, names):
    """Where a fused-cycle comparison's largest relative state error on
    walkers with equal integer outcomes comes from: the walker, the
    field, the absolute error and the plain value there, whether the
    walker was before its window; then that walker alone, step by step
    (the kernel on prefixes of the cycle's schedule, every later step a
    no-op; the plain step loop once), its accept sequence and its
    energy and mu after every step in both.  Prints; gates nothing."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.engine import NOOP, TRANS, _take_lat

    best = (0.0, None, None)
    for name in names:
        a, b = getattr(sk, name), getattr(sp, name)
        d = torch.abs(a - b) / torch.clamp(torch.abs(b), min=1.0)
        d = torch.where(torch.isfinite(d), d, 0.0)
        d[..., ~ok] = 0.0
        if float(d.max()) > best[0]:
            idx = int(torch.argmax(d))
            best = (float(d.max()), name, idx)
    if best[1] is None:
        print(f"[{tag}] no state error on walkers with equal outcomes",
              flush=True)
        return
    rel, name, idx = best
    a, b = getattr(sk, name), getattr(sp, name)
    W = b.shape[-1]
    w = idx % W
    pos = np.unravel_index(idx, tuple(b.shape))
    print(f"[{tag}] largest relative error {rel:.3e}: walker {w}, field "
          f"{name} at {tuple(int(x) for x in pos)}: kernel "
          f"{float(a.reshape(-1)[idx]):.9e}, plain "
          f"{float(b.reshape(-1)[idx]):.9e}, |diff| "
          f"{abs(float(a.reshape(-1)[idx] - b.reshape(-1)[idx])):.3e}; "
          f"walker before its window {not bool(s.in_window[w])}, ls "
          f"{int(s.ls[w])}, mu {float(s.mu[w]):.6f} in "
          f"[{float(s.my_mu_min[w]):.3f}, {float(s.my_mu_max[w]):.3f}]",
          flush=True)

    codes, sched, cu = draws
    s1, cu1 = walker_slice(s, w), cu[..., w:w + 1].contiguous()
    s1.cycle += 1
    wl_active = s1.cycle >= eng.prm.eq_mc_cycles
    switch_ok = eng._switch_ok(s1.cycle)
    n = codes.shape[0]
    # the kernel, on the prefixes of the schedule
    k_acc, k_e, k_mu = [], [], []
    for t in range(n):
        st = s1.clone()
        cod = codes.clone()
        cod[t + 1:] = NOOP
        eng.fused_cycle(st, cod, sched, cu1, wl_active, switch_ok)
        k_acc.append(int(st.acc[0, 0]) + int(st.acc[2, 0]) * 1000)
        k_e.append(st.energy[:, 0].double())
        k_mu.append(float(st.mu[0]))
    # the plain step loop, recorded step by step (FusedCycle.plain's
    # loop), with each translation's margin u - exp(-diffkT) (accepted
    # where negative)
    st = s1.clone()
    p_acc, p_e, p_mu, margin = [], [], [], {}
    fc = eng.fused_cycle
    decide = eng._trans_decision

    def recorded(st_, dE, u_acc, extra_ok=None):
        beta = eng.prm.beta
        mu_new = st_.mu + (dE[0] - dE[1]) * beta
        diffkT = (beta * _take_lat(dE, st_.ls) + eng._eta(st_, mu_new)
                  - eng._eta(st_, st_.mu))
        margin[len(p_acc)] = float((u_acc - torch.exp(-diffkT))[0])
        return decide(st_, dE, u_acc, extra_ok)

    eng._trans_decision = recorded
    try:
        for t, code in enumerate(codes.tolist()):
            if code == TRANS:
                eng._translation_tbl(st, cu1[t], int(sched[t]), wl_active)
            if fc._switch_on(code, switch_ok):
                eng._switch(st, cu1[t, 6])
            p_acc.append(int(st.acc[0, 0]) + int(st.acc[2, 0]) * 1000)
            p_e.append(st.energy[:, 0].double())
            p_mu.append(float(st.mu[0]))
    finally:
        del eng._trans_decision
    torch.cuda.synchronize()
    seq_k = [x - y for x, y in zip(k_acc, [0] + k_acc[:-1])]
    seq_p = [x - y for x, y in zip(p_acc, [0] + p_acc[:-1])]
    diff_steps = [t for t in range(n) if seq_k[t] != seq_p[t]]
    e_err = [float(torch.max(torch.abs(x - y))) for x, y in zip(k_e, p_e)]
    mu_err = [abs(x - y) for x, y in zip(k_mu, p_mu)]
    first = next((t for t in range(n) if e_err[t] > 1e-4 or
                  mu_err[t] > 1e-2), None)
    print(f"[{tag}] walker {w} alone, {n} steps: accepted translations "
          f"kernel {k_acc[-1] % 1000}, plain {p_acc[-1] % 1000}; steps whose "
          f"accept differs {diff_steps[:12]}, the plain version's margin "
          f"u - exp(-diffkT) there "
          f"{[f'{margin.get(t, float(0)):.2e}' for t in diff_steps[:12]]}; "
          f"|dE| after each step: max "
          f"{max(e_err):.3e} Hartree, first above 1e-4 or |dmu| above 1e-2 "
          f"at step {first}; |dmu| max {max(mu_err):.3e}, at the end "
          f"{mu_err[-1]:.3e}", flush=True)
    if first is not None:
        lo = max(0, first - 3)
        rows = [(t, codes[t].item(), seq_k[t], seq_p[t], f"{e_err[t]:.2e}",
                 f"{mu_err[t]:.2e}") for t in range(lo, min(n, first + 4))]
        print(f"[{tag}]   (step, code, kernel accepts, plain accepts, |dE|, "
              f"|dmu|) around it: {rows}", flush=True)


# ----------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ----------------------------------------------------------------------

def full_energy_bound(r3, H, n_shifts):
    """(ms, bound_by): r3 and H read once, E and the moments written
    once; every pair folded and tested, every in-range leg evaluated."""
    import torch

    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.dense import _h_components, _mic_fold

    _, N, W = r3.shape
    b = r3.element_size()
    nbytes = b * (3 * N * W + 9 * W + W + 10 * N * W)
    n_in = 0
    Hc = _h_components(H)
    for i in range(N):
        d = _mic_fold(r3[0] - r3[0, i], r3[1] - r3[1, i], r3[2] - r3[2, i],
                      Hc)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        n_in += int(((r2 < MW.rc2) & (r2 > 0)).sum())
    ops = N * n_shifts * N * W * OPS_FOLD + n_in * OPS_LEG
    return _bound(nbytes, ops)


def _sched_work(eng, s, n_updates):
    """(bytes, operations) of the f schedule beyond the state traffic:
    Swetnam's master histogram view [B, W] read once and, at each of
    ``n_updates`` WL updates of a walker, its sum over the B bins (an
    add, a multiply, a division, a subtraction and a square each)."""
    prm = eng.prm
    if prm.samplerun or not prm.wl_swetnam or prm.num_lattices != 2:
        return 0, 0
    B, W = eng.grid.nbins, s.r.shape[-1]
    return B * W * s.r.element_size(), n_updates * W * B * 6


def fused_bound(eng, s, draws):
    """(ms, bound_by) of one cycle: every state array the kernel reads
    or writes moved once each way, and per translation step and walker
    two folded distance tests for every valid table partner plus the
    leg, wing and moment work of the partners in range at the start of
    the cycle (and the f schedule's work, _sched_work)."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dense import _h_components, _mic_fold

    codes, sched, cu = draws
    L, _, N, W = s.r.shape
    n_trans = int((codes == 0).sum())
    sb, sops = _sched_work(eng, s, n_trans)
    nbytes = _state_bytes(eng, s, N * 7, _table_bytes(eng, s) + sb)
    ops = sops
    trans = [int(m) for c, m in zip(codes.tolist(), sched.tolist())
             if c == 0]
    for l in range(L):
        Hc = _h_components(s.h[l])
        for imol in set(trans):
            js = eng._partners[l][imol]
            d = _mic_fold(*(s.r[l, a][js] - s.r[l, a, imol] for a in
                            range(3)), Hc)
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            n_in = int((r2 < eng.model.rc2).sum())
            k = trans.count(imol)
            ops += k * (len(js) * W * 2 * OPS_FOLD
                        + n_in * 2 * (OPS_LEG + OPS_WING))
    return _bound(nbytes, ops)


def _state_bytes(eng, s, n_u_rows, extra_ro=0):
    """Bytes of one cycle's state traffic: every array a fused-cycle
    kernel reads and writes moved once each way, its read-only inputs
    (cells, volumes, ``n_u_rows`` rows of uniforms, master weights)
    read once, plus ``extra_ro`` bytes of static tables."""
    L, _, N, W = s.r.shape
    # the WL arrays: none with one lattice
    B = eng.grid.nbins if L == 2 else 0
    b = s.r.element_size()
    rw = (L * 3 * N + 10 * L * N + L + 3 * B + 8) * W * b \
        + (N + 11) * W * 4
    ro = (2 * L * 9 + L + n_u_rows + B) * W * b + extra_ro
    return 2 * rw + ro


def _table_bytes(eng, s):
    """Bytes of the static neighbour tables and frac0."""
    return eng.tbl.size * 4 + eng.frac0.numel() * s.r.element_size()


def _dense_in_range(s, l, p, shifts, rc2, exclude=None):
    """[W] count of (candidate, shift) legs in range of the points p
    [3,W] in lattice l, the null image of molecule ``exclude`` [W] left
    out."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dense import (
        _h_components,
        _img_components,
        _mic_fold,
    )

    Hc = _h_components(s.h[l])
    f = _mic_fold(*(s.r[l, a] - p[a] for a in range(3)), Hc)
    img = _img_components(shifts, Hc)                        # [S,W] x3
    r2 = sum((f[a][None] + img[a][:, None]) ** 2 for a in range(3))
    inr = r2 < rc2                                           # [S,N,W]
    if exclude is not None:
        inr[0, exclude, torch.arange(p.shape[-1], device=p.device)] = False
    return inr.sum(dim=(0, 1))


def dense_bound(eng, s, draws):
    """(ms, bound_by) of one dense-branch cycle: the state moved once
    each way, and per translation step and walker, in each lattice, a
    folded distance test of all N candidates from both points plus an
    image shift and test for each further shift, and the leg and wing
    work of the legs in range of the old point, counted on the state at
    the start of the cycle for the molecule each walker draws (the new
    point's legs taken as many)."""
    import torch

    codes, _, cu = draws
    L, _, N, W = s.r.shape
    S = len(eng.fold_shifts)
    sb, sops = _sched_work(eng, s, int((codes == 0).sum()))
    nbytes = _state_bytes(eng, s, N * 7, sb)
    walker = torch.arange(W, device=s.r.device)
    n_steps = n_in = 0
    for t, code in enumerate(codes.tolist()):
        if code != 0:
            continue
        n_steps += 1
        imol = torch.clamp((cu[t, 0] * N).to(torch.int64), max=N - 1)
        for l in range(L):
            p = s.r[l][:, imol, walker]
            n_in += int(_dense_in_range(s, l, p, eng.fold_shifts,
                                        eng.model.rc2, imol).sum())
    ops = n_steps * W * L * 2 * N * (OPS_FOLD + 9 * (S - 1)) \
        + n_in * 2 * (OPS_LEG + OPS_WING) + sops
    return _bound(nbytes, ops)


def multi_bound(eng, s, draws):
    """(ms, bound_by) of one multi-trial cycle: the state moved once each
    way and the tables read, and per mover and walker, in each lattice,
    a folded distance test of every valid table partner from point 0 and
    from each translation trial's point, and the leg and wing work of
    the partners in range of those points (the trial points computed
    from the draws on the state at the start of the cycle)."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dense import _h_components, _mic_fold

    codes, sched, cu = draws
    L, _, N, W = s.r.shape
    T = eng.dT
    sb, sops = _sched_work(eng, s, int((codes == 0).sum()))
    nbytes = _state_bytes(eng, s, cu.shape[0] * cu.shape[1],
                          _table_bytes(eng, s) + sb)
    codes = codes.tolist()
    n_tests = n_legs = 0
    for step, imol in enumerate(sched.tolist()):
        u = cu[step]
        anc = 2.0 * u[1:4] - 1.0
        pts = [s.r[:, :, imol, :]]                           # [L,3,W]
        for t in range(T):
            if codes[step * T + t] == 0:
                v = (anc + (2.0 * u[4 + 3 * t:7 + 3 * t] - 1.0)) \
                    * s.max_trans
                pts.append(pts[0] + eng._map_disp(s, v))
        for l in range(L):
            js = eng._partners[l][imol]
            Hc = _h_components(s.h[l])
            n_tests += len(js) * len(pts) * W
            for p in pts:
                d = _mic_fold(*(s.r[l, a][js] - p[l, a] for a in range(3)),
                              Hc)
                r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                n_legs += int(((r2 < eng.model.rc2) & (r2 > 1e-8)).sum())
    ops = n_tests * OPS_FOLD + n_legs * (OPS_LEG + OPS_WING) + sops
    return _bound(nbytes, ops)


def time_cycles(eng, s, draws, reps):
    """Milliseconds of one cycle of the kernel from clones of ``s``, by
    CUDA events over ``reps`` cycles after a warm-up one (the plain
    version's is timed by fused_compare)."""
    st = s.clone()

    def one_cycle():
        st.cycle += 1
        eng.fused_cycle(st, *draws, True, True)

    return cuda_ms(one_cycle, reps)


def fused_kernel_check(prm, tag, reps=0, paper_pair=False,
                       weights="n216_sample", prepare=None, kernel=None,
                       run_cycles=0):
    """One cycle of the fused-cycle kernel of ``prm``'s engine against its
    plain version, from the state after two cycles, with the same draws:
    float64, identical integer outcomes and continuous state within
    1e-10; float32, at most F32_MAX_DIFF_FRAC of walkers with a
    differing integer outcome.  Prints the kernel's registers and
    spills.  ``prepare(state)`` adjusts the initial state; ``kernel``:
    the engine must run that kernel.  With ``reps``, also times the
    kernel and the plain version and computes the bound, and returns the
    kernel's report entry; with ``run_cycles``, the entry also holds the
    engine's own seconds per cycle over that many cycles and its
    launches there (``cycle_ms``, ``launches``)."""
    import torch

    eng, s = make_engine(prm, paper_pair=paper_pair, weights=weights)
    if kernel is not None and eng.fused_cycle.kernel != kernel:
        fail(f"{tag}: the engine runs {eng.fused_cycle.kernel}, not "
             f"{kernel}")
    kernel = eng.fused_cycle.kernel
    if prepare is not None:
        prepare(s)
    eng.run_cycles(s, 2)                     # walkers drift apart
    draws = kernel_draws(eng, s, 7)
    f64 = s.r.dtype == torch.float64
    W = s.r.shape[-1]
    sk, sp, differ, plain_ms = fused_compare(eng, s, draws, timed=True)
    frac = float(differ.float().mean())
    ok = ~differ
    n_acc = int((sk.acc[0] - s.acc[0]).sum())
    e_err = float(torch.max(torch.abs(sk.energy[:, ok] - sp.energy[:, ok])))
    # (in f32 a histogram row can still differ on the rest: a mu within
    # round-off of a bin edge lands in the neighbouring bin)
    err = fused_max_err(sk, sp, ok, None if f64 else
                        ("r", "moments", "energy", "mu"))
    if not f64 and kernel in ("fused_cycle", "fused_cycle_ext") \
            and not prm.minu:
        # (the trace records the plain decision without MINU's fold-in)
        fused_err_trace(f"{tag}-trace", eng, s, draws, sk, sp, ok,
                        ("r", "moments", "energy", "mu"))
    occ = eng.fused_cycle.occupancy(s.r.dtype, W)
    print(f"[{tag}] {kernel} {'fp64' if f64 else 'f32'} W={W} "
          f"S={len(eng.fold_shifts)} T={eng.dT}: {int(differ.sum())} walkers "
          f"differ ({frac:.4%}; limit {0 if f64 else F32_MAX_DIFF_FRAC:.0%})"
          f", on the rest energy max abs err {e_err:.3e} Hartree, relative "
          f"state err {err:.3e}; {n_acc} accepted translations; "
          f"{occupancy_text(occ)}", flush=True)
    if n_acc == 0:
        fail(f"{kernel}: no translation accepted")
    if f64:
        if differ.any() or not err <= 1e-10:
            fail(f"{kernel} fp64 disagrees with its plain version")
    elif frac > F32_MAX_DIFF_FRAC:
        fail(f"{kernel} f32 differs from its plain version on too many "
             "walkers")
    if not reps:
        return None
    from mc_water_ls_mw_tpu_torch.mcmc.fused import DENSE, KERNELS, MULTI

    ms = time_cycles(eng, s, draws, reps)
    branch = KERNELS[kernel][0]
    bound_ms, bound_by = (dense_bound if branch == DENSE else multi_bound
                          if branch == MULTI else fused_bound)(eng, s, draws)
    print(f"[{tag}] {kernel} f32 W={W}: kernel {ms:.3f} ms/cycle, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{occ['blocks']} blocks of {occ['walkers_per_block']} walkers on "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    out = dict(max_abs_err=e_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               registers=occ["registers"], spill_bytes=occ["spill_bytes"])
    if run_cycles:
        # the engine's own cycles (volume moves, syncs and all), from the
        # state after the warm-up
        eng.fused_cycle.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        eng.run_cycles(s, run_cycles)
        torch.cuda.synchronize()
        out["cycle_ms"] = (time.time() - t0) / run_cycles * 1e3
        out["launches"] = eng.fused_cycle.launches
        print(f"[{tag}] {kernel}: the engine's {run_cycles} cycles "
              f"{out['cycle_ms']:.3f} ms/cycle = "
              f"{W * prm.nwater / out['cycle_ms'] * 1e3:.4e} moves/s, "
              f"{out['launches']} launches", flush=True)
        if out["launches"] != run_cycles:
            fail(f"{tag}: {kernel} launched {out['launches']} times in "
                 f"{run_cycles} cycles")
    return out


def occupancy_keys(occ):
    """What the kernels line keeps of a cell kernel's occupancy (the
    ``occupancy`` of MoverEnergiesKernel or ChainWLKernel)."""
    return {k: occ[k] for k in ("registers", "spill_bytes", "blocks_per_sm")}


def occupancy_text(occ):
    """One line of a kernel's registers, spills and residency."""
    if "blocks_per_sm" in occ:
        return (f"{occ['registers']} registers, {occ['spill_bytes']} spill "
                f"bytes per thread, {occ['blocks_per_sm']} blocks per SM")
    return (f"{occ['registers']} registers, {occ['spill_bytes']} spill "
            f"bytes per thread; {occ['walkers_per_block']} walkers per "
            f"block ({occ['smem_bytes']} shared bytes), {occ['blocks']} "
            f"blocks, at most {occ['walkers_per_sm']} walkers resident per "
            "SM")


def device_rows(prof):
    """[(device microseconds, launches, kernel name)] of a finished
    torch.profiler trace, largest first."""
    from torch.autograd import DeviceType

    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    if not rows:
        fail("the profiler saw no device time")
    rows.sort(reverse=True)
    return rows


def print_device_rows(tag, rows, n, unit, top=12):
    for us, count, key in rows[:top]:
        print(f"[{tag}]   {us / 1e3 / n:10.4f} ms/{unit} {count / n:8.2f} "
              f"launches/{unit}  {key[:90]}", flush=True)


def profile_cycles(eng, s, n, untraced_s_per_cycle, tag="profile"):
    """Trace ``n`` main-path cycles with torch.profiler and print the
    device time per kernel and the device's busy share (one stream, so
    kernel times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.run_cycles(s, n)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(prof)
    dev_s = sum(r[0] for r in rows) * 1e-6
    n_launch = sum(r[1] for r in rows)
    busy = dev_s / (untraced_s_per_cycle * n)
    print(f"[{tag}] {n} cycles: device {dev_s * 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms traced wall ({dev_s / wall:.4f} busy); of "
          f"the untraced {untraced_s_per_cycle * n * 1e3:.3f} ms: "
          f"{busy:.4f} busy, {1 - busy:.4f} idle; {n_launch / n:.0f} "
          f"device launches per cycle", flush=True)
    print_device_rows(tag, rows, n, "cycle")


def profile_cell_cycle(eng, s, tag="cell-profile"):
    """One further cycle of the cell engine, run twice from the same
    state and the same position of the random stream, so that both
    passes schedule the same volume moves (each costs seconds):

    * untraced, with the host-clock walls of the sub-step loop and of
      the whole cycle;
    * under torch.profiler (device activity only: a cycle is ~10^5 host
      operations) in two traces, the sub-step loop and the rest of the
      cycle (scheduled volume moves, delta-sync, chain resync; a rebin
      before the loop is in neither).

    Prints the device time per kernel and the launches of both parts
    and the device's idle share of the untraced walls.  ``s`` is
    advanced by one cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_sub = eng.sweeps_per_cycle * eng.n_tables
    snap = s.clone()
    gens = (eng.stream.sched.get_state(), eng.stream.walk.get_state())
    walls = {}

    def timed_scan(*args):
        torch.cuda.synchronize()
        t0 = time.time()
        out = eng._substep_scan(*args)
        torch.cuda.synchronize()
        walls["loop"] = time.time() - t0
        return out

    att0 = int(s.att[1, 0])
    torch.cuda.synchronize()
    t0 = time.time()
    eng._cycle_with(s, timed_scan)
    torch.cuda.synchronize()
    walls["cycle"] = time.time() - t0
    walls["rest"] = walls["cycle"] - walls["loop"]
    n_vol = int(s.att[1, 0]) - att0

    eng.stream.sched.set_state(gens[0])
    eng.stream.walk.set_state(gens[1])
    traces = [profile(activities=[ProfilerActivity.CUDA]) for _ in range(2)]

    def traced_scan(*args):
        torch.cuda.synchronize()
        traces[0].start()
        out = eng._substep_scan(*args)
        torch.cuda.synchronize()
        traces[0].stop()
        traces[1].start()
        return out

    t0 = time.time()
    eng._cycle_with(snap, traced_scan)
    torch.cuda.synchronize()
    traces[1].stop()
    traced_wall = time.time() - t0
    if not torch.equal(snap.att, s.att):
        fail("the traced cycle did not repeat the untraced one")

    loop, rest = device_rows(traces[0]), device_rows(traces[1])
    dev = {"loop": sum(r[0] for r in loop) * 1e-6,
           "rest": sum(r[0] for r in rest) * 1e-6}
    dev["cycle"] = dev["loop"] + dev["rest"]
    print(f"[{tag}] cycle {s.cycle}, untraced: {walls['cycle']:.3f} s = "
          f"sub-step loop {walls['loop']:.3f} s "
          f"({walls['loop'] / n_sub * 1e3:.3f} ms per sub-step) + rest "
          f"{walls['rest']:.3f} s ({n_vol} volume moves, resync "
          f"{s.cycle % eng.prm.latt_sync_int == 0}, delta-sync "
          f"{s.cycle % eng.prm.mpi_sync_int == 0}, rebin "
          f"{s.cycle % eng.prm.list_update_int == 0}); traced wall "
          f"{traced_wall:.3f} s", flush=True)
    for part, rows, n, unit in (("loop", loop, n_sub, "sub-step"),
                                ("rest", rest, 1, "cycle")):
        busy = dev[part] / walls[part]
        print(f"[{tag}] {part}: device {dev[part] * 1e3:.3f} ms of the "
              f"untraced {walls[part] * 1e3:.3f} ms: {busy:.4f} busy, "
              f"{1 - busy:.4f} idle; {sum(r[1] for r in rows) / n:.1f} "
              f"device launches per {unit}", flush=True)
        print_device_rows(tag, rows, n, unit, top=8)
    busy = dev["cycle"] / walls["cycle"]
    print(f"[{tag}] whole cycle: device {dev['cycle']:.3f} s of "
          f"{walls['cycle']:.3f} s: {busy:.4f} busy, {1 - busy:.4f} idle",
          flush=True)


# ----------------------------------------------------------------------
# the large-N cell engine: set-up shared with
# tests/test_torch_kernels_cuda.py
# ----------------------------------------------------------------------

def cell_params(W, dtype, stack=CELL_STACK, **over):
    """The Wang-Landau run of the JAX package's large-N benchmark
    (scripts/bench_largen.py: 200 K, 1 atm, 0.25 A steps, 201 bins over
    mu in [-1200, 1200], one trial per mover, the apply stage and the
    chain kernel on) on the stacking pair ``stack`` (N=8064 by default),
    at W walkers."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams

    N = 4 * stack[0] * stack[1] * stack[2]
    kw = dict(
        nwater=N, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=0.25 * ANG_TO_BOHR, mc_dv_max=0.2 * ANG_TO_BOHR,
        nbins=201, mu_min=-1200.0, mu_max=1200.0,
        mc_vol_prob=1.0 / N, mc_switch_prob=0.1,
        samplerun=False, eq_mc_cycles=1, list_update_int=5,
        mpi_sync_int=10, latt_sync_int=10_000,
        n_walkers=W, dtype=dtype, seed=2014, stack=stack,
        method="stack", cell_trials=1, cell_pallas="apply", cell_chain="on",
    )
    kw.update(over)
    return RunParams(**kw)


def n_windows(prm):
    """The windows the front end gives a run (app.py's setup)."""
    if prm.parallel_strategy != "dd":
        return 1
    return max(2, min(prm.n_walkers, prm.n_windows))


def make_cell_engine(prm, comm=None, mesh=None):
    """(engine, state) of the stacking pair ``prm.stack`` (one lattice:
    its Ih cell, no correspondence mismatch) on the cell grid the front
    end picks for it (app.py: choose_grid_shape without
    prefer_disjoint); in 'dd' over ``prm.n_windows`` windows.  With
    ``comm`` the walkers are sharded over its ranks; with ``mesh`` (a
    parallel/spatial.SpatialMesh) the engine is the spatially sharded
    one.  The state returned is the whole one."""
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
        CellEngine,
        init_cell_state,
    )
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        correspondence_mismatch,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.cells import (
        build_grid,
        cap_for_positions,
        choose_grid_shape,
    )

    r0, H0 = stacking_cells(prm)
    mx = correspondence_mismatch(r0, H0)[0] if prm.num_lattices == 2 \
        else 0.0
    shape = choose_grid_shape(H0, MW, mx)
    cg = build_grid(shape, cap_for_positions(r0, H0, shape), H0, MW, mx)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg,
                                   n_windows=n_windows(prm), device=DEVICE)
    if mesh is not None:
        from mc_water_ls_mw_tpu_torch.parallel.spatial import (
            SpatialCellEngine,
        )

        return SpatialCellEngine(prm, MW, grid, aux, cg, caux, mesh=mesh,
                                 device=DEVICE), s
    return CellEngine(prm, MW, grid, aux, cg, caux, device=DEVICE,
                      comm=comm), s


def _max_abs(a, b, relative=False):
    """Largest |a - b|, with ``relative`` scaled by max(1, |b|); inf if
    the two are not finite in the same places."""
    import torch

    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)):
        return float("inf")
    if not fin.any():
        return 0.0
    d = torch.abs(a[fin] - b[fin])
    if relative:
        d = d / torch.clamp(torch.abs(b[fin]), min=1.0)
    return float(d.max())


def chain_compare(eng, s, rows, e, inc, hasm, codes, ua, uz,
                  wl_active=True):
    """The chain + WL kernel against its plain version on one sub-step's
    point table (energies ``e`` [L,K,P,W], in-cell flags ``inc``
    [K,P,W], trial flags ``hasm`` [K,W]), each on fresh clones of the
    chain rows ``rows`` (their switch gate and master histogram view
    among them) and the WL slabs of ``s``, with the WL phase
    ``wl_active``, in the cycle after ``s``'s.

    Returns (a dict: the [W] bool of walkers whose integer outcomes
    differ, the rows' and slabs' errors on the rest, accepted and enabled
    trials, switch attempts, the histogram's growth; ``chain(fn, b)``, which runs one pass
    of ``fn`` in place on the buffers ``b``, or returns fresh buffers
    when ``fn`` is None; the kernel's pass)."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import CN_EN, CN_SWEN

    K, P, W = inc.shape
    tables = (e.view(-1, W), inc.view(-1, W), hasm)

    def chain(fn, b=None):
        if b is None:
            b = dict(cf=rows.cf.clone(), ci=rows.ci.clone(),
                     wgt=s.weight.clone(), hist=s.hist.clone(),
                     uh=s.uhist.clone())
        if fn is not None:
            b["joh"], b["cnt"] = fn(codes, wl_active, b["cf"], b["ci"],
                                    b["wgt"], b["hist"], b["uh"], rows.basew,
                                    *tables, ua, uz, baseh=rows.baseh,
                                    cycle=s.cycle + 1)
        return b

    ck_, cp = chain(eng.chain_kernel), chain(eng.chain_kernel.plain)
    torch.cuda.synchronize()
    differ = torch.zeros((W,), dtype=torch.bool, device=DEVICE)
    for name in ("ci", "cnt", "joh"):
        differ |= (ck_[name] != cp[name]).any(dim=0)
    ok = ~differ
    slabs = ("wgt", "hist", "uh")
    out = dict(
        differ=differ,
        cf_err=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok]),
        wl_err=max(_max_abs(ck_[n][:, ok], cp[n][:, ok]) for n in slabs),
        cf_rel=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok], relative=True),
        wl_rel=max(_max_abs(ck_[n][:, ok], cp[n][:, ok], relative=True)
                   for n in slabs),
        n_acc=int((1.0 - cp["joh"].view(K, P, W)[:, 0]).sum()),
        n_enabled=int(cp["cnt"][CN_EN].sum()),
        n_sw=int(cp["cnt"][CN_SWEN].sum()),
        hist_grew=float((cp["hist"] - s.hist).sum()),
        uh_grew=float((cp["uh"] - s.uhist).sum()))
    return out, chain, ck_


def samplerun_chain_compare(eng, s, tbl, seed):
    """The chain kernel of a sample run (samplerun=True, wl_factor=0: the
    unbiased-histogram branch of the WL update, with its third eta
    lookup) against its plain version on one sub-step of the engine
    ``eng`` (a Wang-Landau run) on its state ``s``: the point table of
    the engine's own proposal of table row ``tbl``, the WL slabs of
    ``s`` (``chain_compare``'s dict)."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import (
        SWITCH,
        ChainWLKernel,
    )

    K, W = eng.K, s.r.shape[-1]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((7, K, W), generator=gen, dtype=s.r.dtype, device=DEVICE)
    codes = torch.zeros((K,), dtype=torch.int32, device=DEVICE)
    codes[K // 2] = SWITCH
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    trial = eng._propose_t1(s, pks, tbl, u, rows)
    ck_ = eng.chain_kernel
    kern = ChainWLKernel(
        dataclasses.replace(eng.prm, samplerun=True, wl_factor=0.0),
        eng.grid, ck_.K, ck_.T, ck_.log_norm)
    return chain_compare(SimpleNamespace(chain_kernel=kern), s, rows,
                         trial.e, rows.inc, trial.hasm, codes, u[5],
                         u[6])[0]


def cell_substep_compare(eng, s, tbl, seed, time_reps=0):
    """One sub-step's three kernels against their plain versions, at the
    shapes the main path gives them: the mover energies of table row
    ``tbl`` from the packed state, the chain + WL pass on those energies
    (on clones of the chain rows and WL slabs), and the apply stage with
    the chain kernel's accepts (on clones of the packed slabs).  The
    state ``s`` is left as it is.

    Returns a dict per kernel: errors against the plain version, the
    [W] bool of walkers whose integer chain outcomes differ, what the
    bounds need (in-range counts, accepted movers), and, with
    ``time_reps``, milliseconds of kernel and plain version."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    K, W = eng.K, s.r.shape[-1]
    dtype = s.r.dtype
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((7, K, W), generator=gen, dtype=dtype, device=DEVICE)
    codes = torch.zeros((K,), dtype=torch.int32, device=DEVICE)
    codes[K // 2] = SWITCH               # one scheduled switch, 7 moves
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    fc, cand, off = eng._tables(tbl)
    out = {}

    # -- mover energies (the kernel, through the engine's own proposal)
    n0 = eng.mover_kernel.launches
    trial = eng._propose_t1(s, pks, tbl, u, rows)
    if eng.mover_kernel.launches != n0 + 1:
        fail("the proposal did not launch the mover-energies kernel")
    margs = (pks, s.h, cand, off, fc, trial.rank, trial.p_old, trial.p_new)
    pe, pown = eng.mover_kernel.plain(*margs)
    torch.cuda.synchronize()
    n_occ, n_in = _occupancy_counts(eng, s, pks, trial, cand, off, fc)
    out["mover_energies"] = dict(
        e_err=_max_abs(trial.e, pe), own_err=_max_abs(trial.own_new, pown),
        n_occ=int(n_occ.sum()), n_in=int(n_in.sum()),
        n_movers=int(trial.hasm.sum()),
        dE_max=float(torch.max(torch.abs(pe[:, :, 1] - pe[:, :, 0]))))

    # -- chain + WL on those energies
    out["chain_wl"], chain, ck_ = chain_compare(
        eng, s, rows, trial.e, rows.inc, trial.hasm, codes, u[5], u[6])

    # -- apply with the chain kernel's accepts
    accf = ck_["joh"].view(K, 2, W)[:, 1]
    out["mover_apply"] = apply_compare(
        eng, pks, (s.h, cand, off, fc, trial.rank, accf, trial.p_old,
                   trial.p_new, trial.own_new), n_occ, n_in, time_reps)

    if time_reps:
        # kernels: device time (the host runs ahead); plain versions: as
        # a caller sees them.  The chain runs in place on its buffers,
        # pass after pass.
        t = out["mover_energies"]
        t["ms"] = cuda_ms(lambda: eng.mover_kernel(*margs), time_reps, True)
        t["plain_ms"] = cuda_ms(lambda: eng.mover_kernel.plain(*margs), 3)
        t = out["chain_wl"]
        bk, bp = chain(None), chain(None)
        t["ms"] = cuda_ms(lambda: chain(eng.chain_kernel, bk), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(lambda: chain(eng.chain_kernel.plain, bp), 3)
    return out


def apply_compare(eng, pks, aargs, n_occ, n_in, time_reps=0):
    """The apply kernel against its plain version on clones of the packed
    slabs ``pks`` with the arguments ``aargs`` (h, cand, off, fc, rank,
    accf, p_old, p_new, own_new).  Returns the moment rows' error, whether
    every other slab entry is bitwise equal, the slab entries the kernel
    changed, the accepted movers and their occupied and in-range slots
    (from the [K,W] counts ``n_occ``, ``n_in``), the inputs themselves
    (``args``: pks and aargs) and, with ``time_reps``, milliseconds of
    kernel and plain version (each applied in place on its clones, pass
    after pass)."""
    import torch

    accf = aargs[5]
    pk_k = [pk.clone() for pk in pks]
    pk_p = [pk.clone() for pk in pks]
    eng.apply_kernel(pk_k, *aargs)
    eng.apply_kernel.plain(pk_p, *aargs)
    torch.cuda.synchronize()
    acc = accf if accf.dtype == torch.bool else accf > 0.5
    out = dict(
        mom_err=max(_max_abs(a[:, :10], b[:, :10])
                    for a, b in zip(pk_k, pk_p)),
        rest_equal=all(torch.equal(a[:, 10:], b[:, 10:])
                       for a, b in zip(pk_k, pk_p)),
        changed=int(sum((a != b).sum() for a, b in zip(pk_k, pks))),
        n_acc=int(acc.sum()), n_occ_acc=int(n_occ[acc].sum()),
        n_in_acc=int(n_in[acc].sum()), args=(pks, aargs))
    if time_reps:
        out["ms"] = cuda_ms(lambda: eng.apply_kernel(pk_k, *aargs),
                            time_reps, True)
        out["plain_ms"] = cuda_ms(
            lambda: eng.apply_kernel.plain(pk_p, *aargs), 3)
    return out


def cell_bounds(eng, s, cmp):
    """{kernel: (ms, bound_by)} of one sub-step's launches from the
    counts of ``cell_substep_compare``.

    mover_energies: the occupied flag of every candidate slot, the three
    coordinate rows of the occupied slots (the answer does not depend on
    an empty slot's coordinates) and the ten moment rows of the slots in
    range are read once, the movers' inputs read and their energies and
    own moments written; every occupied slot costs the image shift and
    two distance tests, every slot in range its legs and wings.
    mover_apply: ``apply_bound``.  chain_wl: its tables read, its rows
    read and written, and per enabled trial ~16 slab entries (two eta
    lookups of three bins in two slabs, the histogram and weight
    update)."""
    W, b = s.r.shape[-1], s.r.element_size()
    me, ma, ch = cmp["mover_energies"], cmp["mover_apply"], cmp["chain_wl"]
    return {"mover_energies": mover_energies_bound(eng, s, me),
            "mover_apply": apply_bound(eng, s, ma),
            "chain_wl": chain_bound(eng, W, b, 2, ch["n_enabled"])}


def apply_bound(eng, s, ma):
    """(ms, bound_by) of one apply launch from the counts ``ma`` of
    ``apply_compare``: for the accepted movers only, the occupied flag
    of every candidate slot, the three coordinate rows of the occupied
    slots and the ten moment rows of the in-range ones read, those moment
    rows and the movers' own slots written; the movers' inputs read."""
    L, W = 2, s.r.shape[-1]
    K, CF, cap = eng.K, eng.apply_kernel.CF, eng.cellgrid.cap
    b = s.r.element_size()
    small = (9 * L + 6 * L * K) * W * b + K * W * 4 + K * CF * 16
    ops_slot = 3 + 2 * 9              # image shift, two distance tests
    nbytes = (L * CF * cap * ma["n_acc"] + 3 * ma["n_occ_acc"]
              + 20 * ma["n_in_acc"] + 13 * L * ma["n_acc"]) * b + small \
        + (K + 10 * L * K) * W * b
    ops = ma["n_occ_acc"] * ops_slot + ma["n_in_acc"] * (2 * OPS_LEG + 20)
    return _bound(nbytes, ops)


def mover_energies_bound(eng, s, me, deltas=False):
    """(ms, bound_by) of one mover-energies launch from the counts ``me``
    of a comparison (occupied candidate slots ``n_occ``, neighbour slots
    in range of either position ``n_in``): the occupied flag of every
    candidate slot, the three coordinate rows of the occupied slots (the
    answer does not depend on an empty slot's coordinates) and the ten
    moment rows of the slots in range are read once, the movers' inputs
    read and their energies and own moments written; every occupied slot
    costs the image shift and two distance tests, every slot in range
    its legs and wings.  With ``deltas`` the delta output is written
    whole (ten values per candidate slot, zeros included) and every slot
    in range costs its deltas."""
    L, W = 2, s.r.shape[-1]
    K, CF, cap = eng.K, eng.mover_kernel.CF, eng.cellgrid.cap
    b = s.r.element_size()
    small = (9 * L + 6 * L * K) * W * b + K * W * 4 + K * CF * 16
    nbytes = (L * K * CF * cap * W + 3 * me["n_occ"] + 10 * me["n_in"]) * b \
        + small + (2 * L * K + 10 * L * K) * W * b
    ops = me["n_occ"] * (3 + 2 * 9) + me["n_in"] * 2 * (OPS_LEG + OPS_WING)
    if deltas:
        nbytes += 10 * L * K * CF * cap * W * b
        ops += me["n_in"] * OPS_DELTA
    return _bound(nbytes, ops)


class _Plain:
    """A kernel wrapper whose call is its plain version: the engine's
    sub-step run on CUDA tensors with the plain versions, for the
    comparisons (it launches nothing and counts nothing)."""

    def __init__(self, kern):
        self._kern = kern

    def __getattr__(self, name):
        return getattr(self._kern, name)

    def __call__(self, *args, cnt=None, **kw):
        out = self._kern.plain(*args, **kw)
        if cnt is not None:           # the chain's preallocated counters
            cnt.copy_(out[1])
            out = (out[0], cnt)
        return out


def _occupancy_counts(eng, s, pks, trial, cand, off, fc):
    """Per (mover, walker), summed over the lattices: the occupied
    candidate slots and the neighbour slots in range of either position
    (what the bounds need)."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.cells import PK_VALID

    K, W = trial.rank.shape
    n_occ = torch.zeros((K, W), dtype=torch.int64, device=DEVICE)
    n_in = torch.zeros((K, W), dtype=torch.int64, device=DEVICE)
    for l, pk in enumerate(pks):
        n_occ += (pk[:, PK_VALID][cand.long()] > 0.5).sum(dim=(1, 2))
        kern = eng.mover_kernel if eng.T == 1 else eng.apply_kernel
        _, _, co, cn = kern._candidates(
            pk, s.h[l], cand, off, fc, trial.rank, trial.p_old[l],
            trial.p_new[l])
        n_in += ((co.w > 0) | (cn.w > 0)).sum(dim=1)
    return n_occ, n_in


def scatter_substep_compare(eng, s, tbl, seed, time_reps=0):
    """One sub-step of the scatter path (an engine at cell_pallas 'on')
    at the shapes the main path gives it, from table row ``tbl`` of the
    state ``s`` (left as it is) with one set of draws:

    * the mover kernel's delta output (kernel 3b), from the engine's own
      proposal, against its plain version: energies, own moments and
      every delta of every candidate slot;
    * the chain + WL kernel against its plain version on the kernel's
      energies (``chain_compare``);
    * the whole sub-step (proposal, chain, scatter) run twice through
      the kernels and once through their plain versions (``_Plain``),
      each on a clone of the state: the integer outcomes (chain rows,
      counters, per-slot trial counts) of the kernels against the plain
      versions, the packed slabs, chain rows and WL slabs on the walkers
      whose integer outcomes agree (in float32 the chain rows of the two
      differ by what the energies do: mu by beta times the sum of the
      accepted moves' energy differences), and whether the two kernel
      runs gave bitwise-equal results (the scatter's repeated indices
      are added by atomics in no fixed order).

    With ``time_reps``: milliseconds of the kernel, of its plain version
    and of the scatter (``_scatter_moments``) of one sub-step."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import (
        CN_ACC,
        CN_EN,
        SWITCH,
    )

    K, W = eng.K, s.r.shape[-1]
    dtype = s.r.dtype
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((7, K, W), generator=gen, dtype=dtype, device=DEVICE)
    codes = torch.zeros((K,), dtype=torch.int32, device=DEVICE)
    codes[K // 2] = SWITCH               # one scheduled switch
    fc, cand, off = eng._tables(tbl)
    out = {}

    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    n0 = eng.mover_kernel.launches
    trial = eng._propose_t1(s, pks, tbl, u, rows)
    if eng.mover_kernel.launches != n0 + 1 or trial.dlt is None:
        fail("the proposal did not launch the mover kernel with deltas")
    margs = (pks, s.h, cand, off, fc, trial.rank, trial.p_old, trial.p_new)
    pe, pown, pdlt = eng.mover_kernel.plain(*margs)
    torch.cuda.synchronize()
    n_occ, n_in = _occupancy_counts(eng, s, pks, trial, cand, off, fc)
    out["mover_energies_deltas"] = dict(
        e_err=_max_abs(trial.e, pe), own_err=_max_abs(trial.own_new, pown),
        dlt_err=_max_abs(trial.dlt, pdlt),
        n_dlt=int((pdlt != 0).any(dim=3).sum()),
        n_occ=int(n_occ.sum()), n_in=int(n_in.sum()),
        dE_max=float(torch.max(torch.abs(pe[:, :, 1] - pe[:, :, 0]))))
    out["chain_wl"], chain, _ = chain_compare(
        eng, s, rows, trial.e, rows.inc, trial.hasm, codes, u[5], u[6])

    def substep(plain):
        st = s.clone()
        pk_, rows_ = eng._pack(st), eng._loop_rows(st)
        tpm = torch.zeros((eng.cellgrid.nslot, W), dtype=torch.int32,
                          device=DEVICE)
        kerns = eng.mover_kernel, eng.chain_kernel
        if plain:
            eng.mover_kernel, eng.chain_kernel = map(_Plain, kerns)
        try:
            cnt = eng._substep(st, pk_, tpm, tbl, u.clone(), codes, rows_)
        finally:
            eng.mover_kernel, eng.chain_kernel = kerns
        return dict(pks=pk_, cf=rows_.cf, ci=rows_.ci, cnt=cnt, tpm=tpm,
                    wgt=st.weight, hist=st.hist, uh=st.uhist)

    a, a2, p = substep(False), substep(False), substep(True)
    torch.cuda.synchronize()
    differ = torch.zeros((W,), dtype=torch.bool, device=DEVICE)
    for name in ("ci", "cnt", "tpm"):
        differ |= (a[name] != p[name]).any(dim=0)
    ok = ~differ
    slabs = ("wgt", "hist", "uh")
    out["substep"] = dict(
        differ=differ,
        mom_err=max(_max_abs(x[:, :10][..., ok], y[:, :10][..., ok])
                    for x, y in zip(a["pks"], p["pks"])),
        coord_err=max(_max_abs(x[:, 10:][..., ok], y[:, 10:][..., ok])
                      for x, y in zip(a["pks"], p["pks"])),
        cf_rel=_max_abs(a["cf"][:, ok], p["cf"][:, ok], relative=True),
        wl_rel=max(_max_abs(a[n][:, ok], p[n][:, ok], relative=True)
                   for n in slabs),
        repeat_equal=all(torch.equal(x, y) for x, y in
                         zip(a["pks"], a2["pks"])) and all(
            torch.equal(a[n], a2[n]) for n in ("cf", "ci", "cnt", "tpm")
            + slabs),
        changed=int(sum((x != y).sum() for x, y in zip(a["pks"], pks))),
        n_acc=int(p["cnt"][CN_ACC].sum()),
        n_enabled=int(p["cnt"][CN_EN].sum()))

    if time_reps:
        t = out["mover_energies_deltas"]
        t["ms"] = cuda_ms(lambda: eng.mover_kernel(*margs), time_reps, True)
        t["plain_ms"] = cuda_ms(lambda: eng.mover_kernel.plain(*margs), 3)
        accf = (u[5] < 0.5).to(dtype)
        pk_t = [pk.clone() for pk in pks]
        t["scatter_ms"] = cuda_ms(
            lambda: eng._scatter_moments(pk_t, tbl, trial, accf), time_reps,
            True)
        t = out["chain_wl"]
        bk, bp = chain(None), chain(None)
        t["ms"] = cuda_ms(lambda: chain(eng.chain_kernel, bk), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(lambda: chain(eng.chain_kernel.plain, bp), 3)
    return out


def cycle_rows(eng, s):
    """(the sub-step loop's rows, wl_active) of the cycle after ``s``'s:
    its switch gate and WL phase as the engine decides them."""
    cycle = s.cycle + 1
    return (eng._loop_rows(s, eng._switch_ok(cycle)),
            cycle >= eng.prm.eq_mc_cycles)


def multitrial_compare(eng, s, tbl, seed, time_reps=0):
    """One multi-trial sub-step's points kernel and its chain pass (an
    engine at cell_trials = T > 1) against their plain versions, at the
    shapes the main path gives them: the P = T + 1 point table of table
    row ``tbl`` from the engine's own proposal on the packed state, and
    the K x T chain on that table (on clones of the chain rows and WL
    slabs).  ``s`` is left as it is.

    Returns a dict per kernel: errors against the plain version, the [W]
    bool of walkers whose integer chain outcomes differ, what the bounds
    need (occupied candidate slots, slots in range of any point, legs
    over all points, enabled trials) and, with ``time_reps``,
    milliseconds of kernel and plain version."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH
    from mc_water_ls_mw_tpu_torch.ops.cell_energy import _gather_candidates
    from mc_water_ls_mw_tpu_torch.ops.cells import PK_R0, PK_VALID

    K, T, W = eng.K, eng.T, s.r.shape[-1]
    P = T + 1
    dtype = s.r.dtype
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((4 + 3 * T, K, W), generator=gen, dtype=dtype,
                   device=DEVICE)
    ua, uz = torch.rand((2, K * T, W), generator=gen, dtype=dtype,
                        device=DEVICE)
    codes = torch.zeros((K * T,), dtype=torch.int32, device=DEVICE)
    codes[K * T // 2] = SWITCH
    pks = eng._pack(s)
    rows, wl_active = cycle_rows(eng, s)
    fc, cand, off = eng._tables(tbl)
    out = {}

    n0 = eng.points_kernel.launches
    trial = eng._propose_tm(s, pks, tbl, u, rows)
    if eng.points_kernel.launches != n0 + 1:
        fail("the proposal did not launch the mover-points kernel")
    pargs = (pks, s.h, cand, off, fc, trial.rank, trial.pts)
    pe, pown = eng.points_kernel.plain(*pargs)
    # launched again: the groups' sums are added in a fixed order
    re_, rown = eng.points_kernel(*pargs)
    torch.cuda.synchronize()
    # what the bound needs, summed over (lattice, mover, walker)
    n_occ = n_any = n_legs = 0
    slot = fc.long()[:, None] * eng.cellgrid.cap + trial.rank.long()
    for l, pk in enumerate(pks):
        n_occ += int((pk[:, PK_VALID][cand.long()] > 0.5).sum())
        cx, cy, cz, mask = _gather_candidates(
            pk[:, PK_R0], pk[:, PK_R0 + 1], pk[:, PK_R0 + 2],
            pk[:, PK_VALID] > 0.5, s.h[l], cand.long(), off,
            eng.points_kernel.full_mask, eng.cellgrid.cap, slot)
        anyp = torch.zeros_like(mask)
        for t in range(P):
            p = trial.pts[t, l]
            r2 = ((cx - p[0][:, None]) ** 2 + (cy - p[1][:, None]) ** 2
                  + (cz - p[2][:, None]) ** 2)
            in_t = (r2 < eng.model.rc2) & mask
            n_legs += int(in_t.sum())
            anyp |= in_t
        n_any += int(anyp.sum())
    out["mover_points"] = dict(
        e_err=_max_abs(trial.e, pe), own_err=_max_abs(trial.own, pown),
        repeat_equal=torch.equal(trial.e, re_) and torch.equal(trial.own,
                                                               rown),
        n_occ=n_occ, n_any=n_any, n_legs=n_legs,
        n_movers=int(trial.hasm.sum()),
        dE_max=float(torch.max(torch.abs(pe[:, :, 1:] - pe[:, :, :1]))))

    out["chain_wl"], chain, _ = chain_compare(
        eng, s, rows, trial.e, trial.inc, trial.hasm, codes, ua, uz,
        wl_active)

    if time_reps:
        t = out["mover_points"]
        t["ms"] = cuda_ms(lambda: eng.points_kernel(*pargs), time_reps, True)
        t["plain_ms"] = cuda_ms(lambda: eng.points_kernel.plain(*pargs), 3)
        t = out["chain_wl"]
        bk, bp = chain(None), chain(None)
        t["ms"] = cuda_ms(lambda: chain(eng.chain_kernel, bk), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(lambda: chain(eng.chain_kernel.plain, bp), 3)
    return out


def points_compare(eng, s, tbl, seed, P, time_reps=0):
    """The points kernel at P <= T + 1 points (cell_trials P - 1) on the
    first P points of the engine's own proposal of table row ``tbl`` (an
    engine at cell_trials = T > 1) against its plain version, launched
    twice (the groups' sums are added in a fixed order: the two results
    must be bitwise equal).  ``s`` is left as it is.  Returns the
    errors, the repeat's equality, the plan and, with ``time_reps``,
    milliseconds of kernel and plain version."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.cell_kernels import MoverPointsKernel

    K, T, W = eng.K, eng.T, s.r.shape[-1]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((4 + 3 * T, K, W), generator=gen, dtype=s.r.dtype,
                   device=DEVICE)
    pks = eng._pack(s)
    fc, cand, off = eng._tables(tbl)
    trial = eng._propose_tm(s, pks, tbl, u, eng._loop_rows(s))
    kern = MoverPointsKernel(eng.model, eng.cellgrid, P)
    args = (pks, s.h, cand, off, fc, trial.rank,
            trial.pts[:P].contiguous())
    e, own = kern(*args)
    e2, own2 = kern(*args)
    pe, pown = kern.plain(*args)
    torch.cuda.synchronize()
    out = dict(e_err=_max_abs(e, pe), own_err=_max_abs(own, pown),
               repeat_equal=torch.equal(e, e2) and torch.equal(own, own2),
               plan=kern.plan(s.r.dtype, len(pks), K, W))
    if time_reps:
        out["ms"] = cuda_ms(lambda: kern(*args), time_reps, True)
        out["plain_ms"] = cuda_ms(lambda: kern.plain(*args), 3)
    return out


def multitrial_apply_compare(eng, s, tbl, seed, mode, time_reps=0):
    """The apply stage of a multi-trial sub-step (an engine at
    cell_trials = T > 1) against its plain version, with the arguments
    the engine's ``_apply_tm`` gives it: each mover's final point and
    own moments from the engine's own proposal of table row ``tbl`` and
    a one-hot of its accepted point.  ``mode``: 'chain', the chain
    kernel's one-hot; 'all', every mover (of a cell that has one) at its
    point 1; 'none', every mover at point 0 (all rejected).  ``s`` is
    left as it is.  Returns ``apply_compare``'s dict."""
    from types import SimpleNamespace

    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    K, T, W = eng.K, eng.T, s.r.shape[-1]
    P = T + 1
    dtype = s.r.dtype
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    u = torch.rand((4 + 3 * T, K, W), generator=gen, dtype=dtype,
                   device=DEVICE)
    pks = eng._pack(s)
    rows, wl_active = cycle_rows(eng, s)
    fc, cand, off = eng._tables(tbl)
    trial = eng._propose_tm(s, pks, tbl, u, rows)
    if mode == "chain":
        ua, uz = torch.rand((2, K * T, W), generator=gen, dtype=dtype,
                            device=DEVICE)
        codes = torch.zeros((K * T,), dtype=torch.int32, device=DEVICE)
        codes[K * T // 2] = SWITCH
        _, _, ck_ = chain_compare(eng, s, rows, trial.e, trial.inc,
                                  trial.hasm, codes, ua, uz, wl_active)
        joh = ck_["joh"].view(K, P, W)
    else:
        moved = (trial.hasm > 0.5) & (mode == "all")
        joh = torch.zeros((K, P, W), dtype=dtype, device=DEVICE)
        joh[:, 0] = (~moved).to(dtype)
        joh[:, 1] = moved.to(dtype)
    p_fin = torch.sum(trial.pts * joh.transpose(0, 1)[:, None, None], dim=0)
    own_fin = torch.sum(trial.own * joh[None, :, :, None], dim=2)
    accf = joh[:, 0] < 0.5
    n_occ, n_in = _occupancy_counts(
        eng, s, pks, SimpleNamespace(rank=trial.rank, p_old=trial.pts[0],
                                     p_new=p_fin), cand, off, fc)
    return apply_compare(eng, pks, (s.h, cand, off, fc, trial.rank, accf,
                                    trial.pts[0], p_fin, own_fin),
                         n_occ, n_in, time_reps)


def multitrial_bounds(eng, s, cmp):
    """{kernel: (ms, bound_by)} of one multi-trial sub-step's launches
    from the counts of ``multitrial_compare``.

    mover_points: the occupied flag of every candidate slot, the three
    coordinate rows of the occupied slots and the ten moment rows of the
    slots in range of any point are read once, the points, cells and
    ranks read, the P energies and P own-moment sets written; every
    occupied slot costs its image shift and P distance tests, every leg
    in range of a point its leg and wing terms."""
    L, W = 2, s.r.shape[-1]
    K, T, CF, cap = eng.K, eng.T, eng.points_kernel.CF, eng.cellgrid.cap
    P = T + 1
    b = s.r.element_size()
    mp = cmp["mover_points"]
    nbytes = (L * K * CF * cap * W + 3 * mp["n_occ"] + 10 * mp["n_any"]) * b \
        + (9 * L + 3 * P * L * K) * W * b + K * W * 4 + K * CF * 16 \
        + (P * L * K + 10 * P * L * K) * W * b
    ops = mp["n_occ"] * (3 + P * 9) + mp["n_legs"] * (OPS_LEG + OPS_WING)
    return {"mover_points": _bound(nbytes, ops),
            "chain_wl": chain_bound(eng, W, b, P,
                                    cmp["chain_wl"]["n_enabled"])}


def chain_bound(eng, W, b, P, n_enabled):
    """(ms, bound_by) of one chain pass over K movers x T trials on a
    P-point table: its tables read (energies of both lattices, in-cell
    flags, trial flags, accept and switch uniforms), its rows read and
    written, its one-hot written, and per enabled trial ~16 slab entries
    (two eta lookups of three bins in two slabs, the histogram and weight
    update) and ~200 + 6P operations (the one-hot reads of the current
    point among them)."""
    K, T, B = eng.K, eng.T, eng.grid.nbins
    nbytes = (2 * 14 + 2 * K * P + K * P + K + 2 * K * T + K * P) * W * b \
        + (2 * 7 + 4 + K) * W * 4 + 2 * B * b + 16 * n_enabled * b
    return _bound(nbytes, (200 + 6 * P) * n_enabled)


# ----------------------------------------------------------------------
# the front-end path: runs/n8064_wl through the port's run_input_file
# ----------------------------------------------------------------------

# the overrides of runs/n8064_wl/run.py (its MU_RANGE and WL_QTIME
# defaults)
N8064_WL = dict(
    stack=(14, 8, 18), n_walkers=128, parallel_strategy="dd", n_windows=16,
    window_overlap=2, mu_min=-90000.0, mu_max=90000.0, nbins=201,
    cell_trials=8, mc_max_trans=0.10, mc_dv_max=0.2, eq_adjust_mc=True,
    wl_factor=0.005 * 16.0 / 128, eq_mc_cycles=400, list_update_int=10,
    mpi_sync_int=50, monitor_int=500, flat_chk_int=500, wl_minhist=5,
    file_output_int=100, therm_walkers=8, traj_output_int=100_000_000,
    chkpt_dump_int=250, timer_qtime=9000.0, timer_closetime=420,
    max_mc_cycles=100_000_000,
)
# what the smoke run cuts, to fit rebins, volume moves, delta-syncs,
# monitor_stats with eq_adjust_mc, the equilibration boundary of the 16
# 'dd' windows, check_flatness and a checkpoint into 2 + 1 cycles: these
# cycle counts and intervals (the run's own values in the comments)
FRONTEND_CUTS = dict(
    eq_mc_cycles=3,             # 400
    list_update_int=3,          # 10
    monitor_int=2,              # 500
    flat_chk_int=3,             # 500
    mpi_sync_int=2,             # 50
    file_output_int=2,          # 100
    chkpt_dump_int=2,           # 250 (each call's writer starts at slot
)                               # 1: cycle 2's writes fill both slots)
FRONTEND_CYCLES = (2, 1)        # first call, resumed call


def _block_seconds(log_path):
    """(cycles, seconds of cycle dispatch, seconds of whole blocks) summed
    over the app's '# block' lines of a log."""
    n = disp = tot = 0.0
    for ln in open(log_path):
        if ln.startswith("# block "):
            parts = ln.split()
            n += int(parts[3])
            tot += float(parts[6].rstrip("s"))
            disp += float(parts[9])
    return int(n), disp, tot


def _block_split(log_path):
    """(therm, wl/monitor, ckpt/other) seconds summed over the app's
    '# block' lines of a log (each printed to 0.1 s)."""
    out = [0.0, 0.0, 0.0]
    for ln in open(log_path):
        if ln.startswith("# block "):
            parts = ln.split()
            for k, i in enumerate((12, 15, 18)):
                out[k] += float(parts[i])
    return out


def frontend_run():
    """Drive runs/n8064_wl (128 walkers, float32, cell_trials=8) through
    the port's run_input_file in build/chip_smoke_frontend:
    FRONTEND_CYCLES (a first call, then a second that resumes from the
    checkpoint), then a traced cycle.  The kernels' counts are those of the engines the two
    calls built (created at 0 when the run sets up).  Returns
    {"launches": {kernel: count over both calls}}."""
    import shutil

    import torch

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import CellEngine
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    d = os.path.join(ROOT, "build", "chip_smoke_frontend")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n8064_wl", "ice.input"), d)
    kernels = {"mover_points": "points_kernel", "chain_wl": "chain_kernel",
               "mover_apply": "apply_kernel"}
    out = _app_calls(d, {**N8064_WL, **FRONTEND_CUTS}, FRONTEND_CYCLES,
                     kernels)
    first, second = out
    eng, s = second["app"].engine, second["s"]
    prm = eng.prm
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    W = N8064_WL["n_walkers"]
    if not (isinstance(eng, CellEngine) and eng.T == MT_TRIALS
            and s.r.shape[-1] == W and s.r.dtype == torch.float32):
        fail(f"the front-end run did not build the T={MT_TRIALS} float32 "
             f"cell engine at {W} walkers")
    for run, n_cyc in zip(out, FRONTEND_CYCLES):
        if any(n != n_cyc * n_sub for n in run["launches"].values()):
            fail(f"front-end run: launches {run['launches']}, expected "
                 f"{n_cyc * n_sub} of each kernel")
    if first["s"].cycle != FRONTEND_CYCLES[0] or \
            second["app"].start_cycle != FRONTEND_CYCLES[0] or \
            s.cycle != sum(FRONTEND_CYCLES):
        fail(f"the resumed run did not continue from cycle "
             f"{FRONTEND_CYCLES[0]}: started at "
             f"{second['app'].start_cycle}, ended at {s.cycle}")
    ended = s.cycle
    node = open(os.path.join(d, "node000.log")).read()
    glog = open(os.path.join(d, "mc.log")).read()
    # volume-move attempts of all walkers in the monitored cycles
    n_vol = sum(int(ln.split()[5]) for ln in node.splitlines()
                if ln.endswith(" box moves"))
    need = {
        "monitor_stats with eq_adjust_mc": "# Max molecule translation",
        "the per-window monitor rows": "# window  walkers in-win",
        "check_flatness": "# Checking flatness of histogram at cycle",
        "the restart": f"# Restarting from cycle {FRONTEND_CYCLES[0]} (",
    }
    for what, text in need.items():
        if text not in node + glog:
            fail(f"front-end run: no trace of {what} in the logs")
    files = set(os.listdir(d))
    nwin = s.master_eta.hi.shape[0]
    want = {"checkpoint000.npz.1", "checkpoint000.npz.2", "eta_weights.dat",
            "mW.psf", "mW.dcd", "mc.log", "node000.log"} | {
                f"ice{w:03d}_therm.dat"
                for w in range(min(prm.therm_walkers, W))} | {
                f"{k}_{w:03d}.dat" for w in range(nwin)
                for k in ("eta_weights", "histogram",
                          "unbiased_histogram")}
    if nwin != N8064_WL["n_windows"] or not want <= files:
        fail(f"front-end run: {nwin} windows, missing files "
             f"{sorted(want - files)}")
    inside = (s.mu > s.my_mu_min) & (s.mu < s.my_mu_max)
    per_win = torch.bincount(s.window_id[inside].long(),
                             minlength=nwin).tolist()
    overflow = int(s.occ_overflow.max())
    # the energy audit right after one more cycle's sub-step loop (an
    # accepted volume move, hoisted after the loop, recomputes a
    # walker's energy from scratch, so an audit at the end of a cycle
    # would mostly see none of the loop's accumulated drift); on a copy
    # of the state, whose first 64 walkers the audit overwrites
    drifts = []

    def audited_scan(*args):
        st, tpm = eng._substep_scan(*args)
        drifts.append(eng.audit_energy(st.clone(), n_walkers=64)[1])
        return st, tpm

    eng._cycle_with(s, audited_scan)
    max_drift = float(torch.max(torch.abs(drifts[0])))
    n, disp, tot = _block_seconds(os.path.join(d, "mc.log"))
    rate = eng.trials_per_cycle * W * n / disp
    kind = torch.cuda.get_device_name(0)
    print(f"[frontend] runs/n8064_wl through run_input_file, overrides "
          f"but {sorted(FRONTEND_CUTS)} (cut): N={prm.nwater} W={W} float32 "
          f"T={eng.T}, '{prm.parallel_strategy}' over {nwin} windows "
          f"(overlap {prm.window_overlap}), {n_sub} sub-steps/cycle, "
          f"{eng.trials_per_cycle} trials/cycle; walkers inside their "
          f"window's bounds at cycle {ended} per window {per_win}",
          flush=True)
    print(f"[frontend] {n} cycles over both calls: {disp / n:.3f} s/cycle "
          f"in the cycle loop ({tot / n:.3f} s/cycle with the block "
          f"events) = {rate:.4e} trials/s on {kind}; calls "
          f"{first['wall']:.1f} s and {second['wall']:.1f} s with set-up; "
          f"{n_vol} volume-move attempts (all walkers, cycles 1-"
          f"{prm.monitor_int * (ended // prm.monitor_int)}); launches "
          f"{first['launches']} + {second['launches']}; "
          f"resumed at cycle {second['app'].start_cycle}, ended at "
          f"{ended}; occ_overflow {overflow}; max_trans "
          f"{float(s.max_trans.mean()) / ANG_TO_BOHR:.4f} A (from "
          f"{N8064_WL['mc_max_trans']}); audit of 64 walkers after the "
          f"sub-step loop of cycle {s.cycle}: max |drift| "
          f"{max_drift:.3e} Hartree (limit {AUDIT_CELL_MAX_DRIFT:g}); "
          f"merged histogram sum {ds_value64(s.master_hist).sum():.6e}",
          flush=True)
    if overflow != 0:
        fail(f"front-end run: slab overflow {overflow}")
    if n_vol <= 0:
        fail("front-end run: no volume move")
    if not max_drift < AUDIT_CELL_MAX_DRIFT:
        fail("front-end run: energy audit drift")
    if not (abs(float(s.max_trans.mean())
                - N8064_WL["mc_max_trans"] * ANG_TO_BOHR) > 1e-6):
        fail("front-end run: eq_adjust_mc left max_trans as it was")
    profile_cell_cycle(eng, s, tag="frontend-profile")
    return {"launches": {k: first["launches"][k] + second["launches"][k]
                         for k in kernels}}


# ----------------------------------------------------------------------
# path A: the reference's own N=48 example through run_input_file
# ----------------------------------------------------------------------

# runs/n216_sample/ice.input (the reference's ice1 weight generation,
# nwater = 48) with the README's --walkers 4096, and the (1,2,6)
# stacking pair in place of the example's xmol lattice files, which are
# not in the repository
DENSE48 = dict(n_walkers=4096, stack=(1, 2, 6))
# what the smoke run cuts, to fit volume moves, delta-syncs, chain
# resyncs, monitor_stats with eq_adjust_mc, check_flatness and
# checkpoints into 40 + 8 cycles: these cycle counts and intervals (the
# run's own values, from the input or the defaults, in the comments)
DENSE48_CUTS = dict(
    eq_mc_cycles=16,            # 10000
    monitor_int=8,              # 1000
    flat_chk_int=16,            # 10000
    file_output_int=8,          # 50
    chkpt_dump_int=16,          # 1000
    mpi_sync_int=8,             # 250
    latt_sync_int=16,           # 10000
)
DENSE48_CYCLES = (40, 8)        # first call, resumed call


def dense48_run():
    """Drive runs/n216_sample/ice.input (N=48, 4096 walkers, float32)
    through the port's run_input_file in build/chip_smoke_dense48: 40
    cycles, then a second call that resumes from the checkpoint for 8
    more.  The kernels' counts are those of the engines the two calls
    built (created at 0 when the run sets up).  Returns {"launches":
    {kernel: count over both calls}, "s_per_cycle": ...}."""
    import shutil

    import torch

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    d = os.path.join(ROOT, "build", "chip_smoke_dense48")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n216_sample", "ice.input"), d)
    out = _app_calls(d, {**DENSE48, **DENSE48_CUTS}, DENSE48_CYCLES,
                     {"fused_cycle_dense": "fused_cycle",
                      "full_energy": "full_energy"})
    first, second = out
    eng, s = second["app"].engine, second["s"]
    prm = eng.prm
    W = DENSE48["n_walkers"]
    if not (eng.dense and len(eng.fold_shifts) == 3 and prm.nwater == 48
            and s.r.shape[-1] == W and s.r.dtype == torch.float32
            and not prm.samplerun):
        fail("the N=48 run did not build the dense-candidate float32 WL "
             f"engine with three folded shifts at {W} walkers")
    for run, n_cyc in zip(out, DENSE48_CYCLES):
        if run["launches"]["fused_cycle_dense"] != n_cyc:
            fail(f"N=48 run: launches {run['launches']}, expected {n_cyc} "
                 "of the dense kernel")
    if first["s"].cycle != DENSE48_CYCLES[0] or \
            second["app"].start_cycle != DENSE48_CYCLES[0] or \
            s.cycle != sum(DENSE48_CYCLES):
        fail(f"the resumed N=48 run did not continue from cycle "
             f"{DENSE48_CYCLES[0]}: started at "
             f"{second['app'].start_cycle}, ended at {s.cycle}")
    node = open(os.path.join(d, "node000.log")).read()
    glog = open(os.path.join(d, "mc.log")).read()
    n_vol = sum(int(ln.split()[5]) for ln in node.splitlines()
                if ln.endswith(" box moves"))
    need = {
        "monitor_stats with eq_adjust_mc": "# Max molecule translation",
        "check_flatness": "# Checking flatness of histogram at cycle",
        "the restart": f"# Restarting from cycle {DENSE48_CYCLES[0]} (",
    }
    for what, text in need.items():
        if text not in node + glog:
            fail(f"N=48 run: no trace of {what} in the logs")
    files = set(os.listdir(d))
    want = {"checkpoint000.npz.1", "checkpoint000.npz.2", "eta_weights.dat",
            "histogram.dat", "mW.psf", "mW.dcd", "mc.log", "node000.log",
            "ice000_therm.dat"}
    if not want <= files:
        fail(f"N=48 run: missing files {sorted(want - files)}")
    # the energy audit 5 cycles after the last chain resync (cycle 48);
    # its limit is the drift of the JAX package's own dense step here
    eng.run_cycles(s, 5)
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    # the engine's own cycle time on the host clock (the app's block
    # lines print seconds to 0.1 s), 10 cycles before the next resync
    torch.cuda.synchronize()
    t0 = time.time()
    eng.run_cycles(s, 10)
    torch.cuda.synchronize()
    s_cycle = (time.time() - t0) / 10
    eng.merged_histogram(s)
    hist = ds_value64(s.master_hist)[0]
    n, disp, tot = _block_seconds(os.path.join(d, "mc.log"))
    therm, wlmon, ckpt = _block_split(os.path.join(d, "mc.log"))
    rate = prm.nwater * W / s_cycle
    kind = torch.cuda.get_device_name(0)
    print(f"[dense48] runs/n216_sample/ice.input through run_input_file, "
          f"overrides {sorted(DENSE48)} and {sorted(DENSE48_CUTS)} (cut): "
          f"N={prm.nwater} W={W} float32, {len(eng.fold_shifts)} folded "
          f"shifts, {prm.nbins} bins", flush=True)
    print(f"[dense48] 10 more cycles: {s_cycle * 1e3:.3f} ms/cycle = "
          f"{rate:.4e} moves/s on {kind}; the app's {n} cycles over both "
          f"calls: {disp:.1f} s in the cycle loop, {tot:.1f} s with the "
          f"block events (therm {therm:.1f} s, wl/monitor {wlmon:.1f} s, "
          f"checkpoints {ckpt:.1f} s); calls {first['wall']:.1f} s and "
          f"{second['wall']:.1f} s with set-up; {n_vol} volume-move "
          f"attempts (all walkers, cycles "
          f"1-{prm.monitor_int * (sum(DENSE48_CYCLES) // prm.monitor_int)}); "
          f"launches {first['launches']} + {second['launches']}; resumed "
          f"at cycle {second['app'].start_cycle}; max_trans "
          f"{float(s.max_trans.mean()) / ANG_TO_BOHR:.4f} A (from "
          f"{prm.mc_max_trans / ANG_TO_BOHR:.4f}); audit of 64 walkers 5 "
          f"cycles after a resync: max |drift| {max_drift:.3e} Hartree "
          f"(limit {AUDIT_DENSE48_MAX_DRIFT:g}); merged histogram sum "
          f"{hist.sum():.6e} over {int((hist > 0).sum())} bins", flush=True)
    if n_vol <= 0:
        fail("N=48 run: no volume move")
    if not max_drift < AUDIT_DENSE48_MAX_DRIFT:
        fail("N=48 run: energy audit drift")
    if not (np.isfinite(hist.sum()) and hist.sum() > 0):
        fail("N=48 run: the merged histogram is empty or not finite")
    if not (abs(float(s.max_trans.mean()) - prm.mc_max_trans) > 1e-6):
        fail("N=48 run: eq_adjust_mc left max_trans as it was")
    return {"launches": {k: first["launches"][k] + second["launches"][k]
                         for k in first["launches"]},
            "s_per_cycle": s_cycle, "rate": rate}


# ----------------------------------------------------------------------
# the 'dd' mu windows: kernels against their plain versions with windows
# ----------------------------------------------------------------------

# runs/n216_sample_dd/run.py's windows (8 over the trimmed 101-bin grid,
# overlap 2 from its ice.input)
DD216_WINDOWS = dict(parallel_strategy="dd", n_windows=8, window_overlap=2)
# the dd kernel phase's states: (walkers, type) of the N=216 pair and of
# the N=8064 pair (runs/n8064_wl's 16 windows)
DD_W216 = ((16, "float64"), (W_MAIN, "float32"))
DD_W8064 = ((W_MT_FP64, "float64"), (W_MT, "float32"))
# cycles run before each compared cycle: the first compared cycle falls
# before eq_mc_cycles (switches suppressed, walkers tracked into their
# windows), the second after it (every walker in its window, walls live)
DD_EQ = 4
DD_RUNS = (2, 3)


def dd_counts(s):
    """(walkers before their window, walkers beyond their walls) of a
    'dd' state."""
    out = (s.mu < s.my_mu_min) | (s.mu > s.my_mu_max)
    return int((~s.in_window).sum()), int((s.in_window & out).sum())


def merge_repeat(eng, s):
    """The per-window delta merge of the state's per-walker histograms,
    run twice: (bitwise equal, largest relative error of the merged rows
    against a float64 sum on the host, windows).  Fails where the
    histograms hold no growth to merge."""
    import torch

    if not bool((s.hist != 0).any()):
        fail("merge check: the per-walker histograms are empty")
    got = [eng._delta_merge(s.hist, s.master_hist, s.window_id)
           for _ in range(2)]
    equal = all(torch.equal(getattr(got[0][0], f), getattr(got[1][0], f))
                for f in ("hi", "lo"))
    hist = s.hist.double().cpu().numpy()                     # [B, W]
    wid = s.window_id.cpu().numpy()
    nwin = s.master_hist.hi.shape[0]
    base = (s.master_hist.hi.double() + s.master_hist.lo.double()).cpu()
    want = base.numpy() + np.stack([hist[:, wid == w].sum(axis=1)
                                    for w in range(nwin)])
    m = got[0][0]
    have = (m.hi.double() + m.lo.double()).cpu().numpy()
    rel = float(np.max(np.abs(have - want) / np.maximum(np.abs(want), 1.0)))
    return equal, rel, nwin


def walled_increment_check(eng, s, seed):
    """The sample-run increment of a walled walker stays out of uhist
    (wl_update_at in csrc/wl_common.cuh; the f32 edge-bin fault of the
    JAX engine, engine.py:379-390 of the JAX package).  From the state
    ``s`` after the boundary (every walker in its window), every other
    walker is put just beyond its window's upper wall (the largest of
    the next 8 representable mu whose bin is still the window's end bin,
    else the next one), the rest at their window's centre; one cycle of
    translation trials that leave the displacement wall (rejected, mu
    stays) with switches shut then runs through the kernel and the plain
    version.  Returns a dict: walled walkers whose uhist grew, walled
    walkers in the grid, those whose bin is the window's edge bin, how
    many of them had their visit counted, in-window walkers whose uhist
    did not grow, and the kernel's [W] integer disagreement and relative
    uhist/hist error against the plain version."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.bins import mu_to_bin
    from mc_water_ls_mw_tpu_torch.mcmc.engine import TRANS

    st = s.clone()
    W = st.mu.shape[0]
    B = eng.grid.nbins
    walled = torch.arange(W, device=DEVICE) % 2 == 0
    cand, m = [], st.my_mu_max
    for _ in range(8):
        m = torch.nextafter(m, torch.full_like(m, float("inf")))
        cand.append(m)
    cand = torch.stack(cand)                                 # [8, W]
    in_edge = mu_to_bin(eng.grid, cand) == st.end_bin.long()[None]
    pick = torch.where(in_edge.any(dim=0),
                       7 - torch.argmax(in_edge.flip(0).to(torch.int8),
                                        dim=0), 0)
    edge = torch.gather(cand, 0, pick[None])[0]
    st.mu = torch.where(walled, edge,
                        0.5 * (st.my_mu_min + st.my_mu_max))
    st.in_window = torch.ones_like(st.in_window)
    st.max_trans = torch.full_like(st.max_trans, 1e3)        # Bohr
    for name in ("weight", "hist", "uhist"):
        setattr(st, name, torch.zeros_like(getattr(st, name)))
    _, sched, cu = kernel_draws(eng, st, seed)
    codes = torch.full((st.r.shape[2],), TRANS, dtype=torch.int64)
    sk, sp = st.clone(), st.clone()
    for x in (sk, sp):
        x.cycle += 1
    eng.fused_cycle(sk, codes, sched, cu, True, False)
    eng.fused_cycle.plain(sp, codes, sched, cu, True, False)
    torch.cuda.synchronize()
    still = (sk.acc[0] == st.acc[0]) & (sp.acc[0] == st.acc[0])
    k = mu_to_bin(eng.grid, st.mu)
    in_grid = (k >= 0) & (k < B)
    sel = walled & still & in_grid
    edge_bin = sel & (k == st.end_bin.long())
    uh_k, h_k = sk.uhist.sum(dim=0), sk.hist.sum(dim=0)
    differ = (sk.acc != sp.acc).any(dim=0) | (sk.ls != sp.ls)
    ok = ~differ
    return dict(
        walled_grew=int((sel & (uh_k != 0)).sum()), walled=int(sel.sum()),
        edge=int(edge_bin.sum()),
        edge_counted=int((edge_bin & (h_k > 0)).sum()),
        inside_flat=int((~walled & still & (uh_k <= 0)).sum()),
        inside=int((~walled & still).sum()), differ=differ,
        err=fused_max_err(sk, sp, ok, ("hist", "uhist")))


def dd_fused_checks():
    """4d: the table kernel of the fused cycle against its plain version
    on 'dd' states of runs/n216_sample_dd (8 windows, its committed
    weights, a sample run): before the equilibration boundary (walkers
    before their windows, switches shut, no WL update) and after it
    (walls live, walled walkers gated out of uhist), float64 at W=16
    (identical integers, state within 1e-10) and float32 at W=4096 (at
    most F32_MAX_DIFF_FRAC of walkers with a differing integer outcome);
    the walled-increment check and the per-window merge on the state
    after the boundary."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.engine import SWITCH

    for W, dtype in DD_W216:
        prm = sample_params(W, dtype, eq_mc_cycles=DD_EQ, mpi_sync_int=1,
                            latt_sync_int=10_000, **DD216_WINDOWS)
        eng, s = make_engine(prm, weights="n216_sample_dd")
        f64 = dtype == "float64"
        for n_run in DD_RUNS:
            eng.run_cycles(s, n_run)
            cycle = s.cycle + 1
            pre, beyond = dd_counts(s)
            draws = kernel_draws(eng, s, 20 + cycle)
            sk, sp, differ = fused_compare(eng, s, draws)
            frac = float(differ.float().mean())
            ok = ~differ
            err = fused_max_err(sk, sp, ok, None if f64 else
                                ("r", "moments", "energy", "mu"))
            sw_att = int((sk.att[2] - s.att[2]).sum())
            n_sw = int((draws[0] == SWITCH).sum())
            n_acc = int((sk.acc[0] - s.acc[0]).sum())
            print(f"[dd-fused] {dtype} W={W} cycle {cycle} (eq_mc_cycles "
                  f"{DD_EQ}, switch_ok {eng._switch_ok(cycle)}): {pre} "
                  f"walkers before their window, {beyond} beyond their "
                  f"walls; {int(differ.sum())} walkers differ "
                  f"({frac:.4%}), on the rest relative state err "
                  f"{err:.3e}; {n_acc} accepted translations, {sw_att} "
                  f"switch attempts ({n_sw} scheduled switches)",
                  flush=True)
            if not f64:
                fused_err_trace("dd-fused-trace", eng, s, draws, sk, sp, ok,
                                ("r", "moments", "energy", "mu"))
            if n_acc == 0:
                fail("dd fused_cycle: no translation accepted")
            if f64:
                if differ.any() or not err <= 1e-10:
                    fail("fused_cycle fp64 with windows disagrees with its "
                         "plain version")
            elif frac > F32_MAX_DIFF_FRAC:
                fail("fused_cycle f32 with windows differs from its plain "
                     "version on too many walkers")
            if cycle < DD_EQ:
                if pre == 0 or sw_att != 0:
                    fail(f"dd state before the boundary: {pre} walkers "
                         f"before their window, {sw_att} switch attempts")
            elif beyond == 0 or sw_att == 0 or pre != 0:
                fail(f"dd state after the boundary: {pre} walkers before "
                     f"their window, {beyond} beyond their walls, {sw_att} "
                     "switch attempts")
        wc = walled_increment_check(eng, s, 41)
        print(f"[dd-fused] {dtype} W={W} walled increments: {wc['walled']} "
              f"walled walkers in the grid ({wc['edge']} in their window's "
              f"end bin, {wc['edge_counted']} of them counted in hist), "
              f"{wc['walled_grew']} with uhist growth (must be 0); "
              f"{wc['inside_flat']} of {wc['inside']} walkers in their "
              f"window without uhist growth; kernel vs plain: "
              f"{int(wc['differ'].sum())} walkers differ, hist/uhist "
              f"relative err {wc['err']:.3e}", flush=True)
        if wc["walled"] == 0 or wc["walled_grew"] != 0 \
                or wc["inside_flat"] != 0:
            fail("a walled walker's sample-run increment reached uhist, or "
                 "an in-window walker's did not")
        if (f64 and (wc["differ"].any() or not wc["err"] <= 1e-10)) or (
                not f64 and (float(wc["differ"].float().mean())
                             > F32_MAX_DIFF_FRAC or not wc["err"] <= 1e-5)):
            fail("the walled-increment cycle disagrees with the plain "
                 "version")
        equal, rel, nwin = merge_repeat(eng, sk)
        print(f"[dd-fused] {dtype} W={W} per-window merge over {nwin} "
              f"windows: repeat bitwise equal {equal}, relative err "
              f"{rel:.3e} against a float64 host sum", flush=True)
        if not equal or not rel <= (1e-12 if f64 else 1e-6):
            fail("the per-window delta merge is not repeatable or wrong")
        del eng, s, sk, sp
        torch.cuda.empty_cache()


def dd_cell_params(W, dtype, **over):
    """runs/n8064_wl at W walkers (16 windows, overlap 2, 201 bins over mu
    in [-90000, 90000], cell_trials 8, 0.10 A steps, its wl_factor), one
    volume move per cycle on average."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    keep = ("parallel_strategy", "n_windows", "window_overlap", "mu_min",
            "mu_max", "nbins", "cell_trials", "wl_factor")
    return cell_params(W, dtype, **{
        **{k: N8064_WL[k] for k in keep},
        "mc_max_trans": N8064_WL["mc_max_trans"] * ANG_TO_BOHR, **over})


def dd_cell_checks():
    """4d: the multi-trial sub-step's kernels (mover points, chain + WL,
    mover apply) against their plain versions on 'dd' states of
    runs/n8064_wl (16 windows, T=8), before the equilibration boundary
    (switches shut, no WL update, walkers before their windows) and
    after it (walls live), float64 at W=16 and float32 at W=128, with
    the gates of phase 8; the per-window merge on the state after the
    boundary.  Cycles cut to one sweep."""
    import torch

    for W, dtype in DD_W8064:
        f64 = dtype == "float64"
        # delta-syncs at cycles 2 and 4: the state after cycle 5 holds a
        # cycle's growth for the merge check
        eng, s = make_cell_engine(dd_cell_params(
            W, dtype, eq_mc_cycles=DD_EQ, list_update_int=1,
            mpi_sync_int=2))
        eng.sweeps_per_cycle = 1
        eng.trials_per_cycle = eng.n_tables * eng.K * eng.T
        for n_run in DD_RUNS:
            eng.run_cycles(s, n_run)
            cycle = s.cycle + 1
            pre, beyond = dd_counts(s)
            cmp = multitrial_compare(eng, s, 5, seed=600 + cycle)
            mp, ch = cmp["mover_points"], cmp["chain_wl"]
            ma = multitrial_apply_compare(eng, s, 5, seed=700 + cycle,
                                          mode="chain")
            frac = float(ch["differ"].float().mean())
            print(f"[dd-cell] {dtype} W={W} T={eng.T} cycle {cycle} "
                  f"(switch_ok {eng._switch_ok(cycle)}): {pre} walkers "
                  f"before their window, {beyond} beyond their walls; "
                  f"points energies err {mp['e_err']:.3e}, own moments err "
                  f"{mp['own_err']:.3e}, repeat bitwise equal "
                  f"{mp['repeat_equal']}; chain: {int(ch['differ'].sum())}"
                  f" walkers differ ({frac:.4%}), rows err "
                  f"{ch['cf_err']:.3e} (relative {ch['cf_rel']:.3e}), WL "
                  f"slabs err {ch['wl_err']:.3e} (relative "
                  f"{ch['wl_rel']:.3e}), {ch['n_acc']} of "
                  f"{ch['n_enabled']} trials accepted, {ch['n_sw']} switch "
                  f"attempts; apply: moment rows err {ma['mom_err']:.3e}, "
                  f"other rows equal {ma['rest_equal']}", flush=True)
            tol = 1e-10 if f64 else F32_MOVER_MOM_ATOL
            if not (mp["e_err"] <= (1e-10 if f64 else F32_MOVER_E_ATOL)
                    and mp["own_err"] <= tol and mp["repeat_equal"]):
                fail(f"mover_points {dtype} with windows disagrees with "
                     "its plain version")
            if f64:
                if ch["differ"].any() or not (ch["cf_err"] <= 1e-10
                                              and ch["wl_err"] <= 1e-10):
                    fail("chain_wl fp64 with windows disagrees with its "
                         "plain version")
            elif frac > F32_MAX_DIFF_FRAC or not (
                    ch["cf_rel"] <= F32_CHAIN_RTOL
                    and ch["wl_rel"] <= F32_CHAIN_RTOL):
                fail("chain_wl f32 with windows disagrees with its plain "
                     "version")
            if not (0 < ch["n_acc"] < ch["n_enabled"]):
                fail("chain_wl with windows: no trial or every trial "
                     "accepted")
            if not (ma["mom_err"] <= tol and ma["rest_equal"]):
                fail(f"mover_apply {dtype} with windows disagrees with its "
                     "plain version")
            if cycle < DD_EQ:
                if pre == 0 or ch["n_sw"] != 0:
                    fail(f"dd cell state before the boundary: {pre} walkers"
                         f" before their window, {ch['n_sw']} switch "
                         "attempts")
            elif pre != 0 or ch["n_sw"] == 0 or ch["hist_grew"] <= 0:
                fail(f"dd cell state after the boundary: {pre} walkers "
                     f"before their window, {ch['n_sw']} switch attempts, "
                     f"histogram growth {ch['hist_grew']}")
        equal, rel, nwin = merge_repeat(eng, s)
        print(f"[dd-cell] {dtype} W={W} per-window merge over {nwin} "
              f"windows: repeat bitwise equal {equal}, relative err "
              f"{rel:.3e} against a float64 host sum", flush=True)
        if not equal or not rel <= (1e-12 if f64 else 1e-6):
            fail("the per-window delta merge is not repeatable or wrong")
        del eng, s
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# 5d: runs/n216_sample_dd through the port's run_input_file
# ----------------------------------------------------------------------

# the overrides of runs/n216_sample_dd/run.py (its WL_QTIME default)
DD216 = dict(
    stack=(3, 3, 6), n_walkers=4096, n_windows=8, mu_min=-700.0,
    mu_max=700.0, nbins=101, samplerun=True, eq_mc_cycles=1000,
    mpi_sync_int=50, monitor_int=5000, flat_chk_int=100_000_000,
    deltaG_int=10000, chkpt_dump_int=25000, timer_qtime=11400.0,
    timer_closetime=420, max_mc_cycles=100_000_000,
)
# what the smoke run cuts, to fit monitor_stats, Delta G dumps and a
# checkpoint into 1200 + 300 cycles (the run's own values in the
# comments); eq_mc_cycles stays 1000
DD216_CUTS = dict(
    monitor_int=500,            # 5000
    deltaG_int=250,             # 10000 (dumps at 1000, 1250, 1500)
    chkpt_dump_int=1000,        # 25000
)
DD216_CYCLES = (1200, 300)      # first call, resumed call


def dd216_run():
    """Drive runs/n216_sample_dd (4096 walkers over 8 windows, float32,
    its committed eta_weights.dat) through the port's run_input_file in
    build/chip_smoke_dd216: DD216_CYCLES[0] cycles across the
    equilibration boundary at 1000, then a second call that resumes from
    the checkpoint for DD216_CYCLES[1] more.  Returns {"launches": {kernel: count over
    both calls}}."""
    import shutil

    import torch

    from mc_water_ls_mw_tpu_torch import app as app_mod
    from mc_water_ls_mw_tpu_torch.mcmc.wanglandau import deltaG_from_uhist
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64
    from mc_water_ls_mw_tpu_torch.parallel.windows import join_uhist

    boundary = {}

    class AtBoundary(app_mod.Application):
        """The Application, with each window's walkers in their window
        at the boundary."""

        def _check_windows(self, cycle):
            if cycle == self.prm.eq_mc_cycles:
                s = self.state
                boundary["in"] = torch.bincount(
                    s.window_id[s.in_window].long(),
                    minlength=s.master_eta.hi.shape[0]).tolist()
            return super()._check_windows(cycle)

    d = os.path.join(ROOT, "build", "chip_smoke_dd216")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for name in ("ice.input", "eta_weights.dat"):
        shutil.copy(os.path.join(ROOT, "runs", "n216_sample_dd", name), d)
    out = _app_calls(d, {**DD216, **DD216_CUTS}, DD216_CYCLES,
                     {"fused_cycle": "fused_cycle",
                      "full_energy": "full_energy"}, base=AtBoundary)
    first, second = out
    eng, s = second["app"].engine, second["s"]
    prm = eng.prm
    W = DD216["n_walkers"]
    nwin = s.master_eta.hi.shape[0]
    if not (eng.fused_cycle.kernel == "fused_cycle" and prm.samplerun
            and prm.parallel_strategy == "dd" and nwin == DD216["n_windows"]
            and s.r.shape[-1] == W and s.r.dtype == torch.float32):
        fail("the dd N=216 run did not build the table-mode float32 sample "
             f"run over {DD216['n_windows']} windows at {W} walkers")
    for run, n_cyc in zip(out, DD216_CYCLES):
        if run["launches"]["fused_cycle"] != n_cyc:
            fail(f"dd N=216 run: launches {run['launches']}, expected "
                 f"{n_cyc} of the fused cycle")
    if first["s"].cycle != DD216_CYCLES[0] or \
            second["app"].start_cycle != DD216_CYCLES[0] or \
            s.cycle != sum(DD216_CYCLES):
        fail(f"the resumed dd N=216 run did not continue from cycle "
             f"{DD216_CYCLES[0]}: started at {second['app'].start_cycle}, "
             f"ended at {s.cycle}")
    node = open(os.path.join(d, "node000.log")).read()
    glog = open(os.path.join(d, "mc.log")).read()
    for what, text in {
            "the per-window monitor rows": "# window  walkers in-win",
            "the restart": f"# Restarting from cycle {DD216_CYCLES[0]} (",
            "a Delta G estimate": "# Estimate of delta G from histogram",
    }.items():
        if text not in node + glog:
            fail(f"dd N=216 run: no trace of {what} in the logs")
    files = set(os.listdir(d))
    dumps = sorted(f for f in files if f.startswith("uhist_windows_"))
    want = {"checkpoint000.npz.1", "checkpoint000.npz.2", "eta_weights.dat",
            "unbiased_histogram.dat", "mc.log", "node000.log"} | {
                f"{k}_{w:03d}.dat" for w in range(nwin)
                for k in ("eta_weights", "histogram",
                          "unbiased_histogram")}
    if not want <= files or len(dumps) < 3 or not all(
            f.replace("uhist", "hist") in files for f in dumps):
        fail(f"dd N=216 run: missing files {sorted(want - files)} or "
             f"per-window dumps {dumps}")
    stitched = np.loadtxt(os.path.join(d, "unbiased_histogram.dat"),
                          skiprows=1)
    u_rows = ds_value64(eng.merged_histogram(s).master_uhist)   # [nwin, B]
    dg = deltaG_from_uhist(prm, eng.grid, join_uhist(
        u_rows, eng.grid.nbins, prm.window_overlap))
    logged = [float(ln.split("=")[1].split()[0]) for ln in glog.splitlines()
              if ln.startswith("# G(lattice2) - G(lattice1)")
              and "J/mole" in ln]
    inside = (s.mu > s.my_mu_min) & (s.mu < s.my_mu_max)
    per_win = torch.bincount(s.window_id[inside].long(),
                             minlength=nwin).tolist()
    n, disp, tot = _block_seconds(os.path.join(d, "mc.log"))
    rate = prm.nwater * W * n / disp
    kind = torch.cuda.get_device_name(0)
    print(f"[dd216] runs/n216_sample_dd through run_input_file, overrides "
          f"{sorted(DD216)} with {sorted(DD216_CUTS)} cut: N={prm.nwater} "
          f"W={W} float32, {nwin} windows, {prm.nbins} bins, "
          f"eq_mc_cycles {prm.eq_mc_cycles}", flush=True)
    print(f"[dd216] {n} cycles over both calls: {disp / n * 1e3:.3f} "
          f"ms/cycle in the cycle loop ({tot / n * 1e3:.3f} ms/cycle with "
          f"the block events) = {rate:.4e} moves/s on {kind}; calls "
          f"{first['wall']:.1f} s and {second['wall']:.1f} s with set-up; "
          f"launches {first['launches']} + {second['launches']}; resumed "
          f"at cycle {second['app'].start_cycle}; walkers in their window "
          f"at the boundary (cycle {prm.eq_mc_cycles}) per window "
          f"{boundary.get('in')}, inside their window's bounds at cycle "
          f"{s.cycle} per window {per_win}; unbiased histogram per window "
          f"{[float(x) for x in u_rows.sum(axis=1)]}; stitched Delta G "
          f"{dg and dg['J_per_mol']} J/mol (logged at the last dump "
          f"{logged[-1] if logged else None} J/mol; {len(dumps)} per-window "
          "dumps; a smoke value, not converged)", flush=True)
    if min(per_win) <= 0 or not (u_rows.sum(axis=1) > 0).all():
        fail("dd N=216 run: a window is empty")
    if dg is None or not all(np.all(np.isfinite(v)) for v in dg.values()) \
            or not logged or not np.isfinite(logged[-1]):
        fail(f"dd N=216 run: the stitched Delta G is not finite: {dg}")
    if not np.isfinite(stitched).all() or stitched[:, 1].sum() <= 0:
        fail("dd N=216 run: the stitched unbiased_histogram.dat is not "
             "finite")
    return {"launches": {k: first["launches"][k] + second["launches"][k]
                         for k in first["launches"]}}


def scatter_phase():
    """6b: the scatter path's kernels against their plain versions in
    float64 on the (12,7,18) pair (scatter_substep_compare at two
    tables after a cycle of sampling)."""
    import torch

    eng, s = make_cell_engine(cell_params(
        W_CELL_FP64, "float64", stack=SCATTER_STACK, cell_pallas="auto",
        cell_chain="auto", list_update_int=1, mpi_sync_int=1))
    require_scatter_modes(eng)
    eng.run_cycles(s, 1)            # walkers drift apart, WL slabs fill
    for tbl in (5, 42):
        cmp = scatter_substep_compare(eng, s, tbl, seed=500 + tbl)
        d, ch, sub = (cmp[k] for k in ("mover_energies_deltas", "chain_wl",
                                       "substep"))
        print(f"[scatter] fp64 N={eng.prm.nwater} W={W_CELL_FP64} table "
              f"{tbl}: energies err {d['e_err']:.3e} Hartree (max |dE| "
              f"{d['dE_max']:.3e}), own moments err {d['own_err']:.3e}, "
              f"deltas err {d['dlt_err']:.3e} ({d['n_dlt']} nonzero slots); "
              f"chain: {int(ch['differ'].sum())} walkers differ, rows err "
              f"{ch['cf_err']:.3e}, WL slabs err {ch['wl_err']:.3e}; "
              f"sub-step: {int(sub['differ'].sum())} walkers differ, slab "
              f"moment rows err {sub['mom_err']:.3e}, coordinates err "
              f"{sub['coord_err']:.3e}, chain rows rel err "
              f"{sub['cf_rel']:.3e}, WL slabs rel err {sub['wl_rel']:.3e}, "
              f"{sub['n_acc']} of {sub['n_enabled']} trials accepted, "
              f"{sub['changed']} slab entries changed, repeated run "
              f"bitwise equal {sub['repeat_equal']}", flush=True)
        if not (d["e_err"] <= 1e-10 and d["own_err"] <= 1e-10
                and d["dlt_err"] <= 1e-10 and d["dE_max"] > 0
                and d["n_dlt"] > 0):
            fail("mover_energies_deltas fp64 disagrees with its plain "
                 "version")
        if ch["differ"].any() or not (ch["cf_err"] <= 1e-10
                                      and ch["wl_err"] <= 1e-10):
            fail("chain_wl fp64 at K=8, CF=75 disagrees with its plain "
                 "version")
        if sub["differ"].any() or not (
                sub["mom_err"] <= 1e-10 and sub["coord_err"] <= 1e-10
                and sub["cf_rel"] <= 1e-10 and sub["wl_rel"] <= 1e-10
                and 0 < sub["n_acc"] < sub["n_enabled"]
                and sub["changed"] > 0):
            fail("the fp64 scatter sub-step disagrees with its plain "
                 "versions")
        if not sub["repeat_equal"]:
            fail("the scatter sub-step is not deterministic")


def on_apply_phase():
    """6c: 'on' against 'apply' on the N=8064 grid, where both run
    (disjoint stencils): one cycle each from one seed, float64."""
    import torch

    ends = {}
    for mode in ("on", "apply"):
        eng, s = make_cell_engine(cell_params(
            W_CELL_FP64, "float64", cell_pallas=mode, list_update_int=1,
            mpi_sync_int=1))
        eng.run_cycles(s, 1)
        ends[mode] = s
    ints_equal, names, err = state_diff(ends["on"], ends["apply"])
    print(f"[on-apply] fp64 N=8064 W={W_CELL_FP64}, one cycle: integer "
          f"state equal {ints_equal} {names}; continuous state max abs "
          f"diff {err:.3e}; accepted {ends['on'].acc[0].sum().item()} "
          "translations", flush=True)
    if not (ints_equal and err <= 1e-10):
        fail("'on' and 'apply' disagree on the disjoint grid")


def flagship_run(kind, card):
    """7b: the N=24192 flagship on the grid the front end gives it, on
    the scatter path (kernels 3b and 6 at K=32, CF=75).  Returns
    {"launches": of its main path, "report": the delta kernel's line}."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    prm = cell_params(W_FLAG, "float32", stack=FLAG_STACK,
                      cell_pallas="auto", cell_chain="auto", **FLAG_CUTS)
    t0 = time.time()
    eng, s = make_cell_engine(prm)
    torch.cuda.synchronize()
    cg = eng.cellgrid
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    mu0 = float(s.mu[0])
    print(f"[flagship] N={prm.nwater} W={W_FLAG} f32: coarse {cg.n} "
          f"m={cg.m} nfine={cg.nfine} cap={cg.cap} "
          f"CF={cg.full_cells.shape[1]} K={eng.K} tables={eng.n_tables} "
          f"sweeps={eng.sweeps_per_cycle} sub-steps/cycle={n_sub} "
          f"trials/cycle={eng.trials_per_cycle}; cell_pallas="
          f"'{prm.cell_pallas}' -> use_cell_pallas {eng.use_cell_pallas}, "
          f"use_cell_apply {eng.use_cell_apply} ('on': deltas + scatter), "
          f"cell_chain='{prm.cell_chain}' -> use_chain_kernel "
          f"{eng.use_chain_kernel}; mu0 {mu0:.6e} in [{prm.mu_min:g}, "
          f"{prm.mu_max:g}]; init {time.time() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    if not (cg.n == (8, 8, 4) and cg.full_cells.shape[1] == 75
            and eng.K == 32):
        fail(f"the flagship's grid is not (8,8,4) x 2^3 with CF=75: {cg.n}")
    require_scatter_modes(eng)
    if not prm.mu_min < mu0 < prm.mu_max:
        fail(f"the flagship's starting mu {mu0} is outside the bin range")
    t0 = time.time()
    eng.run_cycles(s, 1)                     # warm-up (WL live from here)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    t0 = time.time()
    cmp = scatter_substep_compare(eng, s, 5, seed=9, time_reps=10)
    d, ch, sub = (cmp[k] for k in ("mover_energies_deltas", "chain_wl",
                                   "substep"))
    bound = mover_energies_bound(eng, s, d, deltas=True)
    frac = float(sub["differ"].float().mean())
    print(f"[flagship] f32: energies err {d['e_err']:.3e} Hartree (limit "
          f"{F32_MOVER_E_ATOL:g}), own moments err {d['own_err']:.3e}, "
          f"deltas err {d['dlt_err']:.3e} (limit {F32_MOVER_MOM_ATOL:g}); "
          f"{d['n_in']} neighbour slots in range, {d['n_dlt']} nonzero "
          f"delta slots; chain at K={eng.K} on the kernel's energies: "
          f"{float(ch['differ'].float().mean()):.4%} of walkers differ, on "
          f"the rest rows rel err {ch['cf_rel']:.3e}, WL slabs rel err "
          f"{ch['wl_rel']:.3e} (limit {F32_CHAIN_RTOL:g}); sub-step: "
          f"{frac:.4%} of walkers differ (limit {F32_MAX_DIFF_FRAC:.0%}), "
          f"on the rest slab moment rows err {sub['mom_err']:.3e}, "
          f"coordinates err {sub['coord_err']:.3e}, chain rows rel err "
          f"{sub['cf_rel']:.3e} (from the energies' round-off), WL slabs "
          f"rel err {sub['wl_rel']:.3e}; {sub['n_acc']} of "
          f"{sub['n_enabled']} trials accepted; repeated run bitwise equal "
          f"{sub['repeat_equal']}; {time.time() - t0:.1f} s", flush=True)
    if not (d["e_err"] <= F32_MOVER_E_ATOL
            and d["own_err"] <= F32_MOVER_MOM_ATOL
            and d["dlt_err"] <= F32_MOVER_MOM_ATOL and d["dE_max"] > 0):
        fail("mover_energies_deltas f32 disagrees with its plain version")
    if (float(ch["differ"].float().mean()) > F32_MAX_DIFF_FRAC
            or not (ch["cf_rel"] <= F32_CHAIN_RTOL
                    and ch["wl_rel"] <= F32_CHAIN_RTOL
                    and 0 < ch["n_acc"] < ch["n_enabled"])):
        fail("chain_wl f32 at K=32 disagrees with its plain version")
    if frac > F32_MAX_DIFF_FRAC or not (
            sub["mom_err"] <= F32_MOVER_MOM_ATOL and sub["coord_err"] == 0.0
            and sub["wl_rel"] <= F32_CHAIN_RTOL
            and 0 < sub["n_acc"] < sub["n_enabled"]):
        fail("the f32 scatter sub-step disagrees with its plain versions")
    if not sub["repeat_equal"]:
        fail("the f32 scatter sub-step is not deterministic")
    line = dict(max_abs_err=max(d["e_err"], d["dlt_err"]), ms=d["ms"],
                plain_ms=d["plain_ms"], bound_ms=bound[0], bound_by=bound[1])
    print(f"[flagship] mover_energies_deltas f32 W={W_FLAG}: kernel "
          f"{d['ms']:.4f} ms/launch, plain {d['plain_ms']:.3f} ms, bound "
          f"{bound[0]:.6f} ms ({bound[1]}); the scatter of one sub-step "
          f"(_scatter_moments, both lattices) {d['scatter_ms']:.4f} ms",
          flush=True)
    cbound = chain_bound(eng, W_FLAG, s.r.element_size(), 2,
                         ch["n_enabled"])
    chain_line = dict(max_abs_err=max(ch["cf_err"], ch["wl_err"]),
                      ms=ch["ms"], plain_ms=ch["plain_ms"],
                      bound_ms=cbound[0], bound_by=cbound[1],
                      **occupancy_keys(eng.chain_kernel.occupancy(
                          s.r.dtype, W_FLAG)))
    print(f"[flagship] chain_wl f32 W={W_FLAG} K={eng.K}: kernel "
          f"{ch['ms']:.4f} ms/launch, plain {ch['plain_ms']:.3f} ms, bound "
          f"{cbound[0]:.6f} ms ({cbound[1]}); {occupancy_text(chain_line)}",
          flush=True)
    del cmp, d, sub

    flag_kernels = {"mover_energies_deltas": eng.mover_kernel,
                    "chain_wl": eng.chain_kernel}
    for k in flag_kernels.values():
        k.launches = 0
    att0 = s.att.clone()
    t0 = time.time()
    s, samples = eng.run_cycles(s, FLAG_TIMED)   # cycles 2-3: rebin and
    torch.cuda.synchronize()                     # sync at 2, resync at 3
    elapsed = time.time() - t0
    flag_launches = {n: k.launches for n, k in flag_kernels.items()}
    att = (s.att - att0).sum(dim=1).tolist()
    acc_frac = [a / max(t, 1) for a, t in zip(s.acc.sum(dim=1).tolist(),
                                              s.att.sum(dim=1).tolist())]
    overflow = int(s.occ_overflow.max())
    print(f"[flagship-main] N={prm.nwater} W={W_FLAG} f32: warm-up cycle "
          f"{warm_s:.3f} s; {FLAG_TIMED} cycles in {elapsed:.3f} s = "
          f"{elapsed / FLAG_TIMED:.3f} s/cycle = "
          f"{eng.trials_per_cycle * W_FLAG * FLAG_TIMED / elapsed:.4e} "
          f"trials/s on {kind} ({card}); launches {flag_launches}; attempts "
          f"trans/vol/switch {att} (all walkers), accepted {acc_frac}; "
          f"occ_overflow {overflow}; dropped {int(s.dropped)}", flush=True)
    if set(flag_launches.values()) != {FLAG_TIMED * n_sub}:
        fail(f"the flagship's kernels were not launched once per sub-step: "
             f"{flag_launches}")
    if att[1] <= 0:
        fail("no volume move fell into the flagship's timed cycles")
    if overflow != 0:
        fail(f"flagship slab overflow {overflow}")
    if not torch.isfinite(samples["E_ls"]).all():
        fail("non-finite therm samples of the flagship")
    profile_cell_cycle(eng, s, tag="flag-profile")       # cycle 4
    t0 = time.time()
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    eng.merged_histogram(s)
    hist = ds_value64(s.master_hist)[0]
    print(f"[flagship-main] audit of 64 walkers one cycle after a resync: "
          f"max |drift| {max_drift:.3e} Hartree (limit "
          f"{AUDIT_FLAG_MAX_DRIFT:g}); merged histogram sum "
          f"{hist.sum():.6e} over {int((hist > 0).sum())} bins; "
          f"{time.time() - t0:.1f} s", flush=True)
    if not max_drift < AUDIT_FLAG_MAX_DRIFT:
        fail("flagship energy audit drift")
    if not (np.isfinite(hist.sum()) and hist.sum() > 0):
        fail("the flagship's merged histogram is empty or not finite")
    return {"launches": flag_launches, "report": line, "chain": chain_line}


# ----------------------------------------------------------------------
# round 5's walls, the unfused sub-step and its XLA chains
# ----------------------------------------------------------------------

VOL_WALL = 0.04                 # mc_vol_wall of phase 5e
VOL_SCALE = 1.1                 # the outside walkers' volume / Vref
VOL_WALL_CYCLES = 50
VOL_TOL = 1e-6                  # float32 round-off of a volume ratio


def vol_wall_phase():
    """5e: the volume wall's inward ratchet on the N=216 main path's
    engine (W=4096, float32, mc_vol_wall=0.04): every fourth walker's
    boxes scaled to 1.1 Vref at fixed fractional coordinates (as
    tests/test_vol_wall.py does), their whole-cell energies from the
    kernel held against its plain version and written into the state,
    an audit of 64 walkers, then VOL_WALL_CYCLES cycles checked one by
    one: no walker inside the wall leaves it, and an outside walker
    comes inside or moves no farther out.  Returns {"launches": the
    whole-cell energy kernel's}."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.geometry import determinant3

    W = W_MAIN
    prm = sample_params(W, "float32", mc_vol_wall=VOL_WALL, mpi_sync_int=5,
                        latt_sync_int=10, eq_mc_cycles=0)
    eng, s = make_engine(prm)
    sel = torch.arange(W, device=DEVICE) % 4 == 0
    lin = VOL_SCALE ** (1.0 / 3.0)
    for name, fac in (("h", lin), ("r", lin), ("ref_r", lin),
                      ("recip", 1.0 / lin), ("volume", VOL_SCALE)):
        t = getattr(s, name)
        t[..., sel] = t[..., sel] * fac
    eng.full_energy.launches = 0
    e_err = m_err = 0.0
    for l in range(2):
        e_k, m_k = eng.full_energy(s.r[l], s.h[l])
        e_p, m_p = eng.full_energy.plain(s.r[l], s.h[l])
        e_err = max(e_err, _max_abs(e_k[sel], e_p[sel], relative=True))
        m_err = max(m_err, _max_abs(torch.stack(list(m_k))[..., sel],
                                    torch.stack(list(m_p))[..., sel]))
    s.energy, s.moments = eng._vol_energy(s, s.r, s.h)
    s.mu = eng._mu_scratch(s.energy, s.volume)
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    vref = torch.abs(torch.stack([determinant3(eng.ref_h[l][:, :, None])[0]
                                  for l in range(2)])).double()

    def where_():
        ratio = s.volume.double() / vref[:, None]
        inside = ((ratio >= 1 - VOL_WALL - VOL_TOL)
                  & (ratio <= 1 + VOL_WALL + VOL_TOL)).all(dim=0)
        return inside, torch.abs(torch.log(ratio)).sum(dim=0)

    inside, dist = where_()
    out0 = ~inside
    d_start = float(dist[out0].mean())
    left = rose = 0
    att0, acc0 = s.att[1].clone(), s.acc[1].clone()
    t0 = time.time()
    for _ in range(VOL_WALL_CYCLES):
        eng.run_cycles(s, 1)
        inside1, dist1 = where_()
        left += int((inside & ~inside1).sum())
        rose += int((~inside & ~inside1 & (dist1 > dist + VOL_TOL)).sum())
        inside, dist = inside1, dist1
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    n_in = int((out0 & inside).sum())
    att, acc = s.att[1] - att0, s.acc[1] - acc0
    print(f"[vol-wall] N=216 W={W} f32, mc_vol_wall {VOL_WALL}: "
          f"{int(out0.sum())} walkers scaled to {VOL_SCALE} Vref; "
          f"full_energy on their boxes: E rel err {e_err:.3e} (limit "
          f"{F32_E_RTOL:g}), moments err {m_err:.3e} (limit "
          f"{F32_MOM_ATOL:g}); audit of 64 walkers max |drift| "
          f"{max_drift:.3e} Hartree (limit {AUDIT_MAX_DRIFT:g})", flush=True)
    print(f"[vol-wall] {VOL_WALL_CYCLES} cycles in {elapsed:.3f} s: volume "
          f"moves accepted {int(acc[~out0].sum())} of {int(att[~out0].sum())}"
          f" (walkers inside), {int(acc[out0].sum())} of "
          f"{int(att[out0].sum())} (outside); inside walkers that left "
          f"{left} (must be 0), outside walkers whose sum |ln(V/Vref)| rose "
          f"{rose} (must be 0); outside walkers' mean sum |ln(V/Vref)| "
          f"{d_start:.6f} -> {float(dist[out0].mean()):.6f}, {n_in} of "
          f"{int(out0.sum())} now inside; full_energy launches "
          f"{eng.full_energy.launches}", flush=True)
    if not (e_err <= F32_E_RTOL and m_err <= F32_MOM_ATOL):
        fail("full_energy disagrees with its plain version on boxes "
             "outside the volume wall")
    if not max_drift < AUDIT_MAX_DRIFT:
        fail("vol-wall: energy audit drift")
    if left or rose or not float(dist[out0].mean()) < d_start:
        fail("the volume wall let a walker out, or did not ratchet the "
             "outside walkers inward")
    n = eng.full_energy.launches
    del eng, s
    torch.cuda.empty_cache()
    return {"launches": {"full_energy": n}}


TRANS_WALL = 0.4                # cell_trans_wall of phase 8b, Bohr
TRANS_WALL_TOL = {"float64": 1e-9, "float32": 1e-4}   # Bohr


def max_displacement(eng, s):
    """Largest minimum-image displacement (Bohr) of any molecule of any
    walker from its lattice-1 reference site (CellAux.fref0), in
    float64."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.geometry import from_frac, to_frac

    mol = torch.clamp(s.slot2mol, min=0).long()
    fd = to_frac(s.recip[0].double()[:, :, None, :], s.r[0].double()) \
        - eng.cellaux.fref0.double()[:, mol]
    fd = fd - torch.round(fd)
    dsp = from_frac(s.h[0].double()[:, :, None, :], fd)
    d = torch.sqrt(torch.sum(dsp * dsp, dim=0))
    return float(torch.where(s.slot2mol >= 0, d, 0.0).max())


def wall_share(eng, s, tbl, seed):
    """Share of the trial points of one proposal of table row ``tbl``
    (the engine's own, from uniforms of ``seed``) that the displacement
    wall rejects, over the (mover, walker) pairs that hold a mover."""
    import torch

    K, T, W = eng.K, eng.T, s.r.shape[-1]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    if T == 1:
        u = torch.rand((7, K, W), generator=gen, dtype=s.r.dtype,
                       device=DEVICE)
        trial = eng._propose_t1(s, pks, tbl, u, rows)
        pts = trial.p_new[0]                               # [3,K,W]
    else:
        u = torch.rand((4 + 3 * T, K, W), generator=gen, dtype=s.r.dtype,
                       device=DEVICE)
        trial = eng._propose_tm(s, pks, tbl, u, rows)
        pts = trial.pts[1:, 0].transpose(0, 1)             # [3,T,K,W]
    mol = torch.gather(s.slot2mol, 0, trial.slot)
    ok = eng._in_trans_wall(s, pts, mol)
    real = (trial.hasm > 0.5).expand_as(ok)
    return float((~ok & real).sum()) / max(1, int(real.sum()))


def trans_wall_phase():
    """8b: the displacement wall (cell_trans_wall = TRANS_WALL) on the
    N=8064 pair, after a cycle of sampling under it: the share of a
    proposal's points it rejects (must be above 0), the largest
    displacement from the reference sites (within the wall), and one
    sub-step's kernels against their plain versions with the gates of
    phases 6 (T=1) and 8 (T=8), in float64 at W=16 and float32 at
    W=128."""
    import torch

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    for T in (1, MT_TRIALS):
        for Wt, dtype in ((W_MT_FP64, "float64"), (W_MT, "float32")):
            f64 = dtype == "float64"
            over = dict(cell_trans_wall=TRANS_WALL, list_update_int=1,
                        mpi_sync_int=1)
            if T > 1:
                over.update(cell_trials=T, mc_max_trans=0.10 * ANG_TO_BOHR)
            eng, s = make_cell_engine(cell_params(Wt, dtype, **over))
            eng.run_cycles(s, 1)
            dmax = max_displacement(eng, s)
            share = wall_share(eng, s, 5, seed=600 + T)
            if T == 1:
                cmp = cell_substep_compare(eng, s, 5, seed=610)
                me, ch = cmp["mover_energies"], cmp["chain_wl"]
                ma = cmp["mover_apply"]
                e_err, own_err = me["e_err"], me["own_err"]
                extra = (f"apply moment rows err {ma['mom_err']:.3e}, "
                         f"other rows equal {ma['rest_equal']}")
                apply_ok = ma["rest_equal"] and ma["mom_err"] <= (
                    1e-10 if f64 else F32_MOVER_MOM_ATOL)
            else:
                cmp = multitrial_compare(eng, s, 5, seed=620)
                me, ch = cmp["mover_points"], cmp["chain_wl"]
                e_err, own_err = me["e_err"], me["own_err"]
                extra = f"points repeat equal {me['repeat_equal']}"
                apply_ok = me["repeat_equal"]
            frac = float(ch["differ"].float().mean())
            print(f"[trans-wall] {dtype} W={Wt} T={T}, cell_trans_wall "
                  f"{TRANS_WALL} Bohr: {share:.4%} of a proposal's trial "
                  f"points beyond the wall; largest displacement after a "
                  f"cycle {dmax:.6f} Bohr; energies err {e_err:.3e}, own "
                  f"moments err {own_err:.3e}; chain {int(ch['differ'].sum())}"
                  f" walkers differ ({frac:.4%}), rows err {ch['cf_err']:.3e}"
                  f" (rel {ch['cf_rel']:.3e}), WL slabs err "
                  f"{ch['wl_err']:.3e} (rel {ch['wl_rel']:.3e}), "
                  f"{ch['n_acc']} of {ch['n_enabled']} trials accepted; "
                  f"{extra}", flush=True)
            if not share > 0:
                fail("the displacement wall rejected no proposal")
            if not dmax <= TRANS_WALL + TRANS_WALL_TOL[dtype]:
                fail(f"a molecule crossed the displacement wall: {dmax}")
            tol_e, tol_m = ((1e-10, 1e-10) if f64
                            else (F32_MOVER_E_ATOL, F32_MOVER_MOM_ATOL))
            if not (e_err <= tol_e and own_err <= tol_m and apply_ok):
                fail(f"the mover kernels disagree with their plain versions "
                     f"under the displacement wall ({dtype}, T={T})")
            if f64:
                if ch["differ"].any() or not (
                        ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
                        and 0 < ch["n_acc"] < ch["n_enabled"]):
                    fail(f"chain_wl fp64 under the displacement wall (T={T})"
                         " disagrees with its plain version")
            elif frac > F32_MAX_DIFF_FRAC or not (
                    ch["cf_rel"] <= F32_CHAIN_RTOL
                    and ch["wl_rel"] <= F32_CHAIN_RTOL
                    and 0 < ch["n_acc"] < ch["n_enabled"]):
                fail(f"chain_wl f32 under the displacement wall (T={T}) "
                     "disagrees with its plain version")
            del eng, s, cmp
            torch.cuda.empty_cache()


def unfused_t1_phase():
    """8c: cell_pallas='off' (the unfused sub-step with the micro-batched
    chain) against 'apply' (the three kernels) in a sample run on the
    N=8064 pair, one cycle each from one seed, cut to UNFUSED_SWEEPS
    sweeps (it rebins and merges), float64 at W=64 (frozen weights: the
    micro-batched chain is the serial one): integer state identical,
    continuous state within 1e-10, the WL slabs within 1e-12
    relative."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    ends, secs = {}, {}
    for mode in ("off", "apply"):
        eng, s = make_cell_engine(cell_params(
            W_CELL_FP64, "float64", cell_pallas=mode, cell_chain="auto",
            samplerun=True, wl_factor=0.0, list_update_int=1,
            mpi_sync_int=1))
        if (mode == "off") != (not eng.use_cell_pallas
                               and not eng.use_chain_kernel):
            fail(f"cell_pallas='{mode}' resolved to use_cell_pallas "
                 f"{eng.use_cell_pallas}, use_chain_kernel "
                 f"{eng.use_chain_kernel}")
        eng.sweeps_per_cycle = UNFUSED_SWEEPS
        eng.trials_per_cycle = (UNFUSED_SWEEPS * eng.n_tables * eng.K
                                * eng.T)
        torch.cuda.synchronize()
        t0 = time.time()
        eng.run_cycles(s, 1)
        torch.cuda.synchronize()
        secs[mode] = time.time() - t0
        ends[mode] = s
    a, b = ends["off"], ends["apply"]
    ints_equal, names, _ = state_diff(a, b)
    fields = field_diffs(a, b)
    # the WL slabs relative, as the CPU tests hold them: the
    # micro-batched chain adds a sub-step's histogram increments up
    # before it adds them to the slab, the chain kernel one by one
    err = max((float(e) for e, _, f in fields if f not in WL_FIELDS),
              default=0.0)
    wl_rel = max((float(e) / max(1.0, float(m)) for e, m, f in fields
                  if f in WL_FIELDS), default=0.0)
    uh = ds_value64(b.master_uhist)
    print(f"[unfused-t1] fp64 N=8064 W={W_CELL_FP64} sample run, one cycle "
          f"of {UNFUSED_SWEEPS} sweeps: "
          f"'off' {secs['off']:.3f} s, 'apply' {secs['apply']:.3f} s; "
          f"integer state equal {ints_equal} {names}; state max abs diff "
          f"{err:.3e}, WL slabs max relative diff {wl_rel:.3e}; by field "
          f"(max abs diff, max |value|) {fields[:5]}; merged uhist sum "
          f"{uh.sum():.6e}; accepted {int(a.acc[0].sum())} translations",
          flush=True)
    if not (ints_equal and err <= 1e-10 and wl_rel <= 1e-12
            and uh.sum() > 0):
        fail("cell_pallas='off' and 'apply' disagree in the T=1 sample run")


WL_FIELDS = ("weight", "hist", "uhist", "master_eta", "master_hist",
             "master_uhist")
UNFUSED_SWEEPS = 4              # of 16: 8c's 'off' cycle ~55 s in full


def field_diffs(a, b):
    """[(max |a - b|, max |b|, field)] of two CellStates' float fields
    (a double-single pair as its float64 value), largest first."""
    import dataclasses

    import torch

    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, tuple):
            x, y = (torch.as_tensor(ds_value64(v)) for v in (x, y))
        if torch.is_tensor(x) and x.is_floating_point():
            out.append((f"{_max_abs(x, y):.3e}",
                        f"{float(torch.max(torch.abs(y))):.3e}", f.name))
    return sorted(out, key=lambda r: -float(r[0]))


FLAG_T8 = dict(cell_trials=8, cell_pallas="auto", cell_chain="auto")
# the flagship at T=8: one timed cycle, the first (no warm-up cycle: ~70
# s of the run's limit), with a rebin and a delta-sync in it, the resync
# left out (a whole-cell energy costs ~7 s here), cut to the first
# FLAG_T8_SUB of its 64 sub-steps (~1.6 s each)
FLAG_T8_CUTS = dict(list_update_int=1, mpi_sync_int=1, latt_sync_int=10_000)
FLAG_T8_SUB = 16


def flagship_t8_run(kind, card):
    """7c: the N=24192 flagship at cell_trials=8 with the modes left to
    'auto': they must resolve to the unfused sub-step with the XLA chain
    (the multi-point kernel has no delta output for overlapping
    stencils).  One sub-step against cell_chain='on' (the chain kernel
    fed by the unfused sub-step) in float64 at W=16; then at W=128 in
    float32 a timed cycle, an audit of 64 walkers, the merged histogram,
    and a torch.profiler trace of one sub-step."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    mt = dict(mc_max_trans=0.10 * ANG_TO_BOHR)
    prm = cell_params(W_MT_FP64, "float64", stack=FLAG_STACK, **FLAG_T8,
                      **mt)
    eng_x, s = make_cell_engine(prm)
    if eng_x.use_cell_pallas or eng_x.use_chain_kernel \
            or eng_x.scatter_unique or eng_x.T != 8:
        fail("the flagship at T=8 did not resolve to the unfused sub-step "
             "with the XLA chain")
    eng_k, _ = make_cell_engine(dataclasses.replace(prm, cell_chain="on"))
    K, T, W = eng_x.K, eng_x.T, W_MT_FP64
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(700)
    u = torch.rand((K, 4 + 5 * T, W), generator=gen, dtype=s.r.dtype,
                   device=DEVICE)
    codes = torch.zeros((K * T,), dtype=torch.int32)
    codes[K * T // 2] = SWITCH
    s.cycle = 1                               # WL live (eq_mc_cycles 1)
    ends, tpms = [], []
    for eng in (eng_x, eng_k):
        st = s.clone()
        tpm = torch.zeros((eng.cellgrid.nslot, W), dtype=torch.int32,
                          device=DEVICE)
        eng._substep_canonical(st, tpm, 5, u, codes)
        ends.append(st)
        tpms.append(tpm)
    torch.cuda.synchronize()
    ints_equal, names, err = state_diff(*ends)
    ints_equal = ints_equal and torch.equal(*tpms)
    n_acc = int(ends[0].acc[0].sum())
    print(f"[flagship-t8] fp64 W={W}: cell_pallas/cell_chain 'auto' -> "
          f"use_cell_pallas {eng_x.use_cell_pallas}, use_chain_kernel "
          f"{eng_x.use_chain_kernel}; one sub-step (K={K}, T={T}) through "
          f"the XLA chain against the chain kernel: integer state equal "
          f"{ints_equal} {names}, continuous state max abs diff {err:.3e}, "
          f"{n_acc} of {int(ends[0].att[0].sum())} trials accepted, "
          f"histogram grew {float(ends[0].hist.sum()):.3e}", flush=True)
    if not (ints_equal and err <= 1e-10 and n_acc > 0
            and float(ends[0].hist.sum()) > 0):
        fail("the flagship's XLA chain disagrees with the chain kernel")
    del eng_x, eng_k, s, ends
    torch.cuda.empty_cache()

    prm = cell_params(W_FLAG, "float32", stack=FLAG_STACK, **FLAG_T8,
                      **FLAG_T8_CUTS, **mt)
    eng, s = make_cell_engine(prm)
    eng.n_tables = FLAG_T8_SUB
    eng.trials_per_cycle = (eng.sweeps_per_cycle * FLAG_T8_SUB * eng.K
                            * eng.T)
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    att0 = s.att.clone()
    torch.cuda.synchronize()
    t0 = time.time()
    s, samples = eng.run_cycles(s, 1)         # cycle 1: WL live, rebin, sync
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    att = (s.att - att0).sum(dim=1).tolist()
    overflow = int(s.occ_overflow.max())
    print(f"[flagship-t8] N={prm.nwater} W={W_FLAG} f32 T={eng.T}: "
          f"{n_sub} sub-steps/cycle, {eng.trials_per_cycle} trials/cycle; "
          f"timed cycle {elapsed:.3f} s = "
          f"{eng.trials_per_cycle * W_FLAG / elapsed:.4e} trials/s on "
          f"{kind} ({card}); attempts trans/vol/switch {att} (all "
          f"walkers); occ_overflow {overflow}", flush=True)
    if overflow != 0:
        fail(f"flagship T=8 slab overflow {overflow}")
    if not torch.isfinite(samples["E_ls"]).all():
        fail("non-finite therm samples of the flagship at T=8")
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    eng.merged_histogram(s)
    hist = ds_value64(s.master_hist)[0]
    print(f"[flagship-t8] audit of 64 walkers: max |drift| {max_drift:.3e} "
          f"Hartree (limit {AUDIT_FLAG_MAX_DRIFT:g}); merged histogram sum "
          f"{hist.sum():.6e} over {int((hist > 0).sum())} bins", flush=True)
    if not max_drift < AUDIT_FLAG_MAX_DRIFT:
        fail("flagship T=8 energy audit drift")
    if not (np.isfinite(hist.sum()) and hist.sum() > 0):
        fail("the flagship's merged histogram at T=8 is empty or not finite")

    # one sub-step, untraced and traced, from the same state
    gen.manual_seed(701)
    K, T, W = eng.K, eng.T, W_FLAG
    u_all = torch.rand((1, K, 4 + 5 * T, W), generator=gen,
                       dtype=s.r.dtype, device=DEVICE)
    u_mv, ua, uz = eng._split_uniforms(u_all)
    codes = torch.zeros((K * T,), dtype=torch.int32)
    walls, traced = [], None
    for pass_ in range(2):
        st = s.clone()
        pks = eng._pack(st)
        rows = eng._loop_rows(st, True)
        tpm = torch.zeros((eng.cellgrid.nslot, W), dtype=torch.int32,
                          device=DEVICE)
        if pass_:
            traced = profile(activities=[ProfilerActivity.CUDA])
            traced.start()
        torch.cuda.synchronize()
        t0 = time.time()
        eng._substep_multi(st, pks, tpm, 5, u_mv[0], ua[0], uz[0], codes,
                           rows)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if pass_:
            traced.stop()
        del st, pks, rows, tpm
    rows = device_rows(traced)
    dev = sum(r[0] for r in rows) * 1e-6
    busy = dev / walls[0]
    print(f"[flagship-t8-profile] one sub-step: untraced {walls[0] * 1e3:.3f}"
          f" ms, traced {walls[1] * 1e3:.3f} ms; device {dev * 1e3:.3f} ms: "
          f"{busy:.4f} busy, {1 - busy:.4f} idle (the Python chain loop's "
          f"share); {sum(r[1] for r in rows)} device launches", flush=True)
    print_device_rows("flagship-t8-profile", rows, 1, "sub-step", top=8)
    del eng, s, samples
    torch.cuda.empty_cache()


# round 5's N=8064 pipeline: the overrides of runs/n8064_wl2/run.py and
# runs/n8064_sample2/run.py (their MU_RANGE and WL_QTIME defaults)
_ROUND5 = dict(
    stack=(14, 8, 18), n_walkers=128, parallel_strategy="dd", n_windows=16,
    window_overlap=2, mu_min=-27000.0, mu_max=27000.0, nbins=201,
    mc_max_trans=0.10, mc_dv_max=0.2, mc_vol_wall=0.2, eq_mc_cycles=400,
    list_update_int=10, mpi_sync_int=50, monitor_int=500, flat_chk_int=500,
    file_output_int=100, therm_walkers=8, traj_output_int=100_000_000,
    chkpt_dump_int=250, timer_qtime=9000.0, timer_closetime=420,
    max_mc_cycles=100_000_000,
)
N8064_WL2 = dict(_ROUND5, cell_trials=8, eq_adjust_mc=True,
                 wl_factor=0.005 * 16.0 / 128, wl_minhist=5)
N8064_SAMPLE2 = dict(_ROUND5, samplerun=True, cell_trials=1,
                     eq_adjust_mc=False, deltaG_int=500)
# what the smoke run cuts, to fit volume moves, delta-syncs, monitor_stats,
# the equilibration boundary, check_flatness, checkpoints, rebins and the
# sample phase's Delta G dumps into 1 + 1 generation cycles and a sample
# cycle: these intervals (the runs' own values in the comments)
ROUND5_CUTS = dict(
    eq_mc_cycles=2,             # 400
    list_update_int=2,          # 10
    monitor_int=2,              # 500
    flat_chk_int=2,             # 500
    mpi_sync_int=1,             # 50
    file_output_int=1,          # 100
    chkpt_dump_int=2,           # 250
)
# (the sample cycle holds a Delta G dump and the monitor's stitched
# unbiased_histogram.dat; deltaG_int and monitor_int 500)
SAMPLE2_CUTS = dict(ROUND5_CUTS, deltaG_int=1, monitor_int=1)
WL2_CYCLES = (1, 1)             # first call, resumed call
SAMPLE2_CYCLES = 1
ROUND5_VOL_TOL = 1e-6           # float32 round-off of a volume ratio


def _app_calls(d, over, calls, kernels, base=None, **call_kw):
    """run_input_file of ``d``/ice.input with the overrides ``over``,
    once per cycle count of ``calls`` (the later calls resume), through
    the Application class ``base`` (the app's own by default)
    remembered so that its engine can be read; ``call_kw`` go to
    run_input_file.  Returns one dict per call: wall seconds, the final
    state, the Application, and its engine's launch counts (the
    kernels' counts start at 0 when the run sets up; ``kernels`` maps a
    name to the engine's attribute)."""
    import torch

    from mc_water_ls_mw_tpu_torch import app as app_mod

    apps = []

    class Recorded(base or app_mod.Application):
        def setup(self):
            apps.append(self)
            return super().setup()

    path = os.path.join(d, "ice.input")
    cwd, original = os.getcwd(), app_mod.Application
    app_mod.Application = Recorded
    out = []
    try:
        for n_cyc in calls:
            t0 = time.time()
            s = app_mod.run_input_file(path, overrides=over,
                                       max_cycles=n_cyc, device=DEVICE,
                                       **call_kw)
            torch.cuda.synchronize()
            app = apps[-1]
            out.append(dict(wall=time.time() - t0, s=s, app=app,
                            launches={k: getattr(app.engine, a).launches
                                      for k, a in kernels.items()}))
    finally:
        os.chdir(cwd)
        app_mod.Application = original
    return out


def _round5_report(tag, d, out, calls, kind, card):
    """Print and check one stage of the round-5 pipeline (its calls'
    launches, rates, windows, slab overflow and every walker's volume
    ratio); returns (engine, final state)."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.geometry import determinant3

    eng, s = out[-1]["app"].engine, out[-1]["s"]
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    W = s.r.shape[-1]
    for run, n_cyc in zip(out, calls):
        if any(n != n_cyc * n_sub for n in run["launches"].values()):
            fail(f"{tag}: launches {run['launches']}, expected "
                 f"{n_cyc * n_sub} of each kernel")
    n, disp, tot = _block_seconds(os.path.join(d, "mc.log"))
    nwin = s.master_eta.hi.shape[0]
    inside = (s.mu > s.my_mu_min) & (s.mu < s.my_mu_max)
    per_win = torch.bincount(s.window_id[inside].long(),
                             minlength=nwin).tolist()
    vref = torch.abs(torch.stack([determinant3(eng.ref_h[l][:, :, None])[0]
                                  for l in range(2)])).double()
    ratio = (s.volume.double() / vref[:, None]).cpu().numpy()   # [L,W]
    overflow = int(s.occ_overflow.max())
    launches = [r["launches"] for r in out]
    print(f"[{tag}] N={eng.prm.nwater} W={W} float32 T={eng.T} "
          f"samplerun={eng.prm.samplerun} mc_vol_wall "
          f"{eng.prm.mc_vol_wall}, '{eng.prm.parallel_strategy}' over "
          f"{nwin} windows, {n_sub} sub-steps/cycle: {n} cycles over "
          f"{len(out)} call(s) in {disp:.3f} s = {disp / n:.3f} s/cycle in "
          f"the cycle loop ({tot / n:.3f} s/cycle with the block events) = "
          f"{eng.trials_per_cycle * W * n / disp:.4e} trials/s on {kind} "
          f"({card}); calls {[round(r['wall'], 1) for r in out]} s with "
          f"set-up; launches {launches}; started at cycle "
          f"{out[0]['app'].start_cycle}, ended at {s.cycle}; occ_overflow "
          f"{overflow}; walkers inside their window's bounds per window "
          f"{per_win}", flush=True)
    print(f"[{tag}] V/Vref of every walker, lattice 1: "
          f"{np.round(ratio[0], 4).tolist()}", flush=True)
    print(f"[{tag}] V/Vref of every walker, lattice 2: "
          f"{np.round(ratio[1], 4).tolist()}", flush=True)
    print(f"[{tag}] V/Vref range [{ratio.min():.6f}, {ratio.max():.6f}] "
          f"(wall {eng.prm.mc_vol_wall})", flush=True)
    if overflow != 0:
        fail(f"{tag}: slab overflow {overflow}")
    if not (np.abs(ratio - 1.0)
            <= eng.prm.mc_vol_wall + ROUND5_VOL_TOL).all():
        fail(f"{tag}: a walker's volume left the volume wall")
    return eng, s


def round5_run(kind, card):
    """9b: round 5's N=8064 pipeline through run_input_file, the runs'
    overrides (ROUND5_CUTS lists the cuts) and jit_chunk=20 as their
    run.py files pass it: runs/n8064_wl2 (T=8, the volume wall, 'dd'
    over 16 windows, Wang-Landau generation) in build/chip_smoke_wl2 for
    a cycle, then a resumed call; its two checkpoint slots, and nothing
    else, copied to build/chip_smoke_sample2, where runs/n8064_sample2
    (T=1, the wall, a sample run) enters its sample phase through the
    gen -> sample restart for a cycle; an energy audit of 64 walkers of
    each stage, the stitched histogram and the per-window dumps.
    Returns {"launches": {kernel line: count}}."""
    import shutil

    import torch

    root = os.path.join(ROOT, "build")
    dw = os.path.join(root, "chip_smoke_wl2")
    ds = os.path.join(root, "chip_smoke_sample2")
    for d in (dw, ds):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    kern_t8 = {"mover_points": "points_kernel", CHAIN_T8: "chain_kernel",
               APPLY_MT: "apply_kernel"}
    shutil.copy(os.path.join(ROOT, "runs", "n8064_wl2", "ice.input"), dw)
    out = _app_calls(dw, {**N8064_WL2, **ROUND5_CUTS}, WL2_CYCLES, kern_t8,
                     jit_chunk=20)
    if out[1]["app"].start_cycle != WL2_CYCLES[0]:
        fail("wl2: the second call did not resume from its checkpoint")
    eng, s = _round5_report("wl2", dw, out, WL2_CYCLES, kind, card)
    if eng.T != 8 or eng.prm.mc_vol_wall != 0.2:
        fail("wl2: the engine is not the T=8 walled one of runs/n8064_wl2")
    _, drift = eng.audit_energy(s.clone(), n_walkers=64)
    print(f"[wl2] audit of 64 walkers at cycle {s.cycle}: max |drift| "
          f"{float(torch.max(torch.abs(drift))):.3e} Hartree (limit "
          f"{AUDIT_CELL_MAX_DRIFT:g})", flush=True)
    if not float(torch.max(torch.abs(drift))) < AUDIT_CELL_MAX_DRIFT:
        fail("wl2: energy audit drift")
    launches = {}
    for r in out:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    del eng, s, out
    torch.cuda.empty_cache()

    for name in ("checkpoint000.npz.1", "checkpoint000.npz.2"):
        shutil.copy(os.path.join(dw, name), ds)
    kern_t1 = {"mover_energies": "mover_kernel", "chain_wl": "chain_kernel",
               "mover_apply": "apply_kernel"}
    shutil.copy(os.path.join(ROOT, "runs", "n8064_sample2", "ice.input"), ds)
    out = _app_calls(ds, {**N8064_SAMPLE2, **SAMPLE2_CUTS},
                     (SAMPLE2_CYCLES,), kern_t1, jit_chunk=20)
    eng, s = _round5_report("sample2", ds, out, (SAMPLE2_CYCLES,), kind,
                            card)
    node = open(os.path.join(ds, "node000.log")).read()
    if out[0]["app"].start_cycle != sum(WL2_CYCLES) or \
            "# Sample phase from a generation checkpoint" not in node or \
            float(s.f.max()) != 0.0:
        fail("sample2 did not enter its sample phase from the wl2 "
             "checkpoint")
    for k, n in out[0]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    # the audit right after one more cycle's sub-step loop (as phase 9's)
    drifts = []

    def audited_scan(*args):
        st, tpm = eng._substep_scan(*args)
        drifts.append(eng.audit_energy(st.clone(), n_walkers=64)[1])
        return st, tpm

    eng._cycle_with(s, audited_scan)
    max_drift = float(torch.max(torch.abs(drifts[0])))
    files = sorted(os.listdir(ds))
    dumps = [f for f in files if f.startswith("uhist_windows_")]
    stitched = np.loadtxt(os.path.join(ds, "unbiased_histogram.dat"),
                          comments="#")
    print(f"[sample2] audit of 64 walkers after the sub-step loop of cycle "
          f"{s.cycle}: max |drift| {max_drift:.3e} Hartree (limit "
          f"{AUDIT_CELL_MAX_DRIFT:g}); stitched unbiased_histogram.dat "
          f"{stitched.shape}, finite {bool(np.isfinite(stitched).all())}, "
          f"sum of its last column {stitched[:, -1].sum():.6e}; per-window "
          f"dumps {dumps}", flush=True)
    if not max_drift < AUDIT_CELL_MAX_DRIFT:
        fail("sample2: energy audit drift")
    if not (dumps and np.isfinite(stitched).all()
            and stitched[:, -1].sum() > 0):
        fail("sample2: no finite stitched histogram or per-window dumps")
    del eng, s, out
    torch.cuda.empty_cache()
    return {"launches": launches}


def require_scatter_modes(eng):
    """Fail unless the cell engine resolved to the scatter path: the
    mover kernel with its delta output, no apply kernel, the chain
    kernel."""
    if not (eng.use_cell_pallas and not eng.use_cell_apply
            and eng.use_chain_kernel and eng.mover_kernel.with_deltas
            and not eng.scatter_unique):
        fail("the cell engine did not resolve to 'on' with the chain "
             "kernel on a grid whose stencils overlap")


def state_diff(a, b):
    """(integer fields equal, names of those that differ, largest |a -
    b| of the float fields) of two CellStates."""
    import dataclasses

    import torch

    names, err = [], 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = (zip(x, y) if isinstance(x, tuple)
                 else [(x, y)] if torch.is_tensor(x) else [])
        for xx, yy in pairs:
            if xx.is_floating_point():
                err = max(err, _max_abs(xx, yy))
            elif not torch.equal(xx, yy):
                names.append(f.name)
    return not names, names, err


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# one lattice, NVT, MINU, leshift, the Swetnam and 1/t schedules
# ----------------------------------------------------------------------

# the single box as the input reader forces it with num_lattices = 1
# (io.f90:208-220): no switching
SINGLE_BOX = dict(num_lattices=1, allow_switch=False, mc_switch_prob=0.0,
                  mc_always_switch=False)
# runs/n216_wl's Wang-Landau parameters (its ice.input and run.py
# overrides) on the N=216 stacking pair
N216_WL = dict(nbins=201, mu_min=-1800.0, mu_max=1800.0, samplerun=False,
               wl_factor=0.005 * 8.0 / 4096, wl_minhist=5)
# what the kernel checks of the f schedules cut, so that each schedule
# changes f within the checked cycle: Swetnam's f = ln(rms) alpha B
# must fall below the cap wl_factor, and the 1/t cap B / (cycle N)
# below f (the runs' own values, from run.py or the defaults, in the
# comments)
SCHED_CUTS = {
    "swetnam": dict(wl_factor=0.05,     # 0.005 * 8 / 4096
                    wl_alpha=1e-4),     # 1.0
    "invt": dict(wl_factor=1.0),        # 0.005 * 8 / 4096
}


def half_invt(s):
    """Every other walker runs the 1/t schedule."""
    s.invt_active[::2] = True


def variant_cases():
    """Phase 4e's cases: (tag, kernel, params builder (W, dtype), state
    preparation, weights, the paper's pair)."""
    wl = dict(N216_WL, eq_mc_cycles=0)
    return [
        ("single", "fused_cycle_1l",
         lambda W, dt: sample_params(W, dt, eq_mc_cycles=0, **SINGLE_BOX),
         None, None, False),
        ("minu-leshift", "fused_cycle_ext",
         lambda W, dt: sample_params(W, dt, minu=True, leshift=True,
                                     eq_mc_cycles=0),
         None, "n216_sample", False),
        # the plain factor at Swetnam's cut: the schedules' baseline
        ("wl", "fused_cycle",
         lambda W, dt: sample_params(W, dt, **{
             **wl, "wl_factor": SCHED_CUTS["swetnam"]["wl_factor"]}),
         None, None, False),
        ("swetnam", "fused_cycle_ext",
         lambda W, dt: sample_params(W, dt, wl_swetnam=True,
                                     **{**wl, **SCHED_CUTS["swetnam"]}),
         None, None, False),
        ("invt", "fused_cycle_ext",
         lambda W, dt: sample_params(W, dt, wl_useinvt=True,
                                     **{**wl, **SCHED_CUTS["invt"]}),
         half_invt, None, False),
        ("nvt", "fused_cycle_ext",
         lambda W, dt: sample_params(W, dt, mc_ensemble="nvt",
                                     eq_mc_cycles=0),
         None, "n216_sample", False),
        ("dense48-single", "fused_cycle_dense_1l",
         lambda W, dt: dense_params(W, dt, "n48", eq_mc_cycles=0,
                                    **SINGLE_BOX),
         None, None, False),
        ("dense48-minu", "fused_cycle_dense_ext",
         lambda W, dt: dense_params(W, dt, "n48", minu=True,
                                    samplerun=False, wl_factor=0.005,
                                    eq_mc_cycles=0),
         None, "n216_sample", False),
        ("multi-minu-swetnam", "fused_cycle_multi_ext",
         lambda W, dt: multi_params(W, dt, MULTI_T, minu=True,
                                    wl_swetnam=True, eq_mc_cycles=0,
                                    **SCHED_CUTS["swetnam"]),
         None, None, True),
    ]


# the report rows of phase 4e (the kernels line): the case that times
# each new instantiation
VARIANT_ROWS = {"fused_cycle_1l": "single",
                "fused_cycle_ext": "swetnam",
                "fused_cycle_dense_1l": "dense48-single",
                "fused_cycle_dense_ext": "dense48-minu",
                "fused_cycle_multi_ext": "multi-minu-swetnam"}
VARIANT_CYCLES = 5              # the engine's own cycles per f32 case


def variant_fused_checks(table_ms):
    """Phase 4e: kernel 1's instantiations beyond the two-lattice plain
    settings against their plain versions over one cycle with the same
    draws (float64 at W_FP64: identical integers, state within 1e-10;
    float32 at W_MAIN: at most 1% of walkers differing), each f32 case
    timed beside phase 4's table kernel (``table_ms``) and run
    VARIANT_CYCLES cycles through its engine.  Returns {case: f32
    report}."""
    import torch

    out = {}
    for tag, kernel, params, prepare, weights, paper in variant_cases():
        fused_kernel_check(params(W_FP64, "float64"), f"4e-{tag}",
                           paper_pair=paper, weights=weights,
                           prepare=prepare, kernel=kernel)
        out[tag] = fused_kernel_check(
            params(W_MAIN, "float32"), f"4e-{tag}", reps=5,
            paper_pair=paper, weights=weights, prepare=prepare,
            kernel=kernel, run_cycles=VARIANT_CYCLES)
        out[tag]["kernel"] = kernel
        torch.cuda.empty_cache()
    print(f"[4e] f32 W={W_MAIN} ms per cycle of the kernel (phase 4's "
          f"fused_cycle: {table_ms:.3f}): "
          + ", ".join(f"{t} ({r['kernel']}) {r['ms']:.3f}"
                      for t, r in out.items()), flush=True)
    return out


# runs/n216_wl/ice.input with the one-lattice overrides: the reference's
# single_box run (NPT sampling of one ice polymorph) on the Ih cell of the
# N=216 stacking pair
SINGLE216 = dict(num_lattices=1, stack=(3, 3, 6), n_walkers=4096,
                 dtype="float32")
# what the smoke run cuts, to fit monitor_stats and checkpoints into 20 +
# 10 cycles (the run's own values, from the input or the defaults, in the
# comments)
SINGLE216_CUTS = dict(
    eq_mc_cycles=10,            # 10000
    monitor_int=10,             # 1000
    chkpt_dump_int=10,          # 1000
    file_output_int=10,         # 50
    flat_chk_int=10,            # 10000
)
SINGLE216_CYCLES = (20, 10)     # first call (the warm-up), resumed call
SINGLE216_TIMED = 20            # the resumed engine's timed cycles


def single_box_run(kind, card):
    """Phase 5f: the single-box N=216 NPT run through run_input_file in
    build/chip_smoke_single216: 20 warm-up cycles, then a second call
    resumed from the checkpoint, then SINGLE216_TIMED cycles of the
    resumed engine timed on the host clock (the app's block lines print
    tenths of seconds): moves/s, the launches of the one-lattice table
    kernel and of the whole-cell energy kernel, an audit of 64 walkers,
    every volume within a factor 2 of the crystal's, and no switch
    attempted.  Returns {"launches": {kernel: count over the calls and
    the timed cycles}}."""
    import shutil

    import torch

    from mc_water_ls_mw_tpu_torch.ops.geometry import determinant3

    d = os.path.join(ROOT, "build", "chip_smoke_single216")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n216_wl", "ice.input"), d)
    out = _app_calls(d, {**SINGLE216, **SINGLE216_CUTS}, SINGLE216_CYCLES,
                     {"fused_cycle_1l": "fused_cycle",
                      "full_energy": "full_energy"})
    first, second = out
    eng, s = second["app"].engine, second["s"]
    prm = eng.prm
    W = SINGLE216["n_walkers"]
    if not (eng.fused_cycle.kernel == "fused_cycle_1l"
            and prm.num_lattices == 1 and prm.nwater == 216
            and s.r.shape[:1] + s.r.shape[-1:] == (1, W)):
        fail(f"the single-box run did not build the one-lattice table "
             f"engine at N=216, {W} walkers: {eng.fused_cycle.kernel}")
    for run, n_cyc in zip(out, SINGLE216_CYCLES):
        if run["launches"]["fused_cycle_1l"] != n_cyc:
            fail(f"single box: launches {run['launches']}, expected "
                 f"{n_cyc} of the one-lattice kernel")
    if second["app"].start_cycle != SINGLE216_CYCLES[0] or \
            s.cycle != sum(SINGLE216_CYCLES):
        fail(f"the single-box run did not resume at cycle "
             f"{SINGLE216_CYCLES[0]}: {second['app'].start_cycle}, "
             f"{s.cycle}")
    eng.fused_cycle.launches = eng.full_energy.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    s, samples = eng.run_cycles(s, SINGLE216_TIMED)
    torch.cuda.synchronize()
    disp = time.time() - t0
    timed = {"fused_cycle_1l": eng.fused_cycle.launches,
             "full_energy": eng.full_energy.launches}
    rate = W * prm.nwater * SINGLE216_TIMED / disp
    if timed["fused_cycle_1l"] != SINGLE216_TIMED or \
            not torch.isfinite(samples["E_ls"]).all():
        fail(f"single box: timed launches {timed} or non-finite samples")
    node = open(os.path.join(d, "node000.log")).read()
    n_vol = sum(int(ln.split()[5]) for ln in node.splitlines()
                if ln.endswith(" box moves"))
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    v0 = float(abs(determinant3(eng.ref_h[0][:, :, None])[0]))
    ratio = (s.volume[0] / v0).double().cpu().numpy()
    print(f"[single] runs/n216_wl/ice.input through run_input_file, "
          f"overrides {sorted(SINGLE216)} and {sorted(SINGLE216_CUTS)} "
          f"(cut): N={prm.nwater} W={W} float32, {eng.fused_cycle.kernel}; "
          f"{SINGLE216_TIMED} timed cycles in {disp:.3f} s = "
          f"{disp / SINGLE216_TIMED * 1e3:.3f} ms/cycle = {rate:.4e} "
          f"moves/s on {kind} ({card}); launches {first['launches']} + "
          f"{second['launches']} + {timed} (timed); resumed at cycle "
          f"{second['app'].start_cycle}; {n_vol} volume-move attempts in "
          f"the monitor blocks; switches attempted {int(s.att[2].sum())}; "
          f"V/V0 {ratio.min():.4f}-{ratio.max():.4f}; audit of 64 walkers: "
          f"max |drift| {max_drift:.3e} Hartree (limit "
          f"{AUDIT_MAX_DRIFT:g})", flush=True)
    if not max_drift < AUDIT_MAX_DRIFT:
        fail("single box: energy audit drift")
    if not (ratio.min() > 0.5 and ratio.max() < 2.0):
        fail("single box: a volume left a factor 2 of the crystal's")
    if int(s.att[2].sum()) != 0 or "lattice switches" in node:
        fail("single box: a switch was attempted")
    if n_vol <= 0:
        fail("single box: no volume move")
    return {"launches": {k: first["launches"][k] + second["launches"][k]
                         + timed[k] for k in timed},
            "cycle_ms": disp / SINGLE216_TIMED * 1e3}


# runs/n216_wl's run.py overrides with the 1/t schedule; its ice.input as
# committed
INVT216 = dict(stack=(3, 3, 6), n_walkers=4096, mu_min=-1800.0,
               mu_max=1800.0, nbins=201, wl_factor=0.005 * 8.0 / 4096,
               wl_minhist=5, wl_useinvt=True, dtype="float32")
# the cuts: the flatness check at cycle 10, where f is below B / (10 N)
# and the switch to 1/t fires, the 1/t dumps every 10 cycles (the run's
# own values in the comments)
INVT_CUTS = dict(
    eq_mc_cycles=2,             # 1000
    flat_chk_int=10,            # 2500
    invt_dump_int=10,           # 500000
    monitor_int=10,             # 5000
    mpi_sync_int=5,             # 50
    chkpt_dump_int=10,          # 25000
    file_output_int=10,         # 50
    latt_sync_int=20,           # 10000
)
INVT_CYCLES = (20, 10)          # first call, resumed call


def invt_run(kind, card):
    """Phase 5g: a 1/t Wang-Landau generation through run_input_file in
    build/chip_smoke_invt216, resumed: the switch to 1/t at the first
    flatness check (every walker's invt_active, f set to B / (cycle N)
    and capped by it from then on), the 1/t dumps (wlf.dat and the
    cycle-tagged curves), the resume.  Returns {"launches": {kernel:
    count over both calls}}."""
    import shutil

    d = os.path.join(ROOT, "build", "chip_smoke_invt216")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n216_wl", "ice.input"), d)
    out = _app_calls(d, {**INVT216, **INVT_CUTS}, INVT_CYCLES,
                     {"fused_cycle_ext": "fused_cycle",
                      "full_energy": "full_energy"})
    first, second = out
    eng, s = second["app"].engine, second["s"]
    prm = eng.prm
    if eng.fused_cycle.kernel != "fused_cycle_ext":
        fail(f"the 1/t run does not run fused_cycle_ext: "
             f"{eng.fused_cycle.kernel}")
    for run, n_cyc in zip(out, INVT_CYCLES):
        if run["launches"]["fused_cycle_ext"] != n_cyc:
            fail(f"1/t run: launches {run['launches']}, expected {n_cyc}")
    glog = open(os.path.join(d, "mc.log")).read()
    files = set(os.listdir(d))
    tags = [f"{c:020d}" for c in range(INVT_CUTS["invt_dump_int"],
                                       sum(INVT_CYCLES) + 1,
                                       INVT_CUTS["invt_dump_int"])]
    want = {"wlf.dat", "checkpoint000.npz.1", "checkpoint000.npz.2"} | {
        f"{n}.dat_{t}" for n in ("eta_weights", "histogram") for t in tags}
    B, N = eng.grid.nbins, prm.nwater
    f = s.f.double().cpu().numpy()
    cap = B / (s.cycle * N)
    wlf = np.loadtxt(os.path.join(d, "wlf.dat"), ndmin=2)
    print(f"[invt] runs/n216_wl/ice.input through run_input_file, "
          f"overrides {sorted(INVT216)} and {sorted(INVT_CUTS)} (cut): "
          f"{first['wall']:.1f} s and {second['wall']:.1f} s with set-up "
          f"on {kind} ({card}); launches {first['launches']} + "
          f"{second['launches']}; resumed at cycle "
          f"{second['app'].start_cycle}; invt_active "
          f"{int(s.invt_active.sum())} of {s.invt_active.numel()} walkers; "
          f"f {f.min():.6e}-{f.max():.6e} (1/t cap at cycle {s.cycle}: "
          f"{cap:.6e}); wlf.dat rows {wlf.tolist()}", flush=True)
    if "# Switching to 1/t method" not in glog:
        fail("1/t run: no switch to 1/t in mc.log")
    if not bool(s.invt_active.all()):
        fail("1/t run: invt_active is not set on every walker after the "
             "resume")
    if not want <= files:
        fail(f"1/t run: missing files {sorted(want - files)}")
    if second["app"].start_cycle != INVT_CYCLES[0] or \
            s.cycle != sum(INVT_CYCLES):
        fail("the 1/t run did not resume from its checkpoint")
    if not (np.isfinite(f).all() and f.max() <= cap * (1 + 1e-6)
            and f.min() > 0):
        fail("1/t run: f is not capped by B / (cycle N)")
    return {"launches": {k: first["launches"][k] + second["launches"][k]
                         for k in first["launches"]}}


# phase 6c's kernel-6 rules on the T=8 sub-step of phase 8
CHAIN_RULES = {
    "minu": dict(minu=True),
    "swetnam": dict(wl_swetnam=True, **SCHED_CUTS["swetnam"]),
    "invt": dict(wl_useinvt=True, **SCHED_CUTS["invt"]),
}
CHAIN_MINU = "chain_wl_minu"    # the report row of the MINU chain at T=8


def chain_rules_phase():
    """Phase 6c: the chain + WL kernel under MINU, Swetnam and 1/t (half
    the walkers) against its plain version on one T=8 sub-step of the
    N=8064 pair after a cycle of sampling: float64 at W_CELL_FP64
    (integers identical, rows and slabs within 1e-10), float32 at W_MT
    (phase 8's gates).  Returns the MINU chain's f32 report entry."""
    import torch

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    report = None
    for rule, over in CHAIN_RULES.items():
        for Wm, dtype in ((W_CELL_FP64, "float64"), (W_MT, "float32")):
            eng, s = make_cell_engine(cell_params(
                Wm, dtype, cell_trials=MT_TRIALS,
                mc_max_trans=0.10 * ANG_TO_BOHR, list_update_int=1,
                mpi_sync_int=1, eq_mc_cycles=0, **over))
            if rule == "invt":
                half_invt(s)
            eng.run_cycles(s, 1)
            f32 = dtype == "float32"
            cmp = multitrial_compare(eng, s, 5, seed=600,
                                     time_reps=20 if f32 and rule == "minu"
                                     else 0)
            ch = cmp["chain_wl"]
            frac = float(ch["differ"].float().mean())
            print(f"[chain-rules] {rule} {dtype} W={Wm} T={eng.T}: "
                  f"{int(ch['differ'].sum())} walkers differ ({frac:.4%}), "
                  f"on the rest chain rows err {ch['cf_err']:.3e} (relative "
                  f"{ch['cf_rel']:.3e}), WL slabs err {ch['wl_err']:.3e} "
                  f"(relative {ch['wl_rel']:.3e}), {ch['n_acc']} of "
                  f"{ch['n_enabled']} trials accepted", flush=True)
            if not f32:
                if ch["differ"].any() or not (
                        ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
                        and 0 < ch["n_acc"] < ch["n_enabled"]
                        and ch["hist_grew"] > 0):
                    fail(f"chain_wl fp64 under {rule} disagrees with its "
                         "plain version")
            elif frac > F32_MAX_DIFF_FRAC or not (
                    ch["cf_rel"] <= F32_CHAIN_RTOL
                    and ch["wl_rel"] <= F32_CHAIN_RTOL
                    and 0 < ch["n_acc"] < ch["n_enabled"]):
                fail(f"chain_wl f32 under {rule} disagrees with its plain "
                     "version")
            if f32 and rule == "minu":
                bound_ms, bound_by = multitrial_bounds(eng, s,
                                                       cmp)["chain_wl"]
                report = dict(max_abs_err=max(ch["cf_err"], ch["wl_err"]),
                              ms=ch["ms"], plain_ms=ch["plain_ms"],
                              bound_ms=bound_ms, bound_by=bound_by)
                print(f"[chain-rules] minu f32 W={Wm}: kernel "
                      f"{ch['ms']:.4f} ms/launch, plain "
                      f"{ch['plain_ms']:.3f} ms, bound {bound_ms:.6f} ms "
                      f"({bound_by})", flush=True)
            del eng, s
            torch.cuda.empty_cache()
    return report


def single_cell_run(kind, card):
    """Phase 7d: the N=8064 single box, the cell engine at one lattice
    ((14,8,18) Ih cell, W_CELL walkers, float32, T=1: the mover kernels at
    L = 1 with the XLA chain): the energies and apply kernels against
    their plain versions on one sub-step, one timed cycle (trials/s,
    launches), slab overflow 0, an audit of 64 walkers.  Returns
    {"launches": {kernel: count}}."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    prm = cell_params(W_CELL, "float32", list_update_int=2,
                      cell_chain="auto", **SINGLE_BOX)
    eng, s = make_cell_engine(prm)
    if eng.use_chain_kernel or not eng.use_cell_apply:
        fail("the one-lattice cell engine did not resolve to the apply "
             "stage with the XLA chain")
    eng.run_cycles(s, 1)                     # warm-up
    torch.cuda.synchronize()
    # one sub-step's kernels against their plain versions
    K, W = eng.K, s.r.shape[-1]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(77)
    u = torch.rand((7, K, W), generator=gen, dtype=s.r.dtype, device=DEVICE)
    codes = torch.zeros((K,), dtype=torch.int32)
    codes[K // 2] = SWITCH
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    fc, cand, off = eng._tables(5)
    trial = eng._propose_t1(s, pks, 5, u, rows)
    margs = (pks, s.h, cand, off, fc, trial.rank, trial.p_old, trial.p_new)
    pe, pown = eng.mover_kernel.plain(*margs)
    n_occ, n_in = _occupancy_counts(eng, s, pks, trial, cand, off, fc)
    accf, _ = eng._chain_t1(s.clone(), rows, trial, codes, u[5], u[6])
    ma = apply_compare(eng, pks, (s.h, cand, off, fc, trial.rank, accf,
                                  trial.p_old, trial.p_new, trial.own_new),
                       n_occ, n_in)
    e_err, own_err = _max_abs(trial.e, pe), _max_abs(trial.own_new, pown)
    print(f"[single-cell] L=1 f32 W={W}: energies err {e_err:.3e} Hartree "
          f"(limit {F32_MOVER_E_ATOL:g}), own moments err {own_err:.3e}; "
          f"apply: moment rows err {ma['mom_err']:.3e}, other rows equal "
          f"{ma['rest_equal']}, {ma['n_acc']} movers accepted", flush=True)
    if not (e_err <= F32_MOVER_E_ATOL and own_err <= F32_MOVER_MOM_ATOL
            and ma["mom_err"] <= F32_MOVER_MOM_ATOL and ma["rest_equal"]
            and ma["changed"] > 0):
        fail("the mover kernels at one lattice disagree with their plain "
             "versions")
    kernels = {"mover_energies": eng.mover_kernel,
               "mover_apply": eng.apply_kernel}
    for k in kernels.values():
        k.launches = 0
    t0 = time.time()
    s, samples = eng.run_cycles(s, 1)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    rate = eng.trials_per_cycle * W / elapsed
    overflow = int(s.occ_overflow.max())
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    print(f"[single-cell] N={prm.nwater} L=1 W={W} f32: one cycle in "
          f"{elapsed:.3f} s = {rate:.4e} trials/s on {kind} ({card}); "
          f"launches {launches} ({n_sub} sub-steps); attempts "
          f"{s.att.sum(dim=1).tolist()}; occ_overflow {overflow}; audit of "
          f"64 walkers: max |drift| {max_drift:.3e} Hartree (limit "
          f"{AUDIT_CELL_MAX_DRIFT:g})", flush=True)
    if any(n != n_sub for n in launches.values()):
        fail(f"single-box cell run: launches {launches}, expected {n_sub}")
    if overflow != 0 or not torch.isfinite(samples["E_ls"]).all():
        fail("single-box cell run: slab overflow or non-finite samples")
    if not max_drift < AUDIT_CELL_MAX_DRIFT:
        fail("single-box cell run: energy audit drift")
    del eng, s
    torch.cuda.empty_cache()
    return {"launches": launches}


def minu_t8_run(kind, card):
    """Phase 8d: N=8064 under MINU at T=8, W=W_MT, float32: one cycle
    through the points, apply and chain kernels (launches, trials/s,
    switches folded into translations), slab overflow 0, an audit of 64
    walkers.  Returns {"launches": {kernel: count}}."""
    import torch

    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    eng, s = make_cell_engine(cell_params(
        W_MT, "float32", cell_trials=MT_TRIALS, minu=True,
        mc_max_trans=0.10 * ANG_TO_BOHR))
    eng.run_cycles(s, 1)                     # warm-up
    kernels = {"mover_points": eng.points_kernel,
               "mover_apply": eng.apply_kernel,
               "chain_wl": eng.chain_kernel}
    for k in kernels.values():
        k.launches = 0
    ls0 = s.ls.clone()
    t0 = time.time()
    s, samples = eng.run_cycles(s, 1)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    n_sub = eng.sweeps_per_cycle * eng.n_tables
    W = s.r.shape[-1]
    overflow = int(s.occ_overflow.max())
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    print(f"[minu-t8] N={eng.prm.nwater} W={W} T={eng.T} f32 MINU: one "
          f"cycle in {elapsed:.3f} s = "
          f"{eng.trials_per_cycle * W / elapsed:.4e} trials/s on {kind} "
          f"({card}); launches {launches} ({n_sub} sub-steps); walkers on "
          f"another lattice than before the cycle "
          f"{int((s.ls != ls0).sum())}; occ_overflow {overflow}; audit of "
          f"64 walkers: max |drift| {max_drift:.3e} Hartree (limit "
          f"{AUDIT_CELL_MAX_DRIFT:g})", flush=True)
    if any(n != n_sub for n in launches.values()):
        fail(f"MINU T=8 run: launches {launches}, expected {n_sub}")
    if overflow != 0 or not torch.isfinite(samples["E_ls"]).all():
        fail("MINU T=8 run: slab overflow or non-finite samples")
    if not max_drift < AUDIT_CELL_MAX_DRIFT:
        fail("MINU T=8 run: energy audit drift")
    del eng, s
    torch.cuda.empty_cache()
    return {"launches": launches}


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# 12-13. ranks on the one card: walker sharding and the spatial engine
# ----------------------------------------------------------------------

# The multi-rank phases spawn gloo groups on this card (NCCL refuses two
# ranks on one card); every gate holds a sharded run against the serial
# one of the same settings, seed and draws, run in this process.
# 12a: the N=216 sample run; the float64 gate at 64 walkers over 3 cycles
# (a delta-sync at cycle 2, a chain resync at 3, ~4 volume moves a cycle)
RANK_DENSE_CUTS = dict(mpi_sync_int=2, latt_sync_int=3, mc_vol_prob=0.02)
RANK_W64 = 64
RANK_F64_CYCLES = 3
RANK_TIMED = (5, 10)            # warm-up and timed cycles of the f32 rate
# 12b: N=8064, T=1, 'apply'; the float64 gate at 4 walkers over one whole
# cycle that rebins first, runs its volume moves, merges and resyncs; the
# float32 seconds of one cycle at W_CELL walkers without volume moves
RANK_CELL_CUTS = dict(list_update_int=1, mpi_sync_int=1, latt_sync_int=1,
                      mc_vol_prob=4.0 / 8064)
RANK_CELL_F32 = dict(mc_vol_prob=0.0, latt_sync_int=10_000)
# 12c: runs/n216_sample_dd through run_input_file, float64, 64 walkers
# over its 8 windows, equilibration cut to 2 cycles, a monitor, Delta G
# and checkpoint every 2: 2 cycles, then 2 resumed on one rank
RANK_FE = dict(DD216, n_walkers=64, dtype="float64", eq_mc_cycles=2,
               monitor_int=2, deltaG_int=2, chkpt_dump_int=2,
               mpi_sync_int=1, file_output_int=1)
RANK_FE_CYCLES = (2, 2)         # first call, resumed call
# 13: the spatial engine on N=8064, cycles cut to one sweep (64 sub-steps)
# that rebins and merges; float64 gates at 2 walkers (4 on the 2x2 grid),
# float32 timing at W_SPATIAL walkers over the first SPATIAL_TIMED_SUB
# (colour, block) tables of a sweep
SPATIAL_CUTS = dict(list_update_int=1, mpi_sync_int=1, mc_vol_prob=0.0,
                    latt_sync_int=10_000)
W_SPATIAL = 128
SPATIAL_TIMED_SUB = 4
RANK_F64_TOL = 1e-10
_KERNEL_ATTRS = ("fused_cycle", "full_energy", "mover_kernel",
                 "points_kernel", "apply_kernel", "chain_kernel")


def _kernel_name(eng, attr):
    """The report name of the kernel held at ``eng.<attr>``."""
    k = getattr(eng, attr)
    return {"fused_cycle": getattr(k, "kernel", None),
            "full_energy": "full_energy", "points_kernel": "mover_points",
            "apply_kernel": "mover_apply", "chain_kernel": "chain_wl"
            }.get(attr) or k.name


def _kernels(eng):
    """{report name: wrapper} of the kernels an engine holds."""
    return {_kernel_name(eng, attr): getattr(eng, attr)
            for attr in _KERNEL_ATTRS if getattr(eng, attr, None) is not None}


def dense_rank_checks(eng, s, seed=12):
    """The dense engine's kernels against their plain versions on this
    rank's walkers of ``s``: the fused cycle over one cycle with the same
    draws, and the full energy of each lattice.  Returns {report name:
    (walkers with differing integers, largest error relative to
    max(1, |plain|))}.  Launches made here are checks: the caller sets
    the counts to 0 afterwards."""
    sk, sp, differ = fused_compare(eng, s, kernel_draws(eng, s, seed))
    out = {_kernel_name(eng, "fused_cycle"):
           (int(differ.sum()), fused_max_err(sk, sp, ~differ))}
    err = 0.0
    for l in range(s.r.shape[0]):
        rel, merr, mscale = full_energy_errors(eng.full_energy, s.r[l],
                                               s.h[l])
        err = max(err, rel, merr / max(1.0, mscale))
    out["full_energy"] = (0, err)
    return out


def cell_rank_checks(eng, s, tbl=3, seed=14):
    """The walker-sharded cell engine's kernels (T=1, 'apply') against
    their plain versions on this rank's walkers of ``s``: the mover
    energies of table row ``tbl``, the chain + WL pass on them and the
    apply with its accepts (``cell_substep_compare``).  Returns {report
    name: (differing walkers or slab entries, largest error)}."""
    cmp = cell_substep_compare(eng, s, tbl, seed)
    me, ch, ap = (cmp[k] for k in ("mover_energies", "chain_wl",
                                   "mover_apply"))
    return {eng.mover_kernel.name: (0, max(me["e_err"], me["own_err"])),
            "chain_wl": (int(ch["differ"].sum()),
                         max(ch["cf_err"], ch["wl_err"])),
            "mover_apply": (int(not ap["rest_equal"]), ap["mom_err"])}


def _host_state(s):
    from mc_water_ls_mw_tpu_torch.mcmc.state import state_to_numpy

    return state_to_numpy(s)


def _np_diff(x, y) -> float:
    """Largest |x - y| of two float arrays, inf unless they are
    non-finite in the same places with the same values."""
    fin = np.isfinite(x)
    if not (np.array_equal(fin, np.isfinite(y))
            and np.array_equal(x[~fin], y[~fin], equal_nan=True)):
        return float("inf")
    return float(np.max(np.abs(x[fin] - y[fin]))) if fin.any() else 0.0


def _rank_gate(tag, ref, got, tol=RANK_F64_TOL):
    """Fail unless two numpy states have identical integer fields and
    float fields within ``tol``; returns the largest float difference."""
    bad, err = [], 0.0
    for name, a in ref.items():
        b = got[name]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype.kind in "fc":
                err = max(err, _np_diff(x, y))
            elif not np.array_equal(x, y):
                bad.append(name)
    print(f"[{tag}] against the serial run: integer fields "
          f"{'identical' if not bad else 'DIFFER: ' + str(bad)}, float "
          f"fields max |diff| {err:.3e} (limit {tol:g})", flush=True)
    if bad or not err <= tol:
        fail(f"{tag}: the sharded run is not the serial run")
    return err


def _rank_checks(tag, checked, launched):
    """Print the kernel checks of a phase's ranks (``checked``: the rank
    jobs' results with a "check") and fail unless every kernel agrees
    with its plain version (no walker or entry differing, largest error
    within RANK_F64_TOL) and every kernel launched by the jobs
    ``launched`` was checked."""
    names = set()
    for r, res in enumerate(checked):
        chk = res["check"]
        print(f"[{tag}] rank {r}: kernels against their plain versions on "
              "this rank's inputs, float64 (differing walkers or entries, "
              f"largest error): {chk}", flush=True)
        for name, (n_diff, err) in chk.items():
            if n_diff or not err <= RANK_F64_TOL:
                fail(f"{tag}: {name} disagrees with its plain version on "
                     f"rank {r}'s inputs")
        names |= set(chk)
    missed = {name for res in launched
              for name, n in res["launches"].items() if n} - names
    if missed:
        fail(f"{tag}: {sorted(missed)} launched but not held against "
             "their plain versions")


def dense_run_checks(tag, eng, s, launched):
    """Hold the dense engine's kernels against their plain versions on
    ``s``, the final state of a run through ``eng`` (dense_rank_checks),
    and fail as _rank_checks does: on any differing walker, an error
    over RANK_F64_TOL, or a kernel of ``launched`` ({engine attribute:
    launches of the run}) left unchecked."""
    _rank_checks(tag, [{"check": dense_rank_checks(eng, s)}],
                 [{"launches": {_kernel_name(eng, a): n
                                for a, n in launched.items()}}])


def _timed_cycles(comm, eng, s, n_warm, n_cycles):
    """(state, seconds, launches) of ``n_cycles`` cycles after ``n_warm``,
    between barriers of the ranks, with the kernels' counts set to 0
    just before the timed cycles and read just after."""
    import torch

    if n_warm:
        s, _ = eng.run_cycles(s, n_warm)
    for k in _kernels(eng).values():
        k.launches = 0
    torch.cuda.synchronize()
    comm.barrier()
    t0 = time.time()
    s, _ = eng.run_cycles(s, n_cycles)
    torch.cuda.synchronize()
    comm.barrier()
    secs = time.time() - t0
    return s, secs, {n: k.launches for n, k in _kernels(eng).items()}


def rank_dense(comm, W, dtype, n_cycles, warm=0, check=False, **over):
    """12a on one rank of ``comm`` (SINGLE: the serial run): the N=216
    sample run at W walkers sharded over the ranks; with ``check`` the
    fused cycle's and the full energy's kernels against their plain
    versions on this rank's walkers first."""
    from mc_water_ls_mw_tpu_torch.parallel.mesh import (
        gather_state,
        shard_state,
    )

    prm = sample_params(W, dtype, **over)
    eng, s = make_engine(prm, comm=comm)
    s = shard_state(s, comm, W)
    out = {}
    if check:
        out["check"] = dense_rank_checks(eng, s)
    s, out["seconds"], out["launches"] = _timed_cycles(comm, eng, s, warm,
                                                       n_cycles)
    out["state"] = _host_state(gather_state(s, comm))
    return out


def _spatial_mesh(comm, walkers):
    from mc_water_ls_mw_tpu_torch.parallel.spatial import make_spatial_mesh

    return make_spatial_mesh(comm, walkers)


def rank_cell(comm, W, dtype, n_cycles=1, warm=0, spatial=None,
              sweeps=None, n_tables=None, check=False, **over):
    """12b and 13 on one rank of ``comm``: the N=8064 cell engine at W
    walkers, sharded over the walkers, or with ``spatial`` = walker ranks
    the spatial engine over the rest; cycles cut to ``sweeps`` sweeps of
    the first ``n_tables`` tables.  With ``check`` the kernels against
    their plain versions first, on this rank's walkers (walker sharding)
    or local slabs and assembled chain tables (spatial); the spatial
    engine's halo refresh timed."""
    import torch

    from mc_water_ls_mw_tpu_torch.parallel.mesh import (
        gather_state,
        shard_state,
    )

    prm = cell_params(W, dtype, **over)
    if spatial is None:
        eng, s = make_cell_engine(prm, comm=comm)
    else:
        eng, s = make_cell_engine(prm, mesh=_spatial_mesh(comm, spatial))
    out = {"n_sub_cycle": eng.sweeps_per_cycle * eng.n_tables}
    if sweeps:
        eng.sweeps_per_cycle = sweeps
        eng.n_tables = n_tables or eng.n_tables
        eng.trials_per_cycle = sweeps * eng.n_tables * eng.K * eng.T
    out["n_sub"] = eng.sweeps_per_cycle * eng.n_tables
    s = shard_state(s, eng.comm, W)
    if check and spatial is None:
        out["check"] = cell_rank_checks(eng, s)
    if spatial is not None:
        out["plan"] = (eng.plan.ndev, eng.plan.rows_owned,
                       eng.plan.rows_halo, eng.plan.K_loc)
        if check:
            out["check"], out["check_at"] = spatial_kernel_checks(eng, s)
        if eng.plan.ndev > 1:
            pks_loc = eng._local_view(s)[0]
            eng._refresh_halo(pks_loc)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(5):
                eng._refresh_halo(pks_loc)
            torch.cuda.synchronize()
            out["halo"] = (eng.halo_bytes(pks_loc),
                           (time.time() - t0) / 5 * 1e3)
            del pks_loc
    s, out["seconds"], out["launches"] = _timed_cycles(comm, eng, s, warm,
                                                       n_cycles)
    out["vol_moves"] = int(eng.comm.max(s.att[1].max()))
    out["state"] = (_host_state(gather_state(s, eng.comm))
                    if dtype == "float64" else None)
    return out


def spatial_kernel_checks(eng, s, seed=13):
    """The spatial engine's kernels against their plain versions on this
    rank's local slabs [owned | halos | dummy] at a table whose schedule
    is padded (padding on the dummy row): the mover energies (T=1) or
    points (T>1); the chain + WL pass on the tables assembled from every
    space rank's owned movers, as the sub-step assembles them, on clones
    of the chain rows and WL slabs; then the apply kernel with a random
    half of the real movers accepted, on copies of the slabs, compared on
    every row but the dummy (whose contents are garbage by design).
    Collective over the space ranks.  Returns ({report name: (differing
    walkers or entries, largest error)}, (the table, its padded movers,
    the accepted ones)).  Launches made here are checks: the caller sets
    the counts to 0 afterwards."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    pks_loc, st_loc, rows, rows_loc = eng._local_view(
        s, eng._switch_ok(s.cycle + 1))
    wl_active = s.cycle + 1 >= eng.prm.eq_mc_cycles
    pad = (~eng.vj).any(dim=1)
    t = int(torch.nonzero(pad)[0]) if bool(pad.any()) else 0
    tab, mvc = eng.ltabs[t], eng.mvc[t]
    K, T, W = eng.K, eng.T, s.r.shape[-1]
    u_g = torch.rand((eng.n_u, K, W), generator=gen, dtype=s.r.dtype,
                     device=DEVICE)
    ua, uz = torch.rand((2, K * T, W), generator=gen, dtype=s.r.dtype,
                        device=DEVICE)
    codes = torch.zeros((K * T,), dtype=torch.int32, device=DEVICE)
    codes[K * T // 2] = SWITCH
    u = u_g[:, mvc]
    out = {}
    if T == 1:
        trial = eng._propose_t1(st_loc, pks_loc, tab, u, rows_loc)
        e_p, own_p = eng.mover_kernel.plain(
            pks_loc, st_loc.h, tab.cand, tab.off, tab.row, trial.rank,
            trial.p_old, trial.p_new)
        out[eng.mover_kernel.name] = (0, max(_max_abs(trial.e, e_p),
                                             _max_abs(trial.own_new, own_p)))
        L, Kl, _, _ = trial.e.shape
        g = eng._to_global(t, torch.cat([
            trial.e.transpose(1, 2).reshape(2 * L, Kl, W),
            rows_loc.inc[:, 1][None], trial.hasm[None]]))
        rows.inc[:, 1] = g[2 * L]
        e_g = g[:2 * L].view(L, 2, K, W).transpose(1, 2).contiguous()
        inc_g, hasm_g, ua, uz = rows.inc, g[2 * L + 1], u_g[5], u_g[6]
        p_new, own = trial.p_new, trial.own_new
    else:
        u = u[:4 + 3 * T]
        trial = eng._propose_tm(st_loc, pks_loc, tab, u, rows_loc)
        e_p, own_p = eng.points_kernel.plain(
            pks_loc, st_loc.h, tab.cand, tab.off, tab.row, trial.rank,
            trial.pts)
        out["mover_points"] = (0, max(_max_abs(trial.e, e_p),
                                      _max_abs(trial.own, own_p)))
        L, Kl, P, _ = trial.e.shape
        g = eng._to_global(t, torch.cat([
            trial.e.permute(0, 2, 1, 3).reshape(L * P, Kl, W),
            trial.inc.transpose(0, 1), trial.hasm[None]]))
        e_g = g[:L * P].view(L, P, K, W).transpose(1, 2).contiguous()
        inc_g = g[L * P:L * P + P].transpose(0, 1).contiguous()
        hasm_g = g[-1]
        p_new = trial.pts[1].contiguous()
        own = trial.own[:, :, 1].contiguous()
    if eng.use_chain_kernel:
        ch = chain_compare(eng, s, rows, e_g, inc_g, hasm_g, codes, ua, uz,
                           wl_active)[0]
        out["chain_wl"] = (int(ch["differ"].sum()),
                           max(ch["cf_err"], ch["wl_err"]))
    # every other (mover, walker) of the real movers accepted
    k, w = torch.meshgrid(torch.arange(trial.rank.shape[0], device=DEVICE),
                          torch.arange(W, device=DEVICE), indexing="ij")
    acc = (((k + w) % 2 == 0) & eng.vj[t][:, None]).to(s.r.dtype)
    p_old = trial.p_old if T == 1 else trial.pts[0].contiguous()
    pk_k = [p.clone() for p in pks_loc]
    pk_p = [p.clone() for p in pks_loc]
    eng.apply_kernel(pk_k, st_loc.h, tab.cand, tab.off, tab.row, trial.rank,
                     acc, p_old, p_new, own)
    eng.apply_kernel.plain(pk_p, st_loc.h, tab.cand, tab.off, tab.row,
                           trial.rank, acc, p_old, p_new, own)
    dummy = eng.plan.dummy_row
    out["mover_apply"] = (0, max(_max_abs(a[:dummy], b[:dummy])
                                 for a, b in zip(pk_k, pk_p)))
    return out, (t, int((~eng.vj[t]).sum()), int(acc.sum()))


def rank_frontend(comm, d, over, n_cycles, check=False):
    """12c on one rank: run_input_file of ``d``/ice.input (its ranks
    are this process's group); with ``check`` its engine's kernels
    against their plain versions on this rank's walkers of the final
    state, after the run's launches are read."""
    out = _app_calls(d, over, [n_cycles], {"fused_cycle": "fused_cycle",
                                           "full_energy": "full_energy"})[0]
    eng = out["app"].engine
    res = {"launches": {_kernel_name(eng, a): n
                        for a, n in out["launches"].items()},
           "cycle": int(out["s"].cycle), "seconds": out["wall"]}
    if check:
        res["check"] = dense_rank_checks(eng, out["s"])
    return res


def rank_jobs(comm, jobs):
    """Run the jobs (name of a rank_* function, its keywords) in order
    on this rank; returns their results."""
    out = []
    for name, kw in jobs:
        t0 = time.time()
        res = globals()[name](comm, **kw)
        res["wall"] = time.time() - t0
        out.append(res)
    return out


def _fe_dir(name):
    import shutil

    d = os.path.join(ROOT, "build", "chip_smoke_ranks", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in ("ice.input", "eta_weights.dat"):
        shutil.copy(os.path.join(ROOT, "runs", "n216_sample_dd", f), d)
    return d


def _same_numbers(x: bytes, y: bytes):
    """(equal, tokens that differ): two text files with the same words,
    numbers equal within RANK_F64_TOL relative to max(1, |number|)."""
    la, lb = x.decode().split(), y.decode().split()
    if len(la) != len(lb):
        return False, -1
    n = 0
    for a, b in zip(la, lb):
        if a == b:
            continue
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            return False, n
        if not abs(fa - fb) <= RANK_F64_TOL * max(1.0, abs(fa), abs(fb)):
            return False, n
        n += 1
    return True, n


def _fe_same_files(tag, d1, d2):
    """Fail unless two run directories hold the same files: every file
    byte for byte (mc.log without its block timings and the sharding
    line) or, where the monitor's audit prints round-off (its drift
    lines: the audit is plain PyTorch, whose reductions on the card may
    group a sum differently at another walker count), the same words
    and numbers within RANK_F64_TOL; the checkpoints' integer arrays
    equal and their float arrays within RANK_F64_TOL."""
    names = sorted(os.listdir(d1))
    if names != sorted(os.listdir(d2)):
        fail(f"{tag}: different files {names} / {sorted(os.listdir(d2))}")
    ck_err, near = 0.0, {}
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.startswith("checkpoint"):
            with np.load(p1) as a, np.load(p2) as b:
                if sorted(a.files) != sorted(b.files):
                    fail(f"{tag}: checkpoint {name} differs")
                for k in a.files:
                    x, y = a[k], b[k]
                    if x.dtype.kind == "f":
                        ck_err = max(ck_err, _np_diff(x, y))
                    elif not np.array_equal(x, y):
                        fail(f"{tag}: checkpoint {name} array {k} differs")
            if not ck_err <= RANK_F64_TOL:
                fail(f"{tag}: checkpoint {name} differs by {ck_err:.3e}")
            continue
        x, y = (open(p, "rb").read() for p in (p1, p2))
        if name == "mc.log":
            x, y = (b"\n".join(ln for ln in v.split(b"\n")
                               if not ln.startswith((b"# block",
                                                     b"# Sharding")))
                    for v in (x, y))
        if x != y:
            same, n = _same_numbers(x, y)
            if not same:
                diff = [(a, b) for a, b in zip(x.split(b"\n"), y.split(b"\n"))
                        if a != b][:3]
                fail(f"{tag}: {name} differs: {diff}")
            near[name] = n
    print(f"[{tag}] {len(names)} files: byte for byte identical but "
          f"{near} (numbers differing within {RANK_F64_TOL:g} relative, by "
          f"file; mc.log without its block timings); checkpoint arrays max "
          f"|diff| {ck_err:.3e}", flush=True)


def ranks_phases(kind, card):
    """Phases 12 (walker sharding: 12a dense, 12b cell, 12c front end)
    and 13 (the spatial engine: 13a one rank, 13b two ranks at T=1, 13c
    at T=8, 13d space 2 x walkers 2), each sharded run on ranks of a gloo
    group spawned on this card and held against the serial run in this
    process.  Returns {"launches": {report row: launches of the sharded
    runs}}."""
    import torch

    from mc_water_ls_mw_tpu_torch.parallel import comm as comm_mod

    single = comm_mod.SINGLE
    print("[ranks] backend gloo, ranks spawned on cuda:0 (NCCL refuses two "
          "ranks on one card); a rank's card tensors reach the collectives "
          "through host copies", flush=True)
    N, Nc = 216, 4 * CELL_STACK[0] * CELL_STACK[1] * CELL_STACK[2]
    dense64 = dict(W=RANK_W64, dtype="float64", n_cycles=RANK_F64_CYCLES,
                   **RANK_DENSE_CUTS)
    dense32 = dict(W=W_MAIN, dtype="float32", n_cycles=RANK_TIMED[1],
                   warm=RANK_TIMED[0])
    cell64 = dict(W=4, dtype="float64", **RANK_CELL_CUTS)
    cell32 = dict(W=W_CELL, dtype="float32", **RANK_CELL_F32)
    sp = dict(sweeps=1, **SPATIAL_CUTS)
    sp64 = {T: dict(W=2, dtype="float64", cell_trials=T, **sp)
            for T in (1, MULTI_T)}
    sp32 = {T: dict(W=W_SPATIAL, dtype="float32", cell_trials=T,
                    n_tables=SPATIAL_TIMED_SUB, **sp) for T in (1, MULTI_T)}
    grid64 = dict(sp64[1], W=4)

    # the serial runs
    t0 = time.time()
    d_one, d_two = _fe_dir("one"), _fe_dir("two")
    ref = {}
    for key, kw in (("dense64", dense64), ("dense32", dense32),
                    ("cell64", cell64), ("cell32", cell32),
                    ("sp64_1", sp64[1]), ("sp64_8", sp64[MULTI_T]),
                    ("grid64", grid64), ("sp32_1", sp32[1]),
                    ("sp32_8", sp32[MULTI_T]),
                    # 13a: the spatial engine's degenerate plan
                    ("d1_64", dict(sp64[1], spatial=1, check=True)),
                    ("d1_32", dict(sp32[1], spatial=1)),
                    ("fe", dict(d=d_one, over=RANK_FE,
                                n_cycles=RANK_FE_CYCLES[0]))):
        ref[key] = rank_jobs(single, [(
            "rank_dense" if key.startswith("dense") else
            "rank_frontend" if key == "fe" else "rank_cell", kw)])[0]
    torch.cuda.empty_cache()
    print(f"[ranks] serial runs in {time.time() - t0:.1f} s", flush=True)

    # the ranks: one group of 2 for 12a-c, 13b and 13c, one of 4 for 13d
    jobs2 = [("rank_dense", dict(dense64, check=True)),
             ("rank_dense", dense32),
             ("rank_cell", dict(cell64, check=True)), ("rank_cell", cell32),
             ("rank_frontend", dict(d=d_two, over=RANK_FE,
                                    n_cycles=RANK_FE_CYCLES[0], check=True)),
             ("rank_cell", dict(sp64[1], spatial=1, check=True)),
             ("rank_cell", dict(sp32[1], spatial=1)),
             ("rank_cell", dict(sp64[MULTI_T], spatial=1, check=True)),
             ("rank_cell", dict(sp32[MULTI_T], spatial=1))]
    jobs4 = [("rank_cell", dict(grid64, spatial=2, check=True)),
             ("rank_cell", dict(sp32[1], spatial=2))]
    t0 = time.time()
    two = comm_mod.run_ranks(rank_jobs, 2, jobs2, timeout_s=400)
    t2 = time.time() - t0
    t0 = time.time()
    four = comm_mod.run_ranks(rank_jobs, 4, jobs4, timeout_s=300)
    t4 = time.time() - t0
    print(f"[ranks] 2 ranks: {t2:.1f} s, 4 ranks: {t4:.1f} s "
          "with their start-up; rank 0's jobs "
          f"{[(n, round(r['wall'], 1)) for (n, _), r in zip(jobs2, two[0])]}"
          f" {[(n, round(r['wall'], 1)) for (n, _), r in zip(jobs4, four[0])]}",
          flush=True)
    launches = {}

    def count(res, rows=None):
        for r in res:
            for name, n in r["launches"].items():
                name = (rows or {}).get(name, name)
                launches[name] = launches.get(name, 0) + n

    d64, d32, c64, c32, fe, s1, s1f, s8, s8f = two[0]
    # ---- 12a
    _rank_gate("12a dense f64", ref["dense64"]["state"], d64["state"])
    _rank_checks("12a", [r[0] for r in two], [r[0] for r in two]
                 + [r[1] for r in two])
    att = d64["state"]["att"].sum(axis=1)
    if att[1] <= 0:
        fail("12a: no volume move in the float64 gate")
    rate1 = W_MAIN * N * RANK_TIMED[1] / ref["dense32"]["seconds"]
    rate2 = W_MAIN * N * RANK_TIMED[1] / max(r[1]["seconds"] for r in two)
    print(f"[12a] N=216 W={W_MAIN} f32 sample run, {RANK_TIMED[1]} cycles "
          f"after {RANK_TIMED[0]}: 1 rank {rate1:.4e} moves/s, 2 ranks x "
          f"{W_MAIN // 2} on the one card {rate2:.4e} moves/s on {kind} "
          f"({card}); attempts trans/vol/switch of the f64 gate "
          f"{att.tolist()}", flush=True)
    count([r[0] for r in two] + [r[1] for r in two])
    # ---- 12b
    _rank_gate("12b cell f64", ref["cell64"]["state"], c64["state"])
    _rank_checks("12b", [r[2] for r in two], [r[2] for r in two]
                 + [r[3] for r in two])
    if c64["vol_moves"] <= 0:
        fail("12b: no volume move in the float64 gate")
    s_1, s_2 = ref["cell32"]["seconds"], max(r[3]["seconds"] for r in two)
    print(f"[12b] N={Nc} T=1 'apply' W={W_CELL} f32, one cycle: 1 rank "
          f"{s_1:.3f} s ({Nc * W_CELL / s_1:.4e} trials/s), 2 ranks x "
          f"{W_CELL // 2} {s_2:.3f} s ({Nc * W_CELL / s_2:.4e} trials/s) on "
          f"{kind} ({card}); volume moves per walker of the f64 gate "
          f"{c64['vol_moves']}", flush=True)
    count([r[2] for r in two] + [r[3] for r in two])
    # ---- 12c
    _fe_same_files("12c 2 ranks vs 1", d_one, d_two)
    _rank_checks("12c", [r[4] for r in two], [r[4] for r in two])
    t0 = time.time()
    out1 = rank_frontend(single, d_one, RANK_FE, RANK_FE_CYCLES[1])
    out2 = rank_frontend(single, d_two, RANK_FE, RANK_FE_CYCLES[1])
    fe_resumed = time.time() - t0
    if out2["cycle"] != sum(RANK_FE_CYCLES) or "# Restarting from cycle" \
            not in open(os.path.join(d_two, "node000.log")).read():
        fail("12c: the 2-rank checkpoint did not resume on one rank")
    _fe_same_files("12c resumed on 1 rank from 2 ranks vs from 1", d_one,
                   d_two)
    print(f"[12c] runs/n216_sample_dd f64 W={RANK_FE['n_walkers']} over "
          f"{RANK_FE['n_windows']} windows: 2 ranks {fe['seconds']:.1f} s, "
          f"1 rank {ref['fe']['seconds']:.1f} s for {RANK_FE_CYCLES[0]} "
          f"cycles with set-up; resumed on 1 rank to cycle "
          f"{out2['cycle']} ({out1['seconds']:.1f} / {out2['seconds']:.1f} "
          "s)", flush=True)
    count([r[4] for r in two])
    # ---- 13
    _rank_gate("13a D=1 f64", ref["sp64_1"]["state"], ref["d1_64"]["state"])
    _rank_checks("13a", [ref["d1_64"]], [ref["d1_64"], ref["d1_32"]])
    print(f"[13a] {ref['d1_32']['n_sub']} sub-steps f32 W={W_SPATIAL}: "
          f"CellEngine {ref['sp32_1']['seconds']:.3f} s, spatial D=1 "
          f"{ref['d1_32']['seconds']:.3f} s", flush=True)
    for tag, T, rf, res64, res32 in (
            ("13b", 1, "sp32_1", [r[5] for r in two], [r[6] for r in two]),
            ("13c", MULTI_T, "sp32_8", [r[7] for r in two],
             [r[8] for r in two]),
            ("13d", 1, "sp32_1", [r[0] for r in four],
             [r[1] for r in four])):
        key = "grid64" if tag == "13d" else f"sp64_{T}"
        _rank_gate(f"{tag} f64", ref[key]["state"], res64[0]["state"])
        for r, res in enumerate(res64):
            print(f"[{tag}] rank {r} plan (D, rows owned, halo rows per "
                  f"side, K_loc) {res['plan']}; kernel checks at (table, "
                  f"padded movers, accepted) {res['check_at']}", flush=True)
        _rank_checks(tag, res64, res64 + res32)
        secs = max(r["seconds"] for r in res32)
        hb, hms = res32[0]["halo"]
        n_sub, n_cyc = res32[0]["n_sub"], res32[0]["n_sub_cycle"]
        ms1 = ref[rf]["seconds"] / n_sub * 1e3
        ms = secs / n_sub * 1e3
        print(f"[{tag}] N={Nc} T={T} f32 W={W_SPATIAL}, {n_sub} sub-steps: "
              f"serial {ms1:.3f} ms, {len(res32)} ranks {ms:.2f} ms per "
              f"sub-step (x {n_cyc} sub-steps a cycle: {ms1 * n_cyc / 1e3:.2f}"
              f" s / {ms * n_cyc / 1e3:.1f} s of sub-step loop); halo refresh "
              f"{hb} bytes sent per rank, {hms:.2f} ms, {hms / ms:.2f} of a "
              f"sub-step (all-gather ring) on {kind} ({card})", flush=True)
        rows = {"mover_apply": APPLY_MT, "chain_wl": CHAIN_T8} if T > 1 \
            else None
        count(res32, rows)
        count(res64, rows)
    # each phase's seconds: its serial runs and rank 0's jobs (the ranks
    # of a group run their jobs in step); the groups' start-up apart
    walls2, walls4 = [r["wall"] for r in two[0]], [r["wall"] for r in four[0]]
    for name, keys, jobs in (
            ("12a. walker-sharded dense engine (N=216)",
             ("dense64", "dense32"), walls2[0:2]),
            ("12b. walker-sharded cell engine (N=8064)",
             ("cell64", "cell32"), walls2[2:4]),
            ("12c. front end on 2 ranks (runs/n216_sample_dd)",
             ("fe",), walls2[4:5] + [fe_resumed]),
            ("13a. spatial engine, one rank", ("d1_64", "d1_32"), []),
            ("13b. spatial engine, 2 ranks, T=1", ("sp64_1", "sp32_1"),
             walls2[5:7]),
            ("13c. spatial engine, 2 ranks, T=8", ("sp64_8", "sp32_8"),
             walls2[7:9]),
            ("13d. spatial engine, space 2 x walkers 2", ("grid64",),
             walls4)):
        secs = sum(ref[k]["wall"] for k in keys) + sum(jobs)
        print(f"[time] {name}: {secs:.1f} s", flush=True)
    print(f"[time] 12-13 the rank groups' start-up: "
          f"{t2 - sum(walls2) + t4 - sum(walls4):.1f} s", flush=True)
    return {"launches": launches}


# ----------------------------------------------------------------------
# 14. the run's own tools on the card
# ----------------------------------------------------------------------

# 14b's supervised run: runs/n216_sample_torch/run.py's overrides (its
# ice.input and eta_weights.dat), cut; the run's own values in comments
WATCH_RUN = dict(
    stack=(3, 3, 6), n_walkers=256,            # 4096
    dtype="float64",                           # float32 (the default)
    mu_min=-700.0, mu_max=700.0, nbins=101, samplerun=True,
    eq_mc_cycles=10,                           # 1000
    mpi_sync_int=50, monitor_int=500,          # 5000
    flat_chk_int=100_000_000, deltaG_int=250,  # 10000
    chkpt_dump_int=100,                        # 25000
    timer_closetime=420, max_mc_cycles=200,    # 100_000_000
)
WATCH_CHUNK = 10        # jit_chunk: a heartbeat every 10 cycles
# the watchdog's flags: a stale heartbeat for 5 s after a 20 s start-up
# grace is a hang (the run's set-up takes ~10 s on the card's machine)
WATCH_FLAGS = ("--stale", "5", "--grace", "20", "--poll", "0.5",
               "--kill-grace", "1", "--max-restarts", "2", "--budget", "900",
               "--probe-backoff", "5")
# the supervised run's script (WATCH_RUN through run_input_file, as
# runs/n216_sample_torch/run.py calls it), which writes its pid first and
# its engine's launch counts last
WATCH_SCRIPT = """import json, os, sys
sys.path.insert(0, {root!r})
from mc_water_ls_mw_tpu_torch import app as app_mod

apps = []


class Recorded(app_mod.Application):
    def setup(self):
        apps.append(self)
        return super().setup()


app_mod.Application = Recorded
with open("run.pid", "w") as fh:
    fh.write(str(os.getpid()))
over = dict({over!r}, timer_qtime=float(os.environ.get("WL_QTIME", "10800")))
s = app_mod.run_input_file("ice.input", overrides=over, jit_chunk={chunk})
app = apps[-1]
with open("launches_%d.json" % os.getpid(), "w") as fh:
    json.dump(dict(start=app.start_cycle, cycle=int(s.cycle),
                   fused_cycle=app.engine.fused_cycle.launches,
                   full_energy=app.engine.full_energy.launches), fh)
"""
THREEBODY = ("4", "16", "--nwater", "216")     # 14c: cycles, walkers
# 14d: the analysis tools on the committed runs (their grids)
ANALYSIS = {
    "deltag_error": ["runs/n216_sample_torch", "--mu-min", "-700",
                     "--mu-max", "700"],
    "deltag_from_weights": ["runs/n216_wl_r2", "--nwater", "216"],
    "compare_dd_mw": ["runs/n216_wl_dd", "runs/n216_wl_r2"],
}
DONE_RUN_DG = ("+0.8506", "0.0337")    # J/mol, the Done run's


def watchdog_run(kind, card):
    """14b: WATCH_RUN under the watchdog (tools/watchdog.py, the card's
    probe gate on) in build/chip_smoke_watchdog, its first launch stopped
    (SIGSTOP: a wedge of the child only) after its first checkpoint;
    then the same input uninterrupted in build/chip_smoke_watchdog_ref
    through this process, and the kernels against their plain versions
    on its final state.  Returns {"launches": {kernel: count of the
    relaunch and of the uninterrupted run}}."""
    import shutil
    import signal

    import torch

    from mc_water_ls_mw_tpu_torch.io import checkpoint as ckpt

    d = os.path.join(ROOT, "build", "chip_smoke_watchdog")
    d_ref = d + "_ref"
    for x in (d, d_ref):
        shutil.rmtree(x, ignore_errors=True)
        os.makedirs(x)
        for name in ("ice.input", "eta_weights.dat"):
            shutil.copy(os.path.join(ROOT, "runs", "n216_sample_torch", name),
                        x)
    with open(os.path.join(d, "run.py"), "w") as fh:
        fh.write(WATCH_SCRIPT.format(root=ROOT, over=WATCH_RUN,
                                     chunk=WATCH_CHUNK))
    pid_file = os.path.join(d, "run.pid")
    first_ckpt = os.path.join(d, "checkpoint000.npz.1")
    t0 = time.time()
    wd = subprocess.Popen(
        [sys.executable, "-m", "mc_water_ls_mw_tpu_torch.tools.watchdog",
         "--workdir", d, "--cmd", f"{sys.executable} run.py",
         "--watch", "heartbeat", *WATCH_FLAGS],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    pid = None
    try:
        while not (os.path.exists(first_ckpt) and os.path.exists(pid_file)):
            if wd.poll() is not None or time.time() - t0 > 120:
                fail("14b: the supervised run wrote no checkpoint")
            time.sleep(0.02)
        pid = int(open(pid_file).read())
        os.kill(pid, signal.SIGSTOP)
        t_stop = time.time() - t0
        stopped_at = int(open(os.path.join(d, "heartbeat")).read())
        out, _ = wd.communicate(timeout=300)
    finally:
        if wd.poll() is None:
            os.killpg(wd.pid, signal.SIGKILL)
            wd.wait()
        if pid is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    t_wd = time.time() - t0
    log = open(os.path.join(d, "watchdog.log")).read()
    print(f"[14b] watchdog over {WATCH_RUN['max_mc_cycles']} cycles of "
          f"runs/n216_sample_torch (W={WATCH_RUN['n_walkers']}, float64, "
          f"jit_chunk={WATCH_CHUNK}): run {pid} stopped at {t_stop:.1f} s, "
          f"heartbeat {stopped_at}; the watchdog exited {wd.returncode} "
          f"after {t_wd:.1f} s; its log:\n{log.rstrip()}", flush=True)
    ends = [json.load(open(os.path.join(d, f))) for f in sorted(os.listdir(d))
            if f.startswith("launches_")]
    logs = "".join(open(os.path.join(d, f)).read()
                   for f in ("mc.log", "node000.log"))
    hb = open(os.path.join(d, "heartbeat")).read()
    kill = log.find("killing process group")
    probe = log.find("backend probe ok")
    if not (wd.returncode == 0 and log.count("launch #") == 2
            and log.count("killing process group") == 1
            and log.count("backend probe ok") == 1 and 0 <= kill < probe
            and log.rstrip().endswith("run exited cleanly (rc=0); done")):
        fail("14b: the watchdog did not kill the stopped run once and "
             "relaunch it once after a probe of the card")
    # max_mc_cycles counts the cycles of one call (as in the JAX app):
    # the relaunch runs them from its checkpoint
    n_cyc = WATCH_RUN["max_mc_cycles"]
    end = ends[0]["start"] + n_cyc if len(ends) == 1 else -1
    if not (stopped_at < n_cyc and len(ends) == 1 and ends[0]["cycle"] == end
            and 0 < ends[0]["start"] <= stopped_at
            and f"# Restarting from cycle {ends[0]['start']} (" in logs
            and hb == f"{end}\n"):
        fail(f"14b: the relaunch did not resume from the checkpoint to the "
             f"end: {ends}, heartbeat {hb!r}")
    relaunch = {k: ends[0][k] for k in ("fused_cycle", "full_energy")}
    if relaunch["fused_cycle"] != n_cyc:
        fail(f"14b: relaunch launches {relaunch}")

    # the same input uninterrupted to the same cycle
    ref = _app_calls(d_ref, dict(WATCH_RUN, timer_qtime=10800.0), [end],
                     {"fused_cycle": "fused_cycle",
                      "full_energy": "full_energy"},
                     jit_chunk=WATCH_CHUNK)[0]
    got, cycle, path = ckpt.load_checkpoint(ref["s"], d)
    same, names, err = state_diff(ref["s"], got)
    hb_ref = open(os.path.join(d_ref, "heartbeat")).read()
    print(f"[14b] resumed at cycle {ends[0]['start']}, ended at {cycle} "
          f"({os.path.basename(path)}); against the uninterrupted run "
          f"({ref['wall']:.1f} s, heartbeat {hb_ref.strip()}): integer "
          f"fields {'identical' if same else 'DIFFER: ' + str(names)}, "
          f"float fields max |diff| {err:.3e} (limit {RANK_F64_TOL:g}); "
          f"launches relaunch {relaunch}, uninterrupted {ref['launches']}; "
          f"{kind} ({card})", flush=True)
    if not (same and err <= RANK_F64_TOL and cycle == ref["s"].cycle
            and hb_ref == hb):
        fail("14b: the supervised run is not the uninterrupted run")
    launches = {k: relaunch[k] + ref["launches"][k] for k in relaunch}
    # the relaunch's kernels and the uninterrupted run's, at the shapes
    # both ran, against their plain versions on the final state (which
    # the relaunch's equals, above)
    dense_run_checks("14b", ref["app"].engine, ref["s"], launches)
    del ref, got
    torch.cuda.empty_cache()
    return {"launches": launches}


def _tool_proc(module, args, block_jax=True):
    """A fresh process running ``module``'s main(args) from the repository
    root, with JAX and the JAX package unimportable (``block_jax``)."""
    code = ("import sys\n"
            + ("sys.modules['jax'] = None\n"
               "sys.modules['mc_water_ls_mw_tpu'] = None\n" if block_jax
               else "")
            + f"sys.path.insert(0, {ROOT!r})\n"
            f"from {module} import main\n"
            f"sys.exit(main({list(args)!r}))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=300):
    """(rc, stdout, stderr) of a process, killed if it outlives
    ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


def tools_phase(kind, card):
    """14: the supervised run (b) and the three-body filter tool on the
    card (c), then side by side in fresh processes: the liveness probe
    (a), the three-body tool with --device cpu (c) and the analysis
    tools where JAX cannot be imported (d).  Returns {"launches":
    {kernel: count of 14b and 14c}}."""
    import threading

    from mc_water_ls_mw_tpu_torch.constants import HART_TO_KJPM, KB
    from mc_water_ls_mw_tpu_torch.liveness import probe_device
    from mc_water_ls_mw_tpu_torch.tools import threebody_filter

    # ---- 14b. the supervised run with a wedge
    launches = watchdog_run(kind, card)["launches"]

    # ---- 14c. the three-body filter tool on the card
    t0 = time.time()
    card_out, tb, ends = threebody_filter.measure(
        int(THREEBODY[0]), int(THREEBODY[1]), (216,), device=DEVICE)
    t_card = time.time() - t0

    # ---- 14a, 14c's CPU side and 14d, each in a fresh process, side by
    # side (each spends its first seconds importing torch)
    t0 = time.time()
    probe = {}
    th = threading.Thread(target=lambda: probe.update(
        res=probe_device(), s=time.time() - t0))
    th.start()
    cpu_proc = _tool_proc("mc_water_ls_mw_tpu_torch.tools.threebody_filter",
                          [*THREEBODY, "--device", "cpu"], block_jax=False)
    procs = {name: _tool_proc(f"mc_water_ls_mw_tpu_torch.tools.{name}", args)
             for name, args in ANALYSIS.items()}
    rc, cpu_json, cpu_err = _finish(cpu_proc)
    outs = {name: _finish(proc) for name, proc in procs.items()}
    th.join()
    t_procs = time.time() - t0

    status, op_s = probe["res"]
    print(f"[14a] liveness.probe_device: {status}, op {op_s:.3f} s "
          f"({probe['s']:.1f} s with the process) on {kind} ({card})",
          flush=True)
    if status != "ok":
        fail(f"14a: the card's probe says {status}")

    if rc != 0:
        fail(f"14c: the three-body tool with --device cpu failed: "
             f"{cpu_err[-2000:]}")
    cpu_out = json.loads(cpu_json)
    print(f"[14c] tools.threebody_filter {' '.join(THREEBODY)} on {kind} "
          f"({t_card:.1f} s, launches {tb}): {json.dumps(card_out)}; with "
          f"--device cpu (a process): {json.dumps(cpu_out)}", flush=True)
    a, b = card_out["n216"], cpu_out["n216"]
    ideal = ("ideal_dE_hartree", "ideal_triplets")
    if not (card_out.keys() == cpu_out.keys()
            and all(np.isfinite(v) for v in list(a.values()) + list(b.values()))
            and all(a[k] == b[k] for k in ideal)
            and all(abs(a[k] - b[k]) <= 1e-9 * max(abs(a[k]), abs(b[k]))
                    for k in a if k not in ideal)
            and min(tb.values()) > 0):
        fail("14c: the three-body filter on the card is not the CPU's")
    # the card's and the CPU's walks draw different Philox streams, so
    # the kernels are held against their plain versions on the card's
    # final state, at the shapes the tool ran
    dense_run_checks("14c", *ends[216], tb)
    del ends
    for k in launches:
        launches[k] += tb[k]

    for name, (rc, out, err) in outs.items():
        print(f"[14d] tools.{name} {' '.join(ANALYSIS[name])} (JAX "
              f"blocked, rc {rc}):\n{out.rstrip()}", flush=True)
        if rc != 0:
            fail(f"14d: tools.{name} failed: {err[-2000:]}")
    print(f"[14a, 14c, 14d] the five processes side by side: "
          f"{t_procs:.1f} s", flush=True)
    line = [ln for ln in outs["deltag_error"][1].splitlines()
            if "kT/molecule" in ln][0]
    dg, se = (float(x) for x in line.split("=")[1].split("kT")[0]
              .split("+-"))
    j_per_mol = KB * 200.0 * HART_TO_KJPM * 1000.0
    got = (f"{dg * j_per_mol:+.4f}", f"{se * j_per_mol:.4f}")
    print(f"[14d] the Done run's Delta G: {got[0]} +- {got[1]} J/mol "
          f"(committed: {DONE_RUN_DG[0]} +- {DONE_RUN_DG[1]})", flush=True)
    if got != DONE_RUN_DG:
        fail("14d: deltag_error does not reproduce the Done run's Delta G")
    json.loads(outs["compare_dd_mw"][1])
    return {"launches": launches}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "mc_water_ls_mw_tpu_torch")):
        fail("run it from the repository root: mc_water_ls_mw_tpu_torch/ "
             "is not beside this script")
    sys.path.insert(0, ROOT)
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"[device] {kind} x{torch.cuda.device_count()} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.mcmc.wanglandau import deltaG_from_uhist
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.dense import reduced_shift_set
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64
    from mc_water_ls_mw_tpu_torch.ops.full_energy import FullEnergyKernel

    # ---- 2. build
    t0 = time.time()
    built = cuda_build.build_all()
    print(f"[build] {len(built)} libraries in {time.time() - t0:.1f} s",
          flush=True)
    for name, (path, secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln]
        print(f"[build] {name}: {secs:.1f} s {os.path.basename(path)}",
              flush=True)
        for ln in regs:
            print(f"[build]   {ln}", flush=True)

    phase_time("1-2. device and build")
    report = {}
    W = W_MAIN

    # ---- 3. FullEnergyKernel vs plain
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    shifts = reduced_shift_set(stacking_switch_pair(3, 3, 6)[1], MW)
    fe = FullEnergyKernel(MW, shifts)
    for dtype in (torch.float64, torch.float32):
        for l, (r3, H) in enumerate(jittered_cells(W, dtype, seed=1)):
            rel, merr, mscale = full_energy_errors(fe, r3, H)
            print(f"[full_energy] {str(dtype)[6:]} lattice {l}: E rel err "
                  f"{rel:.3e}, moments max abs err {merr:.3e} "
                  f"(max |mom| {mscale:.3f})", flush=True)
            if dtype == torch.float64:
                if not (rel <= 1e-12 and merr <= 1e-12 * max(1, mscale)):
                    fail("FullEnergyKernel fp64 disagrees with its plain "
                         "version")
            elif not (rel <= F32_E_RTOL and merr <= F32_MOM_ATOL):
                fail("FullEnergyKernel f32 disagrees with its plain version")
    r3, H = jittered_cells(W, torch.float32, seed=1)[1]
    rel, merr, _ = full_energy_errors(fe, r3, H)
    e_p, _ = fe.plain(r3, H)
    fe_ms = cuda_ms(lambda: fe(r3, H), 20)
    fe_plain_ms = cuda_ms(lambda: fe.plain(r3, H), 3)
    fe_bound_ms, fe_bound_by = full_energy_bound(r3, H, len(shifts))
    e_k, _ = fe(r3, H)
    fe_occ = fe.occupancy(torch.float32, r3.shape[1], W)
    report["full_energy"] = dict(
        max_abs_err=float(torch.max(torch.abs(e_k - e_p))),
        ms=fe_ms, plain_ms=fe_plain_ms, bound_ms=fe_bound_ms,
        bound_by=fe_bound_by, **occupancy_keys(fe_occ))
    print(f"[full_energy] f32 W={W}: kernel {fe_ms:.3f} ms, plain "
          f"{fe_plain_ms:.3f} ms, bound {fe_bound_ms:.4f} ms "
          f"({fe_bound_by}); {fe.plan(torch.float32, r3.shape[1], W)}; "
          f"{occupancy_text(fe_occ)}", flush=True)

    # three folded shifts: the N=48 cells of the (1,2,6) stacking pair
    shifts48 = reduced_shift_set(stacking_switch_pair(1, 2, 6)[1], MW)
    fe48 = FullEnergyKernel(MW, shifts48)
    for dtype in (torch.float64, torch.float32):
        for l, (r3, H) in enumerate(jittered_cells(W, dtype, seed=2,
                                                   stack=(1, 2, 6))):
            rel, merr, mscale = full_energy_errors(fe48, r3, H)
            print(f"[full_energy] N=48 S={len(shifts48)} {str(dtype)[6:]} "
                  f"lattice {l}: E rel err {rel:.3e}, moments max abs err "
                  f"{merr:.3e} (max |mom| {mscale:.3f})", flush=True)
            if dtype == torch.float64:
                if not (rel <= 1e-12 and merr <= 1e-12 * max(1, mscale)):
                    fail("FullEnergyKernel fp64 at S=3 disagrees with its "
                         "plain version")
            elif not (rel <= F32_E_RTOL and merr <= F32_MOM_ATOL):
                fail("FullEnergyKernel f32 at S=3 disagrees with its plain "
                     "version")
    print(f"[full_energy] N=48 S={len(shifts48)} f32 W={W}: kernel "
          f"{cuda_ms(lambda: fe48(r3, H), 20):.4f} ms, plain "
          f"{cuda_ms(lambda: fe48.plain(r3, H), 3):.3f} ms", flush=True)

    phase_time("3. full energy")

    # ---- 4. FusedCycle's kernels vs plain: the table branch, 4b. the
    # dense-candidate branch at N=216 (one shift) and N=48 (three), 4c.
    # the multi-trial branch at T=8
    for samplerun in (True, False):
        fused_kernel_check(sample_params(
            W_FP64, "float64", samplerun=samplerun,
            wl_factor=0.0 if samplerun else 0.005, eq_mc_cycles=0), "fused")
    report["fused_cycle"] = fused_kernel_check(
        sample_params(W, "float32", eq_mc_cycles=0), "fused", reps=5)
    phase_time("4. fused cycle")

    for case in ("n216", "n48"):
        sample = case == "n216"          # path B samples, path A builds WL
        for Wk, dt in ((W_FP64, "float64"), (W, "float32")):
            out = fused_kernel_check(
                dense_params(Wk, dt, case, samplerun=sample,
                             wl_factor=0.0 if sample else 0.005,
                             eq_mc_cycles=0),
                f"dense-{case}", reps=3 if dt == "float32" else 0)
            if sample and out is not None:
                report["fused_cycle_dense"] = out
    phase_time("4b. dense-candidate kernel")

    fused_kernel_check(multi_params(W_FP64, "float64", MULTI_T,
                                    eq_mc_cycles=0), "multi",
                       paper_pair=True)
    for T in MULTI_TS:             # path C's trial counts, T=8 last
        report[multi_name(T)] = fused_kernel_check(
            multi_params(W, "float32", T, eq_mc_cycles=0), "multi", reps=5,
            paper_pair=True)
    torch.cuda.empty_cache()
    phase_time("4c. multi-trial kernel")

    # ---- 4d. the kernels with 'dd' windows: the fused cycle on
    # runs/n216_sample_dd, the multi-trial sub-step's three kernels on
    # runs/n8064_wl, before and after the equilibration boundary
    dd_fused_checks()
    phase_time("4d. dd windows: fused cycle (N=216)")
    dd_cell_checks()
    phase_time("4d. dd windows: multi-trial sub-step (N=8064)")

    # ---- 4e. kernel 1's other instantiations: one lattice, MINU,
    # leshift, NVT, the Swetnam and 1/t schedules
    variants = variant_fused_checks(report["fused_cycle"]["ms"])
    for name, tag in VARIANT_ROWS.items():
        report[name] = {k: v for k, v in variants[tag].items()
                        if k not in ("kernel", "cycle_ms", "launches")}
    phase_time("4e. fused cycle: one lattice and the extended settings")

    # ---- 5. the main path
    prm = sample_params(W, "float32", mpi_sync_int=5, latt_sync_int=10,
                        eq_mc_cycles=20, max_mc_cycles=45)
    eng, s = make_engine(prm)
    eng.run_cycles(s, 20)                    # warm-up = equilibration
    torch.cuda.synchronize()
    eng.fused_cycle.launches = 0
    eng.full_energy.launches = 0
    t0 = time.time()
    s, samples = eng.run_cycles(s, 20)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {"fused_cycle": eng.fused_cycle.launches,
                "full_energy": eng.full_energy.launches}
    rate = W * prm.nwater * 20 / elapsed
    print(f"[main] N=216 W={W} f32: 20 cycles in {elapsed:.3f} s = "
          f"{rate:.4e} moves/s on {kind} ({card}); launches {launches}",
          flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    if not torch.isfinite(samples["E_ls"]).all():
        fail("non-finite therm samples")
    profile_cycles(eng, s, 10, elapsed / 20)
    eng.run_cycles(s, 5)                     # drift since the last resync
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    att, acc = s.att.sum(dim=1).tolist(), s.acc.sum(dim=1).tolist()
    print(f"[main] audit of 64 walkers: max |drift| {max_drift:.3e} "
          f"Hartree (limit {AUDIT_MAX_DRIFT:g}); accepted "
          f"{[a / max(t, 1) for a, t in zip(acc, att)]} of trans/vol/"
          f"switch; dropped {int(s.dropped)}", flush=True)
    if not max_drift < AUDIT_MAX_DRIFT:
        fail("energy audit drift")
    eng.merged_histogram(s)
    dg = deltaG_from_uhist(prm, eng.grid, ds_value64(s.master_uhist)[0])
    if dg is None or not all(np.all(np.isfinite(v)) for v in dg.values()):
        fail(f"Delta G is not finite: {dg}")
    print(f"[main] Delta G(Ic - Ih) = {dg['kT_per_mol']:.6e} kT/molecule "
          f"= {dg['J_per_mol']:.4f} J/mol after 25 sampling cycles "
          "(not converged: a smoke value)", flush=True)

    del eng, s, samples
    torch.cuda.empty_cache()

    phase_time("5. N=216 main path")

    # ---- 5b. path B: the N=216 sample run with exact reference move
    # semantics (nbr_table='off': the dense-candidate kernel)
    prm = dense_params(W, "float32", "n216", mpi_sync_int=5,
                       latt_sync_int=10, eq_mc_cycles=20, max_mc_cycles=45)
    eng, s = make_engine(prm)
    eng.run_cycles(s, 20)                    # warm-up = equilibration
    torch.cuda.synchronize()
    eng.fused_cycle.launches = 0
    eng.full_energy.launches = 0
    t0 = time.time()
    s, samples = eng.run_cycles(s, 20)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    dense_launches = {"fused_cycle_dense": eng.fused_cycle.launches,
                      "full_energy": eng.full_energy.launches}
    print(f"[dense-main] N=216 nbr_table='off' W={W} f32: 20 cycles in "
          f"{elapsed:.3f} s = {elapsed / 20 * 1e3:.3f} ms/cycle = "
          f"{W * prm.nwater * 20 / elapsed:.4e} moves/s on {kind} ({card}); "
          f"launches {dense_launches}", flush=True)
    if dense_launches["fused_cycle_dense"] != 20:
        fail(f"the dense kernel was not launched once per cycle: "
             f"{dense_launches}")
    if not torch.isfinite(samples["E_ls"]).all():
        fail("non-finite therm samples on path B")
    profile_cycles(eng, s, 5, elapsed / 20, tag="dense-profile")
    s, drift = eng.audit_energy(s, n_walkers=64)    # 5 cycles after a resync
    max_drift = float(torch.max(torch.abs(drift)))
    att, acc = s.att.sum(dim=1).tolist(), s.acc.sum(dim=1).tolist()
    print(f"[dense-main] audit of 64 walkers: max |drift| {max_drift:.3e} "
          f"Hartree (limit {AUDIT_MAX_DRIFT:g}); accepted "
          f"{[a / max(t, 1) for a, t in zip(acc, att)]} of trans/vol/switch",
          flush=True)
    if not max_drift < AUDIT_MAX_DRIFT:
        fail("path B energy audit drift")
    eng.merged_histogram(s)
    dg = deltaG_from_uhist(prm, eng.grid, ds_value64(s.master_uhist)[0])
    if dg is None or not all(np.all(np.isfinite(v)) for v in dg.values()):
        fail(f"path B: Delta G is not finite: {dg}")
    print(f"[dense-main] Delta G(Ic - Ih) = {dg['kT_per_mol']:.6e} "
          f"kT/molecule = {dg['J_per_mol']:.4f} J/mol after 25 sampling "
          "cycles (not converged: a smoke value)", flush=True)
    for k, n in dense_launches.items():
        launches[k] = launches.get(k, 0) + n
    del eng, s, samples
    torch.cuda.empty_cache()
    phase_time("5b. path B (N=216, nbr_table='off')")

    # ---- 5c. path C: N=216 Wang-Landau at dense_trials = 1, 2, 4, 8
    for T in (1,) + MULTI_TS:
        prm = multi_params(W, "float32", T)
        eng, s = make_engine(prm, paper_pair=True)
        eng.run_cycles(s, 5)                 # warm-up, WL live
        torch.cuda.synchronize()
        eng.fused_cycle.launches = 0
        att0 = int(s.att[0].sum())
        t0 = time.time()
        s, samples = eng.run_cycles(s, 20)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        n_launch = eng.fused_cycle.launches
        trials = int(s.att[0].sum()) - att0
        print(f"[multi-main] N=216 WL T={T} W={W} f32 ({eng.fused_cycle.kernel}"
              f"): 20 cycles in {elapsed:.3f} s = {elapsed / 20 * 1e3:.3f} "
              f"ms/cycle = {W * prm.nwater * 20 / elapsed:.4e} trials/s "
              f"({trials / elapsed:.4e} translation trials/s) on {kind}; "
              f"{n_launch} launches; accepted "
              f"{float(s.acc[0].sum()) / max(1, int(s.att[0].sum())):.4f} "
              "of translations", flush=True)
        if n_launch != 20 or not torch.isfinite(samples["E_ls"]).all():
            fail(f"path C at T={T}: {n_launch} launches or non-finite "
                 "samples")
        if T > 1:
            launches[multi_name(T)] = n_launch
        if T == MULTI_T:
            eng.resync_chains(s)
            eng.run_cycles(s, 5)
            s, drift = eng.audit_energy(s, n_walkers=64)
            max_drift = float(torch.max(torch.abs(drift)))
            eng.merged_histogram(s)
            hist = ds_value64(s.master_hist)[0]
            print(f"[multi-main] T={T}: audit of 64 walkers 5 cycles after "
                  f"a resync: max |drift| {max_drift:.3e} Hartree (limit "
                  f"{AUDIT_MAX_DRIFT:g}); merged histogram sum "
                  f"{hist.sum():.6e} over {int((hist > 0).sum())} bins",
                  flush=True)
            if not max_drift < AUDIT_MAX_DRIFT:
                fail("path C energy audit drift")
            if not (np.isfinite(hist.sum()) and hist.sum() > 0):
                fail("path C: the merged histogram is empty or not finite")
        del eng, s, samples
    torch.cuda.empty_cache()
    phase_time("5c. path C (N=216, dense_trials sweep)")

    # ---- 5d. runs/n216_sample_dd through the front end (8 windows)
    dd = dd216_run()
    for name, n in dd["launches"].items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    phase_time("5d. dd front-end path (runs/n216_sample_dd)")

    # ---- 5e. the volume wall's inward ratchet (N=216)
    vw = vol_wall_phase()
    for name, n in vw["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("5e. volume wall (N=216)")

    # ---- 5f. the single-box N=216 NPT run through the front end
    for name, n in single_box_run(kind, card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("5f. single box (N=216, one lattice)")

    # ---- 5g. a 1/t Wang-Landau generation through the front end
    for name, n in invt_run(kind, card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    phase_time("5g. 1/t Wang-Landau generation (N=216)")
    # the 4e engine runs of the dense and multi-trial instantiations
    for name in ("fused_cycle_dense_1l", "fused_cycle_dense_ext",
                 "fused_cycle_multi_ext"):
        launches[name] = variants[VARIANT_ROWS[name]]["launches"]

    # ---- 6. the cell engine's kernels vs plain
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value

    eng, s = make_cell_engine(cell_params(
        W_CELL_FP64, "float64", list_update_int=1, mpi_sync_int=1))
    eng.run_cycles(s, 1)            # walkers drift apart, WL slabs fill
    for tbl in (5, 42):
        cmp = cell_substep_compare(eng, s, tbl, seed=100 + tbl)
        me, ch, ma = (cmp[k] for k in ("mover_energies", "chain_wl",
                                       "mover_apply"))
        print(f"[cell] fp64 W={W_CELL_FP64} table {tbl}: energies err "
              f"{me['e_err']:.3e} Hartree (max |dE| {me['dE_max']:.3e}), "
              f"own moments err {me['own_err']:.3e}; chain: "
              f"{int(ch['differ'].sum())} walkers differ, cf err "
              f"{ch['cf_err']:.3e}, WL slabs err {ch['wl_err']:.3e}, "
              f"{ch['n_acc']} of {ch['n_enabled']} trials accepted; apply: "
              f"moment rows err {ma['mom_err']:.3e}, other rows equal "
              f"{ma['rest_equal']}, {ma['changed']} slab entries changed",
              flush=True)
        if not (me["e_err"] <= 1e-10 and me["own_err"] <= 1e-10
                and me["dE_max"] > 0):
            fail("mover_energies fp64 disagrees with its plain version")
        if ch["differ"].any() or not (ch["cf_err"] <= 1e-10
                                      and ch["wl_err"] <= 1e-10
                                      and 0 < ch["n_acc"] < ch["n_enabled"]
                                      and ch["hist_grew"] > 0):
            fail("chain_wl fp64 disagrees with its plain version")
        if not (ma["mom_err"] <= 1e-10 and ma["rest_equal"]
                and ma["changed"] > 0):
            fail("mover_apply fp64 disagrees with its plain version")
    sr = samplerun_chain_compare(eng, s, 5, seed=105)
    print(f"[cell] fp64 W={W_CELL_FP64} table 5, sample run: chain "
          f"{int(sr['differ'].sum())} walkers differ, cf err "
          f"{sr['cf_err']:.3e}, WL slabs err {sr['wl_err']:.3e}, "
          f"{sr['n_acc']} of {sr['n_enabled']} trials accepted, uhist grew "
          f"{sr['uh_grew']:.3e}", flush=True)
    if sr["differ"].any() or not (sr["cf_err"] <= 1e-10
                                  and sr["wl_err"] <= 1e-10
                                  and 0 < sr["n_acc"] < sr["n_enabled"]
                                  and sr["uh_grew"] > 0):
        fail("chain_wl fp64 in a sample run disagrees with its plain "
             "version")
    del eng, s
    torch.cuda.empty_cache()

    Wc = W_CELL
    prm = cell_params(Wc, "float32", list_update_int=2, mpi_sync_int=2,
                      latt_sync_int=3)
    t0 = time.time()
    eng, s = make_cell_engine(prm)
    torch.cuda.synchronize()
    cg = eng.cellgrid
    print(f"[cell] N={prm.nwater} W={Wc} f32: coarse {cg.n} m={cg.m} "
          f"nfine={cg.nfine} cap={cg.cap} CF={cg.full_cells.shape[1]} "
          f"K={eng.K} tables={eng.n_tables} sweeps={eng.sweeps_per_cycle} "
          f"sub-steps/cycle={eng.sweeps_per_cycle * eng.n_tables} "
          f"trials/cycle={eng.trials_per_cycle}; init {time.time() - t0:.1f}"
          f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    t0 = time.time()
    eng.run_cycles(s, 1)                     # warm-up (WL live from here)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    cmp = cell_substep_compare(eng, s, 5, seed=7, time_reps=20)
    bounds = cell_bounds(eng, s, cmp)
    me, ch, ma = (cmp[k] for k in ("mover_energies", "chain_wl",
                                   "mover_apply"))
    frac = float(ch["differ"].float().mean())
    print(f"[cell] f32 W={Wc}: energies err {me['e_err']:.3e} Hartree "
          f"(limit {F32_MOVER_E_ATOL:g}; max |dE| {me['dE_max']:.3e}), own "
          f"moments err {me['own_err']:.3e} (limit {F32_MOVER_MOM_ATOL:g}), "
          f"{me['n_in']} neighbour slots in range of {me['n_movers']} "
          f"(mover, walker) pairs x 2 lattices, {me['n_occ']} of "
          f"{2 * eng.K * cg.full_cells.shape[1] * cg.cap * Wc} candidate "
          f"slots occupied; chain: {frac:.4%} of walkers differ (limit "
          f"{F32_MAX_DIFF_FRAC:.0%}), on the rest chain rows err "
          f"{ch['cf_err']:.3e} (relative {ch['cf_rel']:.3e}) and WL slabs "
          f"err {ch['wl_err']:.3e} (relative {ch['wl_rel']:.3e}; limit "
          f"{F32_CHAIN_RTOL:g} relative), {ch['n_acc']} of "
          f"{ch['n_enabled']} trials accepted; apply: moment rows err "
          f"{ma['mom_err']:.3e} (limit {F32_MOVER_MOM_ATOL:g}), other rows "
          f"equal {ma['rest_equal']}", flush=True)
    if not (me["e_err"] <= F32_MOVER_E_ATOL
            and me["own_err"] <= F32_MOVER_MOM_ATOL and me["dE_max"] > 0):
        fail("mover_energies f32 disagrees with its plain version")
    if frac > F32_MAX_DIFF_FRAC or not (0 < ch["n_acc"] < ch["n_enabled"]):
        fail("chain_wl f32 differs from its plain version on too many "
             "walkers")
    if not (ch["cf_rel"] <= F32_CHAIN_RTOL and ch["wl_rel"] <= F32_CHAIN_RTOL
            and ch["hist_grew"] > 0):
        fail("chain_wl f32: chain rows or WL slabs of walkers with equal "
             "integer outcomes disagree with the plain version")
    if not (ma["mom_err"] <= F32_MOVER_MOM_ATOL and ma["rest_equal"]
            and ma["changed"] > 0):
        fail("mover_apply f32 disagrees with its plain version")
    sr = samplerun_chain_compare(eng, s, 5, seed=8)
    frac = float(sr["differ"].float().mean())
    print(f"[cell] f32 W={Wc}, sample run: chain {frac:.4%} of walkers "
          f"differ (limit {F32_MAX_DIFF_FRAC:.0%}), on the rest chain rows "
          f"relative err {sr['cf_rel']:.3e}, WL slabs relative err "
          f"{sr['wl_rel']:.3e} (limit {F32_CHAIN_RTOL:g}), {sr['n_acc']} of "
          f"{sr['n_enabled']} trials accepted, uhist grew "
          f"{sr['uh_grew']:.3e}", flush=True)
    if frac > F32_MAX_DIFF_FRAC or not (
            sr["cf_rel"] <= F32_CHAIN_RTOL and sr["wl_rel"] <= F32_CHAIN_RTOL
            and 0 < sr["n_acc"] < sr["n_enabled"] and sr["uh_grew"] > 0):
        fail("chain_wl f32 in a sample run disagrees with its plain version")
    occ = {"mover_energies": eng.mover_kernel.occupancy(torch.float32, 2,
                                                        eng.K, Wc),
           "chain_wl": eng.chain_kernel.occupancy(torch.float32, Wc),
           "mover_apply": None}
    for name, err in (("mover_energies", me["e_err"]),
                      ("chain_wl", max(ch["cf_err"], ch["wl_err"])),
                      ("mover_apply", ma["mom_err"])):
        t = cmp[name]
        report[name] = dict(max_abs_err=err, ms=t["ms"],
                            plain_ms=t["plain_ms"],
                            bound_ms=bounds[name][0],
                            bound_by=bounds[name][1])
        if occ[name]:
            report[name].update(occupancy_keys(occ[name]))
        print(f"[cell] {name} f32 W={Wc}: kernel {t['ms']:.4f} ms/launch, "
              f"plain {t['plain_ms']:.3f} ms, bound {bounds[name][0]:.6f} "
              f"ms ({bounds[name][1]})"
              + (f"; {occupancy_text(occ[name])}" if occ[name] else ""),
              flush=True)

    phase_time("6. cell kernels")

    # ---- 7. the N=8064 main path
    n_timed = 3
    cell_kernels = {"mover_energies": eng.mover_kernel,
                    "chain_wl": eng.chain_kernel,
                    "mover_apply": eng.apply_kernel}
    for k in cell_kernels.values():
        k.launches = 0
    att0 = s.att.clone()
    t0 = time.time()
    s, samples = eng.run_cycles(s, n_timed)  # cycles 2-4: rebin and sync
    torch.cuda.synchronize()                 # at 2 and 4, resync at 3
    elapsed = time.time() - t0
    cell_launches = {n: k.launches for n, k in cell_kernels.items()}
    launches.update(cell_launches)
    rate = eng.trials_per_cycle * Wc * n_timed / elapsed
    att = (s.att - att0).sum(dim=1).tolist()
    acc_frac = [a / max(t, 1) for a, t in zip(s.acc.sum(dim=1).tolist(),
                                              s.att.sum(dim=1).tolist())]
    overflow = int(s.occ_overflow.max())
    print(f"[cell-main] N={prm.nwater} W={Wc} f32: warm-up cycle "
          f"{warm_s:.3f} s; {n_timed} cycles in {elapsed:.3f} s = "
          f"{elapsed / n_timed:.3f} s/cycle = {rate:.4e} trials/s on {kind} "
          f"({card}); launches {cell_launches}; attempts trans/vol/switch "
          f"{att} (all walkers), accepted {acc_frac}; occ_overflow "
          f"{overflow}; dropped {int(s.dropped)}", flush=True)
    if min(cell_launches.values()) <= 0:
        fail(f"a kernel of the N=8064 path was not launched: "
             f"{cell_launches}")
    if att[1] <= 0:
        fail("no volume move fell into the timed cycles")
    if overflow != 0:
        fail(f"slab overflow {overflow}")
    if not torch.isfinite(samples["E_ls"]).all():
        fail("non-finite therm samples of the cell engine")
    s, drift = eng.audit_energy(s, n_walkers=64)
    max_drift = float(torch.max(torch.abs(drift)))
    hist_sum = float(ds_value(s.master_hist).sum())
    print(f"[cell-main] audit of 64 walkers one cycle after a resync: max "
          f"|drift| {max_drift:.3e} Hartree (limit {AUDIT_CELL_MAX_DRIFT:g})"
          f"; merged histogram sum {hist_sum:.6e}", flush=True)
    if not max_drift < AUDIT_CELL_MAX_DRIFT:
        fail("cell engine energy audit drift")
    if not (np.isfinite(hist_sum) and hist_sum > 0):
        fail("the merged histogram is empty or not finite")
    t0 = time.time()
    fresh, _ = eng._full_both(s, s.r, s.h)
    torch.cuda.synchronize()
    print(f"[cell-main] slab_full_energy of both lattices, all {Wc} "
          f"walkers: {time.time() - t0:.3f} s", flush=True)
    del fresh
    profile_cell_cycle(eng, s)
    del eng, s, samples
    torch.cuda.empty_cache()
    phase_time("7. N=8064 cell main path")

    # ---- 6b. the scatter path's kernels vs plain (float64, the
    # (12,7,18) pair: 75-cell stencils that overlap)
    scatter_phase()
    torch.cuda.empty_cache()
    phase_time("6b. delta output and scatter path")

    # ---- 6c. 'on' against 'apply' where both run (N=8064)
    on_apply_phase()
    torch.cuda.empty_cache()
    phase_time("6c. 'on' against 'apply' (N=8064)")

    # ---- 6c. the chain kernel under MINU, Swetnam and 1/t (N=8064, T=8)
    report[CHAIN_MINU] = chain_rules_phase()
    phase_time("6c. chain kernel: MINU, Swetnam, 1/t (N=8064, T=8)")

    # ---- 7b. the N=24192 flagship on its front-end grid
    flag = flagship_run(kind, card)
    for name, n in flag["launches"].items():
        # the chain kernel at this path's shape is a line of its own
        name = CHAIN_FLAG if name == "chain_wl" else name
        launches[name] = launches.get(name, 0) + n
    report["mover_energies_deltas"] = flag["report"]
    report[CHAIN_FLAG] = flag["chain"]
    torch.cuda.empty_cache()
    phase_time("7b. N=24192 flagship (scatter path)")

    # ---- 7c. the flagship at cell_trials=8: the unfused sub-step
    flagship_t8_run(kind, card)
    phase_time("7c. N=24192 flagship at T=8 (unfused sub-step)")

    # ---- 7d. the N=8064 single box: the cell engine at one lattice
    for name, n in single_cell_run(kind, card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("7d. N=8064 single box (one lattice)")

    # ---- 8. the multi-trial kernels (cell_trials = 8) vs plain
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    for Wm, dtype in ((W_MT_FP64, "float64"), (W_MT, "float32")):
        eng, s = make_cell_engine(cell_params(
            Wm, dtype, cell_trials=MT_TRIALS,
            mc_max_trans=0.10 * ANG_TO_BOHR, list_update_int=1,
            mpi_sync_int=1))
        eng.run_cycles(s, 1)        # walkers drift apart, WL slabs fill
        reps = 20 if dtype == "float32" else 0
        for tbl in ((5, 42) if dtype == "float64" else (5,)):
            cmp = multitrial_compare(eng, s, tbl, seed=300 + tbl,
                                     time_reps=reps)
            mp, ch = cmp["mover_points"], cmp["chain_wl"]
            frac = float(ch["differ"].float().mean())
            print(f"[multi] {dtype} W={Wm} T={eng.T} table {tbl}: points "
                  f"energies err {mp['e_err']:.3e} Hartree (max |dE| "
                  f"{mp['dE_max']:.3e}), own moments err "
                  f"{mp['own_err']:.3e}, {mp['n_legs']} legs in range over "
                  f"{eng.T + 1} points of {mp['n_movers']} (mover, walker) "
                  f"pairs x 2 lattices; chain: {int(ch['differ'].sum())} "
                  f"walkers differ ({frac:.4%}), on the rest chain rows err "
                  f"{ch['cf_err']:.3e} (relative {ch['cf_rel']:.3e}), WL "
                  f"slabs err {ch['wl_err']:.3e} (relative "
                  f"{ch['wl_rel']:.3e}), {ch['n_acc']} of {ch['n_enabled']} "
                  "trials accepted", flush=True)
            if dtype == "float64":
                if not (mp["e_err"] <= 1e-10 and mp["own_err"] <= 1e-10
                        and mp["dE_max"] > 0 and mp["repeat_equal"]):
                    fail("mover_points fp64 disagrees with its plain "
                         "version")
                if ch["differ"].any() or not (
                        ch["cf_err"] <= 1e-10 and ch["wl_err"] <= 1e-10
                        and 0 < ch["n_acc"] < ch["n_enabled"]
                        and ch["hist_grew"] > 0):
                    fail("chain_wl fp64 at T=8 disagrees with its plain "
                         "version")
                continue
            if not (mp["e_err"] <= F32_MOVER_E_ATOL
                    and mp["own_err"] <= F32_MOVER_MOM_ATOL
                    and mp["dE_max"] > 0 and mp["repeat_equal"]):
                fail("mover_points f32 disagrees with its plain version")
            if frac > F32_MAX_DIFF_FRAC or not (
                    ch["cf_rel"] <= F32_CHAIN_RTOL
                    and ch["wl_rel"] <= F32_CHAIN_RTOL
                    and 0 < ch["n_acc"] < ch["n_enabled"]):
                fail("chain_wl f32 at T=8 disagrees with its plain version")
            bounds = multitrial_bounds(eng, s, cmp)
            report["mover_points"] = dict(
                max_abs_err=max(mp["e_err"], mp["own_err"]), ms=mp["ms"],
                plain_ms=mp["plain_ms"], bound_ms=bounds["mover_points"][0],
                bound_by=bounds["mover_points"][1], **occupancy_keys(
                    eng.points_kernel.occupancy(torch.float32, 2, eng.K,
                                                Wm)))
            report[CHAIN_T8] = dict(
                max_abs_err=max(ch["cf_err"], ch["wl_err"]), ms=ch["ms"],
                plain_ms=ch["plain_ms"], bound_ms=bounds["chain_wl"][0],
                bound_by=bounds["chain_wl"][1], **occupancy_keys(
                    eng.chain_kernel.occupancy(torch.float32, Wm)))
            for name in ("mover_points", "chain_wl"):
                t = cmp[name]
                print(f"[multi] {name} f32 W={Wm} T={eng.T}: kernel "
                      f"{t['ms']:.4f} ms/launch, plain {t['plain_ms']:.3f} "
                      f"ms, bound {bounds[name][0]:.6f} ms "
                      f"({bounds[name][1]})", flush=True)
        # the points kernel at P = 3 and 5 (cell_trials 2 and 4) on the
        # first points of the engine's own proposal
        for P in MT_POINTS:
            pc = points_compare(eng, s, 5, seed=500 + P, P=P,
                                time_reps=reps)
            print(f"[multi] mover_points {dtype} W={Wm} T={P - 1}: energies "
                  f"err {pc['e_err']:.3e} Hartree, own moments err "
                  f"{pc['own_err']:.3e}, repeat bitwise equal "
                  f"{pc['repeat_equal']}"
                  + (f"; kernel {pc['ms']:.4f} ms/launch, plain "
                     f"{pc['plain_ms']:.3f} ms; {pc['plan']}"
                     if reps else ""), flush=True)
            tol_e, tol_m = ((1e-10, 1e-10) if dtype == "float64"
                            else (F32_MOVER_E_ATOL, F32_MOVER_MOM_ATOL))
            if not (pc["e_err"] <= tol_e and pc["own_err"] <= tol_m
                    and pc["repeat_equal"]):
                fail(f"mover_points {dtype} at T={P - 1} disagrees with its "
                     "plain version")
        # the apply kernel at this shape (the front-end path's), with the
        # chain kernel's accepts; in float64 also with every mover
        # accepted and with every mover rejected
        f64 = dtype == "float64"
        for mode in ("chain", "all", "none") if f64 else ("chain",):
            ma = multitrial_apply_compare(eng, s, 5, seed=400, mode=mode,
                                          time_reps=0 if f64 else 20)
            print(f"[multi] mover_apply {dtype} W={Wm} T={eng.T} "
                  f"({mode}): moment rows err {ma['mom_err']:.3e}, other "
                  f"rows equal {ma['rest_equal']}, {ma['changed']} slab "
                  f"entries changed, {ma['n_acc']} movers accepted",
                  flush=True)
            if not (ma["mom_err"] <= (1e-10 if f64 else F32_MOVER_MOM_ATOL)
                    and ma["rest_equal"]
                    and (ma["changed"] == 0) == (mode == "none")):
                fail(f"mover_apply {dtype} at T={eng.T} ({mode}) disagrees "
                     "with its plain version")
            if not f64:
                bound_ms, bound_by = apply_bound(eng, s, ma)
                report[APPLY_MT] = dict(
                    max_abs_err=ma["mom_err"], ms=ma["ms"],
                    plain_ms=ma["plain_ms"], bound_ms=bound_ms,
                    bound_by=bound_by)
                print(f"[multi] mover_apply f32 W={Wm} T={eng.T}: kernel "
                      f"{ma['ms']:.4f} ms/launch, plain "
                      f"{ma['plain_ms']:.3f} ms, bound {bound_ms:.6f} ms "
                      f"({bound_by})", flush=True)
        del eng, s
        torch.cuda.empty_cache()
    phase_time("8. multi-trial kernels")

    # ---- 8b. the displacement wall; 8c. the unfused T=1 sub-step
    trans_wall_phase()
    phase_time("8b. displacement wall (N=8064, T=1 and 8)")
    unfused_t1_phase()
    torch.cuda.empty_cache()
    phase_time("8c. unfused sub-step against 'apply' (N=8064, T=1)")

    # ---- 8d. N=8064 under MINU at T=8
    for name, n in minu_t8_run(kind, card)["launches"].items():
        # the apply kernel at this shape and the MINU chain are lines of
        # their own
        name = {"mover_apply": APPLY_MT, "chain_wl": CHAIN_MINU}.get(name,
                                                                   name)
        launches[name] = launches.get(name, 0) + n
    phase_time("8d. N=8064 MINU at T=8")

    # ---- 9. the front-end path: run_input_file at T = 8
    fe = frontend_run()
    for name, n in fe["launches"].items():
        # the apply and chain kernels at this path's shape are lines of
        # their own
        name = {"mover_apply": APPLY_MT, "chain_wl": CHAIN_T8}.get(name, name)
        launches[name] = launches.get(name, 0) + n
    phase_time("9. front-end path")

    # ---- 9b. round 5's pipeline: runs/n8064_wl2 -> runs/n8064_sample2
    r5 = round5_run(kind, card)
    for name, n in r5["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("9b. round-5 pipeline (n8064_wl2 -> n8064_sample2)")

    # ---- 10. path A: the reference's own N=48 example through the front
    # end (the dense-candidate kernel at three folded shifts)
    d48 = dense48_run()
    for name, n in d48["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("10. path A (N=48 example)")

    # ---- 12-13. ranks on the one card: walker sharding (12a dense,
    # 12b cell, 12c front end) and the spatial engine (13a-d)
    for name, n in ranks_phases(kind, card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("12-13. ranks: walker sharding and the spatial engine")

    # ---- 14. the run's own tools on the card: the probe, a supervised
    # run with a wedge, the three-body filter, the analysis tools
    torch.cuda.empty_cache()
    for name, n in tools_phase(kind, card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("14. the run's tools (probe, watchdog, filter, analysis)")

    # ---- 11. the kernels
    kernels = [
        dict(name="fused_cycle", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/fused_cycle.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/fused.py:1099",
             launches=launches["fused_cycle"], library_ms=None,
             **report["fused_cycle"]),
        dict(name="fused_cycle_dense", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/fused_cycle.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/fused.py:584",
             launches=launches["fused_cycle_dense"], library_ms=None,
             **report["fused_cycle_dense"]),
    ] + [
        dict(name=multi_name(T), route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/fused_cycle.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/fused.py:856",
             launches=launches[multi_name(T)], library_ms=None,
             **report[multi_name(T)]) for T in MULTI_TS
    ] + [
        dict(name="full_energy", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/full_energy.cu",
             replaces="mc_water_ls_mw_tpu/ops/pallas_energy.py:44",
             launches=launches["full_energy"], library_ms=None,
             **report["full_energy"]),
        dict(name="mover_energies", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:88",
             launches=launches["mover_energies"], library_ms=None,
             **report["mover_energies"]),
    ] + [
        dict(name=name, route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:624",
             launches=launches[name], library_ms=None, **report[name])
        for name in ("mover_apply", APPLY_MT)
    ] + [
        dict(name=name, route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/chain_wl.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/chain_pallas.py:92",
             launches=launches[name], library_ms=None, **report[name])
        for name in ("chain_wl", CHAIN_FLAG, CHAIN_T8)
    ] + [
        dict(name="mover_points", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:388",
             launches=launches["mover_points"], library_ms=None,
             **report["mover_points"]),
        dict(name="mover_energies_deltas", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:88 "
                      "(with_deltas=True)",
             launches=launches["mover_energies_deltas"], library_ms=None,
             **report["mover_energies_deltas"]),
    ]
    variants_src = "mc_water_ls_mw_tpu_torch/csrc/fused_cycle_variants.cu"
    kernels += [
        dict(name=name, route="cuda", source=variants_src,
             replaces=f"mc_water_ls_mw_tpu/mcmc/fused.py:{line}",
             launches=launches[name], library_ms=None, **report[name])
        for name, line in (("fused_cycle_1l", 731),
                           ("fused_cycle_dense_1l", 584),
                           ("fused_cycle_ext", 731),
                           ("fused_cycle_dense_ext", 584),
                           ("fused_cycle_multi_ext", 856))
    ] + [
        dict(name=CHAIN_MINU, route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/chain_wl.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/chain_pallas.py:92",
             launches=launches[CHAIN_MINU], library_ms=None,
             **report[CHAIN_MINU]),
    ]
    print(f"[time] total: {time.time() - _T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
