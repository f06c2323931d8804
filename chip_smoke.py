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
   N=48 (three shifts); 4c. likewise its multi-trial kernel at
   dense_trials=8; each with its time and bound;
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
6. the three kernels of the large-N cell engine (mover energies, chain +
   WL, mover apply) against their plain versions on one sub-step of the
   N=8064 stacking pair after a cycle of sampling (float64 at W=64:
   every integer output identical, energies and slabs within 1e-10;
   float32 at W=512: the tolerances below, the chain's rows and WL
   slabs held on the walkers whose integer outcomes agree), with their
   times;
7. the N=8064 main path: the cell engine at W=512, float32, Wang-Landau
   live, one warm-up and 3 timed cycles in which a rebin, scheduled
   volume moves, a delta-sync and a chain resync fall; seconds per
   cycle, trials/s, launch counts, slab overflow (must be 0), an energy
   audit of 64 walkers, a finite merged histogram, and a torch.profiler
   trace of one more cycle (device time per kernel, the idle share);
8. the multi-trial sub-step (cell_trials=8): the mover-points kernel and
   the chain + WL kernel at T=8 against their plain versions on one
   sub-step of the N=8064 pair after a cycle of sampling (float64 at
   W=16: every integer output identical, energies and own moments
   within 1e-10; float32 at W=128: the tolerances below), with their
   times and bounds;
9. the front-end path: runs/n8064_wl/ice.input with its run.py
   overrides (128 walkers, float32, cell_trials=8; parallel_strategy
   'mw' in place of 'dd'; FRONTEND_CUTS lists every interval cut)
   through the port's run_input_file in build/chip_smoke_frontend: 6
   cycles that hold volume moves, delta-syncs, monitor_stats with
   eq_adjust_mc, check_flatness, checkpoints and rebins, then a second
   call that resumes from the checkpoint for 2 more; seconds per cycle,
   trials/s, launches, slab overflow (must be 0), an energy audit of 64
   walkers and a torch.profiler trace of one more cycle;
10. path A: the reference's own N=48 example, runs/n216_sample/ice.input
   with --walkers 4096 and the (1,2,6) stacking pair (DENSE48_CUTS
   lists every interval cut), through run_input_file in
   build/chip_smoke_dense48: 40 cycles, then 8 resumed from the
   checkpoint; ms per cycle, moves/s, launches, an energy audit and the
   merged histogram;
11. one JSON line with every kernel's launches (summed over the main
   paths of phases 5, 5b, 5c, 7, 9 and 10), error against its plain
   version, times and bound;
12. as the last line, {"ok": true, "device": {...}}.

Each phase prints its seconds ("[time]").

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
# the dense multi-trial branch (dense_trials = 8, path C)
MULTI_T = 8
W_MT = 128              # walkers of runs/n8064_wl, the f32 checks
W_MT_FP64 = 16          # walkers of the float64 checks
# f32 energy audit of the cell engine, one cycle after a chain resync:
# the tracked and the recomputed total (-159 Hartree, ulp 1.5e-5) each
# carry a few ulps of f32 summation error, and ~4*10^3 accepted moves
# per walker each add an energy change good to ~1e-7 (compensated, so
# no quantisation against the total)
AUDIT_CELL_MAX_DRIFT = 2e-3     # Hartree

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_PHASE_T0 = [time.time()]


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


def make_engine(prm, stream=None, paper_pair=False):
    """(engine, state): the stacking pair of ``prm.stack`` from the
    committed weights (runs/n216_sample/eta_weights.dat), or with
    ``paper_pair`` the paper's N=216 pair (models/lattices.switch_pair_216)
    from flat weights."""
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine
    from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
    from mc_water_ls_mw_tpu_torch.models.lattices import switch_pair_216
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW

    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    if paper_pair:
        r0, H0 = switch_pair_216()
        w0 = None
    else:
        r0, H0 = stacking_switch_pair(*prm.stack)
        w0 = np.loadtxt(os.path.join(ROOT, "runs", "n216_sample",
                                     "eta_weights.dat"), skiprows=1)[:, 1]
        if len(w0) != grid.nbins:
            fail(f"eta_weights.dat has {len(w0)} bins, grid {grid.nbins}")
    s, aux = init_state(prm, MW, r0, H0, grid, weight0=w0, device=DEVICE)
    return Engine(prm, MW, grid, aux, device=DEVICE, stream=stream), s


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


def fused_compare(eng, s, draws):
    """One cycle of FusedCycle's kernel and of its plain version from
    clones of ``s`` with the same draws.  Returns (kernel state, plain
    state, [W] bool of walkers whose integer outcomes differ)."""
    import torch

    codes, sched, cu = draws
    sk, sp = s.clone(), s.clone()
    for st in (sk, sp):
        st.cycle += 1
    wl_active = sk.cycle >= eng.prm.eq_mc_cycles
    eng.fused_cycle(sk, codes, sched, cu, wl_active, True)
    eng.fused_cycle.plain(sp, codes, sched, cu, wl_active, True)
    torch.cuda.synchronize()
    differ = (sk.ls != sp.ls)
    for name in ("att", "acc", "trans_per_mol"):
        differ |= (getattr(sk, name) != getattr(sp, name)).any(dim=0)
    return sk, sp, differ


FUSED_FIELDS = ("r", "moments", "energy", "mu", "weight", "hist", "uhist",
                "min_dmu", "max_dmu")


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


def fused_bound(eng, s, draws):
    """(ms, bound_by) of one cycle: every state array the kernel reads
    or writes moved once each way, and per translation step and walker
    two folded distance tests for every valid table partner plus the
    leg, wing and moment work of the partners in range at the start of
    the cycle."""
    import torch

    from mc_water_ls_mw_tpu_torch.ops.dense import _h_components, _mic_fold

    codes, sched, cu = draws
    L, _, N, W = s.r.shape
    nbytes = _state_bytes(eng, s, N * 7, _table_bytes(eng, s))
    ops = 0
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
    B = eng.grid.nbins
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
    nbytes = _state_bytes(eng, s, N * 7)
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
        + n_in * 2 * (OPS_LEG + OPS_WING)
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
    nbytes = _state_bytes(eng, s, cu.shape[0] * cu.shape[1],
                          _table_bytes(eng, s))
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
    ops = n_tests * OPS_FOLD + n_legs * (OPS_LEG + OPS_WING)
    return _bound(nbytes, ops)


def time_cycles(eng, s, draws, reps):
    """(kernel, plain) milliseconds of one cycle from clones of ``s``:
    the kernel by CUDA events over ``reps`` cycles after a warm-up one,
    the plain version by the host clock over one cycle (the plain
    versions are host-paced)."""
    import torch

    st = s.clone()

    def one_cycle():
        st.cycle += 1
        eng.fused_cycle(st, *draws, True, True)

    ms = cuda_ms(one_cycle, reps)
    sp = s.clone()
    sp.cycle += 1
    torch.cuda.synchronize()
    t0 = time.time()
    eng.fused_cycle.plain(sp, *draws, True, True)
    torch.cuda.synchronize()
    return ms, (time.time() - t0) * 1e3


def fused_kernel_check(prm, tag, reps=0, paper_pair=False):
    """One cycle of the fused-cycle kernel of ``prm``'s engine against its
    plain version, from the state after two cycles, with the same draws:
    float64, identical integer outcomes and continuous state within
    1e-10; float32, at most F32_MAX_DIFF_FRAC of walkers with a
    differing integer outcome.  Prints the kernel's registers and
    spills.  With ``reps``, also times the kernel and the plain version
    and computes the bound, and returns the kernel's report entry."""
    import torch

    eng, s = make_engine(prm, paper_pair=paper_pair)
    kernel = eng.fused_cycle.kernel
    eng.run_cycles(s, 2)                     # walkers drift apart
    draws = kernel_draws(eng, s, 7)
    f64 = s.r.dtype == torch.float64
    W = s.r.shape[-1]
    sk, sp, differ = fused_compare(eng, s, draws)
    frac = float(differ.float().mean())
    ok = ~differ
    n_acc = int((sk.acc[0] - s.acc[0]).sum())
    e_err = float(torch.max(torch.abs(sk.energy[:, ok] - sp.energy[:, ok])))
    # (in f32 a histogram row can still differ on the rest: a mu within
    # round-off of a bin edge lands in the neighbouring bin)
    err = fused_max_err(sk, sp, ok, None if f64 else
                        ("r", "moments", "energy", "mu"))
    regs, spill, per_sm = eng.fused_cycle.occupancy(s.r.dtype)
    print(f"[{tag}] {kernel} {'fp64' if f64 else 'f32'} W={W} "
          f"S={len(eng.fold_shifts)} T={eng.dT}: {int(differ.sum())} walkers "
          f"differ ({frac:.4%}; limit {0 if f64 else F32_MAX_DIFF_FRAC:.0%})"
          f", on the rest energy max abs err {e_err:.3e} Hartree, relative "
          f"state err {err:.3e}; {n_acc} accepted translations; {regs} "
          f"registers, {spill} spill bytes per thread, at most {per_sm} "
          f"blocks of 128 walkers per SM", flush=True)
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
    ms, plain_ms = time_cycles(eng, s, draws, reps)
    bound_ms, bound_by = {"fused_cycle": fused_bound,
                          "fused_cycle_dense": dense_bound,
                          "fused_cycle_multi": multi_bound}[kernel](
                              eng, s, draws)
    print(f"[{tag}] {kernel} f32 W={W}: kernel {ms:.3f} ms/cycle, plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{-(-W // 128)} blocks on "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    return dict(max_abs_err=e_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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

def cell_params(W, dtype, **over):
    """The N=8064 Wang-Landau run of the JAX package's large-N benchmark
    (scripts/bench_largen.py: 200 K, 1 atm, 0.25 A steps, 201 bins over
    mu in [-1200, 1200], one trial per mover, the apply stage and the
    chain kernel on), at W walkers."""
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR, AUP_TO_ATM
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams

    N = 4 * CELL_STACK[0] * CELL_STACK[1] * CELL_STACK[2]
    kw = dict(
        nwater=N, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=0.25 * ANG_TO_BOHR, mc_dv_max=0.2 * ANG_TO_BOHR,
        nbins=201, mu_min=-1200.0, mu_max=1200.0,
        mc_vol_prob=1.0 / N, mc_switch_prob=0.1,
        samplerun=False, eq_mc_cycles=1, list_update_int=5,
        mpi_sync_int=10, latt_sync_int=10_000,
        n_walkers=W, dtype=dtype, seed=2014, stack=CELL_STACK,
        method="stack", cell_trials=1, cell_pallas="apply", cell_chain="on",
    )
    kw.update(over)
    return RunParams(**kw)


def make_cell_engine(prm):
    """(engine, state) of the N=8064 stacking pair on its cell grid."""
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
        CellEngine,
        init_cell_state,
    )
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        correspondence_mismatch,
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops.cells import (
        build_grid,
        cap_for_positions,
        choose_grid_shape,
    )

    r0, H0 = stacking_switch_pair(*prm.stack)
    mx, _ = correspondence_mismatch(r0, H0)
    shape = choose_grid_shape(H0, MW, mx)
    cg = build_grid(shape, cap_for_positions(r0, H0, shape), H0, MW, mx)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg, device=DEVICE)
    return CellEngine(prm, MW, grid, aux, cg, caux, device=DEVICE), s


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
    from mc_water_ls_mw_tpu_torch.ops.cells import PK_VALID

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
    # what the bounds need, per (mover, walker) and summed over the
    # lattices: occupied candidate slots, and neighbour slots in range of
    # either position
    n_occ = torch.zeros((K, W), dtype=torch.int64, device=DEVICE)
    n_in = torch.zeros((K, W), dtype=torch.int64, device=DEVICE)
    for l, pk in enumerate(pks):
        n_occ += (pk[:, PK_VALID][cand.long()] > 0.5).sum(dim=(1, 2))
        _, _, co, cn = eng.mover_kernel._candidates(
            pk, s.h[l], cand, off, fc, trial.rank, trial.p_old[l],
            trial.p_new[l])
        n_in += ((co.w > 0) | (cn.w > 0)).sum(dim=1)
    out["mover_energies"] = dict(
        e_err=_max_abs(trial.e, pe), own_err=_max_abs(trial.own_new, pown),
        n_occ=int(n_occ.sum()), n_in=int(n_in.sum()),
        n_movers=int(trial.hasm.sum()),
        dE_max=float(torch.max(torch.abs(pe[:, :, 1] - pe[:, :, 0]))))

    # -- chain + WL on those energies
    tables = (trial.e.view(-1, W), rows.inc.view(-1, W), trial.hasm)

    def chain_bufs():
        return dict(cf=rows.cf.clone(), ci=rows.ci.clone(),
                    wgt=s.weight.clone(), hist=s.hist.clone(),
                    uh=s.uhist.clone())

    def chain(fn, b=None):
        """One chain pass, in place on the buffers ``b`` (fresh clones
        of the chain rows and WL slabs by default)."""
        b = chain_bufs() if b is None else b
        b["joh"], b["cnt"] = fn(codes, True, b["cf"], b["ci"], b["wgt"],
                                b["hist"], b["uh"], rows.basew, *tables,
                                u[5], u[6])
        return b

    ck_, cp = chain(eng.chain_kernel), chain(eng.chain_kernel.plain)
    torch.cuda.synchronize()
    differ = torch.zeros((W,), dtype=torch.bool, device=DEVICE)
    for name in ("ci", "cnt", "joh"):
        differ |= (ck_[name] != cp[name]).any(dim=0)
    ok = ~differ
    slabs = ("wgt", "hist", "uh")
    out["chain_wl"] = dict(
        differ=differ,
        cf_err=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok]),
        wl_err=max(_max_abs(ck_[n][:, ok], cp[n][:, ok]) for n in slabs),
        cf_rel=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok], relative=True),
        wl_rel=max(_max_abs(ck_[n][:, ok], cp[n][:, ok], relative=True)
                   for n in slabs),
        n_acc=int(cp["joh"].view(K, 2, W)[:, 1].sum()),
        n_enabled=int(cp["cnt"][0].sum()),
        hist_grew=float((cp["hist"] - s.hist).sum()))

    # -- apply with the chain kernel's accepts
    accf = ck_["joh"].view(K, 2, W)[:, 1]
    pk_k = [pk.clone() for pk in pks]
    pk_p = [pk.clone() for pk in pks]
    aargs = (s.h, cand, off, fc, trial.rank, accf, trial.p_old, trial.p_new,
             trial.own_new)
    eng.apply_kernel(pk_k, *aargs)
    eng.apply_kernel.plain(pk_p, *aargs)
    torch.cuda.synchronize()
    acc = accf > 0.5
    out["mover_apply"] = dict(
        mom_err=max(_max_abs(a[:, :10], b[:, :10])
                    for a, b in zip(pk_k, pk_p)),
        rest_equal=all(torch.equal(a[:, 10:], b[:, 10:])
                       for a, b in zip(pk_k, pk_p)),
        changed=int(sum((a != b).sum() for a, b in zip(pk_k, pks))),
        n_acc=int(acc.sum()), n_occ_acc=int(n_occ[acc].sum()),
        n_in_acc=int(n_in[acc].sum()))

    if time_reps:
        # kernels: device time (the host runs ahead); plain versions: as
        # a caller sees them.  The chain and the apply stage run in place
        # on their buffers, pass after pass.
        t = out["mover_energies"]
        t["ms"] = cuda_ms(lambda: eng.mover_kernel(*margs), time_reps, True)
        t["plain_ms"] = cuda_ms(lambda: eng.mover_kernel.plain(*margs), 3)
        t = out["chain_wl"]
        bk, bp = chain_bufs(), chain_bufs()
        t["ms"] = cuda_ms(lambda: chain(eng.chain_kernel, bk), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(lambda: chain(eng.chain_kernel.plain, bp), 3)
        t = out["mover_apply"]
        t["ms"] = cuda_ms(lambda: eng.apply_kernel(pk_k, *aargs), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(
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
    mover_apply: the same reads for the accepted movers only, and the
    moment rows of their in-range neighbours and their own slots
    written.  chain_wl: its tables read, its rows read and written, and
    per enabled trial ~16 slab entries (two eta lookups of three bins in
    two slabs, the histogram and weight update)."""
    L, W = 2, s.r.shape[-1]
    K, CF, cap = eng.K, eng.mover_kernel.CF, eng.cellgrid.cap
    b = s.r.element_size()
    me, ma, ch = cmp["mover_energies"], cmp["mover_apply"], cmp["chain_wl"]
    small = (9 * L + 6 * L * K) * W * b + K * W * 4 + K * CF * 16
    ops_slot = 3 + 2 * 9              # image shift, two distance tests
    nbytes = (L * K * CF * cap * W + 3 * me["n_occ"] + 10 * me["n_in"]) * b \
        + small + (2 * L * K + 10 * L * K) * W * b
    ops = me["n_occ"] * ops_slot + me["n_in"] * 2 * (OPS_LEG + OPS_WING)
    out = {"mover_energies": _bound(nbytes, ops)}
    nbytes = (L * CF * cap * ma["n_acc"] + 3 * ma["n_occ_acc"]
              + 20 * ma["n_in_acc"] + 13 * L * ma["n_acc"]) * b + small \
        + (K + 10 * L * K) * W * b
    ops = ma["n_occ_acc"] * ops_slot + ma["n_in_acc"] * (2 * OPS_LEG + 20)
    out["mover_apply"] = _bound(nbytes, ops)
    out["chain_wl"] = chain_bound(eng, W, b, 2, ch["n_enabled"])
    return out


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
    rows = eng._loop_rows(s)
    fc, cand, off = eng._tables(tbl)
    out = {}

    n0 = eng.points_kernel.launches
    trial = eng._propose_tm(s, pks, tbl, u, rows)
    if eng.points_kernel.launches != n0 + 1:
        fail("the proposal did not launch the mover-points kernel")
    pargs = (pks, s.h, cand, off, fc, trial.rank, trial.pts)
    pe, pown = eng.points_kernel.plain(*pargs)
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
        n_occ=n_occ, n_any=n_any, n_legs=n_legs,
        n_movers=int(trial.hasm.sum()),
        dE_max=float(torch.max(torch.abs(pe[:, :, 1:] - pe[:, :, :1]))))

    tables = (trial.e.view(-1, W), trial.inc.view(-1, W), trial.hasm)

    def chain_bufs():
        return dict(cf=rows.cf.clone(), ci=rows.ci.clone(),
                    wgt=s.weight.clone(), hist=s.hist.clone(),
                    uh=s.uhist.clone())

    def chain(fn, b=None):
        b = chain_bufs() if b is None else b
        b["joh"], b["cnt"] = fn(codes, True, b["cf"], b["ci"], b["wgt"],
                                b["hist"], b["uh"], rows.basew, *tables,
                                ua, uz)
        return b

    ck_, cp = chain(eng.chain_kernel), chain(eng.chain_kernel.plain)
    torch.cuda.synchronize()
    differ = torch.zeros((W,), dtype=torch.bool, device=DEVICE)
    for name in ("ci", "cnt", "joh"):
        differ |= (ck_[name] != cp[name]).any(dim=0)
    ok = ~differ
    slabs = ("wgt", "hist", "uh")
    out["chain_wl"] = dict(
        differ=differ,
        cf_err=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok]),
        wl_err=max(_max_abs(ck_[n][:, ok], cp[n][:, ok]) for n in slabs),
        cf_rel=_max_abs(ck_["cf"][:, ok], cp["cf"][:, ok], relative=True),
        wl_rel=max(_max_abs(ck_[n][:, ok], cp[n][:, ok], relative=True)
                   for n in slabs),
        n_acc=int((1.0 - cp["joh"].view(K, P, W)[:, 0]).sum()),
        n_enabled=int(cp["cnt"][0].sum()),
        hist_grew=float((cp["hist"] - s.hist).sum()))

    if time_reps:
        t = out["mover_points"]
        t["ms"] = cuda_ms(lambda: eng.points_kernel(*pargs), time_reps, True)
        t["plain_ms"] = cuda_ms(lambda: eng.points_kernel.plain(*pargs), 3)
        t = out["chain_wl"]
        bk, bp = chain_bufs(), chain_bufs()
        t["ms"] = cuda_ms(lambda: chain(eng.chain_kernel, bk), time_reps,
                          True)
        t["plain_ms"] = cuda_ms(lambda: chain(eng.chain_kernel.plain, bp), 3)
    return out


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
# what the smoke run changes: the strategy ('dd' mu windows are not
# ported; n_windows and window_overlap go with it) and, to fit rebins,
# volume moves, delta-syncs, monitor_stats with eq_adjust_mc,
# check_flatness and a checkpoint into 6 + 2 cycles, these cycle counts
# and intervals (the run's own values in the comments)
FRONTEND_CUTS = dict(
    parallel_strategy="mw",
    eq_mc_cycles=3,             # 400
    list_update_int=3,          # 10
    monitor_int=2,              # 500
    flat_chk_int=4,             # 500
    mpi_sync_int=2,             # 50
    file_output_int=2,          # 100
    chkpt_dump_int=4,           # 250
)
FRONTEND_CYCLES = (6, 2)        # first call, resumed call


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
    the port's run_input_file in build/chip_smoke_frontend: 6 cycles,
    then a second call that resumes from the checkpoint for 2 more, then
    a traced cycle.  The kernels' counts are those of the engines the two
    calls built (created at 0 when the run sets up).  Returns
    {"launches": {kernel: count over both calls}}."""
    import shutil

    import torch

    from mc_water_ls_mw_tpu_torch import app as app_mod
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.mcmc.cellengine import CellEngine
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    apps = []

    class Recorded(app_mod.Application):
        """The Application, remembered so that its engine can be read."""

        def setup(self):
            apps.append(self)
            return super().setup()

    d = os.path.join(ROOT, "build", "chip_smoke_frontend")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n8064_wl", "ice.input"), d)
    over = {k: v for k, v in {**N8064_WL, **FRONTEND_CUTS}.items()
            if k not in ("n_windows", "window_overlap")}
    path = os.path.join(d, "ice.input")
    cwd, original = os.getcwd(), app_mod.Application
    app_mod.Application = Recorded
    kernels = ("mover_points", "chain_wl", "mover_apply")
    try:
        out = []
        for n_cyc in FRONTEND_CYCLES:
            t0 = time.time()
            s = app_mod.run_input_file(path, overrides=over,
                                       max_cycles=n_cyc, device=DEVICE)
            torch.cuda.synchronize()
            app = apps[-1]
            eng = app.engine
            objs = dict(zip(kernels, (eng.points_kernel, eng.chain_kernel,
                                      eng.apply_kernel)))
            out.append(dict(wall=time.time() - t0, s=s, app=app,
                            launches={k: o.launches
                                      for k, o in objs.items()}))
    finally:
        os.chdir(cwd)
        app_mod.Application = original
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
        "check_flatness": "# Checking flatness of histogram at cycle",
        "the restart": f"# Restarting from cycle {FRONTEND_CYCLES[0]} (",
    }
    for what, text in need.items():
        if text not in node + glog:
            fail(f"front-end run: no trace of {what} in the logs")
    files = set(os.listdir(d))
    want = {"checkpoint000.npz.1", "checkpoint000.npz.2", "eta_weights.dat",
            "histogram.dat", "unbiased_histogram.dat", "mW.psf", "mW.dcd",
            "mc.log", "node000.log"} | {
                f"ice{w:03d}_therm.dat"
                for w in range(min(prm.therm_walkers, W))}
    if not want <= files:
        fail(f"front-end run: missing files {sorted(want - files)}")
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
          f"but {sorted(FRONTEND_CUTS)} (cut) and n_windows/window_overlap "
          f"(dropped): N={prm.nwater} W={W} float32 T={eng.T}, "
          f"{n_sub} sub-steps/cycle, {eng.trials_per_cycle} trials/cycle",
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

    from mc_water_ls_mw_tpu_torch import app as app_mod
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.ops.dsfloat import ds_value64

    apps = []

    class Recorded(app_mod.Application):
        """The Application, remembered so that its engine can be read."""

        def setup(self):
            apps.append(self)
            return super().setup()

    d = os.path.join(ROOT, "build", "chip_smoke_dense48")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(ROOT, "runs", "n216_sample", "ice.input"), d)
    over = {**DENSE48, **DENSE48_CUTS}
    path = os.path.join(d, "ice.input")
    cwd, original = os.getcwd(), app_mod.Application
    app_mod.Application = Recorded
    try:
        out = []
        for n_cyc in DENSE48_CYCLES:
            t0 = time.time()
            s = app_mod.run_input_file(path, overrides=over,
                                       max_cycles=n_cyc, device=DEVICE)
            torch.cuda.synchronize()
            eng = apps[-1].engine
            out.append(dict(wall=time.time() - t0, s=s, app=apps[-1],
                            launches={
                                "fused_cycle_dense": eng.fused_cycle.launches,
                                "full_energy": eng.full_energy.launches}))
    finally:
        os.chdir(cwd)
        app_mod.Application = original
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


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

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
    report["full_energy"] = dict(
        max_abs_err=float(torch.max(torch.abs(e_k - e_p))),
        ms=fe_ms, plain_ms=fe_plain_ms, bound_ms=fe_bound_ms,
        bound_by=fe_bound_by)
    print(f"[full_energy] f32 W={W}: kernel {fe_ms:.3f} ms, plain "
          f"{fe_plain_ms:.3f} ms, bound {fe_bound_ms:.4f} ms "
          f"({fe_bound_by})", flush=True)

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

    for Wk, dt in ((W_FP64, "float64"), (W, "float32")):
        out = fused_kernel_check(
            multi_params(Wk, dt, MULTI_T, eq_mc_cycles=0), "multi",
            reps=5 if dt == "float32" else 0, paper_pair=True)
        if out is not None:
            report["fused_cycle_multi"] = out
    torch.cuda.empty_cache()
    phase_time("4c. multi-trial kernel")

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
    for T in (1, 2, 4, MULTI_T):
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
        if T == MULTI_T:
            launches["fused_cycle_multi"] = n_launch
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
    for name, err in (("mover_energies", me["e_err"]),
                      ("chain_wl", max(ch["cf_err"], ch["wl_err"])),
                      ("mover_apply", ma["mom_err"])):
        t = cmp[name]
        report[name] = dict(max_abs_err=err, ms=t["ms"],
                            plain_ms=t["plain_ms"],
                            bound_ms=bounds[name][0],
                            bound_by=bounds[name][1])
        print(f"[cell] {name} f32 W={Wc}: kernel {t['ms']:.4f} ms/launch, "
              f"plain {t['plain_ms']:.3f} ms, bound {bounds[name][0]:.6f} "
              f"ms ({bounds[name][1]})", flush=True)

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
                        and mp["dE_max"] > 0):
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
                    and mp["dE_max"] > 0):
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
                bound_by=bounds["mover_points"][1])
            for name in ("mover_points", "chain_wl"):
                t = cmp[name]
                print(f"[multi] {name} f32 W={Wm} T={eng.T}: kernel "
                      f"{t['ms']:.4f} ms/launch, plain {t['plain_ms']:.3f} "
                      f"ms, bound {bounds[name][0]:.6f} ms "
                      f"({bounds[name][1]})", flush=True)
        del eng, s
        torch.cuda.empty_cache()
    phase_time("8. multi-trial kernels")

    # ---- 9. the front-end path: run_input_file at T = 8
    fe = frontend_run()
    for name, n in fe["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("9. front-end path")

    # ---- 10. path A: the reference's own N=48 example through the front
    # end (the dense-candidate kernel at three folded shifts)
    d48 = dense48_run()
    for name, n in d48["launches"].items():
        launches[name] = launches.get(name, 0) + n
    phase_time("10. path A (N=48 example)")

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
        dict(name="fused_cycle_multi", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/fused_cycle.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/fused.py:856",
             launches=launches["fused_cycle_multi"], library_ms=None,
             **report["fused_cycle_multi"]),
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
        dict(name="mover_apply", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:624",
             launches=launches["mover_apply"], library_ms=None,
             **report["mover_apply"]),
        dict(name="chain_wl", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/chain_wl.cu",
             replaces="mc_water_ls_mw_tpu/mcmc/chain_pallas.py:92",
             launches=launches["chain_wl"], library_ms=None,
             **report["chain_wl"]),
        dict(name="mover_points", route="cuda",
             source="mc_water_ls_mw_tpu_torch/csrc/cell_movers.cu",
             replaces="mc_water_ls_mw_tpu/ops/cell_pallas.py:388",
             launches=launches["mover_points"], library_ms=None,
             **report["mover_points"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
