#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's chain + WL kernel and its mover-energies
kernel (with and without the delta output) against other versions of
csrc/chain_wl.cu and csrc/cell_movers.cu, in one process on one card.

    python3 scripts/bench_torch_chain.py --other-chain PATH/chain_wl.cu \\
        --other-movers PATH/cell_movers.cu [--variants] [--out OUT.json]

The other sources are compiled with the port's nvcc flags (cuda_build)
into build/torch_kernels/ (their includes from the port's csrc/) and
bound with the same ChainArgs and MoverArgs: the structures of an
earlier version are prefixes of the current ones, which append the
chain's launch plan and the energies kernel's warps per block.  The shapes are
those of chip_smoke.py's main paths, float32:

* ``chain_wl``: the N=8064 cell engine at 512 walkers, one trial per
  mover (K=8, phase 7), the N=24192 flagship at 128 walkers (K=32,
  phase 7b) and the N=8064 engine at 128 walkers, eight trials per
  mover (phase 9), each on one sub-step's point table from the engine's
  own proposal (the N=8064 engines after one cycle of sampling, the
  flagship from its initial state);
* ``mover_energies``: N=8064, K=8, CF=27, 512 walkers, and 128 walkers;
* ``mover_energies_deltas``: the flagship, K=32, CF=75, 128 walkers;
* ``mover_points``: N=8064, K=8, CF=27, 128 walkers at P = 9 points
  (T=8, phase 9's shape) and at the first 3 and 5 of them (T = 2 and 4),
  bound with PointsArgs, whose earlier version is a prefix of the
  current one (which appends the scratch, the tickets and the cell
  groups); the other kernel gets its own warps per block
  (``old_points_warps``, the first design's rule), set on the args.

For each: the two versions' outputs on the same inputs (the chain on
clones of its rows and WL slabs: integer outputs equal, largest
difference of the rest), then each version's launch by CUDA events over
``REPS`` launches, the host running ahead (the chain in place on its
buffers, pass after pass), in the order other, this, this, other, and
for the chain also the host's microseconds per call (its wrapper, its
argument checks and the launch, the device kept busy ahead).  With
``--variants`` the current chain kernel is also timed at other launch
plans, set on its ChainArgs: 1, 2 and 8 walkers per block and its
in-place branch, and the points kernel at other cell groups and warps
per block (POINTS_VARIANTS), set on its PointsArgs with scratch of their
own.  Prints one JSON line per row and one of all (also
written to --out).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPS = 50
TABLE = 5          # the table row of the sub-step (as in phase 6)
# this points kernel at other plans: (candidate cells a group, warps)
POINTS_VARIANTS = ((1, 9), (2, 9), (5, 9), (9, 9), (3, 5), (3, 3))


def old_points_warps(P, itemsize):
    """Warps per block of the points kernel's first design: as many as
    its 13 P running sums a lane (and the points) left room for in
    110592 bytes, at most 8."""
    spare = 110592 - P * 3 * 32 * itemsize
    return max(1, min(8, spare // (P * 13 * 32 * itemsize)))


def bind(lib, sym, struct):
    fn = getattr(lib, sym)
    fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chain_inputs(eng, s, seed):
    """(args of the chain wrapper, point-table tensors) of one sub-step
    of the engine ``eng`` on state ``s``, as chip_smoke.py's comparisons
    build them."""
    import torch

    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import SWITCH

    K, T, W = eng.K, eng.T, s.r.shape[-1]
    dev, dtype = s.r.device, s.r.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pks = eng._pack(s)
    rows = eng._loop_rows(s)
    codes = torch.zeros((K * T,), dtype=torch.int32, device=dev)
    codes[K * T // 2] = SWITCH
    if T == 1:
        u = torch.rand((7, K, W), generator=gen, dtype=dtype, device=dev)
        trial = eng._propose_t1(s, pks, TABLE, u, rows)
        inc, ua, uz = rows.inc, u[5], u[6]
    else:
        u = torch.rand((4 + 3 * T, K, W), generator=gen, dtype=dtype,
                       device=dev)
        ua, uz = torch.rand((2, K * T, W), generator=gen, dtype=dtype,
                            device=dev)
        trial = eng._propose_tm(s, pks, TABLE, u, rows)
        inc = trial.inc
    return (codes, rows, trial.e.view(-1, W), inc.view(-1, W), trial.hasm,
            ua, uz), pks, trial


def host_us(run, reps):
    """Host microseconds per call of ``run`` (wrapper, argument checks
    and launch), with ~20 ms of device work queued first so that
    neither the host nor the launch queue waits on the device."""
    import torch

    import chip_smoke

    pad = torch.zeros(1 << 28, dtype=torch.float32, device=chip_smoke.DEVICE)
    run()
    torch.cuda.synchronize()
    for _ in range(30):
        pad.add_(1.0)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def host_pair(other, this, reps):
    """{'other': [us, us], 'this': [us, us]} of ``host_us`` in the order
    other, this, this, other."""
    out = {}
    for label, run in (("other", other), ("this", this), ("this", this),
                       ("other", other)):
        out.setdefault(label, []).append(host_us(run, reps))
    return out


def time_pair(other, this, reps):
    """{'other': [ms, ms], 'this': [ms, ms]} in the order other, this,
    this, other."""
    import chip_smoke

    times = {}
    for label, run in (("other", other), ("this", this), ("this", this),
                       ("other", other)):
        times.setdefault(label, []).append(chip_smoke.cuda_ms(run, reps,
                                                              True))
    return times


def chain_rows(eng, s, case, old_fn, variants):
    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import (
        INPLACE_WPB,
        _entry,
    )

    (codes, rows, e, inc, hasm, ua, uz), _, _ = chain_inputs(eng, s, seed=7)
    kern = eng.chain_kernel
    W = s.r.shape[-1]

    def buffers():
        return dict(cf=rows.cf.clone(), ci=rows.ci.clone(),
                    wgt=s.weight.clone(), hist=s.hist.clone(),
                    uh=s.uhist.clone())

    def launch_args(b):
        return kern.launch_args(codes, True, b["cf"], b["ci"], b["wgt"],
                                b["hist"], b["uh"], rows.basew, e, inc,
                                hasm, ua, uz)

    def other(b):
        args, b["joh"], b["cnt"] = launch_args(b)
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(old_fn(ctypes.byref(args), stream), "other chain")

    def this(b):
        b["joh"], b["cnt"] = kern(codes, True, b["cf"], b["ci"], b["wgt"],
                                  b["hist"], b["uh"], rows.basew, e, inc,
                                  hasm, ua, uz)

    bo, bn = buffers(), buffers()
    other(bo)
    this(bn)
    torch.cuda.synchronize()
    ints_equal = all(torch.equal(bo[n], bn[n]) for n in ("ci", "cnt", "joh"))
    diff = max(chip_smoke._max_abs(bn[n], bo[n])
               for n in ("cf", "wgt", "hist", "uh"))
    bitwise = ints_equal and all(torch.equal(bo[n], bn[n])
                                 for n in ("cf", "wgt", "hist", "uh"))
    n_enabled = int(bn["cnt"][0].sum())
    ref = {n: t.clone() for n, t in bn.items()}
    bo, bn = buffers(), buffers()
    times = time_pair(lambda: other(bo), lambda: this(bn), REPS)
    host = host_pair(lambda: other(bo), lambda: this(bn), REPS)
    plan = kern.plan(s.r.dtype, W)
    occ = kern.occupancy(s.r.dtype, W)
    bound_ms, bound_by = chip_smoke.chain_bound(
        eng, W, s.r.element_size(), eng.T + 1, n_enabled)
    out = [dict(kernel="chain_wl", case=case, W=W, K=eng.K, T=eng.T,
                B=eng.grid.nbins, reps=REPS, other_ms=times["other"],
                this_ms=times["this"], other_host_us=host["other"],
                this_host_us=host["this"],
                speedup=min(times["other"]) / min(times["this"]),
                bound_ms=bound_ms, bound_by=bound_by,
                integers_equal=ints_equal, bitwise_equal=bitwise,
                max_abs_diff=diff, plan=plan._asdict(), occupancy=occ)]
    if not variants:
        return out
    for wpb, staged in ((1, True), (2, True), (8, True),
                        (INPLACE_WPB, False)):

        def variant(b, wpb=wpb, staged=staged):
            args, b["joh"], b["cnt"] = launch_args(b)
            args.wpb, args.staged = wpb, int(staged)
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(_entry(s.r.dtype)(ctypes.byref(args), stream),
                             "chain variant")

        b = buffers()
        variant(b)
        equal = all(torch.equal(b[n], ref[n]) for n in ref)
        ms = chip_smoke.cuda_ms(lambda: variant(b), REPS, True)
        out.append(dict(kernel="chain_wl", case=case, variant=dict(
            wpb=wpb, staged=staged), this_ms=ms, bitwise_equal=equal))
    return out


def energies_rows(eng, s, case, old_fn, deltas):
    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch import cuda_build

    _, pks, trial = chain_inputs(eng, s, seed=7)
    kern = eng.mover_kernel
    fc, cand, off = eng._tables(TABLE)
    margs = (pks, s.h, cand, off, fc, trial.rank, trial.p_old, trial.p_new)
    L, K, W = len(pks), eng.K, s.r.shape[-1]
    dtype, dev = s.r.dtype, s.r.device

    def other():
        args = kern._args(*margs)
        args.en_warps = kern.en_warps
        e = torch.empty((L, K, 2, W), dtype=dtype, device=dev)
        own = torch.empty((L, K, 10, W), dtype=dtype, device=dev)
        args.e, args.own = e.data_ptr(), own.data_ptr()
        out = [e, own]
        if deltas:
            dlt = torch.empty((L, K, kern.CF, 10, kern.cap, W), dtype=dtype,
                              device=dev)
            args.dlt = dlt.data_ptr()
            out.append(dlt)
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(old_fn(ctypes.byref(args), stream), "other movers")
        return out

    def this():
        return list(kern(*margs))

    ro, rn = other(), this()
    torch.cuda.synchronize()
    diff = max(chip_smoke._max_abs(a, b) for a, b in zip(rn, ro))
    bitwise = all(torch.equal(a, b) for a, b in zip(rn, ro))
    times = time_pair(other, this, REPS)
    counts = dict(zip(("n_occ", "n_in"), (int(x.sum()) for x in
                      chip_smoke._occupancy_counts(eng, s, pks, trial, cand,
                                                   off, fc))))
    bound_ms, bound_by = chip_smoke.mover_energies_bound(eng, s, counts,
                                                         deltas=deltas)
    row = dict(kernel=kern.name, case=case, W=W, K=K, CF=kern.CF,
               cap=kern.cap, reps=REPS, other_ms=times["other"],
               this_ms=times["this"],
               speedup=min(times["other"]) / min(times["this"]),
               bound_ms=bound_ms, bound_by=bound_by, bitwise_equal=bitwise,
               max_abs_diff=diff, **counts)
    if not deltas:
        row["occupancy"] = kern.occupancy(dtype, L, K, W)
    return [row]


def points_rows(eng, s, case, old_fn, variants):
    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
        MoverPointsKernel,
        _entry,
        points_geometry,
    )

    _, pks, trial = chain_inputs(eng, s, seed=7)
    fc, cand, off = eng._tables(TABLE)
    L, K, W = len(pks), eng.K, s.r.shape[-1]
    dtype, dev = s.r.dtype, s.r.device
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for P in (eng.T + 1, 3, 5):
        kern = (eng.points_kernel if P == eng.T + 1
                else MoverPointsKernel(eng.model, eng.cellgrid, P))
        pargs = (pks, s.h, cand, off, fc, trial.rank,
                 trial.pts[:P].contiguous())

        def other():
            args, res = kern.launch_args(*pargs)
            args.nw = old_points_warps(P, s.r.element_size())
            cuda_build.check(old_fn(ctypes.byref(args), stream),
                             "other points")
            return list(res)

        def this():
            return list(kern(*pargs))

        ro, rn = other(), this()
        pe, pown = kern.plain(*pargs)
        torch.cuda.synchronize()
        times = time_pair(other, this, REPS)
        row = dict(kernel="mover_points", case=case, W=W, K=K, P=P,
                   CF=kern.CF, cap=kern.cap, reps=REPS,
                   other_ms=times["other"], this_ms=times["this"],
                   speedup=min(times["other"]) / min(times["this"]),
                   bitwise_equal=all(torch.equal(a, b)
                                     for a, b in zip(rn, ro)),
                   max_abs_diff=max(chip_smoke._max_abs(a, b)
                                    for a, b in zip(rn, ro)),
                   other_err=max(chip_smoke._max_abs(ro[0], pe),
                                 chip_smoke._max_abs(ro[1], pown)),
                   this_err=max(chip_smoke._max_abs(rn[0], pe),
                                chip_smoke._max_abs(rn[1], pown)),
                   plan=kern.plan(dtype, L, K, W)._asdict(),
                   occupancy=kern.occupancy(dtype, L, K, W))
        if P == eng.T + 1:
            mp = chip_smoke.multitrial_compare(eng, s, TABLE, seed=7)
            row["bound_ms"], row["bound_by"] = chip_smoke.multitrial_bounds(
                eng, s, mp)["mover_points"]
        out.append(row)
        for cpg, nw in POINTS_VARIANTS if variants else ():
            plan = points_geometry(L, K, kern.CF, kern.cap, W, P,
                                   s.r.element_size())
            ng = -(-kern.CF // cpg)
            part = torch.empty((L, K, ng, P, 13, W), dtype=dtype, device=dev)
            ticket = torch.zeros((L, K, plan.grid[0]), dtype=torch.int32,
                                 device=dev)

            def variant(cpg=cpg, nw=nw, ng=ng, part=part, ticket=ticket):
                args, res = kern.launch_args(*pargs)
                args.cpg, args.ng, args.nw = cpg, ng, nw
                args.part, args.ticket = part.data_ptr(), ticket.data_ptr()
                cuda_build.check(_entry("points", dtype)(ctypes.byref(args),
                                                         stream),
                                 "points variant")
                return list(res)

            rv = variant()
            torch.cuda.synchronize()
            out.append(dict(kernel="mover_points", case=case, P=P,
                            variant=dict(cpg=cpg, ng=ng, nw=nw),
                            this_ms=chip_smoke.cuda_ms(variant, REPS, True),
                            max_abs_diff=max(chip_smoke._max_abs(a, b)
                                             for a, b in zip(rv, rn)),
                            err=max(chip_smoke._max_abs(rv[0], pe),
                                    chip_smoke._max_abs(rv[1], pown))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-chain", required=True)
    ap.add_argument("--other-movers", required=True)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None)
    opt = ap.parse_args()

    import torch

    import chip_smoke
    from bench_torch_fused import build_other
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.mcmc.chain_kernel import ChainArgs
    from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
        MoverArgs,
        PointsArgs,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cuda_build.build_all(("cell_movers", "chain_wl"))
    old_chain = bind(build_other(opt.other_chain), "chain_wl_f32", ChainArgs)
    old_movers = build_other(opt.other_movers)
    old_en = bind(old_movers, "mover_energies_f32", MoverArgs)
    old_dl = bind(old_movers, "mover_energies_deltas_f32", MoverArgs)
    old_pt = bind(old_movers, "mover_points_f32", PointsArgs)
    rows = []

    def emit(new):
        for r in new:
            print(json.dumps(r), flush=True)
        rows.extend(new)

    for case, W, over, warm in (
            ("K8-W512", chip_smoke.W_CELL, {}, 1),
            ("K8-W128", chip_smoke.W_MT, {}, 1),
            ("K8-T8-W128", chip_smoke.W_MT,
             dict(cell_trials=chip_smoke.MT_TRIALS,
                  mc_max_trans=0.10 * ANG_TO_BOHR), 1),
            ("K32-W128-flagship", chip_smoke.W_FLAG,
             dict(stack=chip_smoke.FLAG_STACK, cell_pallas="auto",
                  cell_chain="auto"), 0)):
        eng, s = chip_smoke.make_cell_engine(chip_smoke.cell_params(
            W, "float32", list_update_int=1, mpi_sync_int=1, **over))
        if warm:
            eng.run_cycles(s, warm)
        if case != "K8-W128":
            emit(chain_rows(eng, s, case, old_chain, opt.variants))
        if case.startswith("K8-W"):
            emit(energies_rows(eng, s, case, old_en, False))
        if case == "K8-T8-W128":
            emit(points_rows(eng, s, case, old_pt, opt.variants))
        if case.endswith("flagship"):
            emit(energies_rows(eng, s, case, old_dl, True))
        del eng, s
        torch.cuda.empty_cache()
    result = dict(card=card, kind=torch.cuda.get_device_name(0), rows=rows)
    line = json.dumps(result)
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
