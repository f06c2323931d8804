#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's fused-cycle kernels against another
version of csrc/fused_cycle.cu, and its whole-cell energy kernel against
another version of csrc/full_energy.cu, in one process on one card.

    python3 scripts/bench_torch_fused.py [--other PATH/fused_cycle.cu] \\
        [--other-full-energy PATH/full_energy.cu [--variants]] \\
        [--out OUT.json]

The other sources are compiled with the port's nvcc flags (cuda_build)
into build/torch_kernels/ (their includes from the port's csrc/).  The
other fused cycle is bound with the same FusedArgs: the structure of an
earlier version is a prefix of the current one, which only appends the
launch plan.  For each case
of chip_smoke.py's phases 4, 4b and 4c at W=4096 in float32 (the table
kernel at N=216; the dense kernel at N=216 with one folded shift and at
N=48 with three; the multi-trial kernel at T=2, 4 and 8, path C's
runs), from the state after two cycles and one cycle's draws: each kernel's cycle by CUDA events
over ``reps`` cycles, in the order other, this, this, other; how many
walkers' integer outcomes differ between the two kernels and the
largest continuous difference on the rest; this kernel at fewer
walkers per block (WPB_TRIES); its registers, walkers per block and
resident walkers per SM.

The other whole-cell energy kernel is bound with the C signature of
the first design (r, H, shifts, S, N, W, mom, contrib, E, constants,
stream).  Its cases are chip_smoke.py's phase 3 at W=4096 in float32
(N=216 with one folded shift, N=48 with three) on jittered cells: both
kernels' outputs (bitwise equality, largest difference, each against
the plain version), then each launch by CUDA events over FE_REPS, in
the order other, this, this, other, and this kernel's plan and
occupancy.  With ``--variants`` this kernel is also timed at other
launch plans, set on its FullEnergyArgs (warps a block, centre groups
a tile), with its errors against the plain version.  Prints one JSON line per row and one of all (also
written to --out).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# fewer walkers per block than the plan's, timed beside it
WPB_TRIES = (8, 6)
FE_REPS = 20
# (stack, jitter seed) of the whole-cell energy cases: phase 3's cells
FE_CASES = (((3, 3, 6), 1), ((1, 2, 6), 2))
# this whole-cell energy kernel at other plans: (warps, centre groups),
# each group a whole number of the block's centre slots
FE_VARIANTS = ((8, 5), (16, 2), (16, 3), (16, 7), (16, 14))
CASES = (("fused_cycle", "table", 5), ("fused_cycle_dense", "n216", 3),
         ("fused_cycle_dense", "n48", 5), ("fused_cycle_multi", "t2", 5),
         ("fused_cycle_multi", "t4", 5), ("fused_cycle_multi", "t8", 5))


def build_other(src):
    """Compile another version of a csrc/ source (its includes from the
    port's csrc/) and load it."""
    from mc_water_ls_mw_tpu_torch import cuda_build

    data = open(src, "rb").read()
    tag = hashlib.sha256(data + " ".join(cuda_build.NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    out = cuda_build.BUILD_DIR / f"other_{stem}-{tag.hexdigest()[:16]}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-I", str(cuda_build.CSRC), "-o", str(out), src],
                       check=True)
    return ctypes.CDLL(str(out))


def full_energy_rows(lib, variants):
    """Rows of the whole-cell energy kernel against the other version in
    ``lib`` at phase 3's cases."""
    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.models.stacking import (
        stacking_switch_pair,
    )
    from mc_water_ls_mw_tpu_torch.models.sw import MW
    from mc_water_ls_mw_tpu_torch.ops import full_energy as fe_mod
    from mc_water_ls_mw_tpu_torch.ops.dense import reduced_shift_set

    V, I = ctypes.c_void_p, ctypes.c_int
    old = lib.full_energy_f32
    old.argtypes = [V, V, V, I, I, I, V, V, V, V, V]
    old.restype = ctypes.c_int
    W = chip_smoke.W_MAIN
    rows = []
    for stack, seed in FE_CASES:
        shifts = reduced_shift_set(stacking_switch_pair(*stack)[1], MW)
        kern = fe_mod.FullEnergyKernel(MW, shifts)
        r3, H = chip_smoke.jittered_cells(W, torch.float32, seed=seed,
                                          stack=stack)[1]
        N = r3.shape[1]
        sh = torch.as_tensor(kern.shifts.reshape(-1), device=r3.device)
        contrib = torch.empty((N, W), dtype=r3.dtype, device=r3.device)

        def other():
            mom = torch.empty((10, N, W), dtype=r3.dtype, device=r3.device)
            E = torch.empty((W,), dtype=r3.dtype, device=r3.device)
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(old(
                r3.data_ptr(), H.data_ptr(), sh.data_ptr(), len(kern.shifts),
                N, W, mom.data_ptr(), contrib.data_ptr(), E.data_ptr(),
                ctypes.byref(kern.consts), stream), "other full_energy")
            return E, mom

        def this():
            E, mom = kern(r3, H)
            return E, torch.stack(list(mom))

        def at_plan(warps, groups):
            slots = 32 * warps // kern.plan(torch.float32, N, W).tw
            groups = min(groups, -(-N // slots))
            cpg = -(-(-(-N // groups)) // slots) * slots
            plan = dict(warps=warps, cpg=cpg, groups=-(-N // cpg))

            def run():
                args, (E, mom) = kern.launch_args(r3, H)
                args.warps, args.cpg, args.groups = (
                    plan["warps"], plan["cpg"], plan["groups"])
                stream = torch.cuda.current_stream().cuda_stream
                cuda_build.check(fe_mod._entry(torch.float32)(
                    ctypes.byref(args), stream), "full_energy variant")
                return E, torch.stack(list(mom))
            return run, plan

        e_p, m_p = kern.plain(r3, H)
        m_p = torch.stack(list(m_p))

        def errors(out):
            e, m = out
            return dict(e_rel=float(torch.max(torch.abs(e - e_p)
                                              / torch.abs(e_p))),
                        mom_err=float(torch.max(torch.abs(m - m_p))))

        ro, rn = other(), this()
        torch.cuda.synchronize()
        times = {}
        for label, run in (("other", other), ("this", this),
                           ("this", this), ("other", other)):
            times.setdefault(label, []).append(
                chip_smoke.cuda_ms(run, FE_REPS, True))
        bound_ms, bound_by = chip_smoke.full_energy_bound(r3, H,
                                                          len(shifts))
        row = dict(kernel="full_energy", N=N, S=len(shifts), W=W,
                   reps=FE_REPS, other_ms=times["other"],
                   this_ms=times["this"],
                   speedup=min(times["other"]) / min(times["this"]),
                   bound_ms=bound_ms, bound_by=bound_by,
                   E_bitwise_equal=torch.equal(ro[0], rn[0]),
                   mom_bitwise_equal=torch.equal(ro[1], rn[1]),
                   max_abs_diff=max(chip_smoke._max_abs(a, b)
                                    for a, b in zip(ro, rn)),
                   other_err=errors(ro), this_err=errors(rn),
                   plan=kern.plan(torch.float32, N, W)._asdict(),
                   occupancy=kern.occupancy(torch.float32, N, W))
        print(json.dumps(row), flush=True)
        rows.append(row)
        for warps, groups in FE_VARIANTS if variants else ():
            run, plan = at_plan(warps, groups)
            out = run()
            torch.cuda.synchronize()
            row = dict(kernel="full_energy", N=N, S=len(shifts), W=W,
                       variant=plan,
                       this_ms=chip_smoke.cuda_ms(run, FE_REPS, True),
                       bitwise_equal=all(torch.equal(a, b)
                                         for a, b in zip(out, rn)),
                       err=errors(out))
            print(json.dumps(row), flush=True)
            rows.append(row)
        del r3, H, contrib
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--other-full-energy", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None)
    opt = ap.parse_args()
    if not (opt.other or opt.other_full_energy):
        ap.error("give --other and/or --other-full-energy")

    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.mcmc import fused
    from mc_water_ls_mw_tpu_torch.mcmc.fused import FusedArgs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    if opt.other_full_energy:
        cuda_build.build_all(("full_energy",))
        rows += full_energy_rows(build_other(opt.other_full_energy),
                                 opt.variants)
    if opt.other:
        cuda_build.build_all(("fused_cycle",))
        lib = build_other(opt.other)
    W = chip_smoke.W_MAIN
    for kernel, case, reps in CASES if opt.other else ():
        if case == "table":
            prm = chip_smoke.sample_params(W, "float32", eq_mc_cycles=0)
        elif case.startswith("t"):
            prm = chip_smoke.multi_params(W, "float32", int(case[1:]),
                                          eq_mc_cycles=0)
        else:
            prm = chip_smoke.dense_params(W, "float32", case,
                                          samplerun=case == "n216",
                                          eq_mc_cycles=0)
        eng, s = chip_smoke.make_engine(prm, paper_pair=case.startswith("t"))
        fc = eng.fused_cycle
        assert fc.kernel == kernel
        eng.run_cycles(s, 2)
        draws = chip_smoke.kernel_draws(eng, s, 7)
        fn = getattr(lib, f"{kernel}_f32")
        fn.argtypes = [ctypes.POINTER(FusedArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def other(st):
            args, wf, wi, keep = fc.launch_args(st, *draws, True, True)
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(fn(ctypes.byref(args), stream), "other kernel")
            fc.finish(st, wf, wi)

        def this(st):
            fc(st, *draws, True, True)

        def this_at(wpb):
            """This kernel with ``wpb`` walkers per block (fewer than the
            plan's: the state still fits)."""
            def run(st):
                args, wf, wi, keep = fc.launch_args(st, *draws, True, True)
                args.wpb = wpb
                stream = torch.cuda.current_stream().cuda_stream
                err = fused._entry(kernel, torch.float32)(ctypes.byref(args),
                                                          stream)
                cuda_build.check(err, kernel)
                fc.finish(st, wf, wi)
            return run

        # one cycle of each from the same state: their outcomes
        so, sn = s.clone(), s.clone()
        for st, run in ((so, other), (sn, this)):
            st.cycle += 1
            run(st)
        torch.cuda.synchronize()
        differ = so.ls != sn.ls
        for name in ("att", "acc", "trans_per_mol"):
            differ |= (getattr(so, name) != getattr(sn, name)).any(dim=0)
        err = chip_smoke.fused_max_err(sn, so, ~differ,
                                       ("r", "moments", "energy", "mu"))
        times = {}
        for label, run in (("other", other), ("this", this),
                           ("this", this), ("other", other)):
            st = s.clone()

            def one_cycle(st=st, run=run):
                st.cycle += 1
                run(st)

            times.setdefault(label, []).append(chip_smoke.cuda_ms(one_cycle,
                                                                  reps))
        by_wpb = {}
        plan = fc.plan(torch.float32, W)
        for wpb in WPB_TRIES:
            if wpb < plan.wpb:
                st = s.clone()

                def one_cycle(st=st, run=this_at(wpb)):
                    st.cycle += 1
                    run(st)

                by_wpb[wpb] = chip_smoke.cuda_ms(one_cycle, reps)
        occ = fc.occupancy(torch.float32, W)
        row = dict(kernel=kernel, case=case, W=W, N=prm.nwater,
                   S=len(eng.fold_shifts), reps=reps,
                   other_ms=times["other"], this_ms=times["this"],
                   speedup=min(times["other"]) / min(times["this"]),
                   this_ms_by_wpb=by_wpb,
                   walkers_differ=int(differ.sum()),
                   max_rel_state_diff=err, **occ)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng, s, so, sn
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
