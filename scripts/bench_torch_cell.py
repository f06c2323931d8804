#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's mover-apply kernel against another
version of csrc/cell_movers.cu, in one process on one card.

    python3 scripts/bench_torch_cell.py --other PATH/cell_movers.cu \\
        [--out OUT.json]

The other source is compiled with the port's nvcc flags (cuda_build)
into build/torch_kernels/ (its includes from the port's csrc/) and bound
with the same MoverArgs: the structure of an earlier version is a prefix
of the current one, which only appends the apply kernel's warps per
block.  Two shapes, those of chip_smoke.py's main paths that launch the
kernel: the N=8064 cell engine at 512 walkers, one trial per mover
(phase 6/7), and at 128 walkers, eight trials per mover (phase 8/9),
both float32, after one cycle of sampling.  For each, the apply stage of
one sub-step (the engine's own proposal of one table row and the chain
kernel's accepts): the two kernels' outputs on clones of the packed
slabs (the largest difference of a moment row, whether every other slab
entry is bitwise equal, how many entries differ), then each kernel's
launch by CUDA events over ``REPS`` launches applied in place on its
clones, the host running ahead, in the order other, this, this, other.
Prints one JSON line per shape and one of all (also written to --out).

    python3 scripts/bench_torch_cell.py --slab [--out OUT.json]

times the whole-cell energy kernel (ops/slab_energy.py) against its
plain version (ops/cell_energy.slab_full_energy of each lattice) on the
same state, in one process: the N=8064 stacking pair at 32 and 128
walkers and the N=24192 flagship at 128, float32, each a fresh state
(the start of a run, where every walker holds the same slots) and its
first walkers jittered with some slots emptied for some walkers.  Each
by CUDA events over SLAB_REPS calls (the plain version over
SLAB_PLAIN_REPS), in the order plain, kernel, kernel, plain, with the
largest differences of E and of the moments, and the bound of
chip_smoke.slab_energy_bound.  With both options the apply rows come
first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 50
TABLE = 5          # the table row of the sub-step (as in phase 6)
SLAB_REPS = 20
SLAB_PLAIN_REPS = 3


def slab_rows(kind):
    """The --slab rows: kernel against plain version on each shape."""
    import torch

    import chip_smoke

    rows = []
    for case, stack, W in (("N8064-W32", chip_smoke.CELL_STACK, 32),
                           ("N8064-W128", chip_smoke.CELL_STACK, 128),
                           ("N24192-W128", chip_smoke.FLAG_STACK, 128)):
        eng, s = chip_smoke.make_cell_engine(chip_smoke.cell_params(
            W, "float32", stack=stack, cell_pallas="auto",
            cell_chain="auto"))
        kern = eng.slab_energy
        bound_ms, bound_by = chip_smoke.slab_energy_bound(s, W, 4, kind)
        for state, (r, valid, h) in (
                ("fresh", (s.r, s.slot2mol >= 0, s.h)),
                ("jittered", chip_smoke.slab_inputs(s, W, seed=W))):
            err = chip_smoke.slab_energy_errors(kern, r, valid, h)
            times = {}
            for label in ("plain", "kernel", "kernel", "plain"):
                if label == "plain":
                    ms = chip_smoke.cuda_ms(
                        lambda: kern.plain(r, valid, h), SLAB_PLAIN_REPS)
                else:
                    ms = chip_smoke.cuda_ms(lambda: kern(r, valid, h),
                                            SLAB_REPS, True)
                times.setdefault(label, []).append(ms)
            occ = kern.occupancy(torch.float32, 2, W)
            row = dict(case=case, state=state, W=W, CF=kern.CF,
                       cap=kern.cap, nfine=kern.nfine,
                       plan=kern.plan(torch.float32, 2, W)._asdict(),
                       plain_ms=times["plain"], kernel_ms=times["kernel"],
                       speedup=min(times["plain"]) / min(times["kernel"]),
                       bound_ms=bound_ms, bound_by=bound_by,
                       roofline=bound_ms / min(times["kernel"]),
                       e_rel_err=err["e_rel"], mom_abs_err=err["mom_err"],
                       repeat_equal=err["repeat_equal"], **occ)
            print(json.dumps(row), flush=True)
            rows.append(row)
        del eng, s
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--slab", action="store_true")
    ap.add_argument("--out", default=None)
    opt = ap.parse_args()
    if opt.other is None and not opt.slab:
        ap.error("give --other PATH/cell_movers.cu, --slab or both")

    import torch

    import chip_smoke
    from bench_torch_fused import build_other
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
        MoverArgs,
        apply_geometry,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cuda_build.build_all(("cell_movers", "chain_wl", "slab_energy"))
    if opt.other is None:
        return _write(opt, card, kind, slab_rows(kind))
    rows = []
    fn = build_other(opt.other).mover_apply_f32
    fn.argtypes = [ctypes.POINTER(MoverArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shapes = (("W512-T1", chip_smoke.W_CELL, {}),
              ("W128-T8", chip_smoke.W_MT,
               dict(cell_trials=chip_smoke.MT_TRIALS,
                    mc_max_trans=0.10 * ANG_TO_BOHR)))
    for case, W, over in shapes:
        eng, s = chip_smoke.make_cell_engine(chip_smoke.cell_params(
            W, "float32", list_update_int=1, mpi_sync_int=1, **over))
        eng.run_cycles(s, 1)
        if eng.T == 1:
            ma = chip_smoke.cell_substep_compare(eng, s, TABLE, seed=7)[
                "mover_apply"]
        else:
            ma = chip_smoke.multitrial_apply_compare(eng, s, TABLE, seed=7,
                                                     mode="chain")
        pks, aargs = ma["args"]
        kern = eng.apply_kernel

        def other(pk_):
            args, keep = kern.launch_args(pk_, *aargs)
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(fn(ctypes.byref(args), stream), "other kernel")

        def this(pk_):
            kern(pk_, *aargs)

        po = [pk.clone() for pk in pks]
        pn = [pk.clone() for pk in pks]
        other(po)
        this(pn)
        torch.cuda.synchronize()
        mom_err = max(chip_smoke._max_abs(a[:, :10], b[:, :10])
                      for a, b in zip(pn, po))
        rest_equal = all(torch.equal(a[:, 10:], b[:, 10:])
                         for a, b in zip(pn, po))
        n_differ = int(sum((a != b).sum() for a, b in zip(pn, po)))
        times = {}
        for label, run in (("other", other), ("this", this),
                           ("this", this), ("other", other)):
            pk_ = [pk.clone() for pk in pks]
            times.setdefault(label, []).append(chip_smoke.cuda_ms(
                lambda run=run, pk_=pk_: run(pk_), REPS, True))
        K, CF, cap = eng.K, kern.CF, kern.cap
        grid, block = apply_geometry(2, K, CF, cap, W)
        bound_ms, bound_by = chip_smoke.apply_bound(eng, s, ma)
        row = dict(case=case, W=W, T=eng.T, K=K, CF=CF, cap=cap, reps=REPS,
                   other_ms=times["other"], this_ms=times["this"],
                   speedup=min(times["other"]) / min(times["this"]),
                   bound_ms=bound_ms, bound_by=bound_by,
                   n_acc=ma["n_acc"], max_abs_mom_diff=mom_err,
                   rest_equal=rest_equal, entries_differ=n_differ,
                   grid=list(grid), block=list(block))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng, s, pks, po, pn, ma
        torch.cuda.empty_cache()
    if opt.slab:
        rows += slab_rows(kind)
    return _write(opt, card, kind, rows)


def _write(opt, card, kind, rows) -> int:
    line = json.dumps(dict(card=card, kind=kind, rows=rows))
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
