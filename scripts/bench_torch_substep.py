#!/usr/bin/env python3
"""Time the sub-step loop of the PyTorch/CUDA port's N=8064 cell engine,
on the host's clock and on the card's, for the version of the port in
a given directory, so that two versions can be compared in one call on
one card.

    python3 scripts/bench_torch_substep.py [--root DIR] [--reps N] \\
        [--frontend] [--other-chain PATH/chain_wl.cu \\
        --other-movers PATH/cell_movers.cu] [--out OUT.json]

DIR (default: this checkout) holds the chip_smoke.py and the
mc_water_ls_mw_tpu_torch/ that are timed.  The engines are those of
chip_smoke.py's phase 7 (N=8064, float32, one trial per mover, W_CELL
walkers) and of its multi-trial phases (MT_TRIALS trials per mover,
W_MT walkers: the shape of the front-end run of phase 9), each after one
cycle of sampling.  For each: ``reps`` cycles' sub-step loops
(CellEngine._substep_scan on each cycle's own draws, no rebin, sync or
volume move between them), each timed by the host's clock from a
synchronised start to a synchronised end, then one more loop traced by
torch.profiler for its device time.  With ``--frontend`` also the
version's own phase 9 (chip_smoke.frontend_run: runs/n8064_wl through
run_input_file, ~4 min), its profiled loop's host ms per sub-step as it
prints them, and ``reps`` further loops of that engine right after.  Run
it once per version, in the order other, this, this, other, in one
call.  With ``--other-chain`` and ``--other-movers`` the comparison is
made in one process instead: each engine's loops alternate between
this version's kernels and the other sources' chain and mover kernels
(compiled as scripts/bench_torch_fused.build_other does, launched by
this version's wrappers), ``reps`` loops each in the order this,
other, other, this.  Prints one JSON line (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loop_times(eng, s, reps, device_rows):
    """(host ms per sub-step of each of ``reps`` loops, device ms per
    sub-step of one traced loop, device launches per sub-step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_sub = eng.sweeps_per_cycle * eng.n_tables
    W = s.r.shape[-1]

    def draws():
        s.cycle += 1
        return eng.stream.cell_cycle_draws(
            s.cycle, eng.probs, eng.trials_per_cycle, n_sub, eng.K,
            eng.n_u, W, s.r.dtype)

    host = []
    for _ in range(reps):
        codes, u_all = draws()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, _ = eng._substep_scan(s, codes, u_all, n_sub)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / n_sub * 1e3)
    codes, u_all = draws()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s, _ = eng._substep_scan(s, codes, u_all, n_sub)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return (host, sum(r[0] for r in rows) * 1e-3 / n_sub,
            sum(r[1] for r in rows) / n_sub)


def kernel_versions(other_chain, other_movers):
    """{'this': switch, 'other': switch}: each switch makes the chain
    and mover wrappers launch this version's kernels or the other
    sources' (``_entry`` of mcmc/chain_kernel and ops/cell_kernels
    replaced; float32; the other points kernel gets its own warps per
    block, bench_torch_chain.old_points_warps)."""
    import ctypes

    import torch

    from bench_torch_chain import old_points_warps
    from bench_torch_fused import build_other
    from mc_water_ls_mw_tpu_torch.mcmc import chain_kernel as ck
    from mc_water_ls_mw_tpu_torch.ops import cell_kernels as ckl

    def bind(lib, sym, struct):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    chain = bind(build_other(other_chain), "chain_wl_f32", ck.ChainArgs)
    lib = build_other(other_movers)
    movers = {w: bind(lib, f"mover_{w}_f32",
                      ckl.PointsArgs if w == "points" else ckl.MoverArgs)
              for w in ("energies", "energies_deltas", "points", "apply")}
    this = (ck._entry, ckl._entry)

    def other_chain_entry(dtype):
        assert dtype == torch.float32
        return chain

    def other_points(args, stream):
        # the other points kernel's own warps per block (an earlier
        # PointsArgs is a prefix of this version's)
        args._obj.nw = old_points_warps(args._obj.P, 4)
        return movers["points"](args, stream)

    def other_mover_entry(which, dtype):
        assert dtype == torch.float32
        return other_points if which == "points" else movers[which]

    def use(entries):
        ck._entry, ckl._entry = entries

    return {"this": lambda: use(this),
            "other": lambda: use((other_chain_entry, other_mover_entry))}


def frontend_times(chip_smoke, reps):
    """(phase 9's printed host ms per sub-step of its profiled loop,
    ``loop_times`` of its engine right after) of the version's
    chip_smoke.frontend_run, its own output captured."""
    import contextlib
    import io
    import re

    got = {}
    original = chip_smoke.profile_cell_cycle

    def profiled(eng, s, tag="cell-profile"):
        out = original(eng, s, tag)
        got["loops"] = loop_times(eng, s, reps, chip_smoke.device_rows)
        return out

    chip_smoke.profile_cell_cycle = profiled
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            chip_smoke.frontend_run()
    finally:
        chip_smoke.profile_cell_cycle = original
    m = re.search(r"\[frontend-profile\] cycle .*\(([0-9.]+) ms per "
                  r"sub-step\)", buf.getvalue())
    return float(m.group(1)), got["loops"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frontend", action="store_true")
    ap.add_argument("--other-chain", default=None)
    ap.add_argument("--other-movers", default=None)
    ap.add_argument("--out", default=None)
    opt = ap.parse_args()
    root = os.path.abspath(opt.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    versions = (kernel_versions(opt.other_chain, opt.other_movers)
                if opt.other_chain else None)
    rows = []
    for case, W, over in (
            ("K8-T1-W512", chip_smoke.W_CELL, {}),
            ("K8-T8-W128", chip_smoke.W_MT,
             dict(cell_trials=chip_smoke.MT_TRIALS,
                  mc_max_trans=0.10 * ANG_TO_BOHR))):
        eng, s = chip_smoke.make_cell_engine(chip_smoke.cell_params(
            W, "float32", **over))
        eng.run_cycles(s, 1)
        row = dict(case=case, W=W, K=eng.K, T=eng.T,
                   sub_steps=eng.sweeps_per_cycle * eng.n_tables)
        if versions is None:
            host, dev, launches = loop_times(eng, s, opt.reps,
                                             chip_smoke.device_rows)
            row.update(host_ms=host, device_ms=dev,
                       launches_per_sub_step=launches,
                       busy=dev / min(host))
        else:
            for label in ("this", "other", "other", "this"):
                versions[label]()
                host, dev, _ = loop_times(eng, s, opt.reps,
                                          chip_smoke.device_rows)
                row.setdefault(f"{label}_host_ms", []).append(host)
                row.setdefault(f"{label}_device_ms", []).append(dev)
            versions["this"]()
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
        del eng, s
        torch.cuda.empty_cache()
    if opt.frontend:
        phase9, (host, dev, launches) = frontend_times(chip_smoke, opt.reps)
        rows.append(dict(case="frontend-K8-T8-W128", phase9_ms=phase9,
                         host_ms=host, device_ms=dev,
                         launches_per_sub_step=launches,
                         busy=dev / min(host)))
        print(json.dumps(rows[-1]), flush=True)
    line = json.dumps(dict(root=root, card=card,
                           kind=torch.cuda.get_device_name(0), rows=rows))
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
