#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's N=216 cycles end to end, as chip_smoke.py's
phase 5 (table kernel) and 5b (path B, the dense-candidate kernel) drive
them, with the device's busy share, and phase 4's timing of the table
kernel, for the port in one source tree.

    python3 scripts/bench_torch_cycle.py [--tree DIR] [--label NAME] \\
        [--reps 3] [--paths 4 5 5b] [--hash-cycles N] [--per-cycle N] \\
        [--frontend N] [--jit-chunk 100 ...] [--out OUT.json]

``--tree`` is the root of a checkout (default: this one): its
chip_smoke.py and mc_water_ls_mw_tpu_torch are imported, so two versions
are compared by running this script once per tree, on one card, in the
order parent, this, this, parent.  For each path, as in chip_smoke.py:
runs/n216_sample at 4096 walkers in float32, 20 cycles of warm-up
(equilibration), then ``reps`` timed runs of 20 cycles on the host clock
(moves/s), then 10 cycles traced by torch.profiler: the device time per
cycle of the fused kernel and of all kernels, and the busy share of the
untraced cycle (device time over wall time; one stream).  Phase 4's
timing (path "4"): from the state after two cycles, ``reps`` runs of
chip_smoke.time_cycles (CUDA events around 5 cycles with the same
draws: the kernel and the host's preparation of each launch), then the
same traced: the fused kernel's device time alone.  With
``--hash-cycles N`` (path "hash"), phase 5's engine runs N cycles from
its initial state and the state's hash is kept after each (positions,
energies, mu, volumes, histogram, lattice, counters): two trees that
agree cycle by cycle ran the same trajectory.  With ``--per-cycle N``
(path "per-cycle"), phase 5's engine runs N cycles from its initial
state under torch.profiler, which gives the fused kernel's device time
launch by launch; then phase 4's timing from the state reached.
With ``--frontend N`` (path "frontend"), runs/n216_sample_torch (its
ice.input, weights and run.py's overrides: 4096 walkers, float32)
through the tree's run_input_file, N cycles in one block, once untimed
and then ``reps`` rounds of one run per ``--jit-chunk`` value, each in
a fresh directory under build/; Application.run alone is timed on the
host clock (it ends synchronised: the final checkpoint reads the
state).  The front end writes its heartbeat after each chunk of at most
jit_chunk cycles, after a synchronise, so this times the heartbeat's
cost against a tree that has none, and, in one process, against
``--jit-chunk`` values at or above the block (one synchronise at its
end, as a tree without the heartbeat does); the host seconds spent in
the heartbeats are kept too.  ``--paths`` picks which of "4",
"5" and "5b" run (default all).  Prints one JSON line per path and one
of all (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time

CYCLES = 20
TRACED = 10
# runs/n216_sample_torch/run.py's overrides (timer and cycle count aside)
SAMPLE_RUN = dict(
    stack=(3, 3, 6), n_walkers=4096, mu_min=-700.0, mu_max=700.0,
    nbins=101, samplerun=True, eq_mc_cycles=1000, mpi_sync_int=50,
    monitor_int=5000, flat_chk_int=100_000_000, deltaG_int=10000,
    chkpt_dump_int=25000, timer_qtime=10800.0, timer_closetime=420,
)


def run_path(cs, name, prm, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, s = cs.make_engine(prm)
    eng.run_cycles(s, CYCLES)                 # warm-up = equilibration
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.time()
        s, _ = eng.run_cycles(s, CYCLES)
        torch.cuda.synchronize()
        walls.append((time.time() - t0) / CYCLES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_cycles(s, TRACED)
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    dev = sum(r[0] for r in rows) * 1e-6 / TRACED
    kern = sum(r[0] for r in rows if "fused_warp_kernel" in r[2]) \
        * 1e-6 / TRACED
    best = min(walls)
    W = s.r.shape[-1]
    return dict(path=name, s_per_cycle=walls,
                moves_per_s=[W * prm.nwater / w for w in walls],
                device_ms_per_cycle=dev * 1e3,
                fused_ms_per_cycle=kern * 1e3,
                busy=dev / best,
                launches_per_cycle=sum(r[1] for r in rows) / TRACED,
                kernel=eng.fused_cycle.kernel,
                occupancy=eng.fused_cycle.occupancy(s.r.dtype, W))


def phase4(cs, prm, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, s = cs.make_engine(prm)
    eng.run_cycles(s, 2)
    draws = cs.kernel_draws(eng, s, 7)
    event_ms = [cs.time_cycles(eng, s, draws, 5) for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.time_cycles(eng, s, draws, 5)
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    kern = [r for r in rows if "fused_warp_kernel" in r[2]]
    return dict(path="4", event_ms=event_ms,
                fused_ms=sum(r[0] for r in kern) * 1e-3
                / sum(r[1] for r in kern),
                kernel=eng.fused_cycle.kernel)


def trajectory(cs, prm, n):
    import hashlib

    eng, s = cs.make_engine(prm)
    out = []
    for _ in range(n):
        eng.run_cycles(s, 1)
        h = hashlib.sha1()
        for name in ("r", "energy", "mu", "volume", "hist", "ls", "att",
                     "acc"):
            h.update(getattr(s, name).contiguous().cpu().numpy().tobytes())
        out.append(h.hexdigest()[:12])
    return dict(path="hash", hashes=out)


def per_cycle(cs, prm, n):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, s = cs.make_engine(prm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_cycles(s, n)
        torch.cuda.synchronize()
    evs = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and "fused_warp_kernel" in ev.name)
    draws = cs.kernel_draws(eng, s, 7)
    return dict(path="per-cycle", fused_ms=[us * 1e-3 for _, us in evs],
                then_event_ms=[cs.time_cycles(eng, s, draws, 5)
                               for _ in range(3)])


def frontend(tree, n, chunks, reps):
    """Seconds of Application.run over ``n`` cycles of runs/
    n216_sample_torch per jit_chunk value of ``chunks`` (``reps`` runs
    each, after one untimed run at the first value), and where the
    tree's app has a heartbeat, the host seconds spent in it (the
    synchronise and the file write) and its count, per run."""
    import torch

    from mc_water_ls_mw_tpu_torch import app as app_mod

    walls, beats = [], []
    beat = getattr(app_mod.Application, "_heartbeat", None)

    class Timed(app_mod.Application):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return super().run(*args, **kw)
            finally:
                torch.cuda.synchronize()
                walls.append(time.time() - t0)

        if beat is not None:
            def _heartbeat(self):
                t0 = time.perf_counter()
                try:
                    return beat(self)
                finally:
                    beats.append(time.perf_counter() - t0)

    def one(tag, chunk):
        d = os.path.join(tree, "build", "bench_frontend", tag)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in ("ice.input", "eta_weights.dat"):
            shutil.copy(os.path.join(tree, "runs", "n216_sample_torch", f),
                        d)
        cwd, original = os.getcwd(), app_mod.Application
        app_mod.Application = Timed
        try:
            app_mod.run_input_file(os.path.join(d, "ice.input"),
                                   overrides=SAMPLE_RUN, max_cycles=n,
                                   device="cuda", jit_chunk=chunk)
        finally:
            app_mod.Application = original
            os.chdir(cwd)
        out = (walls.pop(), sum(beats), len(beats))
        beats.clear()
        return out

    one("warm", chunks[0])
    runs = {c: [] for c in chunks}
    for i in range(reps):
        for c in chunks:
            runs[c].append(one(f"{i}_{c}", c))
    return dict(path="frontend", cycles=n,
                seconds={str(c): [r[0] for r in v] for c, v in runs.items()},
                median={str(c): statistics.median(r[0] for r in v)
                        for c, v in runs.items()},
                heartbeat_s={str(c): [r[1] for r in v]
                             for c, v in runs.items()},
                heartbeats={str(c): v[0][2] for c, v in runs.items()})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--paths", nargs="*", choices=["4", "5", "5b"],
                    default=["4", "5", "5b"])
    ap.add_argument("--frontend", type=int, default=0)
    ap.add_argument("--jit-chunk", type=int, nargs="+", default=[100])
    ap.add_argument("--hash-cycles", type=int, default=0)
    ap.add_argument("--per-cycle", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import mc_water_ls_mw_tpu_torch as port

    for mod in (cs, port):
        if not mod.__file__.startswith(tree + os.sep):
            raise SystemExit(f"{mod.__name__} imported from {mod.__file__}")
    W, over = cs.W_MAIN, dict(mpi_sync_int=5, latt_sync_int=10,
                              eq_mc_cycles=20, max_mc_cycles=45)
    rows = []
    if "4" in a.paths:
        rows.append(phase4(cs, cs.sample_params(W, "float32",
                                                eq_mc_cycles=0), a.reps))
    if "5" in a.paths:
        rows.append(run_path(cs, "5", cs.sample_params(W, "float32", **over),
                             a.reps))
    if "5b" in a.paths:
        rows.append(run_path(cs, "5b", cs.dense_params(W, "float32", "n216",
                                                       **over), a.reps))
    if a.hash_cycles:
        rows.append(trajectory(cs, cs.sample_params(W, "float32", **over),
                               a.hash_cycles))
    if a.per_cycle:
        rows.append(per_cycle(cs, cs.sample_params(W, "float32", **over),
                              a.per_cycle))
    if a.frontend:
        rows.append(frontend(tree, a.frontend, a.jit_chunk, a.reps))
    label = a.label or tree
    card = torch.cuda.get_device_name(0)
    for r in rows:
        r.update(tree=label, card=card)
        print(json.dumps(r), flush=True)
    print(json.dumps(rows))
    if a.out:
        with open(a.out, "a") as f:
            f.write(json.dumps(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
