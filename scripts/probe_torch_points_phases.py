#!/usr/bin/env python3
"""Where the time of one launch of the port's mover-points kernel goes,
block by block, on one card.

    python3 scripts/probe_torch_points_phases.py [--out OUT.json]

Writes a copy of csrc/cell_movers.cu into build/probe/ with a stamp of
the global nanosecond timer (%globaltimer) taken by thread (0, 0) of
every block at the kernel's phase boundaries, compiles it with the
port's nvcc flags, and launches it once (after three warm-up launches)
on the N=8064 engine of chip_smoke.py's phase 8 at 128 walkers, float32,
eight trials per mover, after one cycle of sampling, at P = 9 points
(T=8, the front-end path's shape) and at the first 3 (T=2).  The
phases: start; the flags landed; the coordinates landed and the near
slots listed; the block's barrier; its points' sums written; in the
last block of a (tile, mover, lattice), its groups' sums read; the end.
Prints, per P, each stamp's spread over the blocks (microseconds from
the first block's start), the blocks' durations, each phase's median
and maximum and the deciles of the blocks' start times (their waves),
and one JSON line (also written to --out).  The stamps cost a few
instructions and one store per block and phase.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MAX_BLOCKS = 8192
PHASES = ("start", "flags", "near", "barrier", "points", "last", "end")
# (phase index, the source text the stamp follows, inside the kernel)
MARKS = (
    (1, "    reach2 = reach * reach * (T)1.001;\n    cp_async_wait_all();"),
    (2, "    s_cnt[wy * 32 + lane] = n;"),
    (3, "    s_cnt[wy * 32 + lane] = n;\n  }\n  __syncthreads();"),
    (4, "  // index order\n  __threadfence();\n  __syncthreads();"),
    (5, "  if (!s_last || w_raw >= W) return;\n  __threadfence();"),
)
END = "for (int f = 0; f < 10; ++f) own[(size_t)f * W] = m[f];\n  }\n"


def stamped_source(src: str) -> str:
    """csrc/cell_movers.cu with the stamps and two C entry points that
    clear and read them; raises if the kernel no longer has the text a
    stamp follows."""
    head = '#include "sw_common.cuh"\n'
    src = src.replace(head, head + f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS} * 8];
#define STAMP(i)                                                     \\
  if (threadIdx.x == 0 && threadIdx.y == 0) {{                         \\
    unsigned long long t_;                                           \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_));            \\
    g_stamp[stamp_block * 8 + (i)] = t_;                             \\
  }}
""", 1)
    start = src.index("mover_points_kernel(const PointsArgs a) {")
    body = src.index("\n", start) + 1
    src = (src[:body] + "  const size_t stamp_block = blockIdx.x + (size_t)"
           "gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);\n"
           "  STAMP(0)\n" + src[body:])
    for i, mark in sorted(MARKS, key=lambda m: -len(m[1])):
        at = src.index(mark, start) + len(mark)
        src = src[:at] + f"\n  STAMP({i})\n" + src[at:]
    at = src.index(END, start) + len(END)
    src = src[:at] + "  __syncthreads();\n  STAMP(6)\n" + src[at:]
    return src.replace('extern "C" {\n', f"""extern "C" {{
int stamps_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}}
int stamps_clear() {{
  static unsigned long long zero[{MAX_BLOCKS} * 8];
  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}}
""", 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from bench_torch_chain import TABLE, chain_inputs
    from bench_torch_fused import build_other
    from mc_water_ls_mw_tpu_torch import cuda_build
    from mc_water_ls_mw_tpu_torch.constants import ANG_TO_BOHR
    from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
        MoverPointsKernel,
        PointsArgs,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "cell_movers_stamped.cu")
    with open(cuda_build.CSRC / "cell_movers.cu") as f:
        stamped = stamped_source(f.read())
    with open(src, "w") as f:
        f.write(stamped)
    lib = build_other(src)
    fn = lib.mover_points_f32
    fn.argtypes = [ctypes.POINTER(PointsArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    eng, s = chip_smoke.make_cell_engine(chip_smoke.cell_params(
        chip_smoke.W_MT, "float32", list_update_int=1, mpi_sync_int=1,
        cell_trials=chip_smoke.MT_TRIALS, mc_max_trans=0.10 * ANG_TO_BOHR))
    eng.run_cycles(s, 1)
    _, pks, trial = chain_inputs(eng, s, seed=7)
    fc, cand, off = eng._tables(TABLE)
    W = s.r.shape[-1]
    rows = []
    for P in (eng.T + 1, 3):
        kern = (eng.points_kernel if P == eng.T + 1
                else MoverPointsKernel(eng.model, eng.cellgrid, P))
        pargs = (pks, s.h, cand, off, fc, trial.rank,
                 trial.pts[:P].contiguous())

        def run():
            args, res = kern.launch_args(*pargs)
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(fn(ctypes.byref(args), stream), "stamped")
            return res

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        cuda_build.check(lib.stamps_clear(), "stamps_clear")
        run()
        torch.cuda.synchronize()
        plan = kern.plan(torch.float32, len(pks), eng.K, W)
        n_blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
        cuda_build.check(lib.stamps_read(buf), "stamps_read")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, 8)
        t = t[:n_blocks, :len(PHASES)].astype(np.int64)
        t0 = t[:, 0].min()
        us = np.where(t > 0, (t - t0) / 1e3, np.nan)
        row = dict(P=P, blocks=n_blocks, plan=plan._asdict(),
                   span_us=float(np.nanmax(us)))
        print(f"P={P}: {n_blocks} blocks, first start to last end "
              f"{row['span_us']:.2f} us", flush=True)
        for i, name in enumerate(PHASES):
            v = us[:, i][~np.isnan(us[:, i])]
            row[name] = [float(v.min()), float(np.median(v)), float(v.max()),
                         int(len(v))]
            print(f"  {name:8s} {len(v):4d} blocks: min {v.min():8.2f} "
                  f"median {np.median(v):8.2f} max {v.max():8.2f} us",
                  flush=True)
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (5, 6)):
            d = (us[:, b] - us[:, a])
            d = d[~np.isnan(d)]
            key = f"{PHASES[a]}->{PHASES[b]}"
            row[key] = [float(np.median(d)), float(d.max())]
            print(f"  {key:16s} median {np.median(d):8.2f} max "
                  f"{d.max():8.2f} us", flush=True)
        row["start_deciles"] = np.percentile(
            us[:, 0], [0, 10, 25, 50, 75, 90, 100]).round(2).tolist()
        print(f"  start-time deciles (us) {row['start_deciles']}",
              flush=True)
        rows.append(row)
    line = json.dumps(dict(card=torch.cuda.get_device_name(0), rows=rows))
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
