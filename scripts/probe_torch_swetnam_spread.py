#!/usr/bin/env python3
"""The spread over seeds of chip_smoke.py's phase-4e float32 check of
the fused cycle under the Wang-Landau f schedules: how many walkers'
integer outcomes differ between the kernel and its plain version over
one cycle with the same draws.

    python3 scripts/probe_torch_swetnam_spread.py [--seeds 2014 1 2 3 4] \\
        [--cases wl swetnam invt] [--out OUT.json]

Each case is phase 4e's (chip_smoke.variant_cases: ``wl`` the plain
factor at Swetnam's cut, ``swetnam``, ``invt`` with every other walker
on 1/t), at 4096 walkers in float32, built with the run's seed replaced
by each seed (2014 is the smoke run's); as in phase 4e, two cycles of
the engine, then one cycle's draws from a stream seeded 7 (the smoke
run's) and each other seed.  Prints one JSON line per (case, seed) and
one of all (also written to --out).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[2014, 1, 2, 3, 4])
    ap.add_argument("--cases", nargs="+", default=["wl", "swetnam", "invt"])
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    cases = {c[0]: c for c in cs.variant_cases()}
    rows = []
    for tag in a.cases:
        _, kernel, params, prepare, weights, paper = cases[tag]
        for seed in a.seeds:
            prm = dataclasses.replace(params(cs.W_MAIN, "float32"),
                                      seed=seed)
            eng, s = cs.make_engine(prm, paper_pair=paper, weights=weights)
            if prepare is not None:
                prepare(s)
            eng.run_cycles(s, 2)
            draws = cs.kernel_draws(eng, s, 7 if seed == 2014 else seed)
            _, _, differ = cs.fused_compare(eng, s, draws)
            torch.cuda.synchronize()
            row = dict(case=tag, kernel=eng.fused_cycle.kernel, seed=seed,
                       walkers=cs.W_MAIN, differ=int(differ.sum()),
                       frac=float(differ.float().mean()),
                       limit=cs.F32_MAX_DIFF_FRAC)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del eng, s
            torch.cuda.empty_cache()
    print(json.dumps(rows))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
