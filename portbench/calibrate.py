"""The readings that the limits of ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --first-seed <n> [--seconds 51] [--control 0|1] \
        [--fault <name>] [--out <file.jsonl>]

runs the cell on seeds n, n+1, ... in one process (set-up once per
seed, the kernels built once), each a whole run at the cell's own size
and window, and prints one JSON line per seed: the program's numbers,
also those the cell sets no limit on, and with ``--control 1`` (the
default) the control's (the reference in bfloat16 in the program's
place) on the same final state.  The lower reading of a number is the
largest the program gives; the upper, the smallest the control gives.
``--fault`` plants one of ``portbench/faults.py``'s faults under the
run, to read what it gives.  The benchmark's own runs do not run the
control.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import _env

    _env()
    from portbench import harness
    from portbench.faults import FAULTS

    seconds = args.seconds or harness.manifest(ROOT)["run_seconds"]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in range(args.first_seed, args.first_seed + args.seeds):
            res = harness.run(
                args.workload, seed, seconds,
                fault=FAULTS[args.fault] if args.fault else None,
                with_control=bool(args.control))
            row = {"workload": args.workload, "seed": seed,
                   "fault": args.fault, "correct": res.correct,
                   "failed": res.failed,
                   "program": res.values,
                   "metrics": {k: v for k, (v, _) in res.metrics.items()}}
            if res.control is not None:
                row["control"] = res.control["values"]
                row["control_correct"] = res.control["correct"]
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
