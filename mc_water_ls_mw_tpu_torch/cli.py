"""Command-line interface: ``mw-water-ls-torch <input file>``.

The counterpart of ``mc_water_ls_mw_tpu/cli.py`` (the reference
executable's usage, io.f90:108-120), with its flags, and ``--device``
in place of the JAX CLI's ``--platform`` / ``--x64``: the run's float
type is the input's ``dtype`` (or ``--dtype``).  Under ``torchrun
--nproc-per-node D`` the same command shards the walkers over D ranks
(app.py).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="mw-water-ls-torch",
        description=("Lattice-switching Monte Carlo for mW water - "
                     "PyTorch/CUDA framework"),
    )
    ap.add_argument("input", help="namelist input file (e.g. ice.input)")
    ap.add_argument("--walkers", type=int, default=None,
                    help="walker-ensemble size")
    ap.add_argument("--max-cycles", type=int, default=None,
                    help="override max_mc_cycles")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--profile-dir", default=None,
                    help="trace the run and write to this directory "
                         "trace.json, a torch.profiler trace of one "
                         "steady-state cycle block, and spans.json, the "
                         "run's spans (count and total, self and longest "
                         "ns of each) and counters (cycles, sub-steps, "
                         "volume moves, kernel launches)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    overrides = {}
    if args.walkers is not None:
        overrides["n_walkers"] = args.walkers
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    if args.seed is not None:
        overrides["seed"] = args.seed

    from .app import run_input_file

    run_input_file(args.input, overrides=overrides,
                   max_cycles=args.max_cycles, profile_dir=args.profile_dir,
                   device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
