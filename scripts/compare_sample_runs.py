"""Compare the histograms of two sample runs (samplerun=.true.) bin by
bin.

For each run directory: the flatness of the biased visit histogram
``histogram.dat`` (the largest relative deviation of a bin from the mean
over the bins), the block-jackknife Delta G of tools/deltag_error.py
(in kT per molecule and J/mol at --temperature, 200 K by default) and
the two runs' difference in combined sigma, and the unbiased
probability density P(mu) of the last cumulative dump
``unbiased_histogram_<cycle>.dat`` at or before ``--max-cycle`` (raw
third column, normalised over the widths of the grid that --mu-min,
--mu-max and the number of bins define), with a per-bin standard error
from the blocks between consecutive dumps (the first ``--skip-blocks``
dropped: the blocks, the estimator and the jackknife are
tools/deltag_error.py's).  Then, bin by bin, the difference of the two
P(mu) in units of their combined error: the largest |z|, the bins
beyond 3, and chi^2 per bin.

Usage:
    python scripts/compare_sample_runs.py RUN_A RUN_B \
        --mu-min -700 --mu-max 700 [--nwater 216] [--skip-blocks 1] \
        [--max-cycle C] [--max-cycle-b C] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from mc_water_ls_mw_tpu_torch.constants import HART_TO_KJPM, KB  # noqa: E402
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid  # noqa: E402
from mc_water_ls_mw_tpu_torch.tools.deltag_error import (  # noqa: E402
    block_differences,
    deltag,
    jackknife,
    load_dumps,
)


def load(run_dir, skip, bw, max_cycle):
    dumps = [d for d in load_dumps(run_dir) if d[0] <= max_cycle]
    if len(dumps) < skip + 3:
        raise SystemExit(f"{run_dir}: {len(dumps)} dumps, too few blocks")
    blocks = block_differences(dumps, skip)
    # Delta G and each bin's normalised density, each with the
    # delete-one-block jackknife of tools/deltag_error.py (its estimator:
    # the centre bin counts toward the mu > 0 side)
    dg, dg_err, _, n = jackknife(blocks,
                                 lambda t: deltag(t, bw, len(bw) // 2))
    p, err, _, _ = jackknife(blocks, lambda t: t / (t * bw).sum())
    h = np.loadtxt(os.path.join(run_dir, "histogram.dat"), comments="#")
    flat = float(np.max(np.abs(h[:, 1] / h[:, 1].mean() - 1.0)))
    return dict(mu=dumps[-1][1], p=p, err=err, blocks=n, cycle=dumps[-1][0],
                dg=float(dg), dg_err=float(dg_err),
                flat=flat, hist_min=float(h[:, 1].min()),
                hist_max=float(h[:, 1].max()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_a")
    ap.add_argument("run_b")
    ap.add_argument("--mu-min", type=float, required=True)
    ap.add_argument("--mu-max", type=float, required=True)
    ap.add_argument("--nwater", type=int, default=216)
    ap.add_argument("--temperature", type=float, default=200.0)
    ap.add_argument("--skip-blocks", type=int, default=1)
    ap.add_argument("--max-cycle", type=int, default=2 ** 62)
    ap.add_argument("--max-cycle-b", type=int, default=None,
                    help="RUN_B's cut, where it differs from --max-cycle")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    nbins = len(np.loadtxt(os.path.join(args.run_a, "histogram.dat"),
                           comments="#"))
    grid = build_bin_grid(nbins, args.mu_min, args.mu_max)
    bw = np.asarray(grid.binwidth)
    a = load(args.run_a, args.skip_blocks, bw, args.max_cycle)
    b = load(args.run_b, args.skip_blocks, bw, args.max_cycle
             if args.max_cycle_b is None else args.max_cycle_b)
    for r in (a, b):
        if not np.allclose(r["mu"], np.asarray(grid.mu_bin), rtol=1e-6):
            raise SystemExit("a run's bins are not the grid's")
    j_per_mol = KB * args.temperature * HART_TO_KJPM * 1000.0 / args.nwater
    for name, r in ((args.run_a, a), (args.run_b, b)):
        print(f"{name}: cycle {r['cycle']}, {r['blocks']} blocks; biased "
              f"histogram within {100 * r['flat']:.2f}% of its mean "
              f"(bins {r['hist_min']:.4e} .. {r['hist_max']:.4e}); "
              f"deltaG {r['dg'] / args.nwater:+.8f} +- "
              f"{r['dg_err'] / args.nwater:.8f} kT/molecule = "
              f"{r['dg'] * j_per_mol:+.4f} +- {r['dg_err'] * j_per_mol:.4f}"
              " J/mol")
    diff = (a["dg"] - b["dg"]) / np.hypot(a["dg_err"], b["dg_err"])
    print(f"deltaG difference {diff:+.3f} combined sigma")
    comb = np.sqrt(a["err"] ** 2 + b["err"] ** 2)
    ok = comb > 0
    z = np.where(ok, (a["p"] - b["p"]) / np.where(ok, comb, 1.0), 0.0)
    print(f"P(mu) bin by bin: max |z| {np.abs(z).max():.3f} at mu "
          f"{a['mu'][np.argmax(np.abs(z))]:.2f}; {int((np.abs(z) > 3).sum())}"
          f" of {ok.sum()} bins beyond 3 sigma; chi^2 per bin "
          f"{float((z[ok] ** 2).mean()):.3f}")
    rel = np.abs(a["p"] - b["p"]) / np.maximum(b["p"], 1e-300)
    print(f"P(mu) largest relative difference {rel.max():.4f} at mu "
          f"{a['mu'][np.argmax(rel)]:.2f}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(dict(mu=a["mu"].tolist(), p_a=a["p"].tolist(),
                           err_a=a["err"].tolist(), p_b=b["p"].tolist(),
                           err_b=b["err"].tolist(), z=z.tolist(),
                           flat_a=a["flat"], flat_b=b["flat"]), fh)


if __name__ == "__main__":
    main()
