"""Weights-only deltaG estimates across a WL run's f-archives.

Implements the reference's weights-direct estimator
(mc_compute_deltaG_from_eta, mc_moves.F90:2418-2496, shipped
commented out): assume the converged multicanonical weights are
exactly -G(mu)/kT, so P_nat(mu) proportional to exp(eta(mu)); the two
halves of the normalised P integrate to p_A/p_B and
deltaG = ln(p_A/p_B).  Applied to EVERY archived
``eta_weights.dat_<f>`` of a generation run plus the final curve, the
sequence of estimates across successive f-halvings is a convergence
series: its tail spread is an error estimate the single final number
lacks (each halving is a progressively finer, largely independent
refinement stage).  The counterpart of the JAX package's
``scripts/deltag_from_weights.py``, with its flags and output; numpy
only.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.deltag_from_weights \\
        <run_dir> --nwater 216 --temperature 200 \\
        [--nbins 201 --mu-min -1800 --mu-max 1800]

The bin grid must match the run's (the mid-bin mu values in the file
are checked against the rebuilt grid).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..constants import HART_TO_EV, HART_TO_KJPM, KB
from ..io.writers import read_eta_weights
from ..mcmc.bins import build_bin_grid


def deltag_from_eta(eta, binwidth):
    """The reference's trapezoid split integration
    (mc_moves.F90:2449-2471), 0-indexed."""
    nbins = len(eta)
    P = np.exp(eta - eta.max())
    P = P / np.sum(P * binwidth)
    half = nbins // 2
    pA = 0.0
    for i in range(half):
        pA += P[i] * 0.5 * (binwidth[i] + binwidth[i + 1])
        pA += 0.5 * binwidth[i] * (P[i + 1] - P[i])
    pB = 0.0
    for i in range(half, nbins):
        pB += 0.5 * binwidth[i - 1] * (P[i - 1] - P[i])
        pB += P[i] * 0.5 * (binwidth[i - 1] + binwidth[i])
    return np.log(pA / pB)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.deltag_from_weights",
        description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--nwater", type=int, required=True)
    ap.add_argument("--temperature", type=float, default=200.0)
    ap.add_argument("--nbins", type=int, default=201)
    ap.add_argument("--mu-min", type=float, default=-1800.0)
    ap.add_argument("--mu-max", type=float, default=1800.0)
    ap.add_argument(
        "--leshift-kt", type=float, default=0.0,
        help="beta*(ref_enthalpy2 - ref_enthalpy1) in kT, ADDED to "
             "every estimate - required for runs generated with "
             "leshift=.true. (mc_moves.F90:2479); default 0 matches "
             "the leshift=.false. n216 runs",
    )
    args = ap.parse_args(argv)

    grid = build_bin_grid(args.nbins, args.mu_min, args.mu_max)
    bw = grid.binwidth
    mids = grid.mu_bin

    files = sorted(
        glob.glob(os.path.join(args.run_dir, "eta_weights.dat_*")),
        key=lambda f: -float(f.rsplit("_", 1)[1]),
    )
    final = os.path.join(args.run_dir, "eta_weights.dat")
    if os.path.exists(final):
        files.append(final)

    kT_J = KB * args.temperature * HART_TO_KJPM * 1000.0
    kT_meV = KB * args.temperature * HART_TO_EV * 1000.0
    rows = []
    for f in files:
        wl_f, eta = read_eta_weights(f)
        if len(eta) != args.nbins:
            raise SystemExit(
                f"{f}: {len(eta)} bins, grid has {args.nbins}"
            )
        mu_file = np.loadtxt(f, skiprows=1)[:, 0]
        if not np.allclose(mu_file, mids, atol=1e-6 * abs(args.mu_max)):
            raise SystemExit(f"{f}: mid-bin mu values do not match "
                             "the rebuilt grid")
        dg = (deltag_from_eta(eta, bw) + args.leshift_kt) / args.nwater
        rows.append((os.path.basename(f), wl_f, dg))
        print(f"{os.path.basename(f):40s} f={wl_f:.3e}  "
              f"dG = {dg:+.6e} kT/molec = {dg * kT_J:+.4f} J/mol "
              f"= {dg * kT_meV:+.5f} meV/molec")

    tail = [r[2] for r in rows[-4:]]
    if len(tail) >= 2:
        mean, spread = np.mean(tail), np.std(tail)
        print(f"\ntail (last {len(tail)}): dG = {mean:+.6e} "
              f"+- {spread:.2e} kT/molec "
              f"= {mean * kT_J:+.4f} +- {spread * kT_J:.4f} J/mol")
    return 0


if __name__ == "__main__":
    sys.exit(main())
