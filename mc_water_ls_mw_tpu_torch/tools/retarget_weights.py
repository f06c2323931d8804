"""Re-target converged eta weights onto a different mu-bin grid.

The WL generation ran on a wide grid (mu +-1800: nothing was known
about the weight landscape a priori); the converged weights show the
probability mass confined to |mu| < ~600 (beyond: < 1e-6 relative).
The sample phase's round-trip time scales with (grid range)^2, so a
trimmed grid samples ~6x faster at < 1e-6 estimator bias - the
weights only steer sampling; the unbiased histogram reweights
exactly (mc_update_wl_bins samplerun branch, mc_moves.F90:1625-32).

Evaluates the source curve's piecewise-linear eta (the engine's own
eta_interp convention) at the target grid's bin centres.  The
counterpart of the JAX package's ``scripts/retarget_weights.py``, with
its flags and output file; numpy only.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.retarget_weights SRC DST \\
        --src-range -1800 1800 --dst-range -700 700 --dst-bins 101
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.writers import read_eta_weights, write_curve
from ..mcmc.bins import build_bin_grid


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.retarget_weights",
        description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--src-range", nargs=2, type=float,
                    default=(-1800.0, 1800.0))
    ap.add_argument("--dst-range", nargs=2, type=float,
                    default=(-700.0, 700.0))
    ap.add_argument("--dst-bins", type=int, default=101)
    args = ap.parse_args(argv)

    f, w = read_eta_weights(args.src)
    w = np.asarray(w, np.float64)
    mu_s = build_bin_grid(len(w), *args.src_range).mu_bin
    mu_d = build_bin_grid(args.dst_bins, *args.dst_range).mu_bin
    if mu_d[0] < mu_s[0] or mu_d[-1] > mu_s[-1]:
        sys.exit("target grid exceeds the source grid's support")
    w_d = np.interp(mu_d, mu_s, w)
    w_d -= w_d.min()
    write_curve(args.dst, mu_d, w_d, f)
    print(f"wrote {args.dst}: {args.dst_bins} bins over "
          f"{args.dst_range}, span {w_d.max():.3f} kT, f={f:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
