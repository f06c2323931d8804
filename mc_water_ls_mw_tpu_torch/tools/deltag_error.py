"""deltaG with a block-jackknife error bar from sample-run dumps.

The sample phase (samplerun=.true.) dumps a cumulative unbiased
histogram every ``deltaG_int`` cycles as
``unbiased_histogram_<cycle>.dat`` with a third RAW (unnormalised)
column (mcmc/wanglandau.compute_deltaG).  Consecutive dumps are far
apart in Markov time, so their DIFFERENCES are near-independent
blocks; delete-one-block jackknife over the deltaG estimator

    deltaG = ln( sum_{k < B//2} P_k dmu_k / sum_{k >= B//2} P_k dmu_k )

(the app's own estimator split: the centre bin counts toward the
mu>0 side) gives the error bar the single pooled estimate lacks
(reference counterpart: mc_compute_deltaG_from_hist,
mc_moves.F90:2498-2621, which reports no error).

dd mode (--dd --overlap K): uses the per-window cumulative raw dumps
``uhist_windows_<cycle>.dat`` (written by compute_deltaG in dd runs)
instead - consecutive STITCHED dumps cannot be differenced because
join_uhist's per-window matching constants change between dumps, so
each delete-one-block total is re-stitched from per-window block sums
(comms_join_uhist semantics, comms_mpi.f90:299-379).

dd large weight spans (--dd-counts): the per-window COUNT dumps
``hist_windows_<cycle>.dat`` recombined with the frozen eta offline in
float64 log-space.

The counterpart of the JAX package's ``scripts/deltag_error.py``, with
its flags, estimator and output; numpy only.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.deltag_error <run_dir> \\
        --nwater 216 --mu-min -1800 --mu-max 1800 [--skip-blocks 1] \\
        [--dd --overlap 2]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

from ..mcmc.bins import build_bin_grid


def _dumps(run_dir, pattern):
    """(cycle, table) of every ``pattern`` dump in cycle-name order."""
    out = []
    for f in sorted(glob.glob(os.path.join(run_dir, pattern))):
        m = re.search(r"_(\d+)\.dat$", f)
        if m:
            out.append((int(m.group(1)), np.loadtxt(f)))
    return out


def load_dumps(run_dir):
    """unbiased_histogram_<cycle>.dat: (cycle, mu [B], raw [B])."""
    return [(c, a[:, 0], a[:, 2])
            for c, a in _dumps(run_dir, "unbiased_histogram_*.dat")
            # a legacy 2-column dump has no raw column
            if a.ndim == 2 and a.shape[1] >= 3]


def load_window_dumps(run_dir):
    """uhist_windows_<cycle>.dat: (cycle, mu [B], raw [nwin, B])."""
    return [(c, a[:, 0], a[:, 1:].T)
            for c, a in _dumps(run_dir, "uhist_windows_*.dat")
            if a.ndim == 2 and a.shape[1] >= 3]


def load_count_dumps(run_dir):
    """hist_windows_<cycle>.dat: mu, nwin count columns, nwin frozen
    eta columns (the large-span estimator input).  Returns (cycle,
    mu [B], counts [nwin, B], eta [nwin, B])."""
    out = []
    for c, a in _dumps(run_dir, "hist_windows_*.dat"):
        if a.ndim != 2 or (a.shape[1] - 1) % 2 != 0:
            continue
        nwin = (a.shape[1] - 1) // 2
        out.append((c, a[:, 0], a[:, 1:1 + nwin].T,
                    a[:, 1 + nwin:1 + 2 * nwin].T))
    return out


def deltag(raw, bw, split):
    w = raw * bw
    lo = w[:split].sum()
    hi = w[split:].sum()
    if lo <= 0 or hi <= 0:
        return np.nan
    return np.log(lo / hi)


def deltag_counts(counts, eta, bw, split, bounds=None):
    """log-space offline recombination for spans beyond f32 range:
    P_w(bin) ∝ counts_w(bin)·exp(+eta_w(bin)) — the engine's
    convention has converged eta = +ln P = −G/kT (the biased chain
    samples ∝ P·e^(−eta), flat at convergence; the in-flight uhist
    unbias multiplies exp(+eta−norm)).  Windows stitched by median
    log-offset over shared valid bins; ΔG from logsumexp of the two
    halves.  All f64 — a 10⁴-kT weight span is ~e^10000, far past ANY
    floating-point range if exponentiated in-flight, but trivial as
    log-arithmetic here.  Returns (ΔG, per-boundary offset spreads)."""
    nwin, B = counts.shape
    valid = (eta < 1e29) & (counts > 0)
    if bounds is not None:
        # restrict each window to its NOMINAL bin range: the stored
        # eta rows do not carry the wall sentinels (walls are applied
        # at eval time), and a pathological walker's out-of-window
        # visits must not contaminate the stitch
        bin_ids = np.arange(B)
        for w, (s, e) in enumerate(bounds):
            valid[w] &= (bin_ids >= s) & (bin_ids <= e)
    with np.errstate(divide="ignore", invalid="ignore"):
        logP = np.where(
            valid,
            np.log(np.maximum(counts, 1e-300)) + eta
            + np.log(bw)[None, :],
            -np.inf,
        )
    off = np.zeros(nwin)
    resid = []
    for w in range(1, nwin):
        both = valid[w - 1] & valid[w]
        if not both.any():
            return np.nan, resid        # stitch chain broken
        d = (logP[w - 1] + off[w - 1]) - logP[w]
        off[w] = np.median(d[both])
        resid.append(float(np.std(d[both])))
    vals = np.where(valid, logP + off[:, None], np.nan)
    with np.errstate(invalid="ignore"):
        lp = np.nanmean(vals, axis=0)               # [B]
    lo = lp[:split]
    hi = lp[split:]
    lo = lo[np.isfinite(lo)]
    hi = hi[np.isfinite(hi)]
    if len(lo) == 0 or len(hi) == 0:
        return np.nan, resid
    lse = np.logaddexp.reduce
    return float(lse(lo) - lse(hi)), resid


def block_differences(dumps, skip_blocks):
    """Consecutive differences of cumulative dumps (cycle, _, data) =
    the per-interval raw histograms, as (cycle, block) after dropping
    the first ``skip_blocks`` (burn-in)."""
    blocks = []
    for (_, _, r0), (c1, _, r1) in zip(dumps[:-1], dumps[1:]):
        d = r1 - r0
        d[d < 0] = 0.0      # guard (restart overlap should not occur)
        blocks.append((c1, d))
    return blocks[skip_blocks:]


def jackknife(blocks, estimate):
    """Delete-one-block jackknife of ``estimate`` (a scalar or an array
    per total) over the blocks' total.  Returns (estimate of the total,
    standard error, blocks used, blocks): deleted totals whose estimate
    is not finite are left out."""
    total = np.sum([b for _, b in blocks], axis=0)
    est = estimate(total)
    n = len(blocks)
    jack = np.array([estimate(total - blocks[i][1]) for i in range(n)])
    jack = jack[np.isfinite(jack).reshape(n, -1).all(axis=1)]
    n_eff = len(jack)
    if n_eff < 2:
        return est, np.nan, n_eff, n
    se = np.sqrt((n_eff - 1) / n_eff
                 * ((jack - jack.mean(axis=0)) ** 2).sum(axis=0))
    return est, se, n_eff, n


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.deltag_error",
        description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--nwater", type=int, default=216)
    ap.add_argument("--mu-min", type=float, default=-1800.0)
    ap.add_argument("--mu-max", type=float, default=1800.0)
    ap.add_argument("--skip-blocks", type=int, default=1,
                    help="leading blocks dropped as burn-in")
    ap.add_argument("--dd", action="store_true",
                    help="dd run: jackknife over per-window raw "
                         "dumps with per-block re-stitching")
    ap.add_argument("--dd-counts", action="store_true",
                    help="dd run, large weight spans: jackknife "
                         "over per-window COUNT dumps recombined "
                         "with the frozen eta offline in f64 "
                         "log-space (hist_windows_*.dat)")
    ap.add_argument("--overlap", type=int, default=2,
                    help="dd window_overlap used by the run")
    ap.add_argument("--no-window-bounds", action="store_true",
                    help="dd-counts: do not restrict windows to "
                         "their nominal bin ranges (use when stray "
                         "walkers carry the only usable counts)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    eta_frozen = None
    if args.dd_counts:
        dumps = load_count_dumps(args.run_dir)
        if dumps:
            # frozen eta identical across dumps; keep the last and
            # reduce the tuples to the (cycle, mu, data) shape the
            # block machinery expects
            eta_frozen = dumps[-1][3]
            dumps = [(c, mu_, cnt) for c, mu_, cnt, _ in dumps]
    elif args.dd:
        dumps = load_window_dumps(args.run_dir)
    else:
        dumps = load_dumps(args.run_dir)
    if len(dumps) < 3:
        sys.exit("need >= 3 dumps for a jackknife")
    mu = dumps[0][1]
    B = len(mu)

    # exact grid binwidths: rebuild the run's GP grid (float64) and
    # check the dumped mu column matches its bin centres
    grid = build_bin_grid(B, args.mu_min, args.mu_max)
    if not np.allclose(mu, grid.mu_bin, rtol=1e-4, atol=1e-3):
        sys.exit("dumped mu column does not match the grid for "
                 f"(nbins={B}, mu_min={args.mu_min}, "
                 f"mu_max={args.mu_max}) - pass the run's values")
    bw = grid.binwidth
    split = B // 2

    # per-interval raw histograms (in dd mode per WINDOW: [nwin, B]
    # blocks, stitched per jackknife total)
    blocks = block_differences(dumps, args.skip_blocks)
    if len(blocks) < 2:
        sys.exit("not enough blocks after burn-in skip")

    resid_report = []
    if args.dd_counts:
        from ..mcmc.config import RunParams
        from ..mcmc.state import assign_windows

        nwin = eta_frozen.shape[0]
        prm_w = RunParams(nbins=B, mu_min=args.mu_min,
                          mu_max=args.mu_max,
                          window_overlap=args.overlap,
                          num_lattices=2)
        bounds = None if args.no_window_bounds else [
            (s, e) for s, e, _, _ in
            assign_windows(prm_w, grid, nwin)]

        def estimate(win_total):
            dg, resid = deltag_counts(win_total, eta_frozen, bw,
                                      split, bounds=bounds)
            if resid and not resid_report:
                resid_report.extend(resid)
            return dg
    elif args.dd:
        from ..parallel.windows import join_uhist

        def estimate(win_total):
            joined = np.asarray(
                join_uhist(win_total, B, args.overlap)
            )
            return deltag(joined, bw, split)
    else:
        def estimate(raw_total):
            return deltag(raw_total, bw, split)

    dg_all, se, n_eff, n = jackknife(blocks, estimate)
    if n_eff < 2 or not np.isfinite(dg_all):
        sys.exit("estimator undefined (one histogram half is empty)")

    per_mol = dg_all / args.nwater
    se_mol = se / args.nwater
    if resid_report:
        worst = max(resid_report)
        print("stitch-boundary log-offset spreads (kT): "
              + " ".join(f"{r:.2f}" for r in resid_report))
        print(f"  (worst {worst:.2f} kT — spreads >> the error bar "
              "flag a contaminated bridge window)")
    print(f"blocks used: {n_eff} (of {n}; {args.skip_blocks} skipped)")
    print(f"deltaG(A=mu<0 half vs B) = {dg_all:+.6f} +- {se:.6f} kT")
    print(f"                        = {per_mol:+.8f} +- {se_mol:.8f} "
          f"kT/molecule  (N={args.nwater})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
