"""Compare the dd-mode stitched WL curve against the mw-mode curve.

runs/n216_wl_dd (8 mu-windows, overlap-matched stitching -
comms_join_eta semantics, comms_mpi.f90:381-459) must reproduce
runs/n216_wl_r2 (mw mode, the round-2 production curve) up to WL
noise, and the weights-direct delta-G estimates (mc_moves.F90:2418-2496
estimator, tools/deltag_from_weights.py) of the two curves must agree.
The counterpart of the JAX package's ``scripts/compare_dd_mw.py``, with
its arguments and output; numpy only.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.compare_dd_mw \\
        [dd_dir] [mw_dir]   (defaults runs/n216_wl_dd runs/n216_wl_r2)

Prints one JSON line: per-curve deltaG (kT and J/mol), curve
deviation statistics (offset-free, per window), and the per-window f
levels of the dd run (windows still at larger f carry
proportionally larger WL noise - the comparison reports deviation
per dd window so unconverged windows are visible, not averaged
away).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..constants import HART_TO_KJPM, KB
from ..io.writers import read_eta_weights
from ..mcmc.bins import build_bin_grid
from .deltag_from_weights import deltag_from_eta


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.compare_dd_mw",
        description=__doc__.splitlines()[0])
    ap.add_argument("dd_dir", nargs="?", default="runs/n216_wl_dd")
    ap.add_argument("mw_dir", nargs="?", default="runs/n216_wl_r2")
    args = ap.parse_args(argv)
    dd_dir, mw_dir = args.dd_dir, args.mw_dir
    nbins, mu_min, mu_max = 201, -1800.0, 1800.0
    T = 200.0

    bw = build_bin_grid(nbins, mu_min, mu_max).binwidth

    f_dd, w_dd = read_eta_weights(os.path.join(dd_dir,
                                               "eta_weights.dat"))
    f_mw, w_mw = read_eta_weights(os.path.join(mw_dir,
                                               "eta_weights.dat"))
    w_dd = np.asarray(w_dd, dtype=np.float64)
    w_mw = np.asarray(w_mw, dtype=np.float64)

    dg_dd = deltag_from_eta(w_dd, bw)
    dg_mw = deltag_from_eta(w_mw, bw)
    kT_to_jpm = KB * T * HART_TO_KJPM * 1e3

    # offset-free curve deviation (weights are defined up to a
    # constant): global, and per dd window so unconverged windows
    # (larger per-window f) stay visible
    d = w_dd - w_mw
    d = d - d.mean()
    out = {
        "deltaG_dd_kT": dg_dd, "deltaG_mw_kT": dg_mw,
        "deltaG_dd_jpm": dg_dd * kT_to_jpm,
        "deltaG_mw_jpm": dg_mw * kT_to_jpm,
        "deltaG_diff_jpm": (dg_dd - dg_mw) * kT_to_jpm,
        "curve_rms_kT": float(np.sqrt(np.mean(d ** 2))),
        "curve_max_kT": float(np.abs(d).max()),
        "f_dd_final": f_dd, "f_mw_final": f_mw,
        "windows": [],
    }
    # per-window rows (window layout of the production run: 8 windows,
    # overlap 2 - state.assign_windows)
    nwin = 8
    bpw = nbins // nwin
    for w in range(nwin):
        s = 0 if w == 0 else w * bpw - 3
        e = nbins - 1 if w == nwin - 1 else (w + 1) * bpw + 1
        fw = None
        wf = os.path.join(dd_dir, f"eta_weights_{w:03d}.dat")
        if os.path.exists(wf):
            fw, _ = read_eta_weights(wf)
        dw = d[s:e + 1] - d[s:e + 1].mean()
        out["windows"].append({
            "w": w, "f": fw,
            "rms_kT": float(np.sqrt(np.mean(dw ** 2))),
            "max_kT": float(np.abs(dw).max()),
        })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
