"""Quantify the unfiltered near-collinear three-body deviation.

The reference's LOCAL energy path drops three-body terms with
cos(theta) >= 0.99 (molint.F90:367-371); its FULL-cell path does not
filter (molint.F90:407-499).  Both engines of the port sample the
unfiltered published SW Hamiltonian (the degenerate k==i direction is
removed analytically; ops/dense.py).  The deviation between the two
chains is therefore exactly the total weight of GENUINE near-collinear
triplets (j != k, both inside the cutoff, cos(theta_jik) >= 0.99):

    dE(config) = lam*eps * sum_{i, j<k in rc, cos >= 0.99}
                    (cos - cos0)^2 * w_j * w_k

This tool measures dE per lattice (a) on the ideal cells of the N=48
(1,2,6) and N=216 (3,3,6) stacking pairs, and (b) along a sampled
finite-temperature trajectory of the dense engine at the production
state point (200 K, 1 atm), and reports the induced mu perturbation
|d_mu| = beta * |dE_1 - dE_2| in kT - the quantity that bounds any
shift of the Delta-G estimate (mu is the integration variable of the
estimator, mc_moves.F90:2498-2621).  The counterpart of the JAX
package's ``scripts/threebody_filter.py``, with its JSON keys.

Geometry argument for why dE should vanish: cos >= 0.99 needs two
neighbours within 8.1 degrees of the same ray from i; with both inside
the mW cutoff a*sigma = 4.306 Angstrom this forces a j-k separation
well below 2 Angstrom - deep into the repulsive core, ~10 kT uphill at
200 K.  The tool turns that argument into a measured bound.

Usage:
    python -m mc_water_ls_mw_tpu_torch.tools.threebody_filter \\
        [cycles] [walkers] [--nwater 48 216] [--device cpu]

The engine runs on the card (kernels 1 and 2 of csrc/) unless
``--device cpu`` is given; the measurement itself is evaluated in
float64, in plain PyTorch on the engine's device (no TPU kernel is
behind it: the JAX script evaluates it in XLA).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..constants import ANG_TO_BOHR, AUP_TO_ATM, HART_TO_EV
from ..models.sw import MW
from ..ops.energy import three_body_terms
from ..ops.geometry import cell_shift_range, enumerate_shifts
from ..ops.neighbours import build_neighbour_list

K_CAP = 50   # reference maxneigh (molint.F90:79)

#: the stacking pairs measured, by molecule count
STACKS = {48: (1, 2, 6), 216: (3, 3, 6)}


def collinear_sum(r, H, prm=MW, cos_cut=0.99):
    """Total filtered-term weight of one configuration, in float64 on
    the device of ``r`` (the CPU for arrays).

    r: [N, 3] positions (Bohr); H: [3, 3] cell matrix (arrays or
    tensors).  Returns (dE, n_triplets): the energy the reference's
    local path would drop, and how many triplets triggered the filter.
    """
    r = torch.as_tensor(r).to(torch.float64)
    H = torch.as_tensor(H, device=r.device).to(torch.float64)
    shifts = enumerate_shifts(cell_shift_range(H.cpu().numpy(), prm.rskin))
    nbr = build_neighbour_list(r, H, shifts, K_CAP, prm.rskin)
    terms, cosq, pairs = three_body_terms(r, H, nbr, prm)
    near = pairs & (cosq >= cos_cut)
    dE = prm.lam * prm.epsilon * torch.sum(torch.where(near, terms, 0.0))
    return float(dE), int(near.sum())


def measure_state(state, beta):
    """Per-walker filtered-term stats of a sampled ensemble state, on
    the state's device."""
    r = state.r.double()                     # [L,3,N,W]
    h = state.h.double()                     # [L,3,3,W]
    L, _, N, W = r.shape
    d_mu = []
    dEs = []
    n_tr = 0
    for w in range(W):
        dE_l = []
        for l in range(L):
            dE, n = collinear_sum(r[l, :, :, w].T, h[l, :, :, w])
            dE_l.append(dE)
            n_tr += n
        dEs.append(dE_l)
        d_mu.append(beta * abs(dE_l[0] - dE_l[1]))
    return np.asarray(dEs), np.asarray(d_mu), n_tr


def setup(nwater, walkers, device):
    """(prm, engine, state): the dense engine on the stacking pair of
    ``nwater`` molecules with the JAX package's benchmark set-up
    (__graft_entry__._setup: 21 bins over mu in [-400, 400], a sample
    run, 200 K, 1 atm, 1.1 A steps, no switch moves), delta-syncs every
    10 cycles, in float64."""
    from ..mcmc.bins import build_bin_grid
    from ..mcmc.config import RunParams
    from ..mcmc.engine import Engine
    from ..mcmc.state import init_state
    from ..models.stacking import stacking_switch_pair

    stack = STACKS[nwater]
    prm = RunParams(
        nwater=nwater, num_lattices=2, temperature=200.0,
        pressure=1.0 / AUP_TO_ATM,
        mc_max_trans=1.1 * ANG_TO_BOHR, mc_dv_max=0.924 * ANG_TO_BOHR,
        nbins=21, mu_min=-400.0, mu_max=400.0,
        mc_vol_prob=1.0 / 768, mc_switch_prob=0.0,
        samplerun=True, eq_mc_cycles=1, list_update_int=10,
        mpi_sync_int=10, n_walkers=walkers, dtype="float64",
        parallel_strategy="mw", window_overlap=1, stack=stack,
        method="stack",
    )
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    r0, H0 = stacking_switch_pair(*stack)
    state, aux = init_state(prm, MW, r0, H0, grid, device=device)
    return prm, Engine(prm, MW, grid, aux, device=device), state


def measure(cycles=40, walkers=16, nwaters=(48, 216), device="cuda"):
    """The tool's JSON record, the launches of the engines' kernels
    (fused cycle, whole-cell energy; 0 on the CPU), and {nwater: (engine,
    final state)}, from which a caller can hold the kernels against
    their plain versions at the shapes they ran."""
    out = {"cos_cut": 0.99, "cycles": cycles, "walkers": walkers}
    launches = {"fused_cycle": 0, "full_energy": 0}
    ends = {}
    for nwater in nwaters:
        prm, eng, state = setup(nwater, walkers, device)
        # ideal cells first (the stacking pair)
        dE0, dmu0, ntr0 = measure_state(state, prm.beta)

        # finite-temperature trajectory: sample every other cycle
        max_dmu, max_dE, n_tr, n_cfg = 0.0, 0.0, 0, 0
        for _ in range(cycles // 2):
            state, _ = eng.run_cycles(state, 2)
            dE, dmu, ntr = measure_state(state, prm.beta)
            max_dmu = max(max_dmu, float(dmu.max()))
            max_dE = max(max_dE, float(np.abs(dE).max()))
            n_tr += ntr
            n_cfg += walkers * 2
        if not bool(torch.isfinite(state.energy).all()):
            raise RuntimeError(f"N={nwater}: non-finite energies")
        launches["fused_cycle"] += eng.fused_cycle.launches
        launches["full_energy"] += eng.full_energy.launches
        ends[nwater] = (eng, state)
        out[f"n{nwater}"] = {
            "ideal_dE_hartree": float(np.abs(dE0).max()),
            "ideal_triplets": ntr0,
            "traj_configs": n_cfg,
            "traj_triplets": n_tr,
            "traj_max_dE_eV": max_dE * HART_TO_EV,
            "traj_max_dmu_kT": max_dmu,
        }
    return out, launches, ends


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mc_water_ls_mw_tpu_torch.tools.threebody_filter",
        description=__doc__.splitlines()[0])
    ap.add_argument("cycles", type=int, nargs="?", default=40)
    ap.add_argument("walkers", type=int, nargs="?", default=16)
    ap.add_argument("--nwater", type=int, nargs="+", choices=sorted(STACKS),
                    default=sorted(STACKS))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run the engine on the card (default) or the CPU")
    args = ap.parse_args(argv)
    out, _, _ = measure(args.cycles, args.walkers, tuple(args.nwater),
                     args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
