"""The port's neighbour-list Hamiltonian (ops/neighbours.py, ops/energy.py)
and tools/threebody_filter.py against the JAX package's, on the CPU in
float64.

Inputs: both lattices of the N=216 (3,3,6) and N=48 (1,2,6) stacking
pairs, built by each package's models/stacking.py, with numpy-seeded
displacements; and an N=216 cell with a near-collinear triplet (a
molecule moved onto the bond between two neighbours), where the local
path's cos >= 0.99 filter fires.

* ``build_neighbour_list``: the same count, mask and (idx, shift)
  entries, in the same order, per molecule; at a capacity below the
  counts (overflow) the same first entries; the walker-chunked build
  likewise, and the same refusal of a walker count the chunk does not
  divide;
* ``full_energy``, ``local_energy`` and ``translation_energies`` within
  1e-12 relative;
* ``collinear_sum`` equal to the JAX script's, and on the collinear
  cell exactly the weight the local path misses: a small move's change
  of the full energy less that of the local one.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu.models.stacking import stacking_switch_pair as jpair
from mc_water_ls_mw_tpu.models.sw import MW as JMW
from mc_water_ls_mw_tpu.ops import energy as jenergy
from mc_water_ls_mw_tpu.ops import neighbours as jnbr
from mc_water_ls_mw_tpu.ops.geometry import (
    cell_shift_range as jrange,
    enumerate_shifts as jshifts,
)

from mc_water_ls_mw_tpu_torch.models.stacking import (
    stacking_switch_pair as tpair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.ops import energy as tenergy
from mc_water_ls_mw_tpu_torch.ops import neighbours as tnbr
from mc_water_ls_mw_tpu_torch.ops.geometry import (
    cell_shift_range,
    enumerate_shifts,
)
from mc_water_ls_mw_tpu_torch.tools import threebody_filter as tfilter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 50          # the reference's maxneigh (molint.F90:79)
STACKS = {216: (3, 3, 6), 48: (1, 2, 6)}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cells(n, seed=0, sigma=0.15):
    """Both lattices of the stacking pair of ``n`` molecules, each
    package's own build (equal), displaced by numpy-seeded noise."""
    r0, H0 = tpair(*STACKS[n])
    jr0, jH0 = jpair(*STACKS[n])
    np.testing.assert_array_equal(r0, jr0)
    np.testing.assert_array_equal(H0, jH0)
    r = r0 + np.random.default_rng(seed).normal(0.0, sigma, r0.shape)
    return r, H0


def _collinear_cell():
    """Lattice 0 of the N=216 pair with a third molecule moved onto the
    bond between molecule 0 and its nearest neighbour, 0.05 Bohr off
    the axis: cos(theta) at molecule 0 is ~1.  (In the N=48 box a
    molecule sees two images of another, and the local path counts the
    change of such a triplet twice (ROADMAP.md queue 3): no place to
    compare local and full changes.)"""
    r, H = _cells(216, sigma=0.0)
    r, H = r[0].copy(), H[0]
    d = np.linalg.norm(r[1:] - r[0], axis=1)
    j = 1 + int(np.argmin(d))
    k = 1 + int(np.argmax(d))
    bond = r[j] - r[0]
    perp = np.cross(bond, [0.0, 0.0, 1.0])
    r[k] = r[0] + 0.45 * bond + 0.05 * perp / np.linalg.norm(perp)
    return r, H, (0, j, k)


def _both_lists(r, H, capacity=K):
    shifts = enumerate_shifts(cell_shift_range(H, MW.rskin))
    np.testing.assert_array_equal(shifts, jshifts(jrange(H, JMW.rskin)))
    t = tnbr.build_neighbour_list(torch.as_tensor(r), torch.as_tensor(H),
                                  shifts, capacity, MW.rskin)
    j = jnbr.build_neighbour_list(jnp.asarray(r), jnp.asarray(H),
                                  jnp.asarray(shifts), capacity, JMW.rskin)
    return t, j


def _assert_same_list(t, j):
    for name in ("idx", "shift", "mask", "count"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("n", [216, 48])
def test_neighbour_list_matches_jax(n):
    r, H = _cells(n)
    for l in range(2):
        t, j = _both_lists(r[l], H[l])
        _assert_same_list(t, j)
        # each molecule's (partner, image) set, in the reference's order
        assert int(t.mask.sum(dim=1).min()) >= 16
        assert int(t.count.max()) <= K
    # a capacity below the counts: the overflow keeps the first entries
    t, j = _both_lists(r[0], H[0], capacity=12)
    assert int(t.count.min()) > 12
    _assert_same_list(t, j)


def test_chunked_neighbour_list_matches_jax():
    r, H = _cells(48, seed=3)
    rng = np.random.default_rng(4)
    rw = r[None] + rng.normal(0.0, 0.1, (4,) + r.shape)       # [W,L,N,3]
    Hw = np.broadcast_to(H, (4,) + H.shape).copy()
    shifts = enumerate_shifts(cell_shift_range(H[0], MW.rskin))
    t = tnbr.build_neighbour_list_chunked(
        torch.as_tensor(rw), torch.as_tensor(Hw), shifts, K, MW.rskin,
        chunk=2)
    j = jnbr.build_neighbour_list_chunked(
        jnp.asarray(rw), jnp.asarray(Hw), jnp.asarray(shifts), K,
        JMW.rskin, chunk=2)
    assert tuple(t.idx.shape) == (4, 2, 48, K)
    _assert_same_list(t, j)
    with pytest.raises(ValueError, match="not divisible"):
        tnbr.build_neighbour_list_chunked(
            torch.as_tensor(rw[:3]), torch.as_tensor(Hw[:3]), shifts, K,
            MW.rskin, chunk=2)


@pytest.mark.parametrize("case", ["n216", "n48", "collinear"])
def test_energies_match_jax(case):
    if case == "collinear":
        r, H, (i, _, _) = _collinear_cell()
        cells, movers = [(r, H)], [i, 5, 200]
    else:
        r, H = _cells(int(case[1:]), seed=1)
        cells, movers = [(r[0], H[0]), (r[1], H[1])], [0, 7, 47]
    rng = np.random.default_rng(2)
    for r, H in cells:
        t, j = _both_lists(r, H)
        tr, tH = torch.as_tensor(r), torch.as_tensor(H)
        jr, jH = jnp.asarray(r), jnp.asarray(H)
        e_t = tenergy.full_energy(tr, tH, t, MW)
        e_j = jenergy.full_energy(jr, jH, j, JMW)
        assert _rel(e_t, e_j) < 1e-12
        for i in movers:
            p = r[i] + rng.normal(0.0, 0.4, 3)
            assert _rel(tenergy.local_energy(tr, tH, t, i, torch.as_tensor(p),
                                             MW),
                        jenergy.local_energy(jr, jH, j, i, jnp.asarray(p),
                                             JMW)) < 1e-12
            for a, b in zip(
                    tenergy.translation_energies(tr, tH, t, i,
                                                 torch.as_tensor(p), MW),
                    jenergy.translation_energies(jr, jH, j, i,
                                                 jnp.asarray(p), JMW)):
                assert _rel(a, b) < 1e-12


def test_collinear_filter_fires_and_matches_jax():
    r, H, (i, _, _) = _collinear_cell()
    t, _ = _both_lists(r, H)
    tr, tH = torch.as_tensor(r), torch.as_tensor(H)
    dE, n = tfilter.collinear_sum(r, H)
    assert n >= 1 and dE > 0
    jdE, jn = _jax_script("threebody_filter").collinear_sum(r, H)
    assert n == jn and _rel(dE, jdE) < 1e-12
    # a small move of i: the local path (filtered) misses exactly the
    # change of the dropped weight that the full path (unfiltered) sees
    p = r[i] + np.array([0.02, -0.01, 0.015])
    r_new = r.copy()
    r_new[i] = p
    dE_new, n_new = tfilter.collinear_sum(r_new, H)
    assert n_new == n
    e_old, e_new = tenergy.translation_energies(tr, tH, t, i,
                                                torch.as_tensor(p), MW)
    d_full = float(tenergy.full_energy(torch.as_tensor(r_new), tH, t, MW)
                   - tenergy.full_energy(tr, tH, t, MW))
    d_local = float(e_new - e_old)
    assert abs(d_full - d_local) > 1e-6
    assert d_full - d_local == pytest.approx(dE_new - dE, abs=1e-10)


@pytest.mark.parametrize("n", [216, 48])
def test_collinear_sum_matches_jax_on_stacking_cells(n):
    r, H = _cells(n, seed=5, sigma=0.3)
    script = _jax_script("threebody_filter")
    for l in range(2):
        assert tfilter.collinear_sum(r[l], H[l]) == \
            script.collinear_sum(r[l], H[l])
