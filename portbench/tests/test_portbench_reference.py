"""The plain reference against known values, and the roofline's count."""

import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid, mu_to_bin  # noqa: E402
from mc_water_ls_mw_tpu_torch.models.stacking import stacking_switch_pair  # noqa: E402
from mc_water_ls_mw_tpu_torch.models.sw import MW as PORT_MW  # noqa: E402
from mc_water_ls_mw_tpu_torch.ops.dense import full_energy_batch  # noqa: E402
from mc_water_ls_mw_tpu_torch.ops.geometry import (  # noqa: E402
    cell_shift_range,
    enumerate_shifts,
)
from portbench import work  # noqa: E402
from portbench.reference.mc import EV_PER_HARTREE, BinEdges  # noqa: E402
from portbench.reference.sw import MW, sw_terms  # noqa: E402


def _pair(stack):
    r, h = stacking_switch_pair(*stack)
    return torch.tensor(r), torch.tensor(h)


def test_perfect_lattices_n216():
    """The N=216 pair's perfect lattices: the port's float64 energy, and
    the float32 line the port printed on the card for
    runs/n216_sample_torch (node000.log's 'Computed energies')."""
    r, h = _pair((3, 3, 6))
    e = sw_terms(r, h).energy * EV_PER_HARTREE
    shifts = enumerate_shifts(cell_shift_range(h[0].numpy(), PORT_MW.rc))
    port, _ = full_energy_batch(r[0].T[:, :, None], h[0][:, :, None],
                                shifts, PORT_MW, False)
    assert abs(float(e[0]) - float(port) * EV_PER_HARTREE) < 1e-9
    assert abs(float(e[0] - e[1])) < 1e-9
    log = open(os.path.join(ROOT, "runs", "n216_sample_torch",
                            "node000.log")).read()
    line = re.search(r"# Computed energies\s+=\s+(\S+)\s+(\S+)", log)
    f32 = [float(line.group(1)), float(line.group(2))]
    assert f32 == [-115.940419, -115.940406]
    assert np.allclose(e.numpy(), f32, rtol=0, atol=5e-5)


def test_model_matches_port_parameters():
    for k in ("sigma", "epsilon", "lam", "gamma", "a", "cos0"):
        assert getattr(MW, k) == pytest.approx(getattr(PORT_MW, k),
                                               rel=1e-15)
    assert MW.A == PORT_MW.bigA and MW.B == PORT_MW.bigB


@pytest.mark.parametrize("grid", [(101, -700.0, 700.0),
                                  (201, -90000.0, 90000.0)])
def test_bins_match_port(grid):
    edges = BinEdges(*grid)
    port = build_bin_grid(*grid)
    assert np.allclose(edges.widths, port.binwidth, rtol=1e-12)
    mu = np.random.default_rng(0).uniform(grid[1], grid[2], 20000)
    far = edges.edge_distance(mu) > 1e-6
    assert (edges.index(mu) == mu_to_bin(port, torch.tensor(mu)).numpy()
            )[far].all()


def test_narrow_cell_refused():
    r, h = _pair((1, 2, 6))
    with pytest.raises(ValueError):
        sw_terms(r, h)


def test_counts_of_the_ice_network():
    """Four bonds a molecule in ice, no other neighbour in range."""
    r, h = _pair((3, 3, 6))
    t = sw_terms(r, h)
    assert t.pairs.tolist() == [432, 432]
    assert t.triplets.tolist() == [216 * 6, 216 * 6]


def test_roofline_count_whichever_branch():
    """The operation count depends on the positions alone: the same for
    the same state whether the port runs its neighbour-table branch or
    not."""
    from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid as bbg
    from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
    from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
    from mc_water_ls_mw_tpu_torch.models.sw import MW as M

    r0, h0 = stacking_switch_pair(3, 3, 6)
    counts = []
    for table in ("on", "off"):
        prm = RunParams(nwater=216, n_walkers=2, nbr_table=table,
                        dtype="float64")
        s, aux = init_state(prm, M, r0, h0, bbg(21, -400.0, 400.0),
                            device="cpu")
        assert (aux.nbr_tbl is None) == (table == "off")
        t = [sw_terms(s.r[l].permute(2, 1, 0), s.h[l].permute(2, 0, 1))
             for l in range(2)]
        pairs = torch.stack([x.pairs for x in t])
        trip = torch.stack([x.triplets for x in t])
        counts.append(work.window_ops(pairs, trip, 216,
                                      torch.tensor([216, 216]),
                                      torch.tensor([1, 0])))
    assert counts[0] == counts[1] > 0


def test_control_precision_is_far():
    """bfloat16 in the reference's place misses the float64 energy by
    orders of magnitude more than float32 does."""
    r, h = _pair((3, 3, 6))
    e64 = sw_terms(r, h).energy
    e32 = sw_terms(r.float(), h.float(), dtype=torch.float32).energy
    e16 = sw_terms(r, h, dtype=torch.bfloat16).energy
    gap32 = float((e32 - e64).abs().max())
    assert float((e16 - e64).abs().max()) > 100 * gap32
