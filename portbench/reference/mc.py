"""Plain lattice-switch bookkeeping: the order parameter, the mu bins and
the volume of a cell, written out again from the method (Quigley, JCP
141, 121101 (2014); Bruce, Wilding and Ackland, PRL 79, 3002 (1997) for
the switch) and the reference code's geometric bin grid.

Units: Hartree, Bohr, K.
"""

from __future__ import annotations

import numpy as np
import torch

HARTREE_PER_KELVIN = 1.0 / 3.1577465e5
EV_PER_HARTREE = 27.211396181


def beta(temperature_k: float) -> float:
    return 1.0 / (HARTREE_PER_KELVIN * temperature_k)


def volume(h):
    """|det h| of h [W, 3, 3], in the precision of h."""
    return torch.abs(
        h[:, 0, 0] * (h[:, 1, 1] * h[:, 2, 2] - h[:, 1, 2] * h[:, 2, 1])
        - h[:, 0, 1] * (h[:, 1, 0] * h[:, 2, 2] - h[:, 1, 2] * h[:, 2, 0])
        + h[:, 0, 2] * (h[:, 1, 0] * h[:, 2, 1] - h[:, 1, 1] * h[:, 2, 0]))


def order_parameter(e, v, n: int, temperature_k: float, p: float):
    """mu = beta (H_1 - H_2) - N ln(V_1 / V_2), H = E + P V, of the two
    lattices' energies e [2, W] and volumes v [2, W]; p in atomic
    units."""
    b = beta(temperature_k)
    return (b * (e[0] + p * v[0] - e[1] - p * v[1])
            - n * torch.log(v[0] / v[1]))


class BinEdges:
    """The geometric mu grid: a central bin [-1/2, 1/2] and, on each side,
    nbins // 2 bins whose widths grow by a common ratio from 1 so that
    they end at the grid's ends (nbins made odd)."""

    def __init__(self, nbins: int, mu_min: float, mu_max: float):
        if nbins % 2 == 0:
            nbins += 1
        ns = nbins // 2
        rp = _ratio(abs(mu_max) - 0.5, ns)
        rn = _ratio(abs(mu_min) - 0.5, ns)
        up = 0.5 + np.concatenate([[0.0], np.cumsum(rp ** np.arange(ns))])
        dn = -0.5 - np.concatenate([[0.0], np.cumsum(rn ** np.arange(ns))])
        self.edges = np.concatenate([dn[::-1], up])        # [nbins + 1]
        self.widths = np.diff(self.edges)
        self.nbins = nbins

    def index(self, mu: np.ndarray) -> np.ndarray:
        """Bin of each mu (-1 below the grid, nbins above)."""
        return np.searchsorted(self.edges, mu, side="right") - 1

    def edge_distance(self, mu: np.ndarray) -> np.ndarray:
        """Distance from each mu to the nearest bin edge."""
        k = np.clip(np.searchsorted(self.edges, mu), 1, self.nbins)
        return np.minimum(np.abs(mu - self.edges[k - 1]),
                          np.abs(self.edges[k] - mu))


def _ratio(span: float, n: int) -> float:
    """The common ratio r with sum_{k<n} r^k = span, by bisection."""
    lo, hi = 1.0 + 1e-15, 2.0
    while (hi ** n - 1.0) / (hi - 1.0) < span:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if (mid ** n - 1.0) / (mid - 1.0) < span:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
