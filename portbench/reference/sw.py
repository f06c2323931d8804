"""Plain Stillinger-Weber (mW water) energies under the minimum image.

The benchmark's own yardstick: it imports nothing of the program.  It
recomputes, from positions and cell matrices alone, what the program
tracks incrementally: the two- and three-body energy of every walker's
configuration, and, from the same neighbour search, the count of pair
and triplet terms in range that the roofline share is computed from.

Conventions (the same physics, written out again): lengths in Bohr,
energies in Hartree; ``h[:, i]`` is cell vector i, cartesian = h @ frac.
The minimum image by rounding fractional coordinates finds every pair
in range exactly while the cutoff is below half of each perpendicular
width of the cell; a cell narrower than that is refused.

mW parameters: Molinero and Moore, J. Phys. Chem. B 113, 4008 (2009),
in the units above (1 Angstrom = 1/0.5291772108 Bohr, 1 Hartree =
627.509469 kcal/mol), with cos(theta_0) as the reference code stores it.
"""

from __future__ import annotations

import dataclasses

import torch

BOHR_PER_ANG = 1.0 / 0.5291772108
KCALMOL_PER_HARTREE = 627.509469


@dataclasses.dataclass(frozen=True)
class SW:
    sigma: float = 2.3925 * BOHR_PER_ANG
    epsilon: float = 6.189 / KCALMOL_PER_HARTREE
    lam: float = 23.15
    A: float = 7.049556277
    B: float = 0.6022245584
    gamma: float = 1.2
    a: float = 1.8
    cos0: float = -0.33331324756

    @property
    def rc(self) -> float:
        return self.a * self.sigma


MW = SW()

# elements of one [walkers, rows, N, 3] displacement block
_BLOCK = 1 << 24


@dataclasses.dataclass
class Terms:
    """Per-walker results of one lattice: energy [W], unordered pairs in
    range [W] and triplets (j, i, k), i the centre, [W]."""

    energy: torch.Tensor
    pairs: torch.Tensor
    triplets: torch.Tensor


def perpendicular_widths(h):
    """h [W, 3, 3] -> [W, 3]: the cell's width across each pair of faces."""
    vol = torch.abs(torch.linalg.det(h.double()))
    out = []
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        out.append(vol / torch.linalg.norm(
            torch.cross(h[:, :, b].double(), h[:, :, c].double(), dim=-1),
            dim=-1))
    return torch.stack(out, dim=-1)


def _pairs_block(s, h, i0, i1, rc2, dtype):
    """Pairs (w, i, j) with i in [i0, i1), j != i, |r_j - r_i| < rc.
    s [W, N, 3] fractional, h [W, 3, 3].  Returns (w, i, j, d [P, 3])."""
    ds = s[:, None, :, :] - s[:, i0:i1, None, :]          # [W, R, N, 3]
    ds = ds - torch.round(ds)
    d = (h[:, None, None, :, 0] * ds[..., 0:1] + h[:, None, None, :, 1]
         * ds[..., 1:2] + h[:, None, None, :, 2] * ds[..., 2:3])
    d2 = (d * d).sum(-1)
    inr = d2 < rc2
    ar = torch.arange(i0, i1, device=s.device)
    inr[:, ar - i0, ar] = False
    w, r, j = inr.nonzero(as_tuple=True)
    return w, r + i0, j, d[w, r, j].to(dtype)


def sw_terms(r, h, model: SW = MW, dtype=torch.float64) -> Terms:
    """Energy and term counts of W configurations.

    r [W, N, 3] cartesian positions, h [W, 3, 3]; everything is computed
    in ``dtype`` (float64 for the reference, a lower precision for the
    control)."""
    W, N, _ = r.shape
    rc = model.rc
    widths = perpendicular_widths(h)
    if bool((widths.min() <= 2.0 * rc)):
        raise ValueError("cell narrower than twice the cutoff: the minimum "
                         "image would miss pairs")
    # fractional coordinates solved in float64 and then held in dtype
    # (the solver has no lower precision)
    s = torch.linalg.solve(h.double(), r.double().transpose(1, 2)
                           ).transpose(1, 2).to(dtype)
    h = h.to(dtype)
    energy = torch.zeros(W, dtype=torch.float64, device=r.device)
    pairs = torch.zeros(W, dtype=torch.int64, device=r.device)
    triplets = torch.zeros(W, dtype=torch.int64, device=r.device)
    wc = max(1, min(W, _BLOCK // (N * N * 3)))
    rows = max(1, min(N, _BLOCK // (wc * N * 3)))
    for w0 in range(0, W, wc):
        w1 = min(W, w0 + wc)
        parts = [_pairs_block(s[w0:w1], h[w0:w1], i0, min(N, i0 + rows),
                              rc * rc, dtype) for i0 in range(0, N, rows)]
        w, i, j, d = (torch.cat(x) for x in zip(*parts))
        e, p, t = _energy_from_pairs(w, i, j, d, w1 - w0, N, model, dtype)
        energy[w0:w1] = e
        pairs[w0:w1] = p
        triplets[w0:w1] = t
    return Terms(energy, pairs, triplets)


def _energy_from_pairs(w, i, j, d, W, N, m: SW, dtype):
    """Two- and three-body energy per walker from the ordered pairs
    (each unordered pair appears as (i, j) and (j, i))."""
    dist = torch.sqrt((d * d).sum(-1))
    inv = 1.0 / (dist - m.rc)                  # negative inside the cutoff
    sr2 = (m.sigma / dist) ** 2
    phi2 = m.A * m.epsilon * (m.B * sr2 * sr2 - 1.0) * torch.exp(
        m.sigma * inv)
    e = torch.zeros(W, dtype=dtype, device=d.device)
    e = e.index_add(0, w, 0.5 * phi2)          # each pair counted twice
    npairs = torch.bincount(w, minlength=W) // 2
    # neighbour lists of each centre (w, i), padded to the largest degree
    centre = w * N + i
    deg = torch.bincount(centre, minlength=W * N)
    kmax = int(deg.max()) if deg.numel() else 0
    ntrip = (deg * (deg - 1) // 2).view(W, N).sum(1)
    if kmax >= 2:
        order = torch.argsort(centre, stable=True)
        centre, d, dist = centre[order], d[order], dist[order]
        leg = torch.exp(m.gamma * m.sigma / (dist - m.rc))
        start = torch.cumsum(deg, 0) - deg
        slot = torch.arange(centre.numel(), device=d.device) - start[centre]
        vec = torch.zeros((W * N, kmax, 3), dtype=dtype, device=d.device)
        rr = torch.ones((W * N, kmax), dtype=dtype, device=d.device)
        ex = torch.zeros((W * N, kmax), dtype=dtype, device=d.device)
        vec[centre, slot] = d
        rr[centre, slot] = dist
        ex[centre, slot] = leg
        ja, kb = torch.triu_indices(kmax, kmax, 1, device=d.device)
        cos = ((vec[:, ja] * vec[:, kb]).sum(-1)
               / (rr[:, ja] * rr[:, kb]))
        phi3 = (m.lam * m.epsilon * (cos - m.cos0) ** 2
                * ex[:, ja] * ex[:, kb])       # 0 where a leg is padding
        e = e + phi3.sum(1).view(W, N).sum(1)
    return e.double(), npairs, ntrip
