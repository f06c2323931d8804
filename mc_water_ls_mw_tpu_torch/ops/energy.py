"""Stillinger-Weber (mW) energies over a neighbour list (ops/neighbours.py).

Counterpart of ``mc_water_ls_mw_tpu/ops/energy.py``, the reference's
own neighbour-list Hamiltonian (molint.F90), in plain PyTorch on one
lattice:

* :func:`full_energy` - whole-cell energy (reference
  compute_model_energy, molint.F90:407-499);
* :func:`local_energy` / :func:`translation_energies` - the local
  energy of one molecule, at one position or at its old AND new trial
  position with shared neighbour gathers (reference
  compute_local_real_energy, molint.F90:220-404, called 4x per trial
  translation).

No TPU kernel is behind these: the JAX package computes them in XLA,
and no engine path of either package uses them (the engines' energies
are ops/full_energy.py, ops/dense.py and the cell kernels, over the
unfiltered Hamiltonian).  tools/threebody_filter.py uses them to
measure what the reference's filter drops.

Reference quirks replicated deliberately:
* local (but not full-cell) three-body terms drop cos(theta) >= 0.99
  (molint.F90:367-371) - this removes the degenerate k==i direction in
  the j-centred gather and is numerically safe because the smooth
  cutoff kills genuinely near-collinear triplets;
* pair terms are halved in the full-cell sum (each pair visited twice,
  molint.F90:464) but unhalved in the local sum (molint.F90:294-297).

The 3-vector contractions are written as products and sums, never as
matrix products: a float32 product on the card could otherwise run
through TF32 tensor cores.
"""

from __future__ import annotations

import torch

from ..models.sw import SWParams
from .dense import _DENOM_CLAMP
from .neighbours import shift_images


def _dot(a, b):
    """Sum over the last (xyz) axis of a * b, broadcasting."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _denom(rij, in_rc, prm: SWParams):
    # clamped strictly negative: rounded rij can hit rc exactly while
    # r^2 < rc^2 (ops/dense._DENOM_CLAMP note)
    return torch.clamp(torch.where(in_rc, rij - prm.rc, -1.0),
                       max=_DENOM_CLAMP)


def _pair_term(r2_safe, rij, in_rc, prm: SWParams):
    """A*eps*(B*(sigma/r)^4 - 1) * exp(sigma/(r - a*sigma)), masked."""
    sig2 = prm.sigma * prm.sigma
    expf = torch.exp(prm.sigma / _denom(rij, in_rc, prm))
    frac = sig2 * sig2 / (r2_safe * r2_safe)
    e = prm.bigA * prm.epsilon * (prm.bigB * frac - 1.0) * expf
    return torch.where(in_rc, e, 0.0)


def _leg_exp(rij, in_rc, prm: SWParams):
    """exp(gamma*sigma/(r - a*sigma)) per three-body leg, masked to 0."""
    return torch.where(
        in_rc, torch.exp(prm.gamma * prm.sigma / _denom(rij, in_rc, prm)),
        0.0)


def _upper(K, device):
    """[K, K] pairs a < b (each angle once)."""
    return torch.triu(torch.ones((K, K), dtype=torch.bool, device=device),
                      diagonal=1)


def _legs(r, H, nbr, prm: SWParams):
    """Each molecule's legs to its listed neighbours: the vectors d
    [N, K, 3] (images applied), r^2 [N, K] with 1 beyond the cutoff, |d|
    from it, and the in-cutoff mask [N, K].  The list is padded and
    includes skin entries beyond the cutoff, so the mask is recomputed
    here, as the reference re-tests r2 < rc^2 at every use
    (molint.F90:454)."""
    d = r[nbr.idx.long()] + shift_images(nbr.shift, H) - r[:, None, :]
    r2 = _dot(d, d)
    in_rc = nbr.mask & (r2 < prm.rc2)
    r2s = torch.where(in_rc, r2, 1.0)
    return d, r2s, torch.sqrt(r2s), in_rc


def _three_body(d, rij, in_rc, prm: SWParams):
    """The three-body terms centred on each molecule over unordered
    pairs of its legs (a < b), each angle once, unfiltered and without
    the lam*eps factor (molint.F90:467-487): (terms [N, K, K], 0 off
    ``pairs``; cos(theta) [N, K, K]; pairs, the a < b pairs with both
    legs inside the cutoff)."""
    u = d * (1.0 / rij)[..., None]                        # unit vectors
    cosq = _dot(u[:, :, None, :], u[:, None, :, :])       # [N, K, K]
    leg = _leg_exp(rij, in_rc, prm)                       # [N, K]
    pairs = (_upper(leg.shape[-1], d.device)[None]
             & in_rc[:, :, None] & in_rc[:, None, :])
    terms = (cosq - prm.cos0) ** 2 * leg[:, :, None] * leg[:, None, :]
    return torch.where(pairs, terms, 0.0), cosq, pairs


def three_body_terms(r, H, nbr, prm: SWParams):
    """The whole-cell three-body terms of one lattice, as
    :func:`full_energy` sums them: (terms, cos(theta), pairs), each
    [N, K, K] (see ``_three_body``).  tools/threebody_filter.py sums
    the terms where cos(theta) >= 0.99, the ones the local path
    drops."""
    d, _, rij, in_rc = _legs(r, H, nbr, prm)
    return _three_body(d, rij, in_rc, prm)


def full_energy(r, H, nbr, prm: SWParams):
    """Whole-cell SW energy of one lattice (molint.F90:407-499).

    r:   [N, 3] positions (Bohr)
    H:   [3, 3] cell matrix
    nbr: NeighbourList (padded, includes skin entries beyond the
         cutoff, masked here)
    """
    d, r2s, rij, in_rc = _legs(r, H, nbr, prm)

    # pair terms, halved: each (i, j) visited from both ends
    # (molint.F90:464)
    e_pair = 0.5 * torch.sum(_pair_term(r2s, rij, in_rc, prm))

    # three-body terms; no cos-filter in the full-cell sum
    terms, _, _ = _three_body(d, rij, in_rc, prm)
    return e_pair + prm.lam * prm.epsilon * torch.sum(terms)


def _local_terms(p, jlj, mj, klj, mk, prm: SWParams):
    """Local energy of a molecule at ``p`` given its gathered
    neighbourhood.

    jlj: [K, 3]  absolute positions of its neighbours (image applied)
    mj:  [K]     neighbour slot validity
    klj: [K, K, 3] absolute positions of each neighbour's neighbours,
         translated into the neighbour's image frame
         (molint.F90:324-343: ivect(:,ki) + j_ivect)
    mk:  [K, K]  slot validity of the above
    """
    dij = jlj - p[None, :]
    r2ij = _dot(dij, dij)
    in_j = mj & (r2ij < prm.rc2)
    r2s = torch.where(in_j, r2ij, 1.0)
    rij = torch.sqrt(r2s)
    inv_rij = 1.0 / rij

    # unhalved pair terms (molint.F90:294-297)
    e_pair = torch.sum(_pair_term(r2s, rij, in_j, prm))

    leg_j = _leg_exp(rij, in_j, prm)                      # [K]

    # i-centred angles j-i-k over unordered pairs (molint.F90:302-318),
    # with the local-path cos < 0.99 screen (molint.F90:367)
    u = dij * inv_rij[..., None]
    cos_ik = _dot(u[:, None, :], u[None, :, :])
    tri = _upper(leg_j.shape[0], p.device)
    m_i = tri & in_j[:, None] & in_j[None, :] & (cos_ik < 0.99)
    t_i = (cos_ik - prm.cos0) ** 2 * leg_j[:, None] * leg_j[None, :]
    e3_i = torch.sum(torch.where(m_i, t_i, 0.0))

    # j-centred angles i-j-k for each neighbour j and each of j's
    # neighbours k (molint.F90:324-343)
    djk = klj - jlj[:, None, :]
    r2jk = _dot(djk, djk)
    in_k = mk & (r2jk < prm.rc2)
    rjk = torch.sqrt(torch.where(in_k, r2jk, 1.0))
    leg_k = _leg_exp(rjk, in_k, prm)                      # [K, K]
    # cos(theta_ijk): angle at j between (i - j) and (k - j)
    cos_ijk = _dot(-dij[:, None, :], djk) * (inv_rij[:, None] / rjk)
    m_j = in_j[:, None] & in_k & (cos_ijk < 0.99)
    t_j = (cos_ijk - prm.cos0) ** 2 * leg_j[:, None] * leg_k
    e3_j = torch.sum(torch.where(m_j, t_j, 0.0))

    return e_pair + prm.lam * prm.epsilon * (e3_i + e3_j)


def _gather(r, H, nbr, i):
    """Molecule i's neighbourhood: partners jn [K] at their images
    (without the substitution of i), and the partners' partners kn
    [K, K] in the partner's image frame."""
    jn = nbr.idx[i].long()
    sj = nbr.shift[i]
    kn = nbr.idx[jn].long()
    return (jn, r[jn] + shift_images(sj, H), nbr.mask[i], kn,
            r[kn] + shift_images(nbr.shift[jn] + sj[:, None, :], H),
            nbr.mask[jn])


def _at(p, jn, kn, i, H, nbr):
    """The images of molecule i among the gathered partners, with i at
    position p: (rows to replace in jlj, their values; likewise klj)."""
    sj = nbr.shift[i]
    pj = p[None, :] + shift_images(sj, H)
    pk = p[None, None, :] + shift_images(nbr.shift[jn] + sj[:, None, :], H)
    return (jn == i)[:, None], pj, (kn == i)[..., None], pk


def local_energy(r, H, nbr, i, p, prm: SWParams):
    """Local SW energy of molecule ``i`` evaluated at position ``p``.

    Single-evaluation form of compute_local_real_energy
    (molint.F90:220-404).  ``r`` holds the stored positions; the
    evaluation substitutes ``p`` for molecule i everywhere it appears
    (the reference achieves this by updating ljr before the call,
    mc_moves.F90:1076-1083).
    """
    jn, jlj, mj, kn, klj, mk = _gather(r, H, nbr, i)
    self_j, pj, self_k, pk = _at(p, jn, kn, i, H, nbr)
    return _local_terms(p, torch.where(self_j, pj, jlj), mj,
                        torch.where(self_k, pk, klj), mk, prm)


def translation_energies(r, H, nbr, i, p_new, prm: SWParams):
    """(E_old, E_new) for molecule ``i`` moving to ``p_new``.

    Shares the neighbour gathers between the old- and new-position
    evaluations; the reference instead calls
    compute_local_real_energy twice per lattice
    (mc_moves.F90:1007-1018, 1076-1092).
    """
    jn, jlj, mj, kn, klj, mk = _gather(r, H, nbr, i)
    out = []
    for p in (r[i], p_new):
        self_j, pj, self_k, pk = _at(p, jn, kn, i, H, nbr)
        out.append(_local_terms(p, torch.where(self_j, pj, jlj), mj,
                                torch.where(self_k, pk, klj), mk, prm))
    return out[0], out[1]
