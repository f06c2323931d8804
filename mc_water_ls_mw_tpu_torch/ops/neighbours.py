"""Padded fixed-capacity Verlet neighbour lists.

Counterpart of ``mc_water_ls_mw_tpu/ops/neighbours.py`` (reference:
molint.F90:501-559 ``compute_neighbours`` and molint.F90:174-217
``compute_ivects``), on tensors: the lists are built on the device of
the positions given.

* Every neighbour slot stores its integer cell shift (i, j, k) instead
  of an index into a table of image vectors (``ivect``); the image
  vector is H @ shift, which stays exact across volume moves as the
  reference's index-into-rebuilt-ivect scheme does
  (mc_moves.F90:1353-1356).
* The variable-length Fortran lists (counts ``nn``, partners ``jn``,
  images ``vn``, capacity maxneigh=50, molint.F90:79-81) become
  fixed-capacity padded tensors with a validity mask.  ``count`` is the
  true number of neighbours and may exceed the capacity: the entries
  beyond it are dropped (check ``count``).
* The brute-force O(N^2 * n_images) search is a dense distance
  computation + a stable compaction; entries come out in the same
  (partner-major, image-minor) order as the reference loops
  (molint.F90:520-549).

No TPU kernel is behind this: the JAX package computes it in XLA, and
no engine path of either package uses it (the engines use the static
tables of ops/nbrtable.py).  tools/threebody_filter.py does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NeighbourList(NamedTuple):
    """Padded neighbour list of one lattice (leading axes: one list per
    leading index).

    idx:   [..., N, K] int32    partner molecule index (0 in padded slots)
    shift: [..., N, K, 3] int32 integer cell shift of the partner image
    mask:  [..., N, K] bool     slot validity
    count: [..., N] int32       true neighbour count (may exceed K: check!)
    """

    idx: torch.Tensor
    shift: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor


def shift_images(shift, H):
    """Image vectors H @ shift: shift [..., 3] (integers, any leading
    axes matching or broadcasting against H's), H [..., 3, 3] ->
    [..., 3].  Written as three products and two sums, never a matrix
    product (TF32 on the card would round it)."""
    s = shift.to(H.dtype)
    return (s[..., 0, None] * H[..., 0] + s[..., 1, None] * H[..., 1]
            + s[..., 2, None] * H[..., 2])


def build_neighbour_list(r, H, shifts, capacity, rskin):
    """Build the padded neighbour list(s).

    r:        [..., N, 3] positions (Bohr)
    H:        [..., 3, 3] cell matrix (columns = lattice vectors)
    shifts:   [S, 3] integer cell shifts (null shift first;
              ops/geometry.enumerate_shifts)
    capacity: int K <= N*S (reference maxneigh=50, molint.F90:79)
    rskin:    Verlet radius = 1.18 * cutoff (molint.F90:516)

    A molecule is its own neighbour only through non-null images
    (molint.F90:532: the (k==1 .and. jmol==imol) cycle).
    """
    N = r.shape[-2]
    shifts = torch.as_tensor(shifts, dtype=torch.int32, device=r.device)
    S = shifts.shape[0]
    img = shift_images(shifts, H[..., None, :, :])             # [..., S, 3]
    disp = (r[..., None, :, None, :] + img[..., None, None, :, :]
            - r[..., :, None, None, :])                        # [..., N, N, S, 3]
    d2 = (disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1]
          + disp[..., 2] * disp[..., 2])                       # [..., N, N, S]
    del disp

    is_null = (shifts == 0).all(dim=-1)                        # [S]
    self_pair = (torch.eye(N, dtype=torch.bool, device=r.device)[:, :, None]
                 & is_null[None, None, :])
    valid = (d2 < rskin * rskin) & ~self_pair                  # [..., N, N, S]

    flat = valid.reshape(*valid.shape[:-2], N * S)
    count = flat.sum(dim=-1, dtype=torch.int32)

    # a stable descending sort keeps the valid entries in (j-major,
    # image-minor) order, the reference's loop nest (molint.F90:525-549)
    key, ki = torch.sort(flat.to(torch.uint8), dim=-1, descending=True,
                         stable=True)
    mask = key[..., :capacity] > 0
    ki = ki[..., :capacity]
    idx = torch.where(mask, torch.div(ki, S, rounding_mode="floor"), 0)
    shift = torch.where(mask[..., None], shifts[ki % S], 0)
    return NeighbourList(idx=idx.to(torch.int32),
                         shift=shift.to(torch.int32), mask=mask, count=count)


def build_neighbour_list_chunked(r, H, shifts, capacity, rskin, chunk=128):
    """Walker-chunked build over [W, L] leading axes (r [W, L, N, 3],
    H [W, L, 3, 3]) to bound the [W, L, N, N, S] peak memory: chunks of
    ``chunk`` walkers, one after the other.  A walker count above the
    chunk must be divisible by it (the JAX package's rule)."""
    W = r.shape[0]
    if W <= chunk:
        return build_neighbour_list(r, H, shifts, capacity, rskin)
    if W % chunk:
        raise ValueError(f"walker count {W} not divisible by chunk {chunk}")
    parts = [build_neighbour_list(r[c:c + chunk], H[c:c + chunk], shifts,
                                  capacity, rskin)
             for c in range(0, W, chunk)]
    return NeighbourList(*(torch.cat(f) for f in zip(*parts)))
