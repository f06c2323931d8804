"""Cell-matrix geometry ops on tensors.

Counterpart of ``mc_water_ls_mw_tpu/ops/geometry.py`` (reference:
util.f90:16-156).  ``H[:, i]`` is lattice vector i (cartesian =
H @ frac); the reciprocal matrix is 2*pi * H^{-T} from explicit
cofactors, so results agree with the reference to the last bit in
fp64.  Every function broadcasts over trailing (walker) axes of ``H``.

The 3x3 contractions are written as explicit products and sums, never
as matrix products: a float32 product on the card could otherwise be
routed through TF32 tensor cores (three decimal digits), which would
corrupt coordinate transforms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import INV_PI, PI


def determinant3(H):
    """Determinant of a 3x3 matrix (reference: util.f90:16-41)."""
    det = H[0, 0] * (H[1, 1] * H[2, 2] - H[1, 2] * H[2, 1])
    det = det - H[0, 1] * (H[1, 0] * H[2, 2] - H[1, 2] * H[2, 0])
    det = det + H[0, 2] * (H[1, 0] * H[2, 1] - H[1, 1] * H[2, 0])
    return det


def recip_matrix(H):
    """Matrix of reciprocal lattice vectors, 2*pi*H^{-T}
    (cofactor construction of util.f90:43-77)."""
    r00 = H[1, 1] * H[2, 2] - H[1, 2] * H[2, 1]
    r01 = H[1, 2] * H[2, 0] - H[1, 0] * H[2, 2]
    r02 = H[1, 0] * H[2, 1] - H[1, 1] * H[2, 0]

    r10 = H[0, 2] * H[2, 1] - H[0, 1] * H[2, 2]
    r11 = H[0, 0] * H[2, 2] - H[0, 2] * H[2, 0]
    r12 = H[0, 1] * H[2, 0] - H[0, 0] * H[2, 1]

    r20 = H[0, 1] * H[1, 2] - H[0, 2] * H[1, 1]
    r21 = H[0, 2] * H[1, 0] - H[0, 0] * H[1, 2]
    r22 = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]

    recip = torch.stack([
        torch.stack([r00, r01, r02]),
        torch.stack([r10, r11, r12]),
        torch.stack([r20, r21, r22]),
    ])
    vol = H[0, 0] * r00 + H[0, 1] * r01 + H[0, 2] * r02
    return recip * (2.0 * PI / vol)


def to_frac(recip, v):
    """Cartesian -> fractional: s_b = sum_a recip[a, b] v[a] / 2pi.

    ``v`` is [3, ...] (coordinate first), ``recip`` [3, 3, ...] with the
    same number of trailing axes as ``v`` (size-1 axes broadcast).  All
    three components are formed at once, three products and two sums
    in the order of the component-wise formula."""
    s = recip[0] * v[0] + recip[1] * v[1] + recip[2] * v[2]
    return s * (0.5 * INV_PI)


def from_frac(H, s):
    """Fractional -> cartesian: v_a = sum_b H[a, b] s[b]; shapes as in
    ``to_frac``."""
    return H[:, 0] * s[0] + H[:, 1] * s[1] + H[:, 2] * s[2]


def min_image(v, H, recip):
    """Minimum-image convention in fractional coords (util.f90:108-156)."""
    s = to_frac(recip, v)
    s = s - torch.floor(s + 0.5)
    return from_frac(H, s)


def cell_shift_range(H, radius):
    """Static per-axis image bounds covering ``radius``: floor(radius /
    |h_col|) + 1 (molint.F90:189-191).  Host-side numpy."""
    H = np.asarray(H, dtype=np.float64)
    lens = np.sqrt((H * H).sum(axis=0))  # |column i|
    return tuple(int(np.floor(radius / l)) + 1 for l in lens)


def enumerate_shifts(bounds):
    """All integer cell shifts within per-axis ``bounds``: int32 [S, 3],
    null shift first, then the reference's (i, j, k) loop order
    (molint.F90:196-213)."""
    im, jm, km = bounds
    shifts = [(0, 0, 0)]
    for i in range(-im, im + 1):
        for j in range(-jm, jm + 1):
            for k in range(-km, km + 1):
                if i == 0 and j == 0 and k == 0:
                    continue
                shifts.append((i, j, k))
    return np.asarray(shifts, dtype=np.int32)
