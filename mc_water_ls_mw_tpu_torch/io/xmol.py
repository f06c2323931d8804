"""Reader for the reference's xmol configuration files (a copy of
``mc_water_ls_mw_tpu/io/xmol.py``).

Format (reference: init.f90:38-125): first line = atom count, second
line = 9 numbers of the cell matrix in Angstrom (column-major: the
Fortran read fills hmatrix(:,:) so consecutive numbers are the
components of lattice vector 1, then 2, then 3), then one
``O x y z`` line per molecule.  All values are converted to atomic
units (Bohr) on read, as the reference does (init.f90:87,103).
"""

from __future__ import annotations

import numpy as np

from ..constants import ANG_TO_BOHR


def read_xmol(path, expected_n=None):
    """Read one xmol file -> (positions [N,3] Bohr, H [3,3] Bohr).

    H columns are the lattice vectors (cartesian = H @ frac), matching
    the reference convention.
    """
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    if expected_n is not None and n != expected_n:
        raise ValueError(
            f"{path}: {n} atoms, expected {expected_n} "
            "(reference: init.f90:77 'wrong number of atoms')"
        )
    cell = np.array([float(t) for t in tokens[1:10]], dtype=np.float64)
    # Fortran column-major fill: first 3 numbers are column 1
    H = cell.reshape(3, 3).T * ANG_TO_BOHR
    r = np.empty((n, 3), dtype=np.float64)
    k = 10
    for i in range(n):
        elem = tokens[k]  # noqa: F841  (element symbol, unused, init.f90:96)
        r[i] = [float(tokens[k + 1]), float(tokens[k + 2]), float(tokens[k + 3])]
        k += 4
    return r * ANG_TO_BOHR, H


def read_lattices(directory, num_lattices, expected_n=None):
    """Read input001.xmol .. inputNNN.xmol like the reference
    (init.f90:64-69)."""
    import os

    rs, Hs = [], []
    for ils in range(1, num_lattices + 1):
        path = os.path.join(directory, f"input{ils:03d}.xmol")
        r, H = read_xmol(path, expected_n)
        rs.append(r)
        Hs.append(H)
    return np.stack(rs), np.stack(Hs)


def tile_cell(r, H, reps):
    """Replicate a cell (na, nb, nc) times -> supercell positions.

    TPU-native extension (no reference counterpart): the reference
    only ever reads the cell from file.  Used to scale the packaged
    N=48 ice cells up to larger benchmark systems (e.g. 2x2x2 -> 384
    molecules) while preserving the crystal structure.
    """
    import itertools

    r = np.asarray(r, dtype=np.float64)
    H = np.asarray(H, dtype=np.float64)
    na, nb, nc = reps
    out = []
    for i, j, k in itertools.product(range(na), range(nb), range(nc)):
        shift = H @ np.array([i, j, k], dtype=np.float64)
        out.append(r + shift)
    H_new = H @ np.diag([na, nb, nc]).astype(np.float64)
    return np.concatenate(out), H_new
