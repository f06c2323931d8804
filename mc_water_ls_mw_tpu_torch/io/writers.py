"""Output writers: logs, therm series, curve dumps, PSF/DCD trajectories.

A copy of ``mc_water_ls_mw_tpu/io/writers.py``: the files written are
byte for byte those of the JAX package for the same numbers.

Reproduces the reference's layered text/binary outputs
(SURVEY.md §5.5): global mc.log, per-walker node logs and
<seed>NNN_therm.dat series (main.f90:200-223), eta_weights.dat /
histogram.dat / unbiased_histogram.dat curve dumps with f-tagged
archives and wlf.dat (mc_moves.F90:1823-1929, 2068-2100), VMD PSF
topology (io.f90:696-746) and binary CHARMM-style DCD snapshots
(io.f90:748-853).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..constants import AUD_TO_KGM3, BOHR_TO_ANG, HART_TO_EV, WATER_MASS


# ----------------------------------------------------------------------
# curve dumps
# ----------------------------------------------------------------------

def write_curve(path, mu_bin, values, wl_factor):
    """eta_weights.dat-style file: header with current f, two columns
    (mc_moves.F90:1827-1843)."""
    with open(path, "w") as fh:
        fh.write(f"#Current energy increment =  {wl_factor:.12E}\n")
        for m, v in zip(np.asarray(mu_bin), np.asarray(values)):
            fh.write(f"  {m: .14E}  {v: .14E}\n")


def read_eta_weights(path):
    """Read an eta_weights.dat: returns (wl_factor, weights[B]).

    Header format from mc_init (mc_moves.F90:748-768)."""
    with open(path) as fh:
        header = fh.readline()
        m = header.split("=")
        wl_factor = float(m[1]) if len(m) == 2 else 0.0
        data = np.loadtxt(fh)
    return wl_factor, data[:, 1]


def append_wlf(path, cycle, wl_factor, halved=None):
    """wlf.dat f-history (mc_check_flatness:2068-2082)."""
    with open(path, "a") as fh:
        fh.write(f"{cycle:10d}  {wl_factor:.12E}\n")
        if halved is not None:
            fh.write(f"{cycle:10d}  {halved:.12E}\n")


# ----------------------------------------------------------------------
# therm series (main.f90:200-223)
# ----------------------------------------------------------------------

class ThermWriter:
    """Per-walker <seed>NNN_therm.dat time series."""

    def __init__(self, seedname, walker_ids, nwater, restart=False):
        self.files = {}
        self.nwater = nwater
        mode = "a" if restart else "w"
        for w in walker_ids:
            self.files[w] = open(f"{seedname}{w:03d}_therm.dat", mode)

    def write(self, w, cycle, energy_ls, mu, vols, ls, num_lattices,
              samplerun_or_fixed):
        """One sample row, formats per main.f90:204-221."""
        fh = self.files[w]
        e_ev = energy_ls * HART_TO_EV
        if num_lattices == 1:
            fh.write(f"{cycle:8d}  {e_ev:.6E}     "
                     f"{vols[0] * BOHR_TO_ANG**3:15.6f}\n")
        elif samplerun_or_fixed:
            # sample run: volumes of both lattices for reweighting
            v = [x * BOHR_TO_ANG**3 for x in vols]
            fh.write(f"{cycle:8d}  {e_ev:.6E}     {mu:15.6f}"
                     f"{v[0]:15.6f}{v[1]:15.6f} {ls + 1:1d}\n")
        else:
            dens = density_kgm3(self.nwater, vols[ls])
            fh.write(f"{cycle:8d}  {e_ev:.6E}     {mu:15.6f}"
                     f"{dens:15.6f} {ls + 1:1d}\n")
        fh.flush()

    def close(self):
        for fh in self.files.values():
            fh.close()


# ----------------------------------------------------------------------
# logs
# ----------------------------------------------------------------------

class Logs:
    """mc.log (global) + node000.log-style per-run log
    (io.f90:1055-1144)."""

    def __init__(self, restart=False, node_id=0):
        mode = "a" if restart else "w"
        self.glog = open("mc.log", mode)
        self.mylog = open(f"node{node_id:03d}.log", mode)
        if not restart:
            self.glog.write(
                "#==============================================================#\n"
                "#      Lattice-switching MC code for mW water molecules        #\n"
                "#                   PyTorch/CUDA framework                     #\n"
                "#==============================================================#\n"
            )
            self.mylog.write(
                "#==============================================================#\n"
                "# Walker-ensemble log                                          #\n"
                "#==============================================================#\n"
            )

    def g(self, msg):
        self.glog.write(msg + "\n")
        self.glog.flush()

    def my(self, msg):
        self.mylog.write(msg + "\n")
        self.mylog.flush()

    def close(self):
        self.glog.close()
        self.mylog.close()


class NullLogs:
    """The logs of a rank that writes none (every rank but the root of a
    sharded run)."""

    def g(self, msg):
        pass

    def my(self, msg):
        pass

    def close(self):
        pass


# ----------------------------------------------------------------------
# PSF / DCD trajectory output (io.f90:696-853)
# ----------------------------------------------------------------------

def write_psf(path, nwater, num_lattices):
    """X-plor style PSF of non-bonded beads (io_write_psf)."""
    n = nwater * num_lattices
    with open(path, "w") as fh:
        fh.write("PSF\n")
        fh.write("         1 !NTITLE\n\n")
        fh.write(f"{n:8d} !NATOM\n")
        for i in range(1, n + 1):
            fh.write(
                f"{i:8d} BULK {i:4d} UNK  O    O     "
                f"{0.0:10.6f}      {1.0:8.4f}          0\n"
            )
        fh.write("\n")
        fh.write(f"{0:8d} !NBOND: bonds\n")
        fh.write(f"{0:8d} !NTHETA: angles\n")
        fh.write(f"{0:8d} !NPHI: torsions\n")
        fh.write(f"{0:8d} !NIMPHI: torsions\n")
        fh.write(f"{0:8d} !NDON: donors\n")
        fh.write(f"{0:8d} !NACC: acceptors\n")


def _rec(payload: bytes) -> bytes:
    """One Fortran unformatted sequential record."""
    n = struct.pack("<i", len(payload))
    return n + payload + n


def write_dcd_header(path, natoms):
    """CHARMM-format DCD header (io_write_dcd_header, io.f90:748-789)."""
    icntrl = [0] * 20
    icntrl[0] = 1000
    icntrl[2] = 100
    icntrl[3] = 100 * 1000
    icntrl[7] = natoms
    icntrl[10] = 1
    icntrl[19] = 24
    with open(path, "wb") as fh:
        fh.write(_rec(b"CORD" + struct.pack("<20i", *icntrl)))
        fh.write(_rec(struct.pack("<i", 1) + b" " * 80))
        fh.write(_rec(struct.pack("<i", natoms)))


def append_dcd_snapshot(path, r_active, r_other, h_active):
    """Append one snapshot, active lattice first
    (io_write_dcd_snapshot, io.f90:791-853).  x and y are negated as
    in the reference (io.f90:844-846)."""
    coords = np.asarray(r_active) * BOHR_TO_ANG
    if r_other is not None:
        coords = np.concatenate(
            [coords, np.asarray(r_other) * BOHR_TO_ANG]
        )
    H = np.asarray(h_active) * BOHR_TO_ANG
    a = np.linalg.norm(H[:, 0])
    b = np.linalg.norm(H[:, 1])
    c = np.linalg.norm(H[:, 2])
    ua, ub, uc = H[:, 0] / a, H[:, 1] / b, H[:, 2] / c
    xtlabc = np.array([
        a,
        np.degrees(np.arccos(np.clip(ua @ ub, -1, 1))),
        b,
        np.degrees(np.arccos(np.clip(ua @ uc, -1, 1))),
        np.degrees(np.arccos(np.clip(ub @ uc, -1, 1))),
        c,
    ])
    with open(path, "ab") as fh:
        fh.write(_rec(struct.pack("<6d", *xtlabc)))
        fh.write(_rec((-coords[:, 0]).astype("<f4").tobytes()))
        fh.write(_rec((-coords[:, 1]).astype("<f4").tobytes()))
        fh.write(_rec((coords[:, 2]).astype("<f4").tobytes()))


def density_kgm3(nwater, volume_au):
    """Active-lattice density as reported in therm output
    (main.f90:202)."""
    return nwater * WATER_MASS / volume_au * AUD_TO_KGM3


# ----------------------------------------------------------------------
# legacy DLPOLY HISTORY trajectory (io.f90:856-1053; present in the
# reference but not called from its main loop, main.f90:103)
# ----------------------------------------------------------------------

def write_history_header(path, nwater, num_lattices, rank=0):
    """Unformatted-Fortran DLPOLY HISTORY header (io_hist_header)."""
    n = nwater * num_lattices
    header = f"HISTORY file for rank {rank:3d}".ljust(80).encode()
    with open(path, "wb") as fh:
        fh.write(_rec(header))
        fh.write(_rec(struct.pack("<d", float(n))))
        fh.write(_rec(b"".join(b"O_mW    " for _ in range(n))))
        fh.write(_rec(struct.pack(f"<{n}d",
                                  *([15.9998 + 2.0 * 1.0080] * n))))
        fh.write(_rec(struct.pack(f"<{n}d", *([0.0] * n))))


def append_history(path, icyc, r_active, r_other, h_active):
    """Append one HISTORY frame (io_hist_append, io.f90:932-1053),
    including the reference's +2*hmatrix(:,1) offset quirk
    (io.f90:996-998)."""
    coords = np.asarray(r_active) * BOHR_TO_ANG
    if r_other is not None:
        coords = np.concatenate(
            [coords, np.asarray(r_other) * BOHR_TO_ANG]
        )
    H = np.asarray(h_active) * BOHR_TO_ANG
    n = len(coords)
    off = 2.0 * H[:, 0]
    with open(path, "ab") as fh:
        fh.write(_rec(struct.pack(
            "<5d", float(icyc), float(n), 0.0, 3.0, 1.0
        )))
        fh.write(_rec(np.asarray(H, dtype="<f8").T.tobytes()))
        for d in range(3):
            fh.write(_rec(
                (coords[:, d] + off[d]).astype("<f8").tobytes()
            ))
