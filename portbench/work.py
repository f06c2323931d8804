"""The least work of the window's moves, counted from the physics.

The numerator of ``cycle_roofline``: the operations and bytes that the
cycle's moves cannot do without, from the walkers' positions by the
reference's own neighbour search, whichever kernel or branch the program
runs them through.

* A translation of molecule i changes the pair terms of i (its degree)
  and the triplet terms that hold i, as centre or as end, at its old and
  its new position, in both lattices.  Averaged over molecules that is
  2 (2P/N) pair terms and 2 (3T/N) triplet terms a lattice, for P
  unordered pairs and T triplets in range.
* A volume move recomputes every pair and triplet in range of both
  lattices.
* The walker state (positions of both lattices) is read and written
  once a cycle.

A pair term costs PAIR_OPS operations (displacement, squared distance,
square root, the cutoff's reciprocal and exponential, (sigma/r)^4, the
pair's three products and a sum, and the three-body leg factor
exp(gamma sigma / (r - a sigma)) shared by the triplets of the leg); a
triplet TRIPLET_OPS (a dot product, the cosine's product and division,
the shift, square and three products).  Lattice switches reuse tracked
energies and count nothing.
"""

from __future__ import annotations

PAIR_OPS = 20
TRIPLET_OPS = 12


def translation_ops(pairs, triplets, n):
    """Operations of one translation, per walker: pairs and triplets
    [L, W] in range (tensors), n molecules."""
    return (2.0 * (2.0 * pairs / n * PAIR_OPS
                   + 3.0 * triplets / n * TRIPLET_OPS)).sum(0)


def volume_ops(pairs, triplets):
    """Operations of one volume move, per walker."""
    return (pairs * PAIR_OPS + triplets * TRIPLET_OPS).sum(0).double()


def window_ops(pairs, triplets, n, translations, volume_moves) -> float:
    """All operations of a window whose walkers made ``translations`` and
    ``volume_moves`` [W] moves."""
    return float((translations.double() * translation_ops(pairs, triplets, n)
                  + volume_moves.double() * volume_ops(pairs, triplets)
                  ).sum())


def window_bytes(cycles, lattices, n, walkers, itemsize) -> float:
    """Positions of every lattice and walker read and written once a
    cycle."""
    return float(2 * cycles * lattices * 3 * n * walkers * itemsize)


def least_seconds(ops, nbytes, peak) -> float:
    """The roofline's time: the slower of the operations at the peak rate
    and the bytes at the peak bandwidth."""
    return max(ops / peak["f32_ops_per_s"], nbytes / peak["bytes_per_s"])
