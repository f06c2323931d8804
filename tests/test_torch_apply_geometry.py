"""The grid of the port's mover-apply kernel (ops/cell_kernels
apply_geometry and the slot split of csrc/cell_movers.cu
mover_apply_kernel): every (lattice, mover, candidate cell, slot,
walker) is taken by exactly one thread, so the kernel needs no atomics.
CPU only: the geometry is computed in Python."""

import numpy as np
import pytest

from mc_water_ls_mw_tpu_torch.ops.cell_kernels import (
    APPLY_SLOTS_PER_WARP,
    APPLY_WARPS_MAX,
    apply_geometry,
)

# (K, CF, cap, W): the N=8064 main path (phase 7: 512 walkers) and the
# front-end path (phase 9: 128 walkers) of chip_smoke.py, then a ragged
# walker count, a cap that is not a multiple of the slots a warp takes,
# and a cap beyond one pass of the block's warps
SHAPES = [(8, 27, 32, 512), (8, 27, 32, 128), (8, 27, 32, 37),
          (4, 75, 27, 64), (2, 27, 70, 33)]


def _slot_counts(cap, nw):
    """How often the warps of one block take each slot of a cell, by the
    kernel's loops (j0 = wy, wy + nw*SPW, ...; j = j0 + q*nw), and how
    often each slot passes the kernel's own-slot test."""
    spw = APPLY_SLOTS_PER_WARP
    taken = np.zeros(cap, np.int64)
    own = np.zeros(cap, np.int64)
    for wy in range(nw):
        for j0 in range(wy, cap, nw * spw):
            for q in range(spw):
                if j0 + q * nw < cap:
                    taken[j0 + q * nw] += 1
            for rank in range(cap):
                own[rank] += ((rank - j0) % nw == 0 and j0 <= rank
                              < j0 + nw * spw)
    return taken, own


@pytest.mark.parametrize("K,CF,cap,W", SHAPES)
def test_apply_grid_covers_every_slot_once(K, CF, cap, W):
    L = 2
    (gx, gy, gz), (bx, nw) = apply_geometry(L, K, CF, cap, W)
    assert bx == 32 and 1 <= nw <= APPLY_WARPS_MAX and (gy, gz) == (K * CF, L)
    # walkers: lane + 32 x below W, once each
    w = (np.arange(gx)[:, None] * 32 + np.arange(32)[None]).ravel()
    assert np.array_equal(np.bincount(w[w < W], minlength=W), np.ones(W))
    # (mover, candidate cell) of block row y: (y // CF, y % CF), once each
    kc = np.array([divmod(y, CF) for y in range(gy)])
    assert np.array_equal(np.bincount(kc[:, 0] * CF + kc[:, 1]),
                          np.ones(K * CF))
    # slots of a cell over the block's warps; the own slot is written by
    # exactly one of them
    taken, own = _slot_counts(cap, nw)
    assert np.array_equal(taken, np.ones(cap))
    assert np.array_equal(own, np.ones(cap))


@pytest.mark.parametrize("K,CF,cap,W", SHAPES[:2])
def test_apply_grid_fills_the_card(K, CF, cap, W):
    """At the main paths' shapes the grid holds several blocks for each
    of the H100's 132 SMs (the first design had K*L*W/32: 256 and 64),
    and each warp takes APPLY_SLOTS_PER_WARP slots in one pass."""
    (gx, gy, gz), (_, nw) = apply_geometry(2, K, CF, cap, W)
    assert gx * gy * gz >= 10 * 132
    assert nw * APPLY_SLOTS_PER_WARP == cap
