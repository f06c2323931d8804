"""The port's mu-window joins (parallel/windows.py) against the JAX
package's, on seeded curves: additive weight joins, log-space histogram
joins (among them overlaps with empty bins, where the shift is not
finite and falls back to no scaling) and the per-window collapse of
per-walker arrays."""

import numpy as np
import pytest

from mc_water_ls_mw_tpu.parallel import windows as jwin

from mc_water_ls_mw_tpu_torch.parallel import windows as twin


@pytest.mark.parametrize("nwin,nbins,overlap", [
    (2, 21, 2), (4, 21, 1), (8, 101, 2), (16, 201, 2)])
def test_join_eta_matches_jax(nwin, nbins, overlap):
    rng = np.random.default_rng(nwin * 1000 + nbins)
    curves = np.cumsum(rng.normal(0.0, 1.0, (nwin, nbins)), axis=1) \
        + rng.normal(0.0, 50.0, (nwin, 1))
    mine = twin.join_eta(curves, nbins, overlap)
    np.testing.assert_array_equal(mine, jwin.join_eta(curves, nbins,
                                                      overlap))
    assert mine[nbins // 2] == 0.0
    # a curve that every window holds whole joins back to itself,
    # re-zeroed at the central bin
    one = np.broadcast_to(curves[0], (nwin, nbins))
    np.testing.assert_allclose(twin.join_eta(one, nbins, overlap),
                               curves[0] - curves[0][nbins // 2],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("nwin,nbins,overlap,empty", [
    (2, 21, 2, False), (4, 21, 1, False), (8, 101, 2, False),
    (8, 101, 2, True), (16, 201, 2, True)])
def test_join_uhist_matches_jax(nwin, nbins, overlap, empty):
    rng = np.random.default_rng(7 * nwin + nbins)
    curves = rng.uniform(0.5, 2.0, (nwin, nbins)) \
        * np.exp(rng.normal(0.0, 5.0, (nwin, 1)))
    if empty:
        # the overlap bins of the second window's boundary hold nothing
        # in one window: log(0) makes the shift non-finite
        bpw = nbins // nwin
        end = 2 * bpw - 1
        curves[2, end - overlap:end + overlap + 1] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        theirs = jwin.join_uhist(curves, nbins, overlap)
    mine = twin.join_uhist(curves, nbins, overlap)
    np.testing.assert_array_equal(mine, theirs)
    assert np.isfinite(mine).all()
    if empty:
        # no scaling across the empty overlap: the third window's bins
        # past it are taken as they are
        np.testing.assert_array_equal(mine[end + 1:3 * bpw],
                                      curves[2][end + 1:3 * bpw])


def test_per_window_curves_matches_jax():
    rng = np.random.default_rng(3)
    values = rng.normal(size=(37, 21))
    wid = np.arange(37) % 5
    np.testing.assert_array_equal(twin.per_window_curves(values, wid, 5),
                                  jwin.per_window_curves(values, wid, 5))
    np.testing.assert_array_equal(twin.per_window_curves(values, wid, 5),
                                  values[:5])
