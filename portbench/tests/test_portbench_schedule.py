"""The schedule that gives every seed the same volume moves."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, schedule  # noqa: E402


def _prm(seed=7):
    from mc_water_ls_mw_tpu_torch.io.namelist import read_input

    _, wl, cfg = harness.cell_files("n8064_wl")
    ov = {**cfg["params"], **wl["overrides"], "seed": seed}
    ov = {k: tuple(v) if isinstance(v, list) else v for k, v in ov.items()}
    return read_input(os.path.join(ROOT, wl["data"], "ice.input"),
                      extra_overrides=ov)


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 4100000101])
def test_counts_are_the_program_streams(seed):
    """The replicated schedule counts the volume codes that the
    program's own stream draws, cycle by cycle, rebins included."""
    from mc_water_ls_mw_tpu_torch.mcmc.engine import VOL, PhiloxStream

    prm = _prm()
    probs = prm.normalised_probs()
    st = PhiloxStream(seed, "cpu")
    want = []
    for c in range(1, 23):
        if c % prm.list_update_int == 0:
            st.rebin_origin(c, torch.float32)
        codes, _ = st.cell_cycle_draws(c, probs, 8192, 0, 1, 1, 1,
                                       torch.float32)
        want.append(int((codes == VOL).sum()))
    assert schedule.volume_counts(seed, probs, 8192, prm.list_update_int,
                                  None, 22) == want


@pytest.mark.parametrize("seed", [1, 2**32 + 12345, 4100000103])
def test_every_seed_the_same_count(seed):
    prm = _prm()
    probs = prm.normalised_probs()
    pseed, want = schedule.program_seed(seed, prm, 8192, 2, 14)
    counts = schedule.volume_counts(pseed, probs, 8192,
                                    prm.list_update_int, None, 16)
    p_vol = probs[1] - probs[0]
    assert want == round(14 * 8192 * p_vol) == sum(counts[2:])
    assert sum(counts[:2]) == round(2 * 8192 * p_vol)
    # another seed, another schedule
    assert schedule.program_seed(seed + 1, prm, 8192, 2, 14)[0] != pseed
