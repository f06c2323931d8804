"""The port's dense engine against the JAX engine's scan path with one
lattice (the single-box NPT run, at N=216 in table mode and N=48 in
dense mode) and under NVT (the cases and their checks are
test_torch_engine_variants.py's; this file holds one group of them)."""

import pytest

from .test_torch_engine_variants import check_variant


@pytest.mark.parametrize("case", ["nvt", "single", "n48_single"])
def test_variant_matches_jax(case):
    check_variant(case)
