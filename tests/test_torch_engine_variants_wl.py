"""The port's dense engine against the JAX engine's scan path under the
Swetnam and 1/t Wang-Landau schedules (the cases and their checks are
test_torch_engine_variants.py's; this file holds one group of them)."""

import pytest

from .test_torch_engine_variants import check_variant


@pytest.mark.parametrize("case", ["swetnam", "useinvt"])
def test_variant_matches_jax(case):
    check_variant(case)
