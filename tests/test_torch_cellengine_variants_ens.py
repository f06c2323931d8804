"""The port's cell engine against the JAX CellEngine under leshift and NVT
(the cases, their fixture and their checks are
test_torch_cellengine_variants.py's; this file holds one group of them)."""

import pytest

from .test_torch_cellengine_variants import check_cell_variant, grids  # noqa: F401


@pytest.mark.parametrize("case", ['leshift', 'nvt'])
def test_cell_variant_matches_jax(grids, case):  # noqa: F811
    check_cell_variant(grids, case)
