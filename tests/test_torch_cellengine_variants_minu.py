"""The port's cell engine against the JAX CellEngine under MINU (the XLA
chain at T=1, the chain kernel's plain version at T=2) (the cases, their
fixture and their checks are test_torch_cellengine_variants.py's; this
file holds one group of them)."""

import pytest

from .test_torch_cellengine_variants import check_cell_variant, grids  # noqa: F401


@pytest.mark.parametrize("case", ['minu_t1_xla', 'minu_t2_chain'])
def test_cell_variant_matches_jax(grids, case):  # noqa: F811
    check_cell_variant(grids, case)
