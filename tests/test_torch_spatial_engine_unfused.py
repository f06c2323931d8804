"""The port's spatially sharded cell engine without the in-place apply
kernel, against the JAX CellEngine.

Without the apply kernel the sub-step's apply is the serial scatter
(``CellEngine._apply_t1`` -> ``_scatter_moments``): coordinate and own
moment rows are SET at the movers' slots and the stencil deltas ADDed.
On a local slab the padding entries of a schedule address the dummy row
only and are never accepted, so every real slot is set at most once,
and the JAX package's duplicate-safe ADD form (``_apply_spatial``) is
not needed; these tests hold that (tables 5-7 of the N=8064 plan pad 4
of each rank's 8 entries; the N=6048 plan pads none, each rank's halo
being the other's whole slab).  Two ranks along space, float64,
W = 2, three consecutive sub-steps from table 5 in one sharded loop (the
second and third read halo rows refreshed after the first's writes):

* ``cell_pallas='off'`` on the N=8064 (14,8,18) pair: the unfused
  sub-step with its XLA chain, against the JAX engine's jitted
  unsharded sub-steps in the same modes;
* ``cell_pallas='auto'`` on the N=6048 (12,7,18) pair, whose same-colour
  stencils overlap: the port resolves it to the mover kernel's
  per-candidate deltas and the chain kernel (their plain versions on
  the CPU), against the JAX engine's eager unsharded sub-steps at
  ``cell_pallas='off'``, ``cell_chain='on'`` (the same scatter fed by
  XLA deltas; eager, as tests/test_torch_cellengine_scatter.py explains).

Integer outcomes are identical and the continuous state agrees within
1e-9 (``test_torch_spatial_engine._assert_matches``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mc_water_ls_mw_tpu.models.sw import MW
from mc_water_ls_mw_tpu.mcmc.config import RunParams
from mc_water_ls_mw_tpu.mcmc.cellengine import CellEngine as JCellEngine

from mc_water_ls_mw_tpu_torch.parallel.comm import run_ranks

from .test_torch_cellengine_scatter import cell_system
from .test_torch_spatial_engine import CODES, N_SUB, TABLE, _assert_matches
from .test_torch_state import jax_aux_fields, jax_state_fields
from .torch_ranks import spatial_cases

# case: (stacking pair, JAX modes, port modes, jit the JAX sub-steps)
CASES = {
    "off": ((14, 8, 18), dict(cell_pallas="off", cell_chain="off"),
            dict(cell_pallas="off", cell_chain="off"), True),
    "overlap-auto": ((12, 7, 18), dict(cell_pallas="off", cell_chain="on"),
                     dict(cell_pallas="auto", cell_chain="auto"), False),
}


def _jax_substeps(dims, jax_modes, port_modes, jit):
    """The JAX engine's three unsharded sub-steps from the initial state
    at cycle 1, and the case for the ranks."""
    system = cell_system(dims)
    kw = {**system["kw"], **jax_modes}
    jeng = JCellEngine(RunParams(**kw, fused="off"), MW, system["jgrid"],
                       system["jaux"], system["jcg"], system["jcaux"])
    assert not jeng.use_cell_pallas
    K, W = jeng.K, kw["n_walkers"]
    js = system["jst"]._replace(cycle=jnp.asarray(1, jnp.int32))
    u = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, 400),
                                     (N_SUB, K, 7), dtype=jnp.float64),
        out_axes=3)(js.key))                        # [N_SUB, K, 7, W]
    codes = np.asarray(CODES * N_SUB, np.int32)
    jtpm = jnp.zeros((system["jcg"].nslot, W), dtype=jnp.int32)
    jstep = jax.jit(jeng._substep_canonical) if jit \
        else jeng._substep_canonical
    out = js
    for i in range(N_SUB):
        t = TABLE + i
        out, jtpm = jstep(out, jtpm, jeng.fc_stack[t], jeng.cand_stack[t],
                          jeng.off_stack[t], jnp.asarray(u[i]),
                          jnp.asarray(codes[i * K:(i + 1) * K]),
                          jnp.ones(W, dtype=bool))
    case = dict(kw={**system["kw"], **port_modes},
                fields=jax_state_fields(js),
                aux=jax_aux_fields(system["jaux"]),
                caux=jax_aux_fields(system["jcaux"]),
                cellgrid=system["tcg"], u=u, codes=codes, tbl=TABLE,
                n_sub=N_SUB, cycle=1, walkers=1)
    return dict(js=out, jtpm=np.asarray(jtpm), case=case)


@pytest.fixture(scope="module")
def runs():
    ref = {name: _jax_substeps(*c) for name, c in CASES.items()}
    got = run_ranks(spatial_cases, 2,
                    {name: r["case"] for name, r in ref.items()})
    return ref, got


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_without_apply_kernel_match_jax(runs, name):
    ref, got = runs
    for out in got:
        res = out[name]
        assert res["ranks"] == (2, 1) and res["plan"][0] == 2
        assert res["modes"][1] is False            # no apply kernel
        _assert_matches(res, ref[name])
    tf = got[0][name]["state"]
    assert (tf["acc"][0] > 0).all()                # translations accepted


@pytest.mark.parametrize("name,modes", [
    ("off", (False, False, False)),
    ("overlap-auto", (True, False, True)),
])
def test_modes_without_apply_kernel(runs, name, modes):
    """What the port resolves each case to: (mover kernels, apply
    kernel, chain kernel)."""
    _, got = runs
    assert all(out[name]["modes"] == modes for out in got)
