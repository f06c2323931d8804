"""The port's per-chunk heartbeat (app.py) and the chunking under it, on
the CPU in float64.

* ``run_cycles(s, a)`` then ``run_cycles(., b)`` equals
  ``run_cycles(s, a + b)`` bitwise, state, samples and the generators'
  states, for the dense engine (N=48, volume moves, delta-syncs and
  chain resyncs inside) and for the cell engine (N=8064 cut to one
  sweep, 64 sub-steps a cycle, with a rebin, a volume move and
  delta-syncs inside):
  the random streams draw in call order, so a chunk boundary is
  invisible;
* ``run_input_file`` with ``jit_chunk`` below the block writes every
  file of the unchunked run byte for byte (mc.log's block timings
  aside) and a ``heartbeat`` holding the final cycle;
* the port against the JAX front end at ``jit_chunk=1`` (blocks of 2):
  the same files, heartbeat included, and the same physics lines, as
  test_torch_frontend.py holds the unchunked app.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu import app as japp
from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.mcmc.engine import Engine
from mc_water_ls_mw_tpu_torch.mcmc.state import init_state
from mc_water_ls_mw_tpu_torch.models.stacking import (
    correspondence_mismatch,
    stacking_switch_pair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.ops import cells
from mc_water_ls_mw_tpu_torch.ops.dsfloat import DS

from .test_torch_cells import cell_run_params
from .test_torch_frontend import APP_OVERRIDES, _line, _run_app
from .test_torch_state import small_run_params


def _fields(s):
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, DS):
            out[f.name + ".hi"], out[f.name + ".lo"] = v.hi, v.lo
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                out[f"{f.name}.{i}"] = x
        else:
            out[f.name] = v
    return out


def _assert_same_run(eng_a, s_a, smp_a, eng_b, s_b, smp_b):
    fa, fb = _fields(s_a), _fields(s_b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    for k in smp_a:
        assert torch.equal(smp_a[k], smp_b[k]), k
    for ga, gb in zip(eng_a.stream.get_state(), eng_b.stream.get_state()):
        assert torch.equal(ga, gb)


def _chunked(make, chunks):
    """(engine, state, samples) of a fresh engine run in ``chunks``."""
    eng, s = make()
    parts = []
    for c in chunks:
        s, smp = eng.run_cycles(s, c)
        parts.append(smp)
    return eng, s, {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _dense():
    prm = RunParams(**small_run_params(
        nwater=48, stack=(1, 2, 6), method="stack", mc_vol_prob=0.05,
        mpi_sync_int=2, latt_sync_int=3, seed=21))
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    r0, H0 = stacking_switch_pair(1, 2, 6)
    s, aux = init_state(prm, MW, r0, H0, grid, device="cpu")
    return Engine(prm, MW, grid, aux, device="cpu"), s


@pytest.fixture(scope="module")
def cell_start():
    prm = RunParams(**cell_run_params(
        list_update_int=2, mpi_sync_int=1, mc_vol_prob=1.0 / 16384, seed=5))
    r0, H0 = stacking_switch_pair(14, 8, 18)
    mx, _ = correspondence_mismatch(r0, H0)
    shape = cells.choose_grid_shape(H0, MW, mx)
    cg = cells.build_grid(shape, cells.cap_for_positions(r0, H0, shape), H0,
                          MW, mx)
    grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)
    s, aux, caux = init_cell_state(prm, MW, r0, H0, grid, cg, device="cpu")
    return (prm, MW, grid, aux, cg, caux), s


def test_dense_chunks_are_invisible():
    a = _chunked(_dense, (2, 1, 3))
    b = _chunked(_dense, (6,))
    s = a[1]
    assert s.cycle == 6
    # every part of a cycle ran: volume moves, syncs, resyncs
    assert int(s.att[1].min()) > 0 and int(s.acc[0].min()) > 0
    _assert_same_run(*a, *b)


def test_cell_chunks_are_invisible(cell_start):
    args, s0 = cell_start

    def make():
        eng = CellEngine(*args, device="cpu")
        # one sweep: 64 sub-steps of 8 movers a cycle
        eng.sweeps_per_cycle, eng.trials_per_cycle = 1, 512
        return eng, s0.clone()

    a = _chunked(make, (1, 1))
    b = _chunked(make, (2,))
    s = a[1]
    assert s.cycle == 2
    # a volume move (cycle 1), a rebin (cycle 2) and delta-syncs fell
    # inside
    assert float(s.origin.abs().max()) > 0
    assert int(s.att[1].min()) > 0
    _assert_same_run(*a, *b)


@pytest.fixture(scope="module")
def port_chunked(tmp_path_factory):
    """The port's front end at jit_chunk=1 (blocks of 2), run once for
    the two tests below."""
    return _run_app(tapp.run_input_file, tmp_path_factory.mktemp("port"),
                    "chunked", device="cpu", jit_chunk=1)


def test_app_chunked_writes_the_same_files_and_a_heartbeat(tmp_path,
                                                           port_chunked):
    whole = _run_app(tapp.run_input_file, tmp_path, "whole", device="cpu",
                     jit_chunk=100)
    chunked = port_chunked
    names = sorted(os.listdir(whole))
    assert names == sorted(os.listdir(chunked)) and "heartbeat" in names
    for name in names:
        a, b = whole / name, chunked / name
        if name.startswith("checkpoint"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        elif name == "mc.log":
            # but for the block timings
            keep = [[ln for ln in open(p) if not ln.startswith("# block")]
                    for p in (a, b)]
            assert keep[0] == keep[1]
        else:
            assert a.read_bytes() == b.read_bytes(), name
    assert (chunked / "heartbeat").read_text() == "4\n"


def test_app_matches_jax_at_small_jit_chunk(tmp_path, port_chunked):
    jd = _run_app(japp.run_input_file, tmp_path, "jax", use_mesh=False,
                  jit_chunk=1)
    td = port_chunked
    assert set(os.listdir(td)) == set(os.listdir(jd))
    assert (td / "heartbeat").read_text() == \
        (jd / "heartbeat").read_text() == "4\n"
    for start in ("# Computed energies", "# Computed enthalpies",
                  "# Monte-Carlo statistics"):
        assert _line(td / "node000.log", start) == \
            _line(jd / "node000.log", start), start
    rows = np.loadtxt(td / "ice000_therm.dat")
    assert rows[:, 0].tolist() == [1, 2, 3, 4]
    np.testing.assert_array_equal(rows[:, 0],
                                  np.loadtxt(jd / "ice000_therm.dat")[:, 0])
    assert APP_OVERRIDES["chkpt_dump_int"] == 2
