"""The port's spans and counters (``mc_water_ls_mw_tpu_torch.tracing``),
on the CPU in float64.

* off, nothing is recorded and every span is the shared no-op;
* on, a nest of spans gives each its self time, and each span is a
  ``record_function`` range of a running profiler;
* a few cycles of the dense engine (N=48, volume moves, delta-syncs and
  chain resyncs inside) and of the cell engine (N=8064 cut to 4
  sub-steps a cycle, a rebin inside) count their cycles, volume moves
  (the growth of att[1]) and sub-steps, and end bit for bit in the state
  the same run reaches with tracing off;
* ``run_input_file(..., profile_dir=...)`` writes ``spans.json`` beside
  ``trace.json``, with the set-up's spans and the run's counters, and
  leaves tracing off.
"""

import json
import os

import pytest
import torch

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch import tracing
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.cellengine import (
    CellEngine,
    init_cell_state,
)
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.models.stacking import (
    correspondence_mismatch,
    stacking_switch_pair,
)
from mc_water_ls_mw_tpu_torch.models.sw import MW
from mc_water_ls_mw_tpu_torch.ops import cells

from .test_torch_cells import cell_run_params
from .test_torch_frontend_heartbeat import _assert_same_run, _dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SUB = 4


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _run(make, cycles, traced):
    """(engine, state, samples, snapshot) of a fresh engine's run."""
    eng, s = make()
    with tracing.recording(traced):
        s, smp = eng.run_cycles(s, cycles)
    return eng, s, smp, tracing.snapshot()


def test_off_records_nothing():
    assert tracing.span("mw/x") is tracing.NULL
    assert tracing.wait("x") is tracing.NULL
    calls = []
    f = tracing.traced("mw/f")(lambda a: calls.append(a) or a)
    with tracing.span("mw/x"), tracing.wait("x"):
        tracing.count("cycles", 3)
        assert f(7) == 7
    assert calls == [7]
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_self_time_of_a_nest(monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 60, 70, 100])

    class Clock:
        @staticmethod
        def perf_counter_ns():
            return next(ticks)

    monkeypatch.setattr(tracing, "time", Clock)
    with tracing.recording():
        with tracing.span("outer"):              # [0, 100]
            with tracing.span("a"):              # [10, 30]
                pass
            with tracing.span("b"):              # [40, 70]
                with tracing.wait("c"):          # [50, 60]
                    tracing.count("n", 2)
        tracing.count("n")
    got = tracing.snapshot()
    assert got["spans"] == {
        "outer": {"count": 1, "total_ns": 100, "self_ns": 50, "max_ns": 100},
        "a": {"count": 1, "total_ns": 20, "self_ns": 20, "max_ns": 20},
        "b": {"count": 1, "total_ns": 30, "self_ns": 20, "max_ns": 30},
        "mw/wait/c": {"count": 1, "total_ns": 10, "self_ns": 10,
                      "max_ns": 10},
    }
    assert got["counters"] == {"n": 3}
    assert tracing.span("mw/x") is tracing.NULL


def test_spans_are_profiler_ranges():
    f = tracing.traced("mw/f")(lambda: torch.ones(3).sum())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording(), tracing.span("mw/outer"):
            f()
    names = {e.key for e in prof.key_averages()}
    assert {"mw/outer", "mw/f"} <= names
    assert tracing.snapshot()["spans"]["mw/f"]["count"] == 1


def test_dense_engine_counts_and_state():
    eng, s, smp, snap = _run(_dense, 6, True)
    _assert_same_run(eng, s, smp, *_run(_dense, 6, False)[:3])
    spans, ctr = snap["spans"], snap["counters"]
    assert ctr["cycles"] == spans["mw/cycle"]["count"] == 6
    assert spans["mw/step_kernel"]["count"] == 6
    # every walker attempts each scheduled volume move
    assert ctr["volume_moves"] == int(s.att[1, 0]) > 0
    assert torch.all(s.att[1] == ctr["volume_moves"])
    assert spans["mw/volume_move"]["count"] == ctr["volume_moves"]
    assert spans["mw/full_energy"]["count"] >= ctr["volume_moves"]
    assert {"mw/delta_sync", "mw/chain_resync"} <= spans.keys()
    # self time: the cycle's children take their share of it
    cyc = spans["mw/cycle"]
    assert 0 < cyc["self_ns"] < cyc["total_ns"]


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


def test_cell_engine_counts_and_state(cell_start):
    args, s0 = cell_start

    def make():
        eng = CellEngine(*args, device="cpu")
        eng.sweeps_per_cycle, eng.n_tables = 1, N_SUB
        eng.trials_per_cycle = N_SUB * eng.K * eng.T
        return eng, s0.clone()

    eng, s, smp, snap = _run(make, 2, True)
    _assert_same_run(eng, s, smp, *_run(make, 2, False)[:3])
    spans, ctr = snap["spans"], snap["counters"]
    assert ctr["cycles"] == 2
    assert ctr["substeps"] == spans["mw/substep"]["count"] == N_SUB * 2
    assert spans["mw/substeps"]["count"] == 2
    assert ctr["volume_moves"] == int(s.att[1, 0] - s0.att[1, 0])
    # the rebin of cycle 2 and its origin's copy
    assert spans["mw/rebin"]["count"] == 1
    assert spans["mw/wait/rebin_origin"]["count"] == 1
    assert spans["mw/wait/move_codes"]["count"] == 2


def test_profile_dir_writes_spans(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    src = os.path.join(REPO, "runs", "n216_wl", "ice.input")
    (d / "ice.input").write_text(open(src).read())
    cwd = os.getcwd()
    try:
        tapp.run_input_file(
            str(d / "ice.input"), overrides=dict(
                stack=(1, 2, 6), n_walkers=2, dtype="float64", nbins=21,
                mu_min=-400.0, mu_max=400.0, monitor_int=2, flat_chk_int=2,
                chkpt_dump_int=2, mc_vol_prob=0.05),
            max_cycles=4, profile_dir=str(d / "prof"), device="cpu")
    finally:
        os.chdir(cwd)
    assert (d / "prof" / "trace.json").is_file()
    got = json.loads((d / "prof" / "spans.json").read_text())
    spans, ctr = got["spans"], got["counters"]
    for name in ("mw/setup", "mw/setup/rng_self_test", "mw/setup/state",
                 "mw/setup/engine"):
        assert spans[name]["count"] == 1, name
    assert spans["mw/setup"]["self_ns"] < spans["mw/setup"]["total_ns"]
    assert ctr["cycles"] == spans["mw/cycle"]["count"] == 4
    assert spans["mw/block"]["count"] == 2
    assert {"mw/therm", "mw/events", "mw/checkpoint"} <= spans.keys()
    assert "volume_moves" in ctr
    assert tracing.span("mw/x") is tracing.NULL
