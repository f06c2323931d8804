"""The port's analysis tools (mc_water_ls_mw_tpu_torch/tools) against the
JAX package's scripts on the committed runs, on the CPU.

Each tool's ``main(argv)`` and the JAX script's ``main()`` (its
``sys.argv`` set) run in this process on the same inputs: their printed
output is the same, every number in it equal to 1e-12 relative, and
``retarget_weights``'s file byte for byte the script's.  The block
jackknife runs on runs/n216_sample(_torch) and on runs/n216_sample_dd5
(mw, --dd and --dd-counts), and in its --dd and --dd-counts modes on the
synthetic dumps of tests/test_deltag_dd.py; scripts/compare_sample_runs.py
gives the jackknife's Delta G.  The three-body filter tool runs end to
end with ``--device cpu`` (the JAX script's keys, its engine's final
state finite) and refuses to run without it where there is no card.
"""

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mc_water_ls_mw_tpu_torch.constants import HART_TO_KJPM, KB
from mc_water_ls_mw_tpu_torch.mcmc.bins import build_bin_grid
from mc_water_ls_mw_tpu_torch.mcmc.config import RunParams
from mc_water_ls_mw_tpu_torch.mcmc.state import assign_windows
from mc_water_ls_mw_tpu_torch.tools import (
    deltag_error,
    retarget_weights,
    threebody_filter,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(REPO, "runs")
_NUM = re.compile(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _outputs(name, args, capsys, monkeypatch):
    """(JAX script's stdout, the port tool's stdout) for ``args``."""
    script = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    script.main()
    jout = capsys.readouterr().out
    tool = importlib.import_module(f"mc_water_ls_mw_tpu_torch.tools.{name}")
    assert tool.main(args) == 0
    return jout, capsys.readouterr().out


def _assert_same_output(jout, tout):
    assert jout.strip()
    assert _NUM.sub("#", jout) == _NUM.sub("#", tout)
    for a, b in zip(_NUM.findall(jout), _NUM.findall(tout)):
        assert float(b) == pytest.approx(float(a), rel=1e-12, abs=0.0)


@pytest.mark.parametrize("run, args", [
    ("n216_sample_torch", []),
    ("n216_sample", ["--skip-blocks", "3"]),
    ("n216_sample_dd5", []),
    ("n216_sample_dd5", ["--dd", "--overlap", "2"]),
    ("n216_sample_dd5", ["--dd-counts", "--overlap", "2"]),
    ("n216_sample_dd5", ["--dd-counts", "--no-window-bounds"]),
])
def test_deltag_error_matches_jax(run, args, capsys, monkeypatch):
    jout, tout = _outputs(
        "deltag_error", [os.path.join(RUNS, run), "--mu-min", "-700",
                         "--mu-max", "700"] + args, capsys, monkeypatch)
    assert "kT/molecule  (N=216)" in tout
    _assert_same_output(jout, tout)


def _synthetic_dumps(d, counts):
    """The dumps of tests/test_deltag_dd.py: a known double-well P(mu)
    (right well 2x the left: Delta G = ln(1/2)) over 2 windows as
    per-window raw columns, or over 4 windows as visit counts with the
    frozen eta of a 4000 kT barrier."""
    B, nwin, seed = (41, 4, 1) if counts else (21, 2, 0)
    grid = build_bin_grid(B, -400.0, 400.0)
    mub, bw = grid.mu_bin, grid.binwidth
    prm = RunParams(nbins=B, mu_min=-400.0, mu_max=400.0, window_overlap=2,
                    num_lattices=2)
    wins = assign_windows(prm, grid, nwin)
    rng = np.random.default_rng(seed)
    logp = np.logaddexp(
        -0.5 * ((mub + 250) / 60.0) ** 2,
        np.log(2.0) - 0.5 * ((mub - 250) / 60.0) ** 2,
    ) - (4000.0 * np.exp(-0.5 * (mub / 120.0) ** 2) if counts else 0.0)
    eta = np.full((nwin, B), 1e30)
    for w, (s, e, _, _) in enumerate(wins):
        eta[w, s:e + 1] = logp[s:e + 1] + 7.0 * w
    cum = np.zeros((nwin, B))
    for cycle in (1000, 2000, 3000, 4000, 5000, 6000):
        for w, (s, e, _, _) in enumerate(wins):
            blk = np.zeros(B)
            if counts:
                blk[s:e + 1] = 500.0 * rng.uniform(0.95, 1.05, e + 1 - s)
            else:
                blk[s:e + 1] = (np.exp(logp) / bw * (1.0 + 0.5 * w)
                                * rng.uniform(0.97, 1.03, B))[s:e + 1]
            cum[w] += blk
        cols = [cum[w] for w in range(nwin)] + (
            [eta[w] for w in range(nwin)] if counts else [])
        name = "hist_windows" if counts else "uhist_windows"
        with open(os.path.join(d, f"{name}_{cycle:010d}.dat"), "w") as fh:
            fh.write("# mu then per-window columns\n")
            for k in range(B):
                fh.write(f"  {mub[k]: .14E}"
                         + "".join(f"  {c[k]: .14E}" for c in cols) + "\n")


@pytest.mark.parametrize("mode", ["--dd", "--dd-counts"])
def test_deltag_error_dd_synthetic_matches_jax(mode, tmp_path, capsys,
                                               monkeypatch):
    _synthetic_dumps(str(tmp_path), counts=mode == "--dd-counts")
    jout, tout = _outputs(
        "deltag_error", [str(tmp_path), "--mu-min", "-400", "--mu-max",
                         "400", mode, "--overlap", "2", "--skip-blocks",
                         "0"], capsys, monkeypatch)
    _assert_same_output(jout, tout)
    dg = float(re.search(r"= ([-+]\d+\.\d+) \+- [\d.]+ kT\n", tout).group(1))
    assert abs(dg - np.log(0.5)) < 0.1
    assert ("stitch-boundary" in tout) == (mode == "--dd-counts")


def test_deltag_estimators_match_jax():
    script = _jax_script("deltag_error")
    rng = np.random.default_rng(8)
    bw = build_bin_grid(41, -400.0, 400.0).binwidth
    raw = rng.uniform(0.0, 1e6, 41)
    assert deltag_error.deltag(raw, bw, 20) == script.deltag(raw, bw, 20)
    counts = rng.uniform(1.0, 500.0, (3, 41))
    eta = rng.normal(0.0, 30.0, (3, 41))
    for bounds in (None, [(0, 17), (12, 30), (25, 40)]):
        a = deltag_error.deltag_counts(counts, eta, bw, 20, bounds=bounds)
        b = script.deltag_counts(counts, eta, bw, 20, bounds=bounds)
        assert a[0] == pytest.approx(b[0], rel=1e-12)
        np.testing.assert_allclose(a[1], b[1], rtol=1e-12)


@pytest.mark.parametrize("run", ["n216_wl_r2", "n216_wl_dd"])
def test_deltag_from_weights_matches_jax(run, capsys, monkeypatch):
    jout, tout = _outputs("deltag_from_weights",
                          [os.path.join(RUNS, run), "--nwater", "216"],
                          capsys, monkeypatch)
    assert "J/mol" in tout
    _assert_same_output(jout, tout)


def test_retarget_weights_file_is_byte_identical(tmp_path, capsys,
                                                 monkeypatch):
    src = os.path.join(RUNS, "n216_wl_r2", "eta_weights.dat")
    outs = [str(tmp_path / name) for name in ("jax.dat", "port.dat")]
    script = _jax_script("retarget_weights")
    monkeypatch.setattr(sys, "argv", ["retarget_weights.py", src, outs[0]])
    script.main()
    assert retarget_weights.main([src, outs[1]]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace(outs[0], "X") == printed[1].replace(outs[1],
                                                                  "X")
    a, b = (open(p, "rb").read() for p in outs)
    assert a == b and len(a.splitlines()) == 102


def test_compare_dd_mw_matches_jax(capsys, monkeypatch):
    args = [os.path.join(RUNS, "n216_wl_dd"), os.path.join(RUNS, "n216_wl_r2")]
    jout, tout = _outputs("compare_dd_mw", args, capsys, monkeypatch)
    j, t = json.loads(jout), json.loads(tout)
    assert j.keys() == t.keys() and len(t["windows"]) == 8
    for k in j:
        if k != "windows":
            assert t[k] == pytest.approx(j[k], rel=1e-12, abs=0.0), k
    for jw, tw in zip(j["windows"], t["windows"]):
        assert tw == pytest.approx(jw, rel=1e-12, abs=0.0)


def test_compare_sample_runs_uses_the_jackknife(capsys, monkeypatch):
    """scripts/compare_sample_runs.py's Delta G of each run is the JAX
    deltag_error.py's, printed to its digits (the Done run's line:
    +0.8506 +- 0.0337 J/mol)."""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "compare_sample_runs.py"),
         os.path.join(RUNS, "n216_sample"),
         os.path.join(RUNS, "n216_sample_torch"), "--mu-min", "-700",
         "--mu-max", "700"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    script = _jax_script("deltag_error")
    j_per_mol = KB * 200.0 * HART_TO_KJPM * 1000.0
    for run, line in zip(("n216_sample", "n216_sample_torch"), lines):
        monkeypatch.setattr(sys, "argv", [
            "deltag_error.py", os.path.join(RUNS, run), "--mu-min", "-700",
            "--mu-max", "700"])
        script.main()
        kt = re.search(r"= ([-+][\d.]+) \+- ([\d.]+) kT/molecule",
                       capsys.readouterr().out)
        dg, se = float(kt.group(1)), float(kt.group(2))
        assert f"deltaG {dg:+.8f} +- {se:.8f} kT/molecule" in line
        assert f"= {dg * j_per_mol:+.4f} +- {se * j_per_mol:.4f} J/mol" \
            in line
    assert "= +0.8506 +- 0.0337 J/mol" in lines[1]


def test_threebody_filter_runs_on_cpu_and_needs_a_card_otherwise(
        capsys, monkeypatch):
    assert threebody_filter.main(["2", "2", "--nwater", "48",
                                  "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    # the JAX script's keys (scripts/threebody_filter.py)
    assert out.keys() == {"cos_cut", "cycles", "walkers", "n48"}
    rec = out["n48"]
    assert rec.keys() == {"ideal_dE_hartree", "ideal_triplets",
                          "traj_configs", "traj_triplets",
                          "traj_max_dE_eV", "traj_max_dmu_kT"}
    assert rec["traj_configs"] == 4          # 1 sample x 2 walkers x 2
    assert all(np.isfinite(v) for v in rec.values())
    _, launches, ends = threebody_filter.measure(2, 2, (48,), device="cpu")
    eng, s = ends[48]
    assert launches == {"fused_cycle": 0, "full_energy": 0}
    assert int(s.cycle) == 2 and bool(torch.isfinite(s.energy).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        threebody_filter.main(["2", "2", "--nwater", "48"])
