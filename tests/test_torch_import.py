"""The PyTorch port stands alone: it imports without JAX and names
neither JAX nor the JAX package in any import.  The scans walk the whole
package, its tools/ among it."""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / \
    "mc_water_ls_mw_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py")
)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mc_water_ls_mw_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m.startswith('jax')\n"
        "            or m.split('.')[0] == 'mc_water_ls_mw_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert len(MODULES) >= 36
    # the cell engine's modules, the front end and the run's tools are
    # among them
    for name in ("ops.cells", "ops.cell_energy", "ops.cell_kernels",
                 "mcmc.chain_kernel", "mcmc.cellengine", "mcmc.wanglandau",
                 "io.namelist", "io.xmol", "io.writers", "io.checkpoint",
                 "app", "cli", "parallel.comm", "parallel.mesh",
                 "parallel.spatial", "liveness", "ops.neighbours",
                 "ops.energy", "tools.__init__", "tools.watchdog",
                 "tools.threebody_filter", "tools.deltag_error",
                 "tools.deltag_from_weights", "tools.retarget_weights",
                 "tools.compare_dd_mw"):
        assert f"mc_water_ls_mw_tpu_torch.{name}" in MODULES


def test_no_jax_import_in_sources():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax\b|mc_water_ls_mw_tpu\b(?!_torch))",
        re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders
    smoke = PKG.parent / "chip_smoke.py"
    assert not pat.search(smoke.read_text())
