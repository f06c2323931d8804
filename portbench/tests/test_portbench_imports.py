"""What the benchmark's modules import, by top-level name compared whole
(the port's name, ``mc_water_ls_mw_tpu_torch``, begins with the JAX
package's)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")
JAX = {"jax", "jaxlib", "flax", "mc_water_ls_mw_tpu"}


def _modules(sub=""):
    """Every module the benchmark runs on the card (its tests aside)."""
    out = []
    for d, dirs, files in os.walk(os.path.join(PB, sub)):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__",
                                                "data")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")
                and f != "conftest.py"]
    return sorted(out)


def _tops(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p[len(PB) + 1:])
def test_no_jax(path):
    assert not _tops(path) & JAX


@pytest.mark.parametrize("path", _modules("reference"),
                         ids=lambda p: p[len(PB) + 1:])
def test_reference_imports_nothing_of_the_program(path):
    tops = _tops(path)
    assert tops <= {"__future__", "dataclasses", "math", "numpy", "torch"}
    assert "mc_water_ls_mw_tpu_torch" not in tops


def test_whole_names():
    # the check compares whole top-level names: the port passes it
    assert "mc_water_ls_mw_tpu_torch" not in JAX
    sys.path.insert(0, ROOT)
    from portbench.run import FORBIDDEN

    assert set(FORBIDDEN) == JAX


def test_run_loads_no_jax():
    """Importing the harness and the port loads no JAX."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.harness, portbench.calibrate, "
            "mc_water_ls_mw_tpu_torch.app; "
            "from portbench.run import _jax_loaded; "
            "print(_jax_loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
