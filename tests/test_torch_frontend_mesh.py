"""The port's front end on 2 gloo ranks against 1 rank.

``runs/n216_sample_dd/ice.input`` (a 'dd' weight generation) with the
overrides of tests/test_torch_frontend_dd.py at 8 walkers over 2
windows, float64, through ``run_input_file`` (each rank calls it inside
an initialised ``torch.distributed`` group, as under torchrun):

* 2 ranks from scratch to cycle 2 write rank 0's files, which equal the
  1-rank run's: every log, curve and therm file line by line (integers
  identical, decimals to the last printed digit: on the CPU the two
  runs agree to f64 round-off, not bit for bit, because the plain
  versions' vector arithmetic depends on the batch width), the
  trajectory, and the checkpoint, whose layout is the serial one;
* the 2-rank checkpoint resumes on 1 rank, and a 1-rank checkpoint on 2
  ranks, each going on to cycle 4 as the 1-rank run resumed on 1 rank
  does;
* a walker count that does not divide over the ranks is refused.
"""

import os
import re
import shutil

import numpy as np

from mc_water_ls_mw_tpu_torch import app as tapp
from mc_water_ls_mw_tpu_torch.io import checkpoint as tckpt
from mc_water_ls_mw_tpu_torch.parallel.comm import run_ranks

from .test_torch_frontend import REPO
from .torch_ranks import frontend_jobs

OVER = dict(
    stack=(3, 3, 6), n_walkers=8, n_windows=2, dtype="float64", nbins=21,
    mu_min=-400.0, mu_max=400.0, eq_mc_cycles=2, mpi_sync_int=1,
    list_update_int=2, file_output_int=1, monitor_int=2, flat_chk_int=2,
    chkpt_dump_int=2, traj_output_int=2, therm_walkers=6, mc_vol_prob=0.02,
    deltaG_int=2,
)
_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _one_rank(d, max_cycles):
    cwd = os.getcwd()
    try:
        return tapp.run_input_file(str(d / "ice.input"), overrides=OVER,
                                   max_cycles=max_cycles, device="cpu")
    finally:
        os.chdir(cwd)


def _tokens_match(a, b):
    """Two log/curve lines agree: the same words, integers identical,
    decimals within one unit of their last printed digit (or 1e-9
    relative)."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        if not (_NUM.match(x) and _NUM.match(y)) or "." not in x:
            return False
        mant = re.split("[eE]", x)[0]
        ulp = 10.0 ** -len(mant.split(".")[1]) if "." in mant else 1.0
        if "e" in x.lower():
            ulp *= 10.0 ** int(re.split("[eE]", x)[1])
        if abs(float(x) - float(y)) > ulp + 1e-9 * abs(float(x)) + 1e-12:
            return False
    return True


def _assert_same_files(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    for name in names:
        p1, p2 = d1 / name, d2 / name
        if name.startswith("checkpoint"):
            continue
        if name == "mW.dcd":
            a, b = (np.fromfile(p, np.float32) for p in (p1, p2))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            continue
        la, lb = p1.read_text().splitlines(), p2.read_text().splitlines()
        if name == "mc.log":
            # block timings and the sharding line are the run's own
            keep = lambda ls: [ln for ln in ls                # noqa: E731
                               if not ln.startswith(("# block",
                                                     "# Sharding"))]
            la, lb = keep(la), keep(lb)
        assert len(la) == len(lb), name
        for x, y in zip(la, lb):
            assert _tokens_match(x, y), f"{name}: {x!r} != {y!r}"


def _leaves(d):
    """The newer checkpoint's leaves (the serial layout's)."""
    path = max(tckpt.checkpoint_paths(str(d)),
               key=lambda p: int(np.load(p)["leaf" + str(_cycle_leaf(p))]))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cycle_leaf(path):
    import json

    with np.load(path) as z:
        fp = json.loads(bytes(z["__fingerprint__"]).decode())
    i = 0
    for name, leaves in fp["fields"]:
        if name == "cycle":
            return i
        i += len(leaves)
    raise KeyError("cycle")


def _assert_same_checkpoint(d1, d2):
    a, b = _leaves(d1), _leaves(d2)
    assert a.keys() == b.keys()
    assert bytes(a["__fingerprint__"]) == bytes(b["__fingerprint__"])
    for k in a:
        if k.startswith("torch_stream"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-10,
                                       err_msg=k)


def test_two_ranks_write_the_one_rank_files_and_resume(tmp_path):
    src = os.path.join(REPO, "runs", "n216_sample_dd", "ice.input")
    a, b, c = (tmp_path / x for x in ("one", "two", "one_then_two"))
    for d in (a, b):
        d.mkdir()
        shutil.copy(src, d / "ice.input")
    assert int(_one_rank(a, 2).cycle) == 2
    shutil.copytree(a, c)
    odd = dict(OVER, n_walkers=7, parallel_strategy="mw")
    got = run_ranks(frontend_jobs, 2, [(str(b), OVER, 2),
                                       (str(c), OVER, 2),
                                       (str(b), odd, 2)])
    for res in got:
        assert res[:2] == [2, 4]
        assert "cannot share n_walkers=7" in res[2]
    _assert_same_files(a, b)
    _assert_same_checkpoint(a, b)
    # the 2-rank checkpoint resumed on 1 rank, the 1-rank one on 2
    # ranks, and the 1-rank one on 1 rank, each to cycle 4
    assert int(_one_rank(b, 2).cycle) == 4
    assert int(_one_rank(a, 2).cycle) == 4
    for d in (b, c):
        _assert_same_files(a, d)
        _assert_same_checkpoint(a, d)
    assert "# Restarting from cycle 2" in (c / "node000.log").read_text()
