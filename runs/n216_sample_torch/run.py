"""N=216 sample run of the PyTorch/CUDA port: unbiased histogram +
deltaG(Ih-Ic).

The production phase of runs/n216_sample (the same ice.input, the same
converged eta_weights.dat and the same overrides: 4096 walkers, one
window, float32, weights frozen), driven through the port's
``run_input_file`` on one CUDA card instead of the JAX package.  The
unbiased visit histogram accumulates and deltaG is reported every
deltaG_int cycles, each report with its cumulative dump
``unbiased_histogram_<cycle>.dat`` for the block jackknife of
scripts/deltag_error.py.

Usage, from a directory that holds this script's ice.input and
eta_weights.dat (a copy of this one):
    WL_QTIME=<seconds> python run.py
The run stops cleanly ``timer_closetime`` = 420 s before WL_QTIME.  The
repository root is taken to be two directories above the working
directory (runs/<name>/ or any other two-deep copy).
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..")))
from mc_water_ls_mw_tpu_torch.app import run_input_file  # noqa: E402

qtime = float(os.environ.get("WL_QTIME", "10800"))
run_input_file(
    "ice.input",
    overrides=dict(
        stack=(3, 3, 6),              # 4*3*3*6 = 216 molecules
        n_walkers=4096,
        mu_min=-700.0, mu_max=700.0,
        nbins=101,
        samplerun=True,
        eq_mc_cycles=1000,
        mpi_sync_int=50,
        monitor_int=5000,
        flat_chk_int=100_000_000,     # no flatness events in sampling
        deltaG_int=10000,
        chkpt_dump_int=25000,
        timer_qtime=qtime, timer_closetime=420,
        max_mc_cycles=100_000_000,
    ),
)
print("sample run stopped cleanly", flush=True)
