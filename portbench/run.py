"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the PyTorch/CUDA package
``mc_water_ls_mw_tpu_torch``, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the per-layer metrics, ``busy_s``, ``window_s`` and a
``breakdown``; ``build_s``, the part of set-up that builds or finds the
kernels; ``checks`` last, each a value and its limit, a bound or a
[low, high] range); the last lines of standard error give
each number compared beside its limit.  Without a card, or with fewer
cards than the cell asks for, it exits with code 2 and prints no
result; if JAX or the JAX package is loaded once the window has closed,
with code 3.  Builds and kernel caches stay inside the checkout
(``build/``).
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mc_water_ls_mw_tpu")


def _env():
    """Fixed cache directories inside the checkout, set before torch
    loads; no library may load JAX on its own."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def _jax_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    entry, _, _ = harness.cell_files(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    loaded = _jax_loaded()
    if loaded:
        print("portbench: loaded in the benchmark's process: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    dev = dict(res.device)
    dev["power_limit_w"] = _power_limit()
    line = {
        "correct": res.correct,
        "attempted": res.walkers,
        "failed": res.failed,
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in res.metrics.items()},
        "device": dev,
    }
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    # the part of setup_s that builds the kernels (a checkout's first
    # run) or finds them built
    line["build_s"] = res.build_s
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in res.checks}
    print(f"build_s {res.build_s!r}", file=sys.stderr)
    print(f"correct {res.correct}", file=sys.stderr)
    for k, v, lim in res.checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
