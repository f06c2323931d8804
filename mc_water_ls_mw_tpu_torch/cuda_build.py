"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds); a kernel with many instantiations is split over several
sources that share a header, so that they build side by side.
Libraries go to ``build/torch_kernels/`` at the repository root, named
by a hash of the source, every header and the flags: a changed source
builds anew at first use, an unchanged one is loaded as it is.  Nothing is
built or loaded at import time.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on a non-zero code.  There is no fallback: a missing
``nvcc``, a build error or a launch error raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "torch_kernels"
KERNELS = ("full_energy", "fused_cycle", "fused_cycle_variants",
           "cell_movers", "chain_wl", "slab_energy")
# Shared memory one block can use on the H100 (227 KB): the launch plans
# keep their blocks under it.
SMEM_BLOCK_MAX = 232448
# -fmad=false: every product and sum is rounded on its own, as in the
# plain versions' elementwise PyTorch ops.  With nvcc's default
# contraction into FMAs, a float32 fused cycle rounded each step's
# energy change differently and flipped ~1% of walkers' accept
# sequences per cycle against the plain version (PERF.md).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class SWConsts(ctypes.Structure):
    """Mirror of ``struct SWConsts`` in csrc/sw_common.cuh."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "rc", "rc2", "sigma", "gs", "AE", "Bs4", "lam_eps", "c0",
        "two_c0", "c0sq", "omc2",
    )]

    @classmethod
    def of(cls, m) -> "SWConsts":
        """Fold the SWParams constants in double, in the association
        order of the plain versions (ops/dense.py)."""
        sig2 = m.sigma * m.sigma
        return cls(
            rc=m.rc, rc2=m.rc2, sigma=m.sigma, gs=m.gamma * m.sigma,
            AE=m.bigA * m.epsilon, Bs4=m.bigB * sig2 * sig2,
            lam_eps=m.lam * m.epsilon, c0=m.cos0, two_c0=2.0 * m.cos0,
            c0sq=m.cos0 * m.cos0, omc2=(1.0 - m.cos0) ** 2,
        )


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels cannot be built"
        )
    return nvcc


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: (path, seconds, nvcc
    output)}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            out[name] = (path, 0.0, "(cached)")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, time.time(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (path, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = (path, time.time() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed)."""
    path, _, _ = build_all((name,))[name]
    return ctypes.CDLL(str(path))


def bind(name: str, symbol: str, argtypes):
    """``symbol`` of library ``name`` with its ctypes signature set
    (pointers and the stream as c_void_p, so they are not cut to 32
    bits; returns the C int error code)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
