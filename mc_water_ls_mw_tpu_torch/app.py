"""Run orchestration: the counterpart of ``mc_water_ls_mw_tpu/app.py``
(the reference's main.f90).

Drives a whole calculation in the current working directory: the input
file and the initial structure, the engine pick (the dense N=216-class
engine or the large-N cell engine), the eta_weights.dat warm start, the
restart from a checkpoint, the blocked cycle loop with its interval
events (therm samples, trajectory, monitor, flatness, Delta G,
checkpoint), the SIGTERM-safe stop and the queue-time guard (reference
call stack: SURVEY.md 3.1-3.2, main.f90:40-254).

The run is one process on one device (``device``: 'cuda' by default,
'cpu' on request), or, launched by ``torchrun --nproc-per-node D`` (or
inside a ``torch.distributed`` group of D ranks), D processes with the
walkers sharded over them (``use_mesh``, the JAX package's argument):
rank r takes the walker block [r W/D, (r+1) W/D) of the same run, in
either parallel strategy ('mw', or 'dd' mu windows: walkers assigned
round-robin to ``n_windows`` windows).  Every rank builds the whole
initial state (or loads the whole checkpoint) and keeps its block;
rank 0 writes every file, a checkpoint of the gathered state in the
serial layout, so that a run's files and checkpoints do not depend on
the number of ranks.  A walker count that does not divide over the
ranks is refused (the JAX package falls back to one device there, but
several processes each running the whole run would write the same
files).  Each block runs in chunks of at most ``jit_chunk`` cycles, as
in the JAX package; after each chunk the run waits for the card and
rank 0 writes the cycle reached to ``heartbeat``, the progress signal
of a long block that ``liveness.py`` and ``tools/watchdog.py`` read.
The random streams are keyed by the cycle, so the chunking changes no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import time

import numpy as np
import torch

from . import tracing
from .constants import HART_TO_EV
from .io import checkpoint as ckpt
from .io import writers
from .io.namelist import read_input
from .io.xmol import read_lattices, tile_cell
from .mcmc import wanglandau as wl
from .mcmc.bins import build_bin_grid
from .mcmc.config import RunParams
from .mcmc.engine import Engine
from .mcmc.state import compute_log_unbiased_norm, init_state, resolve_device
from .models.sw import get_model
from .ops.dsfloat import ds_value64, ds_zeros
from .parallel.comm import init_from_env
from .parallel.mesh import gather_state, shard_state
from .parallel.windows import join_eta


class CapacityOverflow(RuntimeError):
    """A rebin exceeded the slab capacity: the affected walkers are
    corrupt from that rebin on, but the last checkpoint predates it (the
    audit runs before the checkpoint write).  run_input_file catches
    this, regrows cell_cap and resumes from that checkpoint through the
    slab-capacity migration (io/checkpoint.migrate_cell_cap)."""

    def __init__(self, cap, overflow):
        self.cap = int(cap)
        self.overflow = int(overflow)
        super().__init__(
            f"cell occupancy exceeded capacity {cap} by {overflow}")


class Timer:
    """Queue-time guard (timer.f90:105-127)."""

    def __init__(self, qtime, closetime):
        self.t0 = time.monotonic()
        self.qtime = qtime
        self.closetime = closetime

    def safe(self) -> bool:
        return (time.monotonic() - self.t0) < (self.qtime - self.closetime)


def rng_self_test(logs, device, n=1_000_000, bins=100, seed=1234):
    """Startup uniformity self-test of the device's generator
    (random_test_uniform, random.f90:105-144)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
    hist = torch.histc(u, bins=bins, min=0.0, max=1.0).cpu().numpy()
    logs.my("# Testing random number generator")
    logs.my(f"#   Minimum bin occupancy {int(hist.min()):8d} "
            f"(expected ~{n // bins})")
    logs.my(f"#   Maximum bin occupancy {int(hist.max()):8d}")


def _block_size(prm: RunParams) -> int:
    """Host-event cadence: gcd of all intervals that need host IO."""
    b = math.gcd(prm.monitor_int, prm.chkpt_dump_int)
    b = math.gcd(b, prm.flat_chk_int)
    if prm.num_lattices == 2 and prm.samplerun:
        b = math.gcd(b, prm.deltaG_int)
    b = math.gcd(b, prm.traj_output_int)
    return max(b, 1)


class Application:
    """One whole run in ``workdir``."""

    def __init__(self, prm: RunParams, workdir=".", use_mesh=True,
                 device="cuda"):
        # the ranks of this run (parallel/comm.py): one without torchrun
        comm, device = init_from_env(device)
        if comm.sharded and not (use_mesh and prm.n_walkers % comm.size
                                 == 0):
            raise ValueError(
                f"{comm.size} ranks cannot share n_walkers="
                f"{prm.n_walkers}" + (
                    "" if use_mesh else " with use_mesh=False") +
                ": the walkers are sharded in equal blocks (pick a "
                "walker count divisible by the number of ranks)")
        self.comm = comm
        self.root = comm.rank == 0
        self.prm = prm
        self.device = resolve_device(device)
        self.workdir = os.path.abspath(workdir)
        os.chdir(self.workdir)
        self.model = get_model(prm.model_type)
        self.restart = ckpt.restart_available(".")
        self.logs = (writers.Logs(restart=self.restart) if self.root
                     else writers.NullLogs())
        self.ckpt_writer = None
        self.therm = None
        self._stop = False

    # ------------------------------------------------------------------

    def _structure(self):
        """Initial positions r0 [L,N,3] and cells H0 [L,3,3] (Bohr):
        the built-in stacking builder (&tpu stack=...) or the xmol files
        (init.f90:38-125), optionally tiled and relabelled."""
        prm, logs = self.prm, self.logs
        if prm.method == "stack" or tuple(prm.stack) != (0, 0, 0):
            from .models.stacking import stacking_cell, stacking_switch_pair

            nx, ny, m = (int(x) for x in prm.stack)
            if prm.num_lattices == 2:
                r0, H0 = stacking_switch_pair(nx, ny, m)
            else:
                r, H = stacking_cell("AB" * ((m + 1) // 2), nx, ny)
                r0, H0 = r[None], H[None]
            self.prm = prm = dataclasses.replace(prm, nwater=r0.shape[1])
            logs.g(f"# Built stacking pair nx={nx} ny={ny} "
                   f"bilayers={m} -> N = {prm.nwater}")
        else:
            r0, H0 = read_lattices(".", prm.num_lattices, prm.nwater)
            if tuple(prm.tile) != (1, 1, 1):
                tiled = [tile_cell(r0[l], H0[l], prm.tile)
                         for l in range(prm.num_lattices)]
                r0 = np.stack([t[0] for t in tiled])
                H0 = np.stack([t[1] for t in tiled])
                self.prm = prm = dataclasses.replace(prm, nwater=r0.shape[1])
                logs.g(f"# Tiled input cells {prm.tile} -> "
                       f"N = {prm.nwater}")
        if prm.relabel and prm.num_lattices == 2:
            from .models.stacking import (
                correspondence_mismatch,
                relabel_for_correspondence,
            )

            before, _ = correspondence_mismatch(r0, H0)
            r0, _ = relabel_for_correspondence(r0, H0)
            after, _ = correspondence_mismatch(r0, H0)
            logs.g(f"# Relabeled lattice 2: correspondence mismatch "
                   f"{before:.3f} -> {after:.3f} Bohr")
        return r0, H0

    def _cell_grid(self, r0, H0):
        """The large-N cell grid when the cell engine is requested or
        eligible (largen, largen_threshold), else None."""
        prm, logs = self.prm, self.logs
        if prm.largen not in ("on", "auto") or prm.num_lattices > 2:
            return None
        from .models.stacking import correspondence_mismatch
        from .ops.cells import build_grid, cap_for_positions, choose_grid_shape

        mismatch = 0.0
        if prm.num_lattices == 2:
            mismatch, _ = correspondence_mismatch(r0, H0)
        try:
            shape = choose_grid_shape(H0, self.model, mismatch)
        except ValueError:
            if prm.largen == "on":
                raise
            return None
        if not (prm.largen == "on" or prm.nwater >= prm.largen_threshold):
            return None
        m_fine = 2
        cap = prm.cell_cap
        if cap <= 0:
            cap = cap_for_positions(r0, H0, shape, m=m_fine)
        cg = build_grid(shape, cap, H0, self.model, mismatch, m=m_fine)
        logs.g(f"# Large-N cell engine: coarse grid {shape} x fine "
               f"{m_fine}^3 ({cg.nfine} fine cells, cap {cap}), mismatch "
               f"{mismatch:.3f} Bohr")
        return cg

    def _make_engine(self, stream=None):
        if self.cellgrid is not None:
            from .mcmc.cellengine import CellEngine

            return CellEngine(self.prm, self.model, self.grid, self.aux,
                              self.cellgrid, self._caux, device=self.device,
                              stream=stream, comm=self.comm)
        return Engine(self.prm, self.model, self.grid, self.aux,
                      device=self.device, stream=stream, comm=self.comm)

    def _any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank takes the same
        branch: a stop on one rank alone would leave the others waiting
        in a collective)."""
        if not self.comm.sharded:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        return bool(self.comm.max(t))

    @tracing.traced("mw/setup")
    def setup(self):
        prm, logs = self.prm, self.logs
        with tracing.span("mw/setup/rng_self_test"):
            rng_self_test(logs, self.device)
        r0, H0 = self._structure()
        prm = self.prm
        # bin grid; nbins may be promoted to odd (mc_init:557)
        self.grid = build_bin_grid(prm.nbins, prm.mu_min, prm.mu_max)

        # warm-start weights (mc_init:736-776): eta_weights.dat if
        # present; the smaller of file-f and input-f; a sample run
        # freezes f at zero
        weight0 = None
        wl_factor = prm.wl_factor
        if prm.num_lattices == 2 and os.path.exists("eta_weights.dat"):
            logs.g("# Found existing eta_weights.dat in current directory.")
            file_f, weight0 = writers.read_eta_weights("eta_weights.dat")
            if len(weight0) != self.grid.nbins:
                raise ValueError(f"eta_weights.dat has {len(weight0)} bins, "
                                 f"grid has {self.grid.nbins}")
            if file_f > 1e-10:
                wl_factor = min(wl_factor, file_f)
                if prm.samplerun:
                    wl_factor = 0.0
        if wl_factor != prm.wl_factor:
            self.prm = prm = dataclasses.replace(prm, wl_factor=wl_factor)
            logs.my("# Using smaller weight increment read from "
                    "eta_weights.dat")

        n_windows = 1
        if prm.parallel_strategy == "dd" and prm.num_lattices == 2:
            n_windows = max(2, min(prm.n_walkers, prm.n_windows))

        with tracing.span("mw/setup/state"):
            self.cellgrid = self._cell_grid(r0, H0)
            if self.cellgrid is not None:
                from .mcmc.cellengine import init_cell_state

                state, self.aux, self._caux = init_cell_state(
                    prm, self.model, r0, H0, self.grid, self.cellgrid,
                    weight0=weight0, n_windows=n_windows,
                    device=self.device)
            else:
                state, self.aux = init_state(
                    prm, self.model, r0, H0, self.grid, weight0=weight0,
                    n_windows=n_windows, device=self.device)
        with tracing.span("mw/setup/engine"):
            self.engine = self._make_engine()

        # initial lattice energies (main.f90:125-140): the float64
        # physics oracle line
        e = state.energy[:, 0].double().cpu().numpy() * HART_TO_EV
        hpv = (state.energy[:, 0] + prm.pressure * state.volume[:, 0]
               ).double().cpu().numpy() * HART_TO_EV
        logs.my("# Reference lattices")
        logs.my("# Computed energies   = "
                + "".join(f"{x:15.6f}" for x in e) + "  eV")
        logs.my("# Computed enthalpies = "
                + "".join(f"{x:15.6f}" for x in hpv) + "  eV")

        # trajectory headers (io.f90:696-789)
        if self.root:
            writers.write_psf("mW.psf", prm.nwater, prm.num_lattices)
            writers.write_dcd_header("mW.dcd",
                                     prm.nwater * prm.num_lattices)
        if self.comm.sharded:
            logs.g(f"# Sharding {prm.n_walkers} walkers over "
                   f"{self.comm.size} ranks")

        # restart (mc_init:825-854); a cell-engine checkpoint of a
        # smaller slab capacity is migrated to the current one
        self.start_cycle = 0
        if self.restart:
            state = self._restore(state)
        else:
            state = shard_state(state, self.comm, prm.n_walkers)
        self.state = state
        if self.root:
            self.ckpt_writer = ckpt.CheckpointWriter(".", background=True,
                                                     seed=prm.seed)
            self.therm = writers.ThermWriter(
                prm.seedname, range(min(prm.therm_walkers, prm.n_walkers)),
                prm.nwater, restart=self.restart)
        self.timer = Timer(prm.timer_qtime, prm.timer_closetime)
        signal.signal(signal.SIGTERM, self._sigterm)
        return self

    def _restore(self, state):
        """The whole state from the newer checkpoint (every rank reads
        it and keeps its block), resynchronised and audited."""
        prm, logs = self.prm, self.logs
        migrate = None
        if self.cellgrid is not None:
            migrate = (self.cellgrid.nfine, self.cellgrid.cap)
        loaded = ckpt.load_checkpoint(state, ".", cell_migrate=migrate,
                                      stream=self.engine.stream)
        if loaded is None:
            raise RuntimeError("checkpoint files present but unreadable")
        state, cycle, path = loaded
        state = shard_state(state, self.comm, prm.n_walkers)
        self.start_cycle = cycle
        logs.my(f"# Restarting from cycle {cycle} ({path})")
        if prm.num_lattices == 2:
            state = self.engine.resync_chains(state)
        state, _ = self.engine.audit_energy(state)
        # a generation checkpoint entering a sample phase: the chain
        # state carries over, the estimator accumulators start clean and
        # f freezes (the tell is a stored f > 0; a sample-phase resume
        # has f == 0 and keeps its accumulators)
        if prm.samplerun and float(self.comm.max(state.f.max())) > 0:
            logs.my("# Sample phase from a generation checkpoint: "
                    "freezing f, zeroing histogram/uhist accumulators, "
                    "keeping eta + chain state")
            for name in ("f", "hist", "uhist", "sumhist", "firstcycle"):
                setattr(state, name, torch.zeros_like(getattr(state, name)))
            for name in ("master_hist", "master_uhist"):
                hi = getattr(state, name).hi
                setattr(state, name, ds_zeros(hi.shape, hi.dtype, hi.device))
            # the unbiased increment is exp(eta - log_norm) clamped at
            # 60: recompute the norm from the checkpoint's eta (the
            # stitched curve of its windows) and rebuild the engine
            # around it
            w_cur = ds_value64(state.master_eta)               # [nwin, B]
            joined = (join_eta(w_cur, self.grid.nbins, prm.window_overlap)
                      if w_cur.shape[0] > 1 else w_cur[0])
            log_norm = compute_log_unbiased_norm(prm, self.grid, joined,
                                                 prm.n_walkers)
            logs.my(f"# Recomputed log_unbiased_norm = {log_norm:.3f} "
                    "from checkpoint eta")
            self.aux = self.aux._replace(log_unbiased_norm=log_norm)
            self.engine = self._make_engine(stream=self.engine.stream)
        return state

    def _sigterm(self, signum, frame):
        # cooperative shutdown (cleanexit, main.f90:263-295)
        self._stop = True

    # ------------------------------------------------------------------

    @tracing.traced("mw/therm")
    def _write_therm(self, samples):
        prm = self.prm
        if not self.root:
            return
        cycles = samples["cycle"].numpy()
        with tracing.wait("therm_copy"):
            e = samples["E_ls"].double().cpu().numpy()       # [n, T]
            mu = samples["mu"].double().cpu().numpy()
            vol = samples["vol"].double().cpu().numpy()      # [n, L, T]
            ls = samples["ls"].cpu().numpy()
        fixed = prm.samplerun or prm.wl_factor < 1e-300
        for i in np.nonzero(cycles % prm.file_output_int == 0)[0]:
            for w in self.therm.files:
                self.therm.write(
                    w, int(cycles[i]), float(e[i, w]), float(mu[i, w]),
                    vol[i, :, w], int(ls[i, w]), prm.num_lattices, fixed)

    def _write_traj(self):
        """Walker 0's configuration, which the root rank holds."""
        if not self.root:
            return
        s = self.state
        with tracing.wait("traj_copy"):
            ls0 = int(s.ls[0])
            r_all = s.r[..., 0]                               # [L,3,n]
            if self.cellgrid is not None:
                # slab layout: molecule order through mol2slot
                r_all = r_all[:, :, s.mol2slot[:, 0].long()]
            r_all = r_all.double().cpu().numpy()
            h0 = s.h[ls0, :, :, 0].double().cpu().numpy()
        r_oth = r_all[1 - ls0].T if self.prm.num_lattices == 2 else None
        writers.append_dcd_snapshot("mW.dcd", r_all[ls0].T, r_oth, h0)

    @tracing.traced("mw/events")
    def _events(self, cycle):
        """The host events of a block boundary at ``cycle``."""
        prm, eng = self.prm, self.engine
        if cycle % prm.traj_output_int == 0:
            self._write_traj()
        if cycle % prm.monitor_int == 0:
            self.state = wl.monitor_stats(eng, self.state, self.logs,
                                          self.aux)
        if prm.num_lattices == 2 and cycle % prm.flat_chk_int == 0:
            self.state = wl.check_flatness(eng, self.state, self.logs)
        if (prm.num_lattices == 2 and prm.samplerun
                and cycle % prm.deltaG_int == 0):
            self.state = wl.compute_deltaG(eng, self.state, self.logs,
                                           self.aux)

    @tracing.traced("mw/audit")
    def _check_windows(self, cycle):
        """The 'dd' equilibration window check (mc_cycle:187-201) after
        the boundary.  With window seeding (dd_seeding, the default)
        membership is instantaneous at the boundary and the eta walls
        capture a stray on first contact, while its out-of-window writes
        land in bins that the per-window flatness and the stitching
        leave out: a warning.  With the reference's reach-once windows a
        walker outside its window would sample the wrong statistics: the
        run stops."""
        prm = self.prm
        if prm.parallel_strategy != "dd" or cycle < prm.eq_mc_cycles:
            return
        with tracing.wait("audit_read"):
            n_out = int(self.comm.sum((~self.state.in_window).sum()[None]))
        if n_out == 0:
            return
        if not prm.dd_seeding:
            raise RuntimeError(
                "Not all walkers have reached their designated window "
                f"after {prm.eq_mc_cycles} MC cycles")
        self.logs.g(f"# WARNING: {n_out} walkers not inside their "
                    f"mu-window at cycle {cycle} (eta walls capture them "
                    "on first contact; out-of-window WL writes are "
                    "excluded from flatness/stitching)")

    def run(self, max_cycles=None, jit_chunk=100, profile_dir=None):
        """The cycle loop, in blocks whose boundaries fall on the event
        intervals, each run in chunks of at most ``jit_chunk`` cycles
        with a heartbeat after each.  ``profile_dir``: trace the run
        (``tracing``) and write to that directory a torch.profiler trace
        (chrome format) of the SECOND block, the first steady one, as
        ``trace.json``, and at the end the spans and counters of the run
        (``tracing.snapshot()``, rank 0's) as ``spans.json``."""
        with tracing.recording(profile_dir is not None):
            state = self._run(max_cycles, jit_chunk, profile_dir)
            if profile_dir is not None and self.root:
                os.makedirs(profile_dir, exist_ok=True)
                with open(os.path.join(profile_dir, "spans.json"),
                          "w") as fh:
                    json.dump(tracing.snapshot(), fh, indent=1)
        return state

    def _run(self, max_cycles, jit_chunk, profile_dir):
        prm, eng = self.prm, self.engine
        total = max_cycles if max_cycles is not None else prm.max_mc_cycles
        block = _block_size(prm)
        chunk = min(block, max(1, jit_chunk))
        if profile_dir is not None:
            # a second block inside the run; the shrunk block must divide
            # the original so that boundaries still land on the intervals
            cap = max(1, min(chunk, total // 2))
            block = max(d for d in range(1, cap + 1) if block % d == 0)
            chunk = min(chunk, block)
            if total < 2 * block:
                self.logs.g("# WARNING: run too short for a steady-state "
                            "profile block; no trace will be written")
        done = blocks_done = 0
        while done < total and not self._any(self._stop):
            prof = None
            if profile_dir is not None and blocks_done == 1 and self.root:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda"
                    else [])
                prof = profile(activities=acts)
                prof.start()
            with tracing.span("mw/block"):
                t_blk = time.monotonic()
                # blocks end on the interval boundaries
                n = min(block, total - done,
                        block - self.state.cycle % block)
                parts, left = [], n
                while left > 0:
                    c = min(chunk, left)
                    self.state, smp = eng.run_cycles(self.state, c)
                    parts.append(smp)
                    left -= c
                    self._heartbeat()
                samples = {k: torch.cat([p[k] for p in parts])
                           for k in parts[0]}
                t_disp = time.monotonic()
                done += n
                blocks_done += 1
                if prof is not None:
                    prof.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir,
                                                          "trace.json"))
                    self.logs.g(f"# profiler trace ({n} cycles) written "
                                f"to {profile_dir}")
                cycle = self.state.cycle
                self._write_therm(samples)
                t_therm = time.monotonic()
                self._events(cycle)
                t_wl = time.monotonic()
                # slab-capacity audit BEFORE the checkpoint write: an
                # overflowing walker is corrupt and must never be
                # persisted
                if self.cellgrid is not None:
                    with tracing.span("mw/audit"), \
                            tracing.wait("audit_read"):
                        ovf = int(self.comm.max(
                            self.state.occ_overflow.max()))
                    if ovf > 0:
                        raise CapacityOverflow(self.cellgrid.cap, ovf)
                if cycle % prm.chkpt_dump_int == 0:
                    self._checkpoint()
                t_end = time.monotonic()
                self.logs.g(
                    f"# block {cycle}: {n} cycles in {t_end - t_blk:.1f}s"
                    f" = dispatch {t_disp - t_blk:.1f} + therm "
                    f"{t_therm - t_disp:.1f} + wl/monitor "
                    f"{t_wl - t_therm:.1f} + ckpt/other {t_end - t_wl:.1f}")
                if self._any(not self.timer.safe()):
                    bar = "!" + "=" * 44 + "!"
                    self.logs.g(bar)
                    self.logs.g("! Approaching end of queue time - "
                                "stopping   !")
                    self.logs.g(bar)
                    break
                self._check_windows(cycle)
        # final checkpoint (main.f90:246), synchronous
        self._checkpoint(wait=True)
        if self.therm is not None:
            self.therm.close()
        return self.state

    def _heartbeat(self):
        """The liveness heartbeat of a chunk: the card's work is done (the
        cycles run asynchronously there), then rank 0 writes the cycle
        reached.  Without it a long block's first output lands at its
        end, and a watcher cannot tell it from a wedged process."""
        if self.device.type == "cuda":
            with tracing.wait("heartbeat"):
                torch.cuda.synchronize(self.device)
        if not self.root:
            return
        try:
            with open("heartbeat", "w") as hb:
                hb.write(f"{int(self.state.cycle)}\n")
        except OSError:
            pass

    @tracing.traced("mw/checkpoint")
    def _checkpoint(self, wait=None):
        """The gathered state, written by the root rank in the serial
        layout (collective)."""
        full = gather_state(self.state, self.comm)
        if self.root:
            self.ckpt_writer.write(full, stream=self.engine.stream,
                                   wait=wait)

    def close(self):
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait()
        self.logs.close()


def run_input_file(path, overrides=None, max_cycles=None, workdir=None,
                   profile_dir=None, use_mesh=True, jit_chunk=100,
                   device="cuda"):
    """Programmatic entry: run an ice.input file (in its directory, or
    ``workdir``) to completion on ``device``; returns the final state.

    ``use_mesh`` and ``jit_chunk`` are the JAX package's arguments, so
    that its callers (the committed runs/*/run.py) run unchanged.
    ``use_mesh`` shards the walkers over the ranks of a ``torchrun``
    launch (or of an initialised ``torch.distributed`` group), see
    Application; ``jit_chunk`` caps the cycles between two heartbeats
    (Application.run; in the JAX package it also caps the cycles of one
    compiled dispatch).  Host events stay on the block boundaries, so
    results do not depend on it.

    Cell-engine capacity resilience: if a rebin overflows the slab
    capacity (CapacityOverflow), the run is set up again with a regrown
    cell_cap and resumes from the last good checkpoint through the
    capacity migration of the loader (the reference's dual-checkpoint
    standard, mc_moves.F90:336-350, applied to a failure mode it never
    had)."""
    prm = read_input(path, extra_overrides=overrides)
    wd = workdir or os.path.dirname(os.path.abspath(path))
    with tracing.recording(profile_dir is not None):
        for attempt in range(4):
            app = Application(prm, workdir=wd, use_mesh=use_mesh,
                              device=device)
            try:
                app.setup()
                return app.run(max_cycles=max_cycles, jit_chunk=jit_chunk,
                               profile_dir=profile_dir)
            except CapacityOverflow as err:
                if attempt == 3:
                    raise
                new_cap = err.cap + max(2, err.overflow, err.cap // 8)
                app.logs.g(f"# Slab capacity {err.cap} overflowed by "
                           f"{err.overflow}: regrowing cell_cap to {new_cap} "
                           "and resuming from the last good checkpoint")
                prm = dataclasses.replace(prm, cell_cap=new_cap)
            finally:
                app.close()
