"""Dual-slot checkpointing of the full sampler state.

Counterpart of ``mc_water_ls_mw_tpu/io/checkpoint.py`` (the reference's
alternating checkpoint files, mc_checkpoint_write/load,
mc_moves.F90:324-501): two slots ``checkpoint000.npz.1`` / ``.2`` are
written alternately, so one valid checkpoint survives a crash mid-write,
and the loader restores the newer readable one.

The file layout is the JAX package's, so that a checkpoint written by
either package loads in the other: one array ``leaf<i>`` per leaf of the
JAX state pytree in field order (the ten moment fields one leaf each,
[L, N, W]; a double-single master two, hi then lo; ``cycle`` an int32
scalar; the JAX state's PRNG keys ``key`` [W, 2] and ``shared_key`` [2],
uint32, before ``dropped``), and ``__fingerprint__``, the JSON layout
fingerprint (state kind, every field's leaf shapes and dtypes) that both
loaders compare before restoring anything.

The random streams are each package's own.  The port writes, in the
JAX key leaves, raw keys drawn by numpy from (seed, cycle), from which
the JAX package resumes its threefry streams; and it stores its own
Philox generators' states beside the leaves (``torch_stream_sched``,
``torch_stream_walk``, which the JAX loader does not read).  Loading a
checkpoint without them (one the JAX package wrote), the port re-seeds
its streams from the run's seed and the checkpoint's cycle
(``PhiloxStream.reseed``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import zipfile

import numpy as np
import torch

from .. import tracing
from ..mcmc.state import fields_from_numpy
from ..ops.dsfloat import DS

_BASENAME = "checkpoint000"
_STREAM_KEYS = ("torch_stream_sched", "torch_stream_walk")
_KEY_FIELDS = ("key", "shared_key")
_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.int32: "int32", torch.bool: "bool"}


def _slot_path(directory, slot):
    return os.path.join(directory, f"{_BASENAME}.npz.{slot}")


def checkpoint_paths(directory="."):
    return [_slot_path(directory, s) for s in (1, 2)]


def restart_available(directory=".") -> bool:
    """Restart auto-detection (main.f90:65-68)."""
    return any(os.path.exists(p) for p in checkpoint_paths(directory))


# ----------------------------------------------------------------------
# the JAX package's leaf layout
# ----------------------------------------------------------------------

def _field_names(state) -> list[str]:
    """The JAX state's field order: the port's fields with the two PRNG
    key fields before ``dropped``."""
    names = [f.name for f in dataclasses.fields(state)]
    i = names.index("dropped")
    return names[:i] + list(_KEY_FIELDS) + names[i:]


def _field_meta(state, name) -> list:
    """[[shape, dtype], ...] of the leaves of field ``name`` (metadata
    only: nothing is copied off the device)."""
    W = state.mu.shape[0]
    if name == "key":
        return [[[W, 2], "uint32"]]
    if name == "shared_key":
        return [[[2], "uint32"]]
    if name == "cycle":
        return [[[], "int32"]]
    v = getattr(state, name)
    if isinstance(v, DS):
        return [[list(x.shape), _NP_DTYPES[x.dtype]] for x in v]
    if name == "moments":
        return [[list(v.shape[1:]), _NP_DTYPES[v.dtype]]] * 10
    return [[list(v.shape), _NP_DTYPES[v.dtype]]]


def state_fingerprint(state) -> str:
    """The JAX package's layout fingerprint of a state: engine kind
    ('SamplerState' / 'CellState') and every field's leaf (shape,
    dtype), as the JSON string both packages compare."""
    fields = [[name, _field_meta(state, name)]
              for name in _field_names(state)]
    return json.dumps({"kind": type(state).__name__, "fields": fields})


def _stream_keys(seed: int, cycle: int, W: int):
    """Raw threefry keys for the JAX key leaves, drawn from (seed,
    cycle)."""
    rng = np.random.default_rng([int(seed), int(cycle)])
    k = rng.integers(0, 2 ** 32, size=(W + 1, 2), dtype=np.uint32)
    return k[1:], k[0]


def _host_leaves(state, seed: int) -> list[np.ndarray]:
    """Every leaf of the state in the JAX order, pulled to the host."""
    W = state.mu.shape[0]
    key, shared_key = _stream_keys(seed, state.cycle, W)
    out = []
    for name in _field_names(state):
        if name == "key":
            out.append(key)
        elif name == "shared_key":
            out.append(shared_key)
        elif name == "cycle":
            out.append(np.asarray(state.cycle, np.int32))
        else:
            v = getattr(state, name)
            if isinstance(v, DS):
                out.extend(x.cpu().numpy() for x in v)
            elif name == "moments":
                out.extend(f.cpu().numpy() for f in v)
            else:
                out.append(v.cpu().numpy())
    return out


def _leaf_field_names(state) -> list[str]:
    """Flat leaf index -> owning field name."""
    return [name for name in _field_names(state)
            for _ in _field_meta(state, name)]


def _state_from_leaves(template, leaves):
    """A state of the template's class, device and float type from
    leaves in the JAX order (the key leaves are dropped)."""
    fields, i = {}, 0
    for name in _field_names(template):
        n = len(_field_meta(template, name))
        group = leaves[i:i + n]
        i += n
        if name in _KEY_FIELDS:
            continue
        if name == "moments":
            fields[name] = np.stack(group)
        elif isinstance(getattr(template, name), DS):
            fields[name] = tuple(group)
        else:
            fields[name] = group[0]
    dev = template.mu.device
    kw = fields_from_numpy(type(template), fields, dev)
    for name, v in kw.items():
        tv = getattr(template, name)
        if isinstance(v, DS):
            kw[name] = DS(*(x.to(tv.hi.dtype) for x in v))
        elif isinstance(v, torch.Tensor):
            kw[name] = v.to(tv.dtype)
    return type(template)(**kw)


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

class CheckpointWriter:
    """Alternating-slot writer (mc_checkpoint_write:336-350).

    The device-to-host pull is synchronous (the engine updates the state
    in place); with ``background=True`` the savez and rename run in a
    worker thread while the cycle loop goes on.  Each slot is written to
    a temporary file and renamed, so a kill mid-write leaves the other
    slot valid.  A failed background write re-raises on the next
    write() / wait()."""

    def __init__(self, directory=".", background=False, seed=0):
        # absolute: a background write must not follow a later chdir
        self.directory = os.path.abspath(directory)
        self.slot = 1
        self.background = background
        self.seed = int(seed)
        self._thread = None
        self._error = None

    def _save(self, arrays, path):
        try:
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **arrays)
            os.replace(tmp, path)
        except Exception as err:  # re-raised on the next write/wait
            self._error = err

    def wait(self):
        """Block until any background write has landed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def write(self, state, stream=None, wait=None):
        """Write ``state`` (and the generator states of ``stream``, a
        PhiloxStream) to the next slot; returns the slot's path."""
        self.wait()
        with tracing.wait("checkpoint_copy"):
            leaves = _host_leaves(state, self.seed)
        arrays = {f"leaf{i}": x for i, x in enumerate(leaves)}
        arrays["__fingerprint__"] = np.frombuffer(
            state_fingerprint(state).encode(), dtype=np.uint8)
        if stream is not None:
            for k, st in zip(_STREAM_KEYS, stream.get_state()):
                arrays[k] = st.numpy()
        path = _slot_path(self.directory, self.slot)
        self.slot = 2 if self.slot == 1 else 1
        if (not self.background) if wait is None else wait:
            self._save(arrays, path)
            self.wait()
        else:
            self._thread = threading.Thread(
                target=self._save, args=(arrays, path), name="ckpt-writer",
                daemon=True)
            self._thread.start()
        return path


# ----------------------------------------------------------------------
# loading
# ----------------------------------------------------------------------

def migrate_cell_cap(template, leaves, names, nfine: int, cap_new: int):
    """Repack a cell-engine checkpoint's slab leaves from an old slab
    capacity to ``cap_new`` (the cell_cap regrow path after an occupancy
    overflow; app.run_input_file).  As the JAX package's function of the
    same name: every slab leaf [.., nfine*cap, ..] is padded at the end
    of each fine cell's slot run (occupied ranks stay contiguous; empty
    ``slot2mol`` entries are -1) and ``mol2slot`` is remapped
    fc*cap_old + r -> fc*cap_new + r.  Returns (leaves, cap_old); raises
    ValueError unless the stored layout is a smaller-capacity variant
    of the template's."""
    out = []
    cap_old = None
    shapes = [tuple(m[0]) for name in _field_names(template)
              for m in _field_meta(template, name)]
    for ts, arr, name in zip(shapes, leaves, names):
        ss = tuple(arr.shape)
        if ts == ss:
            if name == "mol2slot":
                if cap_old is None:
                    raise ValueError("mol2slot before any slab leaf; "
                                     "cannot infer the old capacity")
                arr = (arr // cap_old) * cap_new + arr % cap_old
            out.append(arr)
            continue
        diffs = [d for d, (a, b) in enumerate(zip(ts, ss)) if a != b]
        if (len(ts) != len(ss) or len(diffs) != 1
                or ts[diffs[0]] != nfine * cap_new
                or ss[diffs[0]] % nfine != 0):
            raise ValueError(f"field {name}: stored shape {ss} is not a "
                             f"slab-capacity variant of {ts}")
        d = diffs[0]
        this_cap = ss[d] // nfine
        if cap_old is None:
            cap_old = this_cap
        elif this_cap != cap_old:
            raise ValueError("inconsistent stored slab capacities")
        if cap_old >= cap_new:
            raise ValueError(
                f"stored capacity {cap_old} >= new {cap_new}: only "
                "capacity growth can be migrated")
        fill = -1 if name == "slot2mol" else 0
        a5 = arr.reshape(ss[:d] + (nfine, cap_old) + ss[d + 1:])
        pad = [(0, 0)] * a5.ndim
        pad[d + 1] = (0, cap_new - cap_old)
        out.append(np.pad(a5, pad, constant_values=fill).reshape(ts))
    if cap_old is None:
        raise ValueError("no slab-shaped field differed; nothing to "
                         "migrate")
    return out, cap_old


def load_checkpoint(template, directory=".", cell_migrate=None,
                    stream=None):
    """Probe both slots and restore the newer readable one
    (mc_checkpoint_load:417-448).  Returns (state, cycle, path) or None.

    ``template`` gives the expected layout, class, device and float
    type.  A slot whose fingerprint differs is refused with an error
    naming both layouts, unless ``cell_migrate=(nfine, cap_new)`` and
    the only difference is a smaller slab capacity (migrate_cell_cap).
    ``stream`` (a PhiloxStream) gets the stored generator states, or is
    re-seeded from its seed and the checkpoint's cycle when the file has
    none (a checkpoint of the JAX package)."""
    want_fp = state_fingerprint(template)
    n_leaves = sum(len(_field_meta(template, n))
                   for n in _field_names(template))
    candidates, mismatches = [], []
    migrated_from = None
    for path in checkpoint_paths(directory):
        if not os.path.exists(path):
            continue
        try:
            with np.load(path) as data:
                got_fp = bytes(data["__fingerprint__"].tobytes()).decode()
                leaves = [data[f"leaf{i}"] for i in range(n_leaves)]
                gens = ([data[k] for k in _STREAM_KEYS]
                        if all(k in data for k in _STREAM_KEYS) else None)
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile):
            continue                 # a torn or foreign file: the other slot
        if got_fp != want_fp:
            if cell_migrate is None:
                mismatches.append((path, got_fp))
                continue
            try:
                leaves, migrated_from = migrate_cell_cap(
                    template, leaves, _leaf_field_names(template),
                    *cell_migrate)
            except ValueError:
                mismatches.append((path, got_fp))
                continue
        cycle = int(leaves[_leaf_field_names(template).index("cycle")])
        candidates.append((cycle, path, leaves, gens))
    if not candidates:
        if mismatches:
            path, got_fp = mismatches[-1]
            raise RuntimeError(
                f"checkpoint {path} was written by an incompatible run "
                f"configuration and cannot be restored.\n"
                f"  expected: {want_fp}\n  found:    {got_fp}\n"
                "Remove the checkpoint files to start fresh, or restore "
                "the original nbins/n_walkers/nwater/engine settings.")
        return None
    candidates.sort(key=lambda c: c[0])
    cycle, path, leaves, gens = candidates[-1]
    state = _state_from_leaves(template, leaves)
    if stream is not None:
        if gens is None:
            stream.reseed(cycle)
        else:
            stream.set_state([torch.as_tensor(g) for g in gens])
    if migrated_from is not None:
        path = (f"{path} (slab capacity migrated {migrated_from} -> "
                f"{cell_migrate[1]})")
    return state, cycle, path
