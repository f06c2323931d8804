"""Walker-ensemble sampler state and initialisation, on tensors.

Counterpart of ``mc_water_ls_mw_tpu/mcmc/state.py``.  The state holds a
batch of W independent chains, each carrying BOTH lattice replicas, in
the JAX package's walker-last layout, so that a state converts field by
field (``state_from_numpy`` / ``state_to_numpy``).  Two differences:

* the ten moment fields are one stacked [10, L, N, W] tensor (the
  layout the fused-cycle kernel takes; fused.py:1247 of the JAX
  package), in ``Moments`` field order;
* there are no per-walker PRNG keys and ``cycle`` is a host int: the
  engine owns its random streams (``mcmc/engine.py``).

The engine updates a state IN PLACE (the kernels write the tensors they
are given); clone a state before running it if it is needed again.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.sw import SWParams
from ..ops.dense import full_energy_batch, reduced_shift_set
from ..ops.dsfloat import DS, ds_zeros
from ..ops.geometry import (
    cell_shift_range,
    determinant3,
    enumerate_shifts,
    recip_matrix,
)
from ..ops.nbrtable import build_nbr_tables, mic_unique
from .bins import BinGrid
from .config import RunParams

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device) -> torch.device:
    """The port's device rule: ``cuda`` unless the caller asks for the
    CPU; asking for CUDA where there is none raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def clone_state(state):
    """Deep copy of a state dataclass (tensors and DS pairs cloned)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, DS):
            v = DS(v.hi.clone(), v.lo.clone())
        elif isinstance(v, torch.Tensor):
            v = v.clone()
        out[f.name] = v
    return type(state)(**out)


@dataclasses.dataclass
class SamplerState:
    """Full sampler state; trailing axis = walker everywhere.  Field
    meanings and reference citations: the JAX package's SamplerState."""

    r: torch.Tensor              # [L,3,N,W] positions
    ref_r: torch.Tensor          # [L,3,N,W] reference-lattice positions
    h: torch.Tensor              # [L,3,3,W] cell matrices
    recip: torch.Tensor          # [L,3,3,W]
    volume: torch.Tensor         # [L,W]
    energy: torch.Tensor         # [L,W]
    mu: torch.Tensor             # [W] lattice-switch order parameter
    ls: torch.Tensor             # [W] int32 active lattice (0-based)
    moments: torch.Tensor        # [10,L,N,W] (Moments field order)
    weight: torch.Tensor         # [B,W] WL weight growth since sync
    hist: torch.Tensor           # [B,W] histogram growth since sync
    uhist: torch.Tensor          # [B,W] unbiased-hist growth since sync
    f: torch.Tensor              # [W] WL modification factor
    sumhist: torch.Tensor        # [W]
    invt_active: torch.Tensor    # [W] bool
    firstcycle: torch.Tensor     # [W] bool
    histogram_reset: torch.Tensor  # [W] bool
    master_eta: DS               # [nwin,B] x2 double-single
    master_hist: DS
    master_uhist: DS
    window_id: torch.Tensor      # [W] int32
    my_mu_min: torch.Tensor      # [W]
    my_mu_max: torch.Tensor      # [W]
    start_bin: torch.Tensor      # [W] int32
    end_bin: torch.Tensor        # [W] int32
    in_window: torch.Tensor      # [W] bool
    max_trans: torch.Tensor      # [W]
    dv_max: torch.Tensor         # [W]
    att: torch.Tensor            # [3,W] int32 attempted trans/vol/switch
    acc: torch.Tensor            # [3,W] int32 accepted
    trans_per_mol: torch.Tensor  # [N,W] int32
    avg_energy: torch.Tensor     # [L,W]
    min_dmu: torch.Tensor        # [W]
    max_dmu: torch.Tensor        # [W]
    cycle: int                   # host counter
    dropped: torch.Tensor        # int32 scalar (delta-merge drops)

    def clone(self) -> "SamplerState":
        return clone_state(self)


class EngineAux(NamedTuple):
    """Init-time derived constants closed over by the engine."""

    shifts: np.ndarray          # [S,3] int32 static image shifts
    ref_h: np.ndarray           # [L,3,3] initial cells (float64)
    ref_enthalpy: torch.Tensor  # [L] (main.f90:146-150)
    log_unbiased_norm: float    # (mc_init:778-806)
    nbr_tbl: np.ndarray | None = None  # [L,N,M] int32, sentinel N
    frac0: np.ndarray | None = None    # [L,3,N] reference fractional
    wall: float = 0.0                  # displacement wall (Bohr)


_DS_FIELDS = ("master_eta", "master_hist", "master_uhist")
_INT_FIELDS = ("ls", "window_id", "start_bin", "end_bin", "att", "acc",
               "trans_per_mol", "dropped", "slot2mol", "mol2slot",
               "occ_overflow")
_BOOL_FIELDS = ("invt_active", "firstcycle", "histogram_reset",
                "in_window")


def fields_from_numpy(cls, fields: dict, device) -> dict:
    """Constructor arguments of the state dataclass ``cls`` from a plain
    numpy dict: DS masters from (hi, lo) pairs, ``cycle`` an int, integer
    and bool fields in the state's types, floats in their own dtype.
    Keys that ``cls`` does not have (a JAX state's PRNG keys) are
    ignored."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.name == "cycle":
            kw[f.name] = int(np.asarray(v))
        elif f.name in _DS_FIELDS:
            kw[f.name] = DS(*(torch.as_tensor(np.array(x), device=device)
                              for x in v))
        elif f.name in _INT_FIELDS:
            kw[f.name] = torch.as_tensor(np.array(v, np.int32),
                                         device=device)
        elif f.name in _BOOL_FIELDS:
            kw[f.name] = torch.as_tensor(np.array(v, bool), device=device)
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=device)
    return kw


def aux_from_numpy(aux_fields: dict, dtype, device) -> EngineAux:
    a = dict(aux_fields)
    return EngineAux(
        shifts=np.array(a["shifts"], np.int32),
        ref_h=np.array(a["ref_h"], np.float64),
        ref_enthalpy=torch.as_tensor(np.array(a["ref_enthalpy"]),
                                     dtype=dtype, device=device),
        log_unbiased_norm=float(a["log_unbiased_norm"]),
        nbr_tbl=(None if a.get("nbr_tbl") is None
                 else np.array(a["nbr_tbl"], np.int32)),
        frac0=(None if a.get("frac0") is None
               else np.array(a["frac0"], np.float64)),
        wall=float(a.get("wall", 0.0) or 0.0),
    )


def state_from_numpy(fields: dict, aux_fields: dict, device="cuda"):
    """Build (SamplerState, EngineAux) from plain numpy dicts.

    ``fields`` maps every SamplerState field name to an array (``moments``
    [10,L,N,W]; the DS masters to (hi, lo) pairs; ``cycle`` to an int);
    other keys (a JAX state's PRNG keys) are ignored.  ``aux_fields``
    maps EngineAux field names likewise.  Float fields keep their dtype,
    so a float64 reference state stays float64."""
    device = resolve_device(device)
    state = SamplerState(**fields_from_numpy(SamplerState, fields, device))
    return state, aux_from_numpy(aux_fields, state.r.dtype, device)


def state_to_numpy(state) -> dict:
    """Plain numpy dict of a state (the inverse of state_from_numpy)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, DS):
            out[f.name] = (v.hi.cpu().numpy(), v.lo.cpu().numpy())
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = np.asarray(v, np.int32)
    return out


def assign_windows(prm: RunParams, grid: BinGrid, n_windows: int):
    """dd-mode mu-window layout (mc_init:659-722), 0-based bins.
    Returns per-window (start_bin, end_bin inclusive, mu_min, mu_max)."""
    B = grid.nbins
    bw = np.asarray(grid.binwidth)
    edges = np.concatenate([[prm.mu_min], prm.mu_min + np.cumsum(bw)])
    bpw = B // n_windows
    ov = prm.window_overlap
    wins = []
    for wid in range(n_windows):
        if wid == 0:
            s, e = 0, bpw + ov - 1
            lo, hi = prm.mu_min, edges[e + 1]
        elif wid == n_windows - 1:
            s, e = wid * bpw - ov - 1, B - 1
            lo, hi = edges[s], prm.mu_max
        else:
            s, e = wid * bpw - ov - 1, (wid + 1) * bpw + ov - 1
            lo, hi = edges[s], edges[e + 1]
        wins.append((s, e, lo, hi))
    return wins


def compute_log_unbiased_norm(prm: RunParams, grid: BinGrid,
                              weight0: np.ndarray, n_ranks: int) -> float:
    """Overflow-resistant log of the expected unbiased-histogram norm
    (mc_init:778-806); ``n_ranks`` plays the role of MPI size (here:
    total walkers)."""
    hits_per_bin = (
        (prm.max_mc_cycles - prm.eq_mc_cycles)
        * float(n_ranks * prm.nwater)
        / grid.nbins
    )
    hits_per_bin = max(hits_per_bin, 1.0)
    incr = hits_per_bin * grid.av_binwidth
    logs = np.log(incr) + np.asarray(weight0, dtype=np.float64)
    return float(np.logaddexp.reduce(logs))


def init_state(prm: RunParams, model: SWParams, r0: np.ndarray,
               H0: np.ndarray, grid: BinGrid,
               weight0: np.ndarray | None = None, n_windows: int = 1,
               device="cuda") -> tuple[SamplerState, EngineAux]:
    """Build the initial walker-ensemble state (reference init order:
    positions -> energies -> ref_enthalpy -> windows -> initial mu,
    main.f90:98-175).  r0 [L,N,3], H0 [L,3,3] in Bohr."""
    device = resolve_device(device)
    dtype = _DTYPES[prm.dtype]
    W, L, N, B = prm.n_walkers, prm.num_lattices, prm.nwater, grid.nbins

    H0_host = np.asarray(H0, dtype=np.float64)
    bounds = [cell_shift_range(H0_host[l], model.rskin) for l in range(L)]
    bmax = tuple(max(b[d] for b in bounds) for d in range(3))
    shifts = enumerate_shifts(bmax)

    r0t = torch.as_tensor(np.asarray(r0, np.float64), dtype=dtype,
                          device=device)
    H0t = torch.as_tensor(H0_host, dtype=dtype, device=device)
    r = r0t.permute(0, 2, 1)[..., None].expand(L, 3, N, W).contiguous()
    h = H0t[..., None].expand(L, 3, 3, W).contiguous()
    recip = torch.stack([recip_matrix(h[l]) for l in range(L)])
    vol = torch.abs(torch.stack([determinant3(h[l]) for l in range(L)]))

    # all walkers start identical: compute one copy, broadcast
    per = [full_energy_batch(r0t[l].T[:, :, None], H0t[l][:, :, None],
                             shifts, model, False) for l in range(L)]
    e0 = torch.stack([p[0][0] for p in per])                 # [L]
    mom0 = torch.stack([torch.stack(list(p[1]))[..., 0] for p in per],
                       dim=1)                                 # [10,L,N]
    energy = e0[:, None].expand(L, W).contiguous()
    moments = mom0[..., None].expand(10, L, N, W).contiguous()

    ref_enth = energy[:, 0]
    if prm.mc_ensemble == "npt":
        ref_enth = ref_enth + prm.pressure * vol[:, 0]
    if any(abs(x) > 1e-300 for x in prm.input_ref_enthalpy[:L]):
        ref_enth = torch.as_tensor(prm.input_ref_enthalpy[:L],
                                   dtype=dtype, device=device)

    if L == 2:
        mu0 = (energy[0] + prm.pressure * vol[0]
               - energy[1] - prm.pressure * vol[1])
        if prm.leshift:
            mu0 = mu0 - ref_enth[0] + ref_enth[1]
        mu0 = mu0 * prm.beta - N * torch.log(vol[0] / vol[1])
    else:
        mu0 = torch.zeros((W,), dtype=dtype, device=device)

    if prm.parallel_strategy == "dd" and L == 2 and n_windows > 1:
        wins = assign_windows(prm, grid, n_windows)
        wid = np.arange(W) % n_windows
        sb = np.array([wins[i][0] for i in wid], dtype=np.int32)
        eb = np.array([wins[i][1] for i in wid], dtype=np.int32)
        lo = np.array([wins[i][2] for i in wid])
        hi = np.array([wins[i][3] for i in wid])
        in_window = np.zeros(W, dtype=bool)
        ls0 = np.full(W, prm.ls - 1, dtype=np.int32)
        ls0 = np.where(hi < 0.0, 0, ls0)
        ls0 = np.where(lo > 0.0, 1, ls0)
        nwin = n_windows
    else:
        wid = np.zeros(W, dtype=np.int32)
        sb = np.zeros(W, dtype=np.int32)
        eb = np.full(W, B - 1, dtype=np.int32)
        lo = np.full(W, prm.mu_min)
        hi = np.full(W, prm.mu_max)
        in_window = np.ones(W, dtype=bool)
        ls0 = np.full(W, prm.ls - 1, dtype=np.int32)
        nwin = 1

    if weight0 is None:
        weight0 = np.zeros(B)
    # warm-start weights load into the MASTER rows; per-walker arrays
    # hold only growth since the last sync (see the JAX init_state for
    # the dd_seeding note)
    w0rows = np.broadcast_to(
        np.asarray(weight0, dtype=np.float64), (nwin, B)
    ).copy()
    if (not prm.dd_seeding) and nwin > 1:
        bins = np.arange(B)
        for wdx in range(nwin):
            sbx, ebx = wins[wdx][0], wins[wdx][1]
            w0rows[wdx, (bins < sbx) | (bins > ebx)] = 0.0
    master_eta = DS(
        torch.as_tensor(w0rows, dtype=dtype, device=device),
        torch.zeros((nwin, B), dtype=dtype, device=device),
    )
    log_norm = compute_log_unbiased_norm(prm, grid, weight0, W)

    def full(shape, val, dt=dtype):
        return torch.full(shape, val, dtype=dt, device=device)

    def tens(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    state = SamplerState(
        r=r, ref_r=r.clone(), h=h, recip=recip, volume=vol,
        energy=energy, mu=mu0.to(dtype), ls=tens(ls0, torch.int32),
        moments=moments,
        weight=full((B, W), 0.0), hist=full((B, W), 0.0),
        uhist=full((B, W), 0.0),
        f=full((W,), prm.wl_factor), sumhist=full((W,), 0.0),
        invt_active=full((W,), False, torch.bool),
        firstcycle=full((W,), True, torch.bool),
        histogram_reset=full((W,), False, torch.bool),
        master_eta=master_eta,
        master_hist=ds_zeros((nwin, B), dtype, device),
        master_uhist=ds_zeros((nwin, B), dtype, device),
        window_id=tens(wid, torch.int32),
        my_mu_min=tens(lo, dtype), my_mu_max=tens(hi, dtype),
        start_bin=tens(sb, torch.int32), end_bin=tens(eb, torch.int32),
        in_window=tens(in_window, torch.bool),
        max_trans=full((W,), prm.mc_max_trans),
        dv_max=full((W,), prm.mc_dv_max),
        att=full((3, W), 0, torch.int32), acc=full((3, W), 0, torch.int32),
        trans_per_mol=full((N, W), 0, torch.int32),
        avg_energy=full((L, W), 0.0),
        min_dmu=full((W,), float("inf")), max_dmu=full((W,), 0.0),
        cycle=0,
        dropped=full((), 0, torch.int32),
    )

    # candidate-reduction fast path: static neighbour tables + wall
    # (ops/nbrtable.py), when the geometry allows it
    nbr_tbl, frac0, wall = None, None, 0.0
    want_tbl = prm.nbr_table == "on" or (
        prm.nbr_table == "auto" and N >= 96
    )
    if prm.nbr_table == "on" and prm.trans_wall <= 0.0:
        raise ValueError(
            "nbr_table='on' requires trans_wall > 0 (the displacement "
            "wall is what makes the static tables exact; see "
            "ops/nbrtable.py)"
        )
    # tables, frac0 and ref_h from the positions as rounded to the run
    # dtype, as the JAX package builds them
    r0n = r0t.double().cpu().numpy()
    H0n = H0t.double().cpu().numpy()
    if want_tbl and prm.trans_wall > 0.0:
        mic_ok = mic_unique(H0n, model) and (
            len(reduced_shift_set(H0n, model)) == 1
        )
        if mic_ok:
            wall = float(prm.trans_wall)
            nbr_tbl = build_nbr_tables(r0n, H0n, model, wall)
            frac0 = np.stack([
                r0n[l] @ np.linalg.inv(H0n[l]).T for l in range(L)
            ]).transpose(0, 2, 1)                       # [L,3,N]
        elif prm.nbr_table == "on":
            raise ValueError(
                "nbr_table='on' requires a MIC-unique box (all "
                "perpendicular widths > 2*rc) with a single residual "
                "image shift; use nbr_table='auto' or 'off'"
            )

    aux = EngineAux(
        shifts=shifts,
        ref_h=H0n,
        ref_enthalpy=ref_enth.to(dtype),
        log_unbiased_norm=log_norm,
        nbr_tbl=nbr_tbl,
        frac0=frac0,
        wall=wall,
    )
    return state, aux
